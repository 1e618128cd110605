"""The PyTorch port's serving slice against the JAX package.

Each algorithm (kNN, K-Means, GNB) is fitted in both packages from the same
seeded numpy blobs, and the JAX fit is also carried across with
``repro_torch.convert``; the JAX engine and the port's engine then serve
the same queries through the same power-of-two buckets.  Classes and kNN
neighbour indices compare exactly, fitted params and float aux to
``rtol = atol = 1e-5``.  The port runs on ``device="cpu"``; without that
argument and without a card its entry points raise.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import estimator as jest
from repro.serving.engine import NonNeuralServeEngine as JaxEngine
from repro_torch import convert
from repro_torch.core import estimator as port_est
from repro_torch.data.datasets import class_blobs
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.serving import (ClassifyResult, KNNServeEngine,
                                 NonNeuralServeEngine)

TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = Path(__file__).resolve().parents[1]

# algorithm -> (d, n_groups): GNB at d = 70 takes its kernel arm (d >= 64)
CASES = {"knn": (21, 3), "kmeans": (21, 4), "gnb": (70, 3)}


@pytest.fixture(autouse=True)
def no_backend_env(monkeypatch):
    """Both packages pick their arms by shape, whatever REPRO_BACKEND the
    surrounding run sets."""
    monkeypatch.delenv(tdispatch.ENV_VAR, raising=False)


def _data(algo, n=300, n_q=11, seed=0):
    d, groups = CASES[algo]
    X, y = class_blobs(n=n + n_q, d=d, n_class=groups, seed=seed)
    return X[:n], y[:n], X[n:], y[n:]


def _compare(algo, got, want_cls, want_aux):
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want_cls))
    if algo == "knn":
        np.testing.assert_array_equal(got.aux.numpy(), np.asarray(want_aux))
    else:
        np.testing.assert_allclose(got.aux.numpy(), np.asarray(want_aux),
                                   **TOL)


@pytest.mark.parametrize("algo", sorted(CASES))
def test_engine_matches_jax(algo):
    X, y, Q, _ = _data(algo)
    groups = CASES[algo][1]
    jfit = jest.make_fitted(algo, X, y, n_groups=groups)
    jengine = JaxEngine(jfit, max_batch=8)
    jres = jengine.classify(Q)                   # 11 queries: buckets 8, 4

    # the port's own fit from the same numpy data
    tfit = port_est.make_fitted(algo, X, y, n_groups=groups, device="cpu")
    for name, leaf in tfit.params._asdict().items():
        if isinstance(leaf, torch.Tensor):
            np.testing.assert_allclose(
                leaf.numpy(), np.asarray(getattr(jfit.params, name)), **TOL)
    # the JAX fit carried across as numpy leaves
    params = convert.params_from_numpy(
        algo, jax.tree.map(np.asarray, jfit.params), device="cpu")
    kw = {"k": jfit.k} if algo == "knn" else {}
    carried = type(tfit).from_params(params, device="cpu", **kw)

    for est in (tfit, carried):
        engine = NonNeuralServeEngine(est, max_batch=8, device="cpu")
        assert engine.warmup(Q) == 2
        res = engine.classify(Q)
        assert res.launches == jres.launches == 2
        assert engine.bucket_launches == jengine.bucket_launches
        _compare(algo, res, jres.classes, jres.aux)


@pytest.mark.parametrize("algo", sorted(CASES))
def test_bucket_launches_subset_of_warmed(algo):
    X, y, Q, _ = _data(algo, n_q=13)
    est = port_est.make_fitted(algo, X, y, n_groups=CASES[algo][1],
                               device="cpu")
    engine = NonNeuralServeEngine(est, max_batch=8, device="cpu")
    assert engine.warmup_buckets(X.shape[1]) == 4        # 1, 2, 4, 8
    assert engine.bucket_launches == {}                   # warmup uncounted
    warmed = set(engine.warmed)
    assert warmed == {1, 2, 4, 8}
    for b in (1, 3, 8, 13):
        res = engine.classify(Q[:b])
        assert res.classes.shape == (b,) and res.aux.shape[0] == b
    assert set(engine.bucket_launches) <= warmed
    # 13 queries split into 8 + 5, and 5 pads to the 8 bucket
    assert engine.bucket_launches == {1: 1, 4: 1, 8: 3}


@pytest.mark.parametrize("algo", sorted(CASES))
def test_empty_aux_matches_jax(algo):
    X, y, _, _ = _data(algo, n=60)
    groups = CASES[algo][1]
    jfit = jest.make_fitted(algo, X, y, n_groups=groups)
    tfit = port_est.make_fitted(algo, X, y, n_groups=groups, device="cpu")
    want = jfit.empty_aux()
    got = tfit.empty_aux()
    assert tuple(got.shape) == tuple(want.shape)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    res = NonNeuralServeEngine(tfit, device="cpu").classify(
        np.zeros((0, X.shape[1]), np.float32))
    assert res.launches == 0 and tuple(res.classes.shape) == (0,)
    assert tuple(res.aux.shape) == tuple(want.shape)


def test_predict_matches_predict_batch():
    X, y, Q, _ = _data("knn")
    est = port_est.make_fitted("knn", X, y, device="cpu")
    cls, nbr = est.predict_batch(Q)
    for i in range(3):
        c, n = est.predict(Q[i])
        assert int(c) == int(cls[i])
        assert n.tolist() == nbr[i].tolist()


def test_knn_facade_and_result_alias():
    X, y, Q, _ = _data("knn")
    est = port_est.make_fitted("knn", X, y, device="cpu")
    facade = KNNServeEngine(est.params, k=4, max_batch=8, device="cpu")
    a = facade.classify(Q)
    b = NonNeuralServeEngine(est, max_batch=8, device="cpu").classify(Q)
    assert a.neighbors.tolist() == b.aux.tolist()
    assert a.classes.tolist() == b.classes.tolist()
    with pytest.raises(ValueError):
        KNNServeEngine(est.params, k=len(X) + 1, device="cpu")
    res = ClassifyResult(classes=a.classes, aux=a.aux, launches=1,
                         algorithm="gnb")
    with pytest.raises(AttributeError, match="kNN-only"):
        res.neighbors


def test_engine_rejects_unported_options():
    X, y, _, _ = _data("kmeans")
    est = port_est.make_fitted("kmeans", X, y, device="cpu")
    # the int8 tier is ported: the engine serves a quantized copy and
    # leaves the caller's estimator fp32
    int8 = NonNeuralServeEngine(est, device="cpu", policy="int8")
    assert int8.estimator.quantized and not est.quantized
    assert set(int8.quant_report) == {"bytes_int8", "bytes_fp32",
                                      "bytes_predicted"}
    assert torch.equal(int8.classify(X[:5]).classes,
                       est.quantized_copy().predict_batch(X[:5])[0])
    # the sharded layer is ported (tests/test_torch_sharded.py); what the
    # JAX engine refuses on a mesh, this one refuses too
    with pytest.raises(ValueError, match="sharded=True needs"):
        NonNeuralServeEngine(est, device="cpu", sharded=True)
    with pytest.raises(ValueError, match="qry"):
        NonNeuralServeEngine(est, device="cpu", strategy="qry")
    mesh = make_local_mesh(2, "cpu")
    with pytest.raises(NotImplementedError, match="model-partition"):
        NonNeuralServeEngine(est, device="cpu", mesh=mesh, policy="int8",
                             strategy="reference")
    sharded = NonNeuralServeEngine(est, device="cpu", mesh=mesh)
    with pytest.raises(NotImplementedError, match="single-device"):
        sharded.sibling(policy="int8")
    with pytest.raises(NotImplementedError, match="single-device"):
        sharded.group_fn()
    # autotune is ported (tests/test_torch_autotune.py): one tuned bucket
    engine = NonNeuralServeEngine(est, device="cpu")
    assert engine.warmup(X[:4], autotune=True) == 1
    assert set(engine.tuned) == engine.warmed == {4}
    with pytest.raises(ValueError, match="not fitted|fit the"):
        NonNeuralServeEngine(port_est.make_estimator("gnb", device="cpu"),
                             device="cpu")


def test_entry_points_raise_without_a_card(monkeypatch):
    """No card and no device named: every entry point raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y, _, _ = _data("knn", n=40)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        port_est.make_fitted("knn", X, y)
    est = port_est.make_fitted("knn", X, y, device="cpu")
    with pytest.raises(RuntimeError):
        NonNeuralServeEngine(est)
    with pytest.raises(RuntimeError):
        KNNServeEngine(est.params, k=4)
    with pytest.raises(RuntimeError):
        convert.params_from_numpy("knn", {"A": X, "labels": y,
                                          "n_class": 3})
    with pytest.raises(RuntimeError):
        tserve.main(["--algo", "gnb", "--requests", "8"])


@pytest.mark.parametrize("algo", ["knn", "kmeans", "gnb", "gmm", "rf"])
def test_serve_cli_on_cpu(algo):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--algo", algo, "--batch", "16", "--requests", "40",
         "--train-size", "200", "--dim", "70" if algo == "gnb" else "21"],
        capture_output=True, text=True, env=env, timeout=120, check=True)
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith(f"[serve] algo={algo} policy=fp32 device=cpu")
    assert "q/s" in line and "buckets={16: 2, 8: 1}" in line
    acc = float(line.rsplit("acc=", 1)[1])
    # K-Means and GMM serve cluster ids, which have no accuracy
    assert np.isnan(acc) if algo in ("kmeans", "gmm") else acc >= 0.95
