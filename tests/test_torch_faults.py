"""The port's repairs of the faults ROADMAP C lists against the reference.

C1: float64 numpy input.  The JAX package (x64 off) holds it as float32;
the port casts floating float64 input to float32 at the estimator and
engine boundary, so both packages fit and serve all six algorithms from
float64 arrays.  Classes compare exactly between the packages on the
well-separated blobs (the ROADMAP C bar), and the port's float64 run
equals its own float32 run exactly.

C4: B2 on a row holding NaN.  The port's rule is a real index, 0: a NaN
distance is never the nearest, and a row with no number distance takes
centroid 0 at distance +inf.  The Pallas B2 returns K there, an index out
of range; that is the reference's fault, left as it is.

C5: the serve CLI's defaults are the reference's.
"""
import numpy as np
import pytest
import torch

from repro.core import estimator as jest
from repro.launch import serve as jserve
from repro.serving.engine import NonNeuralServeEngine as JaxEngine
from repro_torch.core import estimator as port_est
from repro_torch.data.datasets import class_blobs
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.serving import NonNeuralServeEngine


@pytest.fixture(autouse=True)
def no_backend_env(monkeypatch):
    monkeypatch.delenv(tdispatch.ENV_VAR, raising=False)


# algorithm -> (d, groups, constructor kwargs); GNB at d = 70 takes its
# kernel arm, ANN at the sizes of tests/test_torch_ann.py
C1_CASES = {
    "knn": (21, 3, {}),
    "kmeans": (21, 4, {}),
    "gnb": (70, 3, {}),
    "gmm": (21, 3, {}),
    "rf": (21, 3, dict(n_trees=4, max_depth=4)),
    "ann": (13, 3, dict(n_cells=8, nprobe=3, pq_m=4, n_codes=16,
                        train_iters=25)),
}


@pytest.mark.parametrize("algo", sorted(C1_CASES))
def test_float64_input_fits_and_serves_as_in_jax(algo):
    d, groups, kw = C1_CASES[algo]
    X, y = class_blobs(n=240 + 13, d=d, n_class=groups, seed=3)
    X64, Q64 = X[:240].astype(np.float64), X[240:].astype(np.float64)
    y = y[:240]

    jfit = jest.make_fitted(algo, X64, y, n_groups=groups, **kw)
    jcls = np.asarray(jfit.predict_batch(Q64)[0])
    jserved = np.asarray(JaxEngine(jfit, max_batch=8).classify(Q64).classes)

    tfit = port_est.make_fitted(algo, X64, y, n_groups=groups,
                                device="cpu", **kw)
    tcls, taux = tfit.predict_batch(Q64)
    tserved = NonNeuralServeEngine(tfit, max_batch=8,
                                   device="cpu").classify(Q64)
    np.testing.assert_array_equal(tcls.numpy(), jcls)
    np.testing.assert_array_equal(tserved.classes.numpy(), jserved)

    # the cast is the float32 path: the same fit and answers as float32
    f32 = port_est.make_fitted(algo, X64.astype(np.float32), y,
                               n_groups=groups, device="cpu", **kw)
    cls32, aux32 = f32.predict_batch(Q64.astype(np.float32))
    assert torch.equal(tcls, cls32) and torch.equal(taux, aux32)
    assert all(leaf.dtype != torch.float64
               for leaf in tfit.params if isinstance(leaf, torch.Tensor))


def test_float64_tensor_queries_are_cast_at_the_engine():
    X, y = class_blobs(n=64 + 5, d=21, n_class=3, seed=1)
    est = port_est.make_fitted("knn", X[:64], y[:64], device="cpu")
    engine = NonNeuralServeEngine(est, max_batch=8, device="cpu")
    got = engine.classify(torch.from_numpy(X[64:].astype(np.float64)))
    want = engine.classify(torch.from_numpy(X[64:]))
    assert torch.equal(got.classes, want.classes)
    assert torch.equal(got.aux, want.aux)


# ------------------------------------------------------------------ C4

C4_CENTROIDS = [[0.0, 0.0], [1.0, 1.0], [2.0, 2.0]]


@pytest.mark.parametrize("fn", [tops.distance_argmin, tref.distance_argmin],
                         ids=["ops", "ref"])
def test_argmin_nan_row_takes_centroid_zero(fn):
    a = torch.tensor([[0.0, 0.0], [float("nan"), 1.0], [1.0, 1.0]])
    vals, ids = fn(a, torch.tensor(C4_CENTROIDS))
    assert ids.dtype == torch.int32 and ids.tolist() == [0, 0, 1]
    assert vals[0] == 0 and vals[2] == 0 and vals[1] == float("inf")


def test_argmin_random_nan_row_and_nan_centroid():
    """A random row with one NaN takes 0; a NaN centroid is never the
    nearest of a row whose other distances are numbers."""
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.normal(size=(9, 5)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(7, 5)).astype(np.float32))
    a[3, 2] = float("nan")
    c_nan = c.clone()
    c_nan[0, 1] = float("nan")
    vals, ids = tref.distance_argmin(a, c)
    want = tref.pairwise_sq_dist(a, c).argmin(1)
    keep = torch.arange(9) != 3
    assert ids[3] == 0 and vals[3] == float("inf")
    assert torch.equal(ids[keep], want[keep].int())
    vals_n, ids_n = tref.distance_argmin(a, c_nan)
    e = tref.pairwise_sq_dist(a, c_nan)[:, 1:]
    assert ids_n[3] == 0
    assert torch.equal(ids_n[keep], e[keep].argmin(1).int() + 1)
    assert bool(torch.isfinite(vals_n[keep]).all())


# ------------------------------------------------------------------ C5


def _defaults(module, monkeypatch):
    """The argparse namespace ``module.main([])`` builds, captured before
    anything is served."""
    seen = {}
    for name in ("serve_lm", "serve_nonneural", "serve_tenants"):
        if hasattr(module, name):
            monkeypatch.setattr(module, name,
                                lambda args: seen.setdefault("args", args))
    module.main([])
    return vars(seen["args"])


def test_serve_cli_defaults_match_the_reference(monkeypatch):
    port = _defaults(tserve, monkeypatch)
    jax = _defaults(jserve, monkeypatch)
    shared = sorted(set(port) & set(jax))
    assert {"algo", "batch", "arch", "prompt_len", "new_tokens"} <= \
        set(shared)
    assert {k: port[k] for k in shared} == {k: jax[k] for k in shared}
    assert port["algo"] == "lm" and port["batch"] == 4
