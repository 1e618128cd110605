"""IVF-PQ approximate kNN in the PyTorch port against the JAX package.

B8 ``adc_topk`` through its plain version (CPU tensors) against the JAX
package's Pallas kernel in interpret mode and its oracle, the query LUTs,
the IVF-PQ fit, ``ANNKNNEstimator`` on carried-across params, and the
estimator's contracts.  Everything compared is integer (LUTs, ADC
distances, positions, cell lists, codes, neighbour ids, classes) and
compares exactly; fitted centroids and codebooks compare to 1e-5.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ann as jann
from repro.core import estimator as jest
from repro.kernels import ann as jak
from repro.kernels import dispatch as jdispatch
from repro_torch import convert
from repro_torch.core import ann as tann
from repro_torch.core import estimator as port_est
from repro_torch.kernels import ann as tak
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import topk_select as tts
from repro_torch.serving import NonNeuralServeEngine

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def no_backend_env(monkeypatch):
    monkeypatch.delenv(tdispatch.ENV_VAR, raising=False)


def _problem(n=300, d=13, n_class=3, seed=0):
    """Well-separated blobs, one row of each class first."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_class, d)) * 3.0
    y = rng.integers(0, n_class, size=n).astype(np.int32)
    y[:n_class] = np.arange(n_class)
    X = (centers[y] + rng.normal(size=(n, d))).astype(np.float32)
    return X, y


def _adc_case(seed, Q=5, L=37, m=4, n_codes=16, lut_hi=256, id_hi=50):
    rng = np.random.default_rng(seed)
    qlut = rng.integers(0, lut_hi, size=(Q, m * n_codes)).astype(np.int32)
    codes = (rng.integers(0, n_codes, size=(Q, L, m)) - 128).astype(np.int8)
    ids = rng.integers(-1, id_hi, size=(Q, L)).astype(np.int32)
    return qlut, codes, ids


def _both(qlut, codes, ids, k):
    jv, jp = jak.adc_topk(jnp.asarray(qlut), jnp.asarray(codes),
                          jnp.asarray(ids), k)
    ov, op = jak.ref_adc_topk(jnp.asarray(qlut), jnp.asarray(codes),
                              jnp.asarray(ids), k)
    tv, tp = tops.adc_topk(*[torch.from_numpy(a) for a in (qlut, codes,
                                                           ids)], k)
    assert tv.dtype == torch.int32 and tp.dtype == torch.int32
    for want_v, want_p in ((jv, jp), (ov, op)):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(want_p))
    return tv, tp


# ------------------------------------------------------------------ B8


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("k", [1, 10, 37])
def test_adc_topk_matches_jax(seed, k):
    _both(*_adc_case(seed), k)


def test_adc_topk_ties_across_candidate_blocks():
    """A constant LUT ties every candidate: the k smallest positions, past
    the reference's 8-candidate blocks."""
    Q, L, m, n_codes, k = 3, 43, 4, 8, 19
    qlut = np.full((Q, m * n_codes), 7, np.int32)
    codes = np.full((Q, L, m), -128, np.int8)        # code 0
    ids = np.zeros((Q, L), np.int32)
    _, pos = _both(qlut, codes, ids, k)
    assert pos[0].tolist() == list(range(k))


def test_adc_topk_heavy_ties_and_ragged_lists():
    qlut, codes, ids = _adc_case(3, lut_hi=3)
    _both(qlut, codes, ids, 8)
    # ragged inverted lists: the -1 tail of every list takes the sentinel
    qlut, codes, ids = _adc_case(4, L=40)
    ids[:, 25:] = -1
    _both(qlut, codes, ids, 30)


def test_adc_topk_short_list_tail_is_the_sentinel():
    """A query whose probed cells hold fewer than k members: its tail is
    adc_dmax(m) at the smallest invalid positions, as in the oracle."""
    qlut, codes, ids = _adc_case(5, Q=3, L=20)
    ids[0, :] = -1                      # no member at all
    ids[1, 3:] = -1                     # three members
    vals, pos = _both(qlut, codes, ids, 6)
    dmax = tak.adc_dmax(4)
    assert vals[0].tolist() == [dmax] * 6 and pos[0].tolist() == list(
        range(6))
    assert vals[1, 3:].tolist() == [dmax] * 3
    assert pos[1, 3:].tolist() == [3, 4, 5]


def test_adc_topk_holds_codes_past_the_table():
    """A code past n_codes - 1 (no valid fit makes one) reads the last
    entry of its own subspace, the rule the CUDA kernel keeps too."""
    qlut, codes, ids = _adc_case(6, n_codes=16)
    wild = (np.random.default_rng(7).integers(0, 256, size=codes.shape)
            - 128).astype(np.int8)
    held = (np.minimum(wild.astype(np.int64) + 128, 15) - 128).astype(np.int8)
    args = [torch.from_numpy(a) for a in (qlut, wild, ids)]
    want = tref.adc_topk(torch.from_numpy(qlut), torch.from_numpy(held),
                         torch.from_numpy(ids), 9)
    got = tops.adc_topk(*args, 9)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_adc_constants_match_jax():
    for m in (1, 4, 21, 256):
        assert tak.adc_dmax(m) == jak.adc_dmax(m)
        assert tak.packed_cols_limit(m) == jak.packed_cols_limit(m)


def test_adc_wrapper_validates_inputs():
    qlut, codes, ids = (torch.from_numpy(a) for a in _adc_case(0))
    with pytest.raises(ValueError):
        tops.adc_topk(qlut, codes, ids, 38)            # k > L
    with pytest.raises(TypeError):
        tops.adc_topk(qlut, codes.to(torch.int32), ids, 2)
    with pytest.raises(ValueError):
        tops.adc_topk(qlut[:, :-1], codes, ids, 2)      # not m * n_codes
    with pytest.raises(ValueError):
        tops.adc_topk(qlut, codes, ids[:, :-1], 2)


def test_adc_wrapper_on_device_tensors_launches(monkeypatch):
    """The CUDA branch, driven on the CPU, at a k past the fused list
    (``ann.FUSED_K_MAX`` lowered to 8 here, so k = 9 takes the matrix
    route): B8 writes the distances of each query chunk and B5's int32
    mode selects; the answer is the plain version's and no plain version
    of the whole op runs.  (The fused route: tests/test_torch_argmin_adc.
    py.)"""
    calls = []

    def dist(qlut, codes, ids):
        calls.append(("adc", codes.dtype, ids.dtype))
        Q, L, m = codes.shape
        col = codes.long() + 128 + torch.arange(m) * (qlut.shape[1] // m)
        e = torch.gather(qlut, 1, col.reshape(Q, L * m)).reshape(Q, L, m)
        return torch.where(ids < 0, tak.adc_dmax(m),
                           e.sum(2).to(torch.int32))

    def select(x, k):
        calls.append(("select", x.dtype, None))
        return tref.topk_smallest(x, k)

    def boom(*_):
        raise AssertionError("a device tensor reached a plain version")

    monkeypatch.setattr(tak, "launch_dist", dist)
    monkeypatch.setattr(tak, "FUSED_K_MAX", 8)
    monkeypatch.setattr(tts, "launch", select)
    monkeypatch.setattr(tdispatch, "BLOCKED_BYTES", 4 * 37 * 2)
    qlut, codes, ids = (torch.from_numpy(a) for a in _adc_case(1))
    want = tref.adc_topk(qlut, codes, ids, 9)
    monkeypatch.setattr(tref, "adc_topk", boom)
    real_check = tops._check
    monkeypatch.setattr(tops, "_check", lambda op, **kw: (
        real_check(op, **kw), torch.device("cuda"))[1])
    tops.reset_launches()
    got = tops.adc_topk(qlut, codes, ids, 9)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # 5 queries in chunks of 2: three launches of each
    assert tops.LAUNCHES["adc_topk"] == 3
    assert tops.LAUNCHES["topk_smallest"] == 3
    assert [c[0] for c in calls] == ["adc", "select"] * 3
    assert all(c[1] in (torch.int8, torch.int32) for c in calls)


def test_adc_dispatch_arms_and_selector():
    assert tdispatch.registered()[("ann", "adc_topk")] == ("fused", "ref")
    qlut, codes, ids = (torch.from_numpy(a) for a in _adc_case(2))
    f = tdispatch.adc_topk(qlut, codes, ids, 5)
    r = tdispatch.adc_topk(qlut, codes, ids, 5, path="ref")
    assert torch.equal(f[0], r[0]) and torch.equal(f[1], r[1])
    # with a card every shape takes B8, even a LUT past shared memory
    for kw in (dict(Q=1024, L=32768, m=21, n_codes=256, k=128),
               dict(Q=4096, L=8, m=256, n_codes=256, k=1)):
        assert tdispatch.resolve("ann", "adc_topk", **kw).name == "fused"
    s = {"C": 16, "d": 21, "m": 21, "n_codes": 256, "L": 4096, "k": 10,
         "R": 128}
    assert tdispatch.hot_shape_kw("ann", s, 64) == \
        jdispatch.hot_shape_kw("ann", s, 64)
    assert tdispatch.HOT_OPS == jdispatch.HOT_OPS


# ------------------------------------------------------ LUTs and the fit


@pytest.mark.parametrize("d,m,n_codes", [(13, 4, 16), (21, 21, 32),
                                         (21, 7, 16), (8, 3, 5)])
def test_build_query_luts_match_jax(d, m, n_codes):
    rng = np.random.default_rng(d + m)
    X = rng.normal(size=(9, d)).astype(np.float32) * 3
    dsub = -(-d // m)
    books = rng.normal(size=(m, n_codes, dsub)).astype(np.float32) * 3
    want = np.asarray(jann.build_query_luts(jnp.asarray(X),
                                            jnp.asarray(books)))
    got = tann.build_query_luts(torch.from_numpy(X), torch.from_numpy(books))
    assert got.dtype == torch.int32 and got.shape == (9, m * n_codes)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def fitted():
    """One JAX fit and one port fit of the same blobs."""
    X, y = _problem(n=300, d=13, n_class=3, seed=0)
    kw = dict(n_cells=8, nprobe=3, pq_m=4, n_codes=16, train_iters=25)
    j = jest.make_fitted("ann", X, y, n_groups=3, **kw)
    t = port_est.make_fitted("ann", X, y, n_groups=3, device="cpu", **kw)
    return X, y, j, t


def test_fit_ivf_pq_matches_jax(fitted):
    X, y, j, t = fitted
    jp, tp = j.params, t.params
    np.testing.assert_array_equal(tp.cell_ids.numpy(),
                                  np.asarray(jp.cell_ids))
    np.testing.assert_array_equal(tp.codes.numpy(), np.asarray(jp.codes))
    assert tp.codes.dtype == torch.int8 and tp.cell_ids.dtype == torch.int32
    np.testing.assert_allclose(tp.centroids.numpy(),
                               np.asarray(jp.centroids), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tp.codebooks.numpy(),
                               np.asarray(jp.codebooks), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tp.refs.numpy(), np.asarray(jp.refs))
    np.testing.assert_array_equal(tp.labels.numpy(), np.asarray(jp.labels))
    assert tp.n_class == jp.n_class
    assert t.serve_cost_shape() == j.serve_cost_shape()


@pytest.mark.parametrize("refine", [0, 16])
@pytest.mark.parametrize("nprobe", [1, 3, 8])
def test_carried_params_predict_like_jax(fitted, refine, nprobe):
    X, y, j, _ = fitted
    Q = _problem(n=40, d=13, n_class=3, seed=1)[0]
    jest_q = jest.ANNKNNEstimator(k=5, nprobe=nprobe, refine=refine)
    jest_q._params = j.params
    jcls, jnbr = jest_q.predict_batch(jnp.asarray(Q))
    tp = convert.params_from_numpy("ann", j.params, device="cpu")
    est = port_est.ANNKNNEstimator.from_params(tp, k=5, nprobe=nprobe,
                                               refine=refine, device="cpu")
    cls, nbr = est.predict_batch(Q)
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(jnbr))
    np.testing.assert_array_equal(cls.numpy(), np.asarray(jcls))
    # the plain arms give the same answer
    ref_est = port_est.ANNKNNEstimator.from_params(
        tp, k=5, nprobe=nprobe, refine=refine, device="cpu", path="ref")
    rcls, rnbr = ref_est.predict_batch(Q)
    assert torch.equal(rnbr, nbr) and torch.equal(rcls, cls)


def test_short_probe_gives_minus_one_ids():
    """A tiny index where the probed cells hold fewer than k members:
    the missing neighbours are -1, as in the reference."""
    X, y = _problem(n=40, d=5, n_class=2, seed=3)
    kw = dict(k=30, n_cells=4, nprobe=1, pq_m=5, n_codes=8)
    j = jest.make_fitted("ann", X, y, n_groups=2, **kw)
    Q = X[:6]
    jcls, jnbr = j.predict_batch(jnp.asarray(Q))
    tp = convert.params_from_numpy("ann", j.params, device="cpu")
    est = port_est.ANNKNNEstimator.from_params(tp, device="cpu", **{
        a: kw[a] for a in ("k", "nprobe")})
    cls, nbr = est.predict_batch(Q)
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(jnbr))
    np.testing.assert_array_equal(cls.numpy(), np.asarray(jcls))
    assert (nbr < 0).any()


# -------------------------------------------------- estimator contracts


def test_ann_refuses_int8_with_the_reference_message():
    with pytest.raises(NotImplementedError) as port_err:
        port_est.make_estimator("ann", device="cpu",
                                policy=tdispatch.get_policy("int8"))
    with pytest.raises(NotImplementedError) as jax_err:
        jest.make_estimator("ann", policy=jdispatch.get_policy("int8"))
    assert str(port_err.value) == str(jax_err.value)


def test_ann_estimator_contracts(fitted):
    X, y, _, t = fitted
    assert isinstance(port_est.make_estimator("ann", device="cpu"),
                      port_est.ANNKNNEstimator)
    assert t.n_class == 3 and t.params.n_class == 3
    aux = t.empty_aux()
    assert aux.dtype == torch.int32 and tuple(aux.shape) == (0, 4)
    cls, nbr = t.predict(X[0])
    assert nbr.shape == (4,) and int(cls) == int(y[0])
    with pytest.raises(ValueError, match="supervised"):
        port_est.make_estimator("ann", device="cpu").fit(X)


def test_ann_engine_buckets_stay_warm(fitted):
    X, y, _, t = fitted
    engine = NonNeuralServeEngine(t, max_batch=16, device="cpu")
    assert engine.warmup_buckets(X.shape[1]) == 5
    res = engine.classify(X[:37])
    assert set(engine.bucket_launches) <= engine.warmed
    assert res.classes.shape == (37,) and res.aux.shape == (37, 4)
    acc = float((res.classes.numpy() == y[:37]).mean())
    assert acc >= 0.95
    empty = engine.classify(X[:0])
    assert tuple(empty.aux.shape) == (0, 4)


def test_ann_serve_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--algo", "ann", "--nprobe", "4", "--refine", "16", "--pq-m", "7",
         "--batch", "16", "--requests", "40", "--train-size", "300"],
        capture_output=True, text=True, env=env, timeout=120, check=True)
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("[serve] algo=ann policy=fp32 device=cpu")
    assert float(line.rsplit("acc=", 1)[1]) >= 0.95
