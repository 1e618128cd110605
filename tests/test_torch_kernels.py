"""Parity of the PyTorch port's kernel functions with the JAX package.

B1 ``distance_topk``, B2 ``distance_argmin`` and B3 ``gnb_scores_batch``:
the same numpy inputs go through ``repro.kernels.ops`` (the Pallas kernels,
in interpret mode on the CPU), ``repro.kernels.ref`` (the jnp oracles) and
``repro_torch.kernels.ops`` on CPU tensors, which run the kernels' plain
PyTorch versions.  Tolerances: indices exact; fp32 values
``rtol = atol = 1e-5`` (the packages sum the distance expansion and the
GNB terms in different orders).  On a card the wrappers launch the CUDA
kernels instead; ``chip_smoke.py`` holds those against the plain versions
there.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distribution as jdist
from repro.core import topk as jtopk
from repro.kernels import gnb_score as jgnb_kernel
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import distribution as tdist
from repro_torch.core import topk as ttopk
from repro_torch.kernels import distance_argmin as tda
from repro_torch.kernels import distance_topk as tdt
from repro_torch.kernels import gnb_score as tgs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = dict(rtol=1e-5, atol=1e-5)


def _points(seed, n, d, dup=False):
    """(n, d) float32.  ``dup``: small integer rows drawn with repetition,
    so distances are exact small integers and equal rows tie exactly."""
    rng = np.random.default_rng(seed)
    if dup:
        base = rng.integers(-2, 3, size=(max(1, n // 3), d))
        return base[rng.integers(0, len(base), size=n)].astype(np.float32)
    return rng.normal(size=(n, d)).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ------------------------------------------------------------------ B1


@pytest.mark.parametrize("N,d,Q,k,dup,dtype", [
    (999, 21, 5, 4, False, "float32"),     # ragged N at the asd_like width
    (37, 5, 3, 1, False, "float32"),       # ragged N, k = 1
    (37, 5, 1, 8, False, "float32"),       # one query
    (64, 8, 3, 8, True, "float32"),        # duplicated rows: exact ties
    (101, 3, 4, tops.TOPK_K_MAX, True, "float32"),   # k at the limit
    (999, 21, 5, 4, False, "bfloat16"),    # upcast before the arithmetic
])
def test_distance_topk_matches_jax(N, d, Q, k, dup, dtype):
    a = _points(10 + N, N, d, dup)
    c = _points(20 + Q, Q, d, dup)
    ja, jc = jnp.asarray(a, dtype), jnp.asarray(c, dtype)
    jv, ji = (np.asarray(x) for x in jops.distance_topk(ja, jc, k))
    rv, ri = (np.asarray(x) for x in jref.distance_topk(ja, jc, k))
    ta, tc = (t.to(getattr(torch, dtype)) for t in _t(a, c))
    tv, ti = tops.distance_topk(ta, tc, k)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    assert tuple(ti.shape) == (Q, k)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(ti.numpy(), ri)
    np.testing.assert_allclose(tv.numpy(), jv, **TOL)
    np.testing.assert_allclose(tv.numpy(), rv, **TOL)
    if dup:   # ties resolved to the smallest row, rank by rank
        vals, idx = tv.numpy(), ti.numpy()
        tied = vals[:, 1:] == vals[:, :-1]
        assert tied.any()
        assert (idx[:, 1:][tied] > idx[:, :-1][tied]).all()


# ------------------------------------------------------------------ B2


@pytest.mark.parametrize("N,d,K,dup", [
    (999, 21, 7, False),
    (37, 5, 1, False),       # K = 1
    (50, 4, 9, True),        # duplicated centroids: first index wins
])
def test_distance_argmin_matches_jax(N, d, K, dup):
    a = _points(30 + N, N, d, dup)
    c = _points(40 + K, K, d, dup)
    if dup:
        c[K // 2:] = c[: K - K // 2]      # every centroid repeated later
    jv, ji = (np.asarray(x) for x in jops.distance_argmin(jnp.asarray(a),
                                                          jnp.asarray(c)))
    rv, ri = (np.asarray(x) for x in jref.distance_argmin(jnp.asarray(a),
                                                          jnp.asarray(c)))
    tv, ti = tops.distance_argmin(*_t(a, c))
    assert tv.shape == (N,) and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(ti.numpy(), ri)
    np.testing.assert_allclose(tv.numpy(), jv, **TOL)
    np.testing.assert_allclose(tv.numpy(), rv, **TOL)
    if dup:
        assert (ti.numpy() < K - K // 2).all()


# ------------------------------------------------------------------ B3


def _gnb_inputs(seed, B, d, C):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, d)).astype(np.float32)
    mu = rng.normal(size=(C, d)).astype(np.float32)
    var = (rng.random((C, d)) + 0.25).astype(np.float32)
    log_prior = np.log(rng.dirichlet(np.ones(C))).astype(np.float32)
    return X, mu, var, log_prior


@pytest.mark.parametrize("B,d,C", [
    (5, 70, 3),      # d pads to the JAX kernel's feature chunk
    (8, 128, 4),     # whole chunks
    (3, 1, 2),       # one feature
    (1, 21, 10),     # one query
])
def test_gnb_scores_batch_matches_jax(B, d, C):
    args = _gnb_inputs(B * d + C, B, d, C)
    js = np.asarray(jops.gnb_scores_batch(*map(jnp.asarray, args)))
    rs = np.asarray(jref.gnb_scores_batch(*map(jnp.asarray, args)))
    ts = tops.gnb_scores_batch(*_t(*args))
    assert ts.shape == (B, C) and ts.dtype == torch.float32
    np.testing.assert_allclose(ts.numpy(), js, **TOL)
    np.testing.assert_allclose(ts.numpy(), rs, **TOL)
    np.testing.assert_array_equal(ts.numpy().argmax(1), js.argmax(1))


def test_gnb_d_padding_correction():
    """The JAX wrapper pads d to its feature chunk (x = mu = 0, var = 1)
    and adds ½·log 2π back per padded feature; the port masks the edge
    and has no correction.  The raw padded Pallas call sits exactly that
    constant below both."""
    B, d, C = 5, 70, 3
    X, mu, var, lp = _gnb_inputs(7, B, d, C)
    bd = jops.clamp_block(128, d)
    n_pad = (-d) % bd
    assert n_pad > 0
    Xp = np.pad(X, ((0, (-B) % 8), (0, n_pad)))
    mup = np.pad(mu, ((0, 0), (0, n_pad)))
    varp = np.pad(var, ((0, 0), (0, n_pad)), constant_values=1.0)
    raw = np.asarray(jgnb_kernel.gnb_scores_batch(
        *map(jnp.asarray, (Xp, mup, varp, lp)), bb=8, bd=bd,
        interpret=True))[:B]
    ts = tops.gnb_scores_batch(*_t(X, mu, var, lp)).numpy()
    corr = 0.5 * math.log(2.0 * math.pi) * n_pad
    np.testing.assert_allclose(raw + corr, ts, **TOL)
    assert not np.allclose(raw, ts, **TOL)
    js = np.asarray(jops.gnb_scores_batch(*map(jnp.asarray,
                                               (X, mu, var, lp))))
    np.testing.assert_allclose(ts, js, **TOL)


# ------------------------------------------------ top-k and chunk helpers


def test_stable_topk_matches_lax_top_k_on_ties():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 4, size=(6, 50)).astype(np.float32)
    for k in (1, 5, 50):
        jv, ji = (np.asarray(v) for v in jref.topk_smallest(jnp.asarray(x),
                                                            k))
        tv, ti = ttopk.topk_smallest_stable(torch.from_numpy(x), k)
        assert ti.dtype == torch.int32
        np.testing.assert_array_equal(ti.numpy(), ji)
        np.testing.assert_array_equal(tv.numpy(), jv)


@pytest.mark.parametrize("k", [1, 4, 9])
def test_selection_topk_matches_jax(k):
    x = np.random.default_rng(k).integers(0, 5, size=40).astype(np.float32)
    jv, ji = (np.asarray(v) for v in jtopk.selection_topk_smallest(
        jnp.asarray(x), k))
    tv, ti = ttopk.selection_topk_smallest(torch.from_numpy(x), k)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(tv.numpy(), jv)


@pytest.mark.parametrize("shape,axis,value", [
    ((13, 3), 0, 0.0), ((4, 13), 1, 1.0), ((16, 2), 0, 0.0), ((5,), 0, -1.0),
])
def test_chunk_helpers_match_jax(shape, axis, value):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    jp, jn = jdist.pad_to_multiple(jnp.asarray(x), 8, axis=axis, value=value)
    tp, tn = tdist.pad_to_multiple(torch.from_numpy(x), 8, axis=axis,
                                   value=value)
    assert tn == jn
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(
        tdist.split_chunks(tp, 8, axis=axis).numpy(),
        np.asarray(jdist.split_chunks(jp, 8, axis=axis)))
    if shape[axis] % 8:
        with pytest.raises(ValueError):
            tdist.split_chunks(torch.from_numpy(x), 8, axis=axis)


# ------------------------------------------------------ wrapper contract


def test_wrappers_validate_inputs():
    a, c = _t(_points(0, 20, 4), _points(1, 3, 4))
    with pytest.raises(ValueError, match="blocked"):
        tops.distance_topk(a, c, tops.TOPK_K_MAX + 1)
    with pytest.raises(ValueError):
        tops.distance_topk(a[:5], c, 6)                  # k > N
    with pytest.raises(TypeError):
        tops.distance_topk(a.to(torch.int32), c, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tops.distance_argmin(a.t(), c.t())
    with pytest.raises(ValueError):
        tops.distance_argmin(a, c[:, :3])
    X, mu, var, lp = _t(*_gnb_inputs(0, 2, 4, 3))
    with pytest.raises(ValueError):
        tops.gnb_scores_batch(X, mu, var[:2], lp)
    with pytest.raises(ValueError):
        tops.gnb_scores_batch(X, mu, var, lp[None])


def test_cpu_tensors_run_plain_and_count_no_launch(monkeypatch):
    def boom(*_):
        raise AssertionError("a CPU tensor reached a kernel launcher")

    monkeypatch.setattr(tdt, "launch_topk", boom)
    monkeypatch.setattr(tda, "launch", boom)
    monkeypatch.setattr(tgs, "launch_scores_batch", boom)
    tops.reset_launches()
    a, c = _t(_points(0, 30, 4), _points(1, 3, 4))
    tops.distance_topk(a, c, 2)
    tops.distance_argmin(a, c)
    tops.gnb_scores_batch(*_t(*_gnb_inputs(0, 2, 4, 3)))
    assert set(tops.LAUNCHES.values()) == {0}


def test_device_tensors_launch_and_never_reach_plain(monkeypatch):
    """The branch a CUDA tensor takes, driven on the CPU by presenting
    the inputs as device tensors: the launcher runs, the count grows by
    one per call, bf16 arrives upcast, and the plain version is never
    called."""
    def boom(*_):
        raise AssertionError("a device tensor reached a plain version")

    calls = []

    def launcher(name):
        def fn(*args):
            calls.append((name, [a.dtype for a in args
                                 if isinstance(a, torch.Tensor)]))
            return "launched"
        return fn

    for name in ("distance_topk", "distance_argmin", "gnb_scores_batch"):
        monkeypatch.setattr(tref, name, boom)
    monkeypatch.setattr(tdt, "launch_topk", launcher("topk"))
    monkeypatch.setattr(tda, "launch", launcher("argmin"))
    monkeypatch.setattr(tgs, "launch_scores_batch", launcher("gnb"))
    real_check = tops._check
    monkeypatch.setattr(tops, "_check", lambda op, **kw: (
        real_check(op, **kw), torch.device("cuda"))[1])
    tops.reset_launches()
    a, c = _t(_points(0, 30, 4), _points(1, 3, 4))
    assert tops.distance_topk(a.bfloat16(), c, 2) == "launched"
    assert tops.distance_argmin(a, c) == "launched"
    assert tops.gnb_scores_batch(*_t(*_gnb_inputs(0, 2, 4, 3))) == "launched"
    assert tops.LAUNCHES == {"distance_topk": 1, "distance_argmin": 1,
                             "gnb_scores_batch": 1, "pairwise_sq_dist": 0,
                             "topk_smallest": 0, "gnb_scores": 0,
                             "distance_topk_q8": 0, "distance_argmin_q8": 0,
                             "adc_topk": 0, "matmul": 0,
                             "flash_attention": 0, "flash_attention_bwd": 0}
    assert [n for n, _ in calls] == ["topk", "argmin", "gnb"]
    assert all(dt == torch.float32 for _, dts in calls for dt in dts)


def test_split_rows_covers_every_row():
    for N, Q, sms in ((1, 1, 132), (1 << 20, 1024, 132), (1000, 3, 132),
                      (64 * 17 + 5, 40, 8), (256, 1024, 132),
                      (32, 5000, 132), (33, 1, 1)):
        n_splits, rows = tdt.split_rows(N, Q, sms)
        assert rows % tdt.SPLIT_ROWS == 0 and n_splits * rows >= N
        assert (n_splits - 1) * rows < N        # no empty split


@pytest.mark.parametrize("N,Q,sms,want", [
    (1 << 20, 1024, 132, (33, 31776)),    # kNN: 8 query tiles x 33 splits
    (256, 1024, 132, (8, 32)),            # the ANN probe: 32-row splits
    (1 << 20, 100, 132, (263, 4000)),     # one query tile
    (1 << 20, 4096, 132, (9, 116512)),    # 32 query tiles
])
def test_split_rows_fills_the_card(N, Q, sms, want):
    """About ``BLOCKS_PER_SM`` blocks an SM (splits x query tiles of 128),
    in multiples of 32 rows."""
    assert tdt.split_rows(N, Q, sms) == want


def test_route_follows_the_alignment_rule():
    """``bulk`` needs a 16-byte-aligned base and d <= the route's width;
    a view such as ``A[1:]`` (84 bytes in at d = 21) takes ``plain``, a
    view whose offset is a multiple of 16 bytes keeps ``bulk``."""
    a = torch.zeros((64, 21))
    assert a.data_ptr() % 16 == 0
    assert tdt.route(a) == "bulk"
    assert tdt.route(a[1:]) == "plain"
    assert tdt.route(a[4:]) == "bulk"                # 336 bytes in
    assert tdt.route(torch.zeros((8, tdt.BULK_MAX_D))) == "bulk"
    assert tdt.route(torch.zeros((8, tdt.BULK_MAX_D + 1))) == "plain"
    assert tdt.route(torch.zeros((8, 784))) == "plain"


def _fake_launch(monkeypatch, mod, sms=132):
    """Run a launcher on CPU tensors: record the C function's arguments
    and the shapes the launcher allocates, launch nothing."""
    calls, shapes = [], []
    real_empty = torch.empty

    def empty(shape, **kw):
        shapes.append(tuple(shape))
        return real_empty(shape, **kw)

    monkeypatch.setattr(mod, "_fn", lambda name, argtypes: (
        lambda *args: calls.append((name, args)) or 0))
    monkeypatch.setattr(mod, "sm_count", lambda device: sms)
    monkeypatch.setattr(mod, "_stream", lambda: 0)
    monkeypatch.setattr(torch, "empty", empty)
    return calls, shapes


@pytest.mark.parametrize("N,d,Q,k,view,route", [
    (5000, 21, 1024, 4, False, "bulk"),     # kNN width, one full bucket
    (256, 21, 1024, 16, False, "bulk"),     # the ANN probe shape
    (5000, 21, 37, 4, True, "plain"),       # A[1:]: base off 16 bytes
    (300, 40, 5, 32, False, "plain"),       # d past the bulk route
])
def test_launch_topk_arguments(monkeypatch, N, d, Q, k, view, route):
    """B1's launcher hands the C function the planned splits, the route
    flag and one list of k per (query, split) as scratch, and counts the
    launch under its route."""
    calls, shapes = _fake_launch(monkeypatch, tdt)
    a = torch.zeros((N + 1, d))[1:] if view else torch.zeros((N, d))
    c = torch.zeros((Q, d))
    tops.reset_launches()
    vals, idx = tdt.launch_topk(a, c, k)
    n_splits, rows = tdt.split_rows(N, Q, 132)
    (name, args), = calls
    assert name == "distance_topk_f32"
    assert args[0] == a.data_ptr() and args[1] == c.data_ptr()
    assert args[6:13] == (N, Q, d, k, n_splits, rows, int(route == "bulk"))
    assert shapes == [(Q, n_splits * k)] * 2 + [(Q, k)] * 2
    assert vals.shape == idx.shape == (Q, k)
    assert tdt.ROUTE_LAUNCHES == {"bulk": int(route == "bulk"),
                                  "plain": int(route == "plain")}
    tops.reset_launches()
    assert tdt.ROUTE_LAUNCHES == {"bulk": 0, "plain": 0}


def test_nonfinite_queries_rank_nan_last():
    """The rule B1 keeps on the card: a NaN distance ranks after every
    number, equal values (NaN too) go to the smaller row, and every index
    is a real row."""
    a = torch.tensor([[0.0, 1.0], [-1.0, 2.0], [1.0, 0.0], [-2.0, 0.0]])
    c = torch.tensor([[float("nan"), 0.0], [float("inf"), 0.0], [0.0, 0.0]])
    vals, idx = tops.distance_topk(a, c, 3)
    assert idx.tolist() == [[0, 1, 2], [1, 3, 0], [0, 2, 3]]
    assert vals[0].isnan().all() and vals[1, :2].isinf().all()
    assert vals[1, 2].isnan()
