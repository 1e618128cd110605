"""B2 ``distance_argmin`` and B8 ``adc_topk`` as redesigned for Hopper: their
routes, plans and launch arguments, and their parity with the JAX
package at the new designs' edge shapes.

The CUDA kernels run only on the card (``chip_smoke.py``); here each
launcher runs on CPU tensors with its C function replaced by a recorder,
so the route it takes, the grid or split plan, the scratch it allocates
and the arguments it would hand the kernel are checked.  Parity: the
same numpy inputs go through ``repro.kernels.ops`` (the Pallas kernels,
in interpret mode on the CPU), ``repro.kernels.ref`` and
``repro_torch.kernels.ops`` on CPU tensors (the plain versions); indices
and every B8 output exact, B2's values to 1e-5.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ann as jak
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ann as tak
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import distance_argmin as tda
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = dict(rtol=1e-5, atol=1e-5)
CSRC = Path(tda.__file__).resolve().parent / "csrc"


@pytest.fixture(autouse=True)
def no_backend_env(monkeypatch):
    monkeypatch.delenv(tdispatch.ENV_VAR, raising=False)


def _recorder(monkeypatch, mod, bind, sms=132):
    """Run ``mod``'s launcher on CPU tensors: record the C function's
    arguments and the shapes the launcher allocates, launch nothing."""
    calls, shapes = [], []
    real_empty = torch.empty

    def empty(shape, **kw):
        shapes.append(tuple(shape))
        return real_empty(shape, **kw)

    def fn(*names):
        return lambda *args: calls.append((names, args)) or 0

    monkeypatch.setattr(mod, bind, fn)
    monkeypatch.setattr(mod, "sm_count", lambda device: sms)
    monkeypatch.setattr(mod, "_stream", lambda: 0)
    monkeypatch.setattr(torch, "empty", empty)
    return calls, shapes


# ------------------------------------------------------------------ B2


@pytest.mark.parametrize("K,d,want", [
    (256, 21, True),     # the K-Means fit and the ANN coarse fit
    (256, 1, True),      # the PQ codebooks
    (1, 111, True),      # one tile of 128 centroids, 112 floats each
    (1, 112, False),
    (1000, 21, False),
    (257, 784, False),
])
def test_argmin_resident_limit(K, d, want):
    """Every 128-centroid tile, transposed, with its norms, within
    ``RESIDENT_MAX`` bytes."""
    assert tda.resident(K, d) is want


@pytest.mark.parametrize("N,d,K,view,want", [
    (262144, 21, 256, False, "bulk"),    # the K-Means fit shape
    (65536, 1, 256, False, "rows"),      # a PQ codebook fit
    (262144, 4, 256, True, "rows"),
    (1024, 5, 256, False, "narrow"),
    (4096, 32, 256, False, "bulk"),
    (4096, 33, 255, False, "plain"),     # past the bulk width
    (4096, 21, 256, True, "plain"),      # A[1:], 84 bytes in
    (1024, 21, 256, False, "narrow"),    # a K-Means serving bucket
    (2048, 21, 256, True, "narrow"),
    (2049, 21, 256, False, "bulk"),
    (1, 21, 257, False, "narrow"),
    (1024, 21, 1000, False, "stream"),   # the centroids do not stay
    (70001, 784, 257, False, "stream"),
])
def test_argmin_route(N, d, K, view, want):
    a = torch.zeros((N + 1, d))[1:] if view else torch.zeros((N, d))
    assert tda.route(a, torch.zeros((K, d))) == want


@pytest.mark.parametrize("N,way,want", [
    (262144, "bulk", 264),     # 2048 row tiles: two persistent blocks an SM
    (65536, "bulk", 264),
    (4099, "bulk", 33),        # at most one block a tile
    (1024, "narrow", 128),     # eight rows a block
    (129, "narrow", 17),
    (1, "narrow", 1),
    (5000, "stream", 40),
    (65536, "rows", 512),      # 128 rows a block
    (262144, "rows", 2048),
    (1, "rows", 1),
])
def test_argmin_plan(N, way, want):
    assert tda.plan(N, 256, 132, way) == want


@pytest.mark.parametrize("N,d,K,view", [
    (262144, 21, 256, False),    # bulk
    (1024, 21, 256, False),      # narrow
    (5000, 21, 256, True),       # plain
    (300, 784, 257, False),      # stream
    (65536, 1, 256, False),      # rows
])
def test_argmin_launch_arguments(monkeypatch, N, d, K, view):
    calls, shapes = _recorder(monkeypatch, tda, "_fn")
    a = torch.zeros((N + 1, d))[1:] if view else torch.zeros((N, d))
    c = torch.zeros((K, d))
    tops.reset_launches()
    vals, idx = tda.launch(a, c)
    way = tda.route(a, c)
    (names, args), = calls
    assert names == ()
    assert args[:4] == (a.data_ptr(), c.data_ptr(), vals.data_ptr(),
                        idx.data_ptr())
    assert args[4:] == (N, K, d, tda.ROUTES.index(way),
                        tda.plan(N, K, 132, way), 0)
    assert shapes == [(N,), (N,)]
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    assert tda.ROUTE_LAUNCHES == {r: int(r == way) for r in tda.ROUTES}


@pytest.mark.parametrize("N,d,K,dup", [
    (300, 1, 255, False),      # d = 1: the PQ codebook fits
    (70, 33, 257, False),      # past the bulk width and a centroid tile
    (129, 21, 1, False),       # K = 1
    (64, 5, 257, True),        # exact ties across two centroid tiles
    (40, 784, 3, False),       # wide rows
])
def test_argmin_matches_jax_at_the_new_edges(N, d, K, dup):
    rng = np.random.default_rng(N + d + K)
    if dup:
        a = rng.integers(-2, 3, size=(N, d)).astype(np.float32)
        c = rng.integers(-2, 3, size=(K, d)).astype(np.float32)
    else:
        a = rng.normal(size=(N, d)).astype(np.float32)
        c = rng.normal(size=(K, d)).astype(np.float32)
    jv, ji = (np.asarray(x) for x in jops.distance_argmin(jnp.asarray(a),
                                                          jnp.asarray(c)))
    rv, ri = (np.asarray(x) for x in jref.distance_argmin(jnp.asarray(a),
                                                          jnp.asarray(c)))
    tv, ti = tops.distance_argmin(torch.from_numpy(a), torch.from_numpy(c))
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(ti.numpy(), ri)
    np.testing.assert_allclose(tv.numpy(), jv, **TOL)
    np.testing.assert_allclose(tv.numpy(), rv, **TOL)


def test_argmin_fused_and_blocked_arms_assign_alike():
    """K-Means' two arms on the same rows: the fused arm's plain version
    and the blocked arm (B4's plain version, then the row min) pick the
    same centroid at the same distance; on the card B2 and B4 share the
    tile arithmetic (``csrc/distance_tile.cuh``) and chip_smoke.py holds
    them bitwise equal."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.normal(size=(500, 21)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(256, 21)).astype(np.float32))
    fv, fi = tdispatch.distance_argmin(a, c, path="fused")
    bv, bi = tdispatch.distance_argmin(a, c, path="blocked")
    assert torch.equal(fi, bi) and torch.equal(fv, bv)


# ------------------------------------------------------------------ B8


def test_adc_route_follows_k():
    """``fused`` up to ``FUSED_K_MAX`` (it covers the ANN path's
    max(k, refine) = 128), ``matrix`` above it."""
    assert tak.FUSED_K_MAX >= 128
    for k in (1, 10, 128, tak.FUSED_K_MAX):
        assert tak.route(k) == "fused"
    for k in (tak.FUSED_K_MAX + 1, 4099):
        assert tak.route(k) == "matrix"


@pytest.mark.parametrize("Q,L,k,want", [
    (1024, 32768, 128, (1, 32768)),   # the ANN bucket fills the card alone
    (512, 32768, 128, (2, 16384)),
    (100, 32768, 128, (6, 5472)),     # about four blocks an SM
    (1, 32768, 128, (16, 2048)),      # a warm-up bucket: the shortest span
    (1, 32768, 256, (8, 4096)),       # eight lists of 256 fill the merge
    (5, 1000, 10, (1, 1024)),         # shorter than a span
    (2, 20001, 300, (6, 3360)),
])
def test_adc_plan(Q, L, k, want):
    assert tak.plan(Q, L, k, 132) == want


@pytest.mark.parametrize("Q,L,k,sms", [
    (1024, 32768, 128, 132), (1, 32768, 128, 132), (7, 33333, 7, 132),
    (3, 777, 33, 132), (1, 1, 1, 132), (2, 5001, 1024, 8),
    (64, 4096, 128, 132), (1, 70000, 2048 // 16, 132),
])
def test_adc_plan_covers_every_candidate(Q, L, k, sms):
    """The spans cover L, none is empty, each is a whole number of
    ``SPAN_ALIGN`` candidates, and the split merge takes at most
    ``MERGE_KEYS`` keys a query."""
    n_splits, span = tak.plan(Q, L, k, sms)
    assert span % tak.SPAN_ALIGN == 0
    assert (n_splits - 1) * span < L <= n_splits * span
    assert n_splits == 1 or n_splits * k <= tak.MERGE_KEYS
    assert n_splits == 1 or span >= tak.MIN_SPAN


@pytest.mark.parametrize("Q,L,m,n_codes,k", [
    (1024, 32768, 21, 256, 128),   # the ANN bucket: one span a query
    (1, 32768, 21, 256, 128),      # split, with scratch for the merge
    (3, 777, 4, 16, 33),
    (2, 300, 256, 256, 20),        # wide codes
])
def test_adc_fused_launch_arguments(monkeypatch, Q, L, m, n_codes, k):
    calls, shapes = _recorder(monkeypatch, tak, "_bind")
    qlut = torch.zeros((Q, m * n_codes), dtype=torch.int32)
    codes = torch.zeros((Q, L, m), dtype=torch.int8)
    ids = torch.zeros((Q, L), dtype=torch.int32)
    tops.reset_launches()
    vals, idx = tak.launch_topk(qlut, codes, ids, k)
    n_splits, span = tak.plan(Q, L, k, 132)
    (names, args), = calls
    assert names == ("adc_topk_i32", [tak._P] * 6 + [tak._I] * 7 + [tak._P])
    assert args[:5] == (qlut.data_ptr(), codes.data_ptr(), ids.data_ptr(),
                        vals.data_ptr(), idx.data_ptr())
    assert (args[5] is None) == (n_splits == 1)
    assert args[6:] == (Q, L, m, n_codes, k, n_splits, span, 0)
    want = [(Q, k), (Q, k)] + ([(Q, n_splits * k)] if n_splits > 1 else [])
    assert shapes == want
    assert tak.ROUTE_LAUNCHES == {"fused": 1, "matrix": 0}


def test_adc_wrapper_fused_route_launches(monkeypatch):
    """The CUDA branch at a k the fused list holds, driven on the CPU: one
    B8 launch for the whole call, no distance matrix and no B5 launch."""
    calls = []

    def fused(qlut, codes, ids, k):
        calls.append(("fused", k))
        return tref.adc_topk(qlut, codes, ids, k)

    def boom(*_):
        raise AssertionError("the fused route reached the matrix route")

    monkeypatch.setattr(tak, "launch_topk", fused)
    monkeypatch.setattr(tak, "launch_dist", boom)
    rng = np.random.default_rng(9)
    qlut = torch.from_numpy(rng.integers(0, 256, size=(5, 64)).astype(
        np.int32))
    codes = torch.from_numpy((rng.integers(0, 16, size=(5, 37, 4))
                              - 128).astype(np.int8))
    ids = torch.from_numpy(rng.integers(-1, 50, size=(5, 37)).astype(
        np.int32))
    want = tref.adc_topk(qlut, codes, ids, 9)
    real_check = tops._check
    monkeypatch.setattr(tops, "_check", lambda op, **kw: (
        real_check(op, **kw), torch.device("cuda"))[1])
    tops.reset_launches()
    got = tops.adc_topk(qlut, codes, ids, 9)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert calls == [("fused", 9)]
    assert tops.LAUNCHES["adc_topk"] == 1
    assert tops.LAUNCHES["topk_smallest"] == 0


def _adc_case(seed, Q, L, m, n_codes, invalid):
    rng = np.random.default_rng(seed)
    qlut = rng.integers(0, 256, size=(Q, m * n_codes)).astype(np.int32)
    codes = (rng.integers(0, n_codes, size=(Q, L, m)) - 128).astype(np.int8)
    ids = rng.integers(0, 1 << 20, size=(Q, L)).astype(np.int32)
    ids[rng.random(size=(Q, L)) < invalid] = -1
    return qlut, codes, ids


@pytest.mark.parametrize("Q,L,m,n_codes,k,invalid", [
    (3, 777, 4, 16, 33, 0.2),      # L not a multiple of 32
    (2, 100, 7, 256, 50, 1.0),     # every candidate is list padding
    (2, 45, 25, 16, 45, 0.3),      # k = L; codes wider than FAST_M
    (1, 300, 21, 256, 1, 0.5),     # k = 1 at the path's m
])
def test_adc_matches_jax_at_the_new_edges(Q, L, m, n_codes, k, invalid):
    qlut, codes, ids = _adc_case(Q + L + m + k, Q, L, m, n_codes, invalid)
    args = [jnp.asarray(x) for x in (qlut, codes, ids)]
    jv, jp = jak.adc_topk(*args, k)
    ov, op = jak.ref_adc_topk(*args, k)
    tv, tp = tops.adc_topk(*[torch.from_numpy(x) for x in (qlut, codes,
                                                            ids)], k)
    for want_v, want_p in ((jv, jp), (ov, op)):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(want_p))


def test_reset_launches_zeroes_the_b2_and_b8_route_counts():
    tda.ROUTE_LAUNCHES.update(bulk=2, narrow=1, stream=4)
    tak.ROUTE_LAUNCHES.update(fused=3, matrix=1)
    tops.reset_launches()
    assert tda.ROUTE_LAUNCHES == dict.fromkeys(tda.ROUTES, 0)
    assert tak.ROUTE_LAUNCHES == {"fused": 0, "matrix": 0}


# ------------------------------------------------- the breakdown's cuts


def test_ann_breakdown_new_cuts_apply_to_this_checkout():
    """Every ``ann_breakdown.py --new`` variant applies to this checkout's
    B2 and B8 sources and changes them (the base variant aside)."""
    from repro_torch.launch import ann_breakdown as ab
    from repro_torch.launch.kernel_cuts import cut
    for stem, variants in ab.NEW_VARIANTS.items():
        text = (CSRC / f"{stem}.cu").read_text()
        for name, edits in variants.items():
            assert (cut(text, edits) != text) == bool(edits), (stem, name)


def test_ann_breakdown_step0_cuts():
    """The step-0 cuts of the matrix B8 still apply here (that kernel is
    the matrix route's); those of the one-row-a-thread B2 refuse this
    checkout, whose ``distance_topk.cu`` holds B1 alone."""
    from repro_torch.launch import ann_breakdown as ab
    from repro_torch.launch.kernel_cuts import cut
    text = (CSRC / "adc_topk.cu").read_text()
    for name, edits in ab.OLD_VARIANTS["adc_topk"].items():
        assert (cut(text, edits) != text) == bool(edits), name
    text = (CSRC / "distance_topk.cu").read_text()
    for name, edits in ab.OLD_VARIANTS["distance_topk"].items():
        if edits:
            with pytest.raises(SystemExit, match="not found"):
                cut(text, edits)
