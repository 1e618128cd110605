"""B3 ``gnb_scores_batch`` (with B9 ``gnb_scores``, B3 at B = 1) and B7
``distance_argmin_q8`` as redesigned for Hopper: their routes, plans and
launch arguments, and their parity with the JAX package at the new
designs' edge shapes.

The CUDA kernels run only on the card (``chip_smoke.py``); here each
launcher runs on CPU tensors with its C function replaced by a recorder,
so the route it takes, the plan and the arguments it would hand the
kernel are checked.  Parity: the same numpy inputs go through
``repro.kernels.ops`` (the Pallas kernels, in interpret mode on the CPU),
``repro.kernels.ref`` and ``repro_torch.kernels.ops`` on CPU tensors (the
plain versions).  Tolerances: GNB scores ``rtol = atol = 1e-5`` (the
packages sum the terms in different orders), as ``test_torch_kernels``
and ``test_torch_blocked`` hold them; B7's distances and indices exact.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import quantized as jqk
from repro.kernels import ref as jref
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import gnb_score as tgs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quantized as tqk

TOL = dict(rtol=1e-5, atol=1e-5)
CSRC = Path(tgs.__file__).resolve().parent / "csrc"


@pytest.fixture(autouse=True)
def no_backend_env(monkeypatch):
    monkeypatch.delenv(tdispatch.ENV_VAR, raising=False)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _recorder(monkeypatch, mod, sms=132):
    """Run ``mod``'s launcher on CPU tensors: record the C function's
    arguments and the shapes the launcher allocates, launch nothing."""
    calls, shapes = [], []
    real_empty = torch.empty

    def empty(shape, **kw):
        shapes.append(tuple(shape))
        return real_empty(shape, **kw)

    monkeypatch.setattr(mod, "_fn", lambda *names: (
        lambda *args: calls.append((names, args)) or 0))
    monkeypatch.setattr(mod, "sm_count", lambda device: sms)
    monkeypatch.setattr(mod, "_stream", lambda: 0)
    monkeypatch.setattr(torch, "empty", empty)
    return calls, shapes


# ------------------------------------------------------------------ B3


def _gnb_inputs(seed, B, d, C):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, d)).astype(np.float32)
    mu = rng.normal(size=(C, d)).astype(np.float32)
    var = (rng.random((C, d)) + 0.25).astype(np.float32)
    log_prior = np.log(rng.dirichlet(np.ones(C))).astype(np.float32)
    return X, mu, var, log_prior


@pytest.mark.parametrize("C,d,want", [
    (10, 784, ("resident", 784)),   # the GNB path: 62,720 bytes staged
    (16, 768, ("resident", 768)),   # one full group at the resident limit
    (16, 785, ("stream", 768)),     # one feature past it
    (17, 5, ("stream", 5)),         # two class groups: staged per group
    (33, 1, ("stream", 1)),
    (1, 1, ("resident", 1)),
    (10, 1300, ("stream", 1216)),   # C·d past the limit in one group
])
def test_gnb_route_and_chunk(C, d, want):
    assert (tgs.route(C, d), tgs.chunk(C, d)) == want
    assert tgs.group_size(C) * tgs.chunk(C, d) * 8 <= tgs.RESIDENT_MAX


@pytest.mark.parametrize("C,want", [(1, 1), (10, 10), (16, 16), (17, 9),
                                    (33, 11), (257, 16)])
def test_gnb_group_size(C, want):
    assert tgs.group_size(C) == want


@pytest.mark.parametrize("B,C,d,sms,want", [
    (1024, 10, 784, 132, (4, 784, 256)),   # the GNB bucket: two an SM
    (1, 10, 784, 132, (16, 784, 1)),       # B9: sixteen warps share it
    (31, 33, 785, 132, (16, 785, 31)),     # three groups of 11 classes
    (1025, 10, 784, 132, (4, 784, 257)),
    (1025, 10, 5, 132, (1, 5, 65)),        # one stripe: one warp a query
    (60_000, 10, 784, 132, (1, 784, 264)),  # persistent: two an SM
    (64, 17, 100, 8, (4, 100, 16)),        # four stripes: four warps
])
def test_gnb_plan(B, C, d, sms, want):
    split, f, grid = tgs.plan(B, C, d, sms)
    assert (split, f, grid) == want
    assert tgs.WARPS % split == 0 and split <= -(-f // 32)
    assert grid <= tgs.BLOCKS_PER_SM * sms


@pytest.mark.parametrize("B,C,d", [(1024, 10, 784), (1, 10, 784),
                                   (31, 33, 785), (3, 17, 1)])
def test_gnb_launch_arguments(monkeypatch, B, C, d):
    """The launcher hands the C function the plan and a (B, C) output, and
    counts the launch per route."""
    calls, shapes = _recorder(monkeypatch, tgs)
    tops.reset_launches()
    X, mu, var, lp = _t(*_gnb_inputs(0, B, d, C))
    out = tgs.launch_scores_batch(X, mu, var, lp)
    (_, args), = calls
    assert args[5:11] == (B, C, d) + tgs.plan(B, C, d, 132)
    assert shapes == [(B, C)] and tuple(out.shape) == (B, C)
    assert args[:5] == tuple(t.data_ptr() for t in (X, mu, var, lp, out))
    way = tgs.route(C, d)
    assert tgs.ROUTE_LAUNCHES == {"resident": int(way == "resident"),
                                  "stream": int(way == "stream")}


def test_gnb_scores_launches_b3_at_one_query(monkeypatch):
    """B9 is B3's launcher at B = 1, counted under ``gnb_scores`` and on
    B3's route counts."""
    calls, shapes = _recorder(monkeypatch, tgs)
    real_check = tops._check
    monkeypatch.setattr(tops, "_check", lambda op, **kw: (
        real_check(op, **kw), torch.device("cuda"))[1])
    tops.reset_launches()
    X, mu, var, lp = _t(*_gnb_inputs(1, 1, 784, 10))
    assert tuple(tops.gnb_scores(X[0], mu, var, lp).shape) == (10,)
    (_, args), = calls
    assert args[5:11] == (1, 10, 784, 16, 784, 1)
    assert tops.LAUNCHES["gnb_scores"] == 1
    assert tops.LAUNCHES["gnb_scores_batch"] == 0
    assert tgs.ROUTE_LAUNCHES == {"resident": 1, "stream": 0}


@pytest.mark.parametrize("B,d,C", [
    (1, 784, 16), (31, 785, 16), (1025, 5, 17), (31, 1, 33),
    (1, 785, 17), (5, 1300, 10), (1025, 784, 10), (31, 5, 33),
])
def test_gnb_scores_batch_matches_jax_at_the_new_edges(B, d, C):
    args = _gnb_inputs(B + d + C, B, d, C)
    js = np.asarray(jops.gnb_scores_batch(*map(jnp.asarray, args)))
    rs = np.asarray(jref.gnb_scores_batch(*map(jnp.asarray, args)))
    ts = tops.gnb_scores_batch(*_t(*args))
    assert ts.shape == (B, C) and ts.dtype == torch.float32
    np.testing.assert_allclose(ts.numpy(), js, **TOL)
    np.testing.assert_allclose(ts.numpy(), rs, **TOL)
    np.testing.assert_array_equal(ts.numpy().argmax(1), js.argmax(1))


@pytest.mark.parametrize("d,C", [(1, 16), (5, 17), (784, 33), (785, 10),
                                 (1300, 17)])
def test_gnb_scores_matches_jax_at_the_new_edges(d, C):
    X, mu, var, lp = _gnb_inputs(d * C, 1, d, C)
    args = (X[0], mu, var, lp)
    js = np.asarray(jops.gnb_scores(*map(jnp.asarray, args)))
    ts = tops.gnb_scores(*_t(*args))
    assert ts.shape == (C,)
    np.testing.assert_allclose(ts.numpy(), js, **TOL)
    batch = tops.gnb_scores_batch(*_t(X, mu, var, lp))[0]
    np.testing.assert_allclose(ts.numpy(), batch.numpy(), **TOL)


# ------------------------------------------------------------------ B7


def _lattice(seed, n, d, dup=False):
    rng = np.random.default_rng(seed)
    if dup:
        base = rng.integers(-3, 4, size=(max(1, n // 3), d))
        return base[rng.integers(0, len(base), size=n)].astype(np.int8)
    return rng.integers(-127, 128, size=(n, d)).astype(np.int8)


@pytest.mark.parametrize("K,d,want", [
    (256, 21, ("resident", 256)),    # the K-Means int8 path
    (1, 1, ("resident", 32)),
    (1088, 21, ("resident", 1088)),  # 1088 x 52 bytes fit 57,344
    (1089, 21, ("stream", 1088)),
    (1200, 21, ("stream", 1088)),
    (64, 832, ("resident", 64)),     # 852 bytes a centroid
    (65, 832, ("stream", 64)),
    (257, 832, ("stream", 64)),
])
def test_argmin_q8_route_and_chunk(K, d, want):
    assert (tqk.argmin_route(K, d), tqk.argmin_chunk(K, d)) == want
    record = (8 * -(-d // 32) + 4) * 4 + 4
    assert tqk.argmin_chunk(K, d) * record <= tqk.ARGMIN_RESIDENT_MAX


@pytest.mark.parametrize("N,K,d,sms,want", [
    (1024, 256, 21, 132, (8, 256, 64)),      # a bucket: 64 blocks of 8 warps
    (262_144, 256, 21, 132, (1, 256, 528)),  # the fit: persistent, 4 an SM
    (1, 1, 1, 132, (1, 32, 1)),              # one group: one warp a tile
    (1025, 257, 832, 132, (2, 64, 17)),      # streamed chunks of 2 groups
    (1025, 255, 21, 132, (8, 256, 65)),
])
def test_argmin_q8_plan(N, K, d, sms, want):
    split, kc, grid = tqk.argmin_plan(N, K, d, sms)
    assert (split, kc, grid) == want
    assert split in (1, 2, 4, 8) and split <= -(-min(kc, K) // 32)


@pytest.mark.parametrize("N,K,d", [(1024, 256, 21), (1, 1, 1),
                                   (1025, 257, 832), (70, 1200, 21)])
def test_argmin_q8_launch_arguments(monkeypatch, N, K, d):
    calls, shapes = _recorder(monkeypatch, tqk)
    tops.reset_launches()
    a, c = _t(_lattice(0, N, d), _lattice(1, K, d))
    vals, idx = tqk.launch_argmin(a, c)
    (names, args), = calls
    assert names[0] == "distance_argmin_q8"
    assert args[4:10] == (N, K, d) + tqk.argmin_plan(N, K, d, 132)
    assert shapes == [(N,), (N,)]
    assert vals.dtype == idx.dtype == torch.int32
    assert tuple(vals.shape) == tuple(idx.shape) == (N,)
    assert args[2:4] == (vals.data_ptr(), idx.data_ptr())
    way = tqk.argmin_route(K, d)
    assert tqk.ARGMIN_ROUTE_LAUNCHES == {"resident": int(way == "resident"),
                                         "stream": int(way == "stream")}
    assert tqk.ROUTE_LAUNCHES == {"bulk": 0, "plain": 0}


@pytest.mark.parametrize("N,K,d,dup", [
    (1, 1, 1, False), (1024, 255, 21, True), (1025, 257, 21, False),
    (1024, 1200, 21, True),          # past the resident limit
    (1025, 1, 832, False), (70, 257, 832, True), (1024, 256, 1, True),
    (1, 257, 21, False),
])
def test_argmin_q8_matches_jax_at_the_new_edges(N, K, d, dup):
    a = _lattice(N + K + d, N, d, dup=dup)
    c = _lattice(N + K + d + 1, K, d, dup=dup)
    if dup:   # duplicate centroids: the first index must win the tie
        c[K // 2:] = c[:K - K // 2]
    jv, ji = jqk.distance_argmin_q8(jnp.asarray(a), jnp.asarray(c))
    tv, ti = tops.distance_argmin_q8(*_t(a, c))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if dup and K > 1:
        assert (ti.numpy() < K - K // 2).all()


def test_argmin_q8_width_limit_still_raises():
    a, c = _t(_lattice(0, 10, 833), _lattice(1, 2, 833))
    with pytest.raises(ValueError, match="832"):
        tops.distance_argmin_q8(a, c)


def test_reset_launches_zeroes_the_b3_and_b7_route_counts():
    tgs.ROUTE_LAUNCHES.update(resident=3, stream=1)
    tqk.ARGMIN_ROUTE_LAUNCHES.update(resident=2, stream=5)
    tops.reset_launches()
    assert tgs.ROUTE_LAUNCHES == {"resident": 0, "stream": 0}
    assert tqk.ARGMIN_ROUTE_LAUNCHES == {"resident": 0, "stream": 0}


# ------------------------------------------------- the breakdown's cuts


def test_gnb_breakdown_cuts():
    """Every ``gnb_breakdown.py --new`` variant applies to this checkout's
    B3 and B7 and changes them (the base variants aside); the step-0 cuts
    of the tile B3 refuse it."""
    from repro_torch.launch import gnb_breakdown as gb
    from repro_torch.launch.kernel_cuts import cut
    for stem, variants in (("gnb_score", gb.NEW_VARIANTS),
                           ("quantized", gb.NEW_B7_VARIANTS)):
        text = (CSRC / f"{stem}.cu").read_text()
        for name, edits in variants.items():
            assert (cut(text, edits) != text) == bool(edits), (stem, name)
    text = (CSRC / "gnb_score.cu").read_text()
    for name, edits in gb.OLD_VARIANTS.items():
        if edits:
            with pytest.raises(SystemExit, match="not found"):
                cut(text, edits)
