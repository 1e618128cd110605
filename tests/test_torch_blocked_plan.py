"""The plans, routes and launch arguments of the blocked arm's kernels,
B4 ``pairwise_sq_dist`` and B5 ``topk_smallest``, and B5's parity with the
JAX package past B1's lists and past its own filter route.

The CUDA kernels run only on the card (``chip_smoke.py``); here each
launcher runs on CPU tensors with its C function replaced by a recorder,
so the arguments it would hand the kernel, the scratch it allocates and
the route it counts are checked.  Parity: the same numpy rows go through
``repro.kernels.ops`` (the Pallas kernel, in interpret mode on the CPU),
``repro.kernels.ref`` and ``repro_torch.kernels.ops`` on CPU tensors (the
plain version); indices and values exact.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pairwise_sq_dist as tpd
from repro_torch.kernels import topk_select as tts

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def no_backend_env(monkeypatch):
    monkeypatch.delenv(tdispatch.ENV_VAR, raising=False)


def _fake_launch(monkeypatch, mod, sms=132):
    """Run ``mod.launch`` on CPU tensors: record the C function's
    arguments and the shapes the launcher allocates, launch nothing."""
    calls, shapes = [], []
    real_empty = torch.empty

    def empty(shape, **kw):
        shapes.append(tuple(shape))
        return real_empty(shape, **kw)

    def fn(*names):
        return lambda *args: calls.append((names, args)) or 0

    monkeypatch.setattr(mod, "_fn", fn)
    monkeypatch.setattr(mod, "sm_count", lambda device: sms)
    monkeypatch.setattr(mod, "_stream", lambda: 0)
    monkeypatch.setattr(torch, "empty", empty)
    return calls, shapes


# ------------------------------------------------------------------ B5


@pytest.mark.parametrize("R,n,k,sms", [
    (1024, 1 << 20, 64, 132),       # the kNN k = 64 bucket
    (1, 1 << 20, 64, 132),          # a warm-up bucket of one query
    (16, 1 << 20, 64, 132),
    (1024, 32768, 128, 132),        # ANN's int32 selection
    (1, 32768, 128, 132),
    (3, 70001, 2048, 132),          # the longest filter list
    (8, 5000, 64, 132),             # a row shorter than a split
    (2, 16385, 1, 8),
    (1, 1, 1, 132),
])
def test_topk_split_rows_covers_every_element(R, n, k, sms):
    """The splits cover the row, none is empty, each is a whole number of
    ``SPLIT_ALIGN`` elements but the last, and the merge takes at most
    ``MERGE_KEYS`` keys a row."""
    n_splits, seg = tts.split_rows(R, n, k, sms)
    assert seg % tts.SPLIT_ALIGN == 0
    assert (n_splits - 1) * seg < n <= n_splits * seg
    assert n_splits == 1 or n_splits * k <= tts.MERGE_KEYS
    assert n_splits == 1 or seg >= tts.MIN_SPLIT


@pytest.mark.parametrize("R,n,k,want", [
    (1024, 1 << 20, 64, (1, 1 << 20)),   # 1024 rows fill the card alone
    (1, 1 << 20, 64, (32, 32768)),       # 32 lists of 64: the merge cap
    (16, 1 << 20, 64, (17, 62464)),      # about two blocks an SM
    (1, 32768, 128, (2, 16384)),         # the shortest split
    (4, 1 << 20, 2048, (1, 1 << 20)),    # one list of 2048 fills the merge
])
def test_topk_split_rows_fills_the_card(R, n, k, want):
    assert tts.split_rows(R, n, k, 132) == want


def test_topk_route_follows_k():
    """``filter`` up to ``FILTER_K_MAX``, ``radix`` above it; a row's
    alignment does not choose (the filter route loads a ragged head and
    tail element by element)."""
    assert tts.FILTER_K_MAX >= 256
    for k in (1, 64, 128, tts.FILTER_K_MAX):
        assert tts.route(k) == "filter"
    for k in (tts.FILTER_K_MAX + 1, 4099):
        assert tts.route(k) == "radix"


@pytest.mark.parametrize("R,n,k,dtype,view", [
    (1024, 5000, 64, torch.float32, None),     # filter, one split
    (1, 70000, 64, torch.float32, None),       # filter, five splits
    (16, 32768, 128, torch.int32, None),       # int32 key mode, two splits
    (3, 5000, 2049, torch.float32, None),      # radix
    (1, 70, 9, torch.float32, None),           # one row
    (4, 3000, 64, torch.float32, "strided"),   # every third row
    (5, 3001, 64, torch.float32, "offset"),    # rows one element in
])
def test_topk_launch_arguments(monkeypatch, R, n, k, dtype, view):
    """B5's launcher hands the C function the row stride, the planned
    splits, the route flag and the split scratch, and counts the route."""
    calls, shapes = _fake_launch(monkeypatch, tts)
    if view == "strided":
        x = torch.zeros((3 * R, n))[::3]
    elif view == "offset":
        x = torch.zeros((R, n + 1))[:, 1:]
    else:
        x = torch.zeros((R, n), dtype=dtype)
    assert x.stride(1) == 1
    tops.reset_launches()
    vals, idx = tts.launch(x, k)
    way = tts.route(k)
    n_splits, seg = tts.split_rows(R, n, k, 132) if way == "filter" \
        else (1, n)
    (names, args), = calls
    assert names == ("topk_smallest_i32" if dtype == torch.int32
                     else "topk_smallest_f32",)
    assert args[0] == x.data_ptr()
    assert args[1:5] == (x.stride(0), R, n, k)
    assert args[5] == vals.data_ptr() and args[6] == idx.data_ptr()
    assert (args[7] is None) == (n_splits == 1)
    assert args[8:12] == (n_splits, seg, int(way == "filter"), 0)
    want = [(R, k), (R, k)] + ([(R, n_splits * k)] if n_splits > 1 else [])
    assert shapes == want
    assert vals.dtype == dtype and idx.dtype == torch.int32
    assert tts.ROUTE_LAUNCHES == {"filter": int(way == "filter"),
                                  "radix": int(way == "radix")}


# ------------------------------------------------------------------ B4


@pytest.mark.parametrize("N,K,sms,want", [
    (1 << 20, 1024, 132, 264),   # kNN: 33 blocks for each of 8 query tiles
    (262144, 256, 132, 264),     # the K-Means fit: 132 for each of 2
    (1024, 256, 132, 16),        # a K-Means serving bucket: one a tile
    (100, 1000, 132, 8),         # one row tile
    (1 << 20, 1, 132, 264),      # a warm-up bucket of one query
    (1 << 20, 40000, 132, 264),  # more query tiles than blocks
    (1, 1, 132, 1),
])
def test_pairwise_plan(N, K, sms, want):
    """About two blocks an SM, a multiple of the query tiles where they
    are fewer (so each block keeps one query tile), and at most one
    block a tile."""
    grid = tpd.plan(N, K, sms)
    assert grid == want
    q_tiles, row_tiles = -(-K // tpd.TILE), -(-N // tpd.TILE)
    assert grid <= row_tiles * q_tiles
    assert q_tiles > grid or grid % q_tiles == 0


def test_pairwise_route_follows_the_alignment_rule():
    """B1's rule: ``bulk`` for a 16-byte-aligned base and d <= 32."""
    a = torch.zeros((64, 21))
    assert tpd.route(a) == "bulk" and tpd.route(a[4:]) == "bulk"
    assert tpd.route(a[1:]) == "plain"
    assert tpd.route(torch.zeros((8, tpd.BULK_MAX_D))) == "bulk"
    assert tpd.route(torch.zeros((8, tpd.BULK_MAX_D + 1))) == "plain"
    assert tpd.route(torch.zeros((8, 784))) == "plain"


@pytest.mark.parametrize("N,K,d,a_fast,view", [
    (5000, 1024, 21, True, False),     # the kNN arm, bulk
    (5000, 256, 21, False, False),     # the K-Means arm, bulk
    (5000, 37, 21, True, True),        # A[1:]: plain
    (300, 5, 784, False, False),       # wide rows: plain
])
def test_pairwise_launch_arguments(monkeypatch, N, K, d, a_fast, view):
    calls, shapes = _fake_launch(monkeypatch, tpd)
    a = torch.zeros((N + 1, d))[1:] if view else torch.zeros((N, d))
    c = torch.zeros((K, d))
    tops.reset_launches()
    e = tpd.launch(a, c, a_fast)
    way = tpd.route(a)
    (names, args), = calls
    assert names == ()
    assert args[0] == a.data_ptr() and args[1] == c.data_ptr()
    assert args[2] == e.data_ptr()
    assert args[3:8] == (N, K, d, int(a_fast), int(way == "bulk"))
    assert args[8:10] == (tpd.plan(N, K, 132), 0)
    assert shapes == [(K, N) if a_fast else (N, K)]
    assert e.shape == (N, K) and (e.T if a_fast else e).is_contiguous()
    assert tpd.ROUTE_LAUNCHES == {"bulk": int(way == "bulk"),
                                  "plain": int(way == "plain")}


def test_reset_launches_zeroes_the_new_route_counts():
    tts.ROUTE_LAUNCHES.update(filter=3, radix=1)
    tpd.ROUTE_LAUNCHES.update(bulk=2, plain=5)
    tops.reset_launches()
    assert tts.ROUTE_LAUNCHES == {"filter": 0, "radix": 0}
    assert tpd.ROUTE_LAUNCHES == {"bulk": 0, "plain": 0}


# ------------------------------------------------- parity past the lists


def _rows(seed, R, n, dup):
    rng = np.random.default_rng(seed)
    if dup:
        return rng.integers(0, 4, size=(R, n)).astype(np.float32)
    return rng.normal(size=(R, n)).astype(np.float32)


@pytest.mark.parametrize("R,n,k,dup", [
    (3, 700, 128, False),       # ANN's k, on the filter route
    (2, 1000, 128, True),       # on long runs of ties
    (2, 2100, tts.FILTER_K_MAX + 1, False),   # the radix route
    (1, 2049, tts.FILTER_K_MAX, True),        # the longest filter list
])
def test_topk_smallest_matches_jax_past_the_lists(R, n, k, dup):
    x = _rows(R + n + k, R, n, dup)
    jv, ji = (np.asarray(v) for v in jops.topk_smallest(jnp.asarray(x), k))
    rv, ri = (np.asarray(v) for v in jref.topk_smallest(jnp.asarray(x), k))
    tv, ti = tops.topk_smallest(torch.from_numpy(x), k)
    assert tuple(ti.shape) == (R, k) and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), ri)
    np.testing.assert_array_equal(tv.numpy(), rv)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(tv.numpy(), jv)


@pytest.mark.parametrize("k", [128, tts.FILTER_K_MAX + 1])
def test_knn_blocked_arm_matches_jax_past_the_lists(k):
    rng = np.random.default_rng(k)
    a = rng.normal(size=(2200, 21)).astype(np.float32)
    c = rng.normal(size=(3, 21)).astype(np.float32)
    tv, ti = tdispatch.distance_topk(torch.from_numpy(a),
                                     torch.from_numpy(c), k)
    jv, ji = (np.asarray(v) for v in jdispatch.distance_topk(
        jnp.asarray(a), jnp.asarray(c), k, path="blocked"))
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(tv.numpy(), jv, **TOL)


def test_breakdown_cuts_apply_to_this_checkout():
    """Every cut-down variant of ``blocked_breakdown.py --new`` applies to
    this checkout's sources and changes them (the base variant aside)."""
    from repro_torch.launch import blocked_breakdown as bb
    from repro_torch.launch.kernel_cuts import cut
    csrc = Path(tpd.__file__).resolve().parent / "csrc"
    for stem, variants in (("pairwise_sq_dist", bb.NEW_VARIANTS),
                           ("topk_select", bb.NEW_B5_VARIANTS)):
        text = (csrc / f"{stem}.cu").read_text()
        for name, edits in variants.items():
            assert (cut(text, edits) != text) == bool(edits), (stem, name)
    stores = cut((csrc / "pairwise_sq_dist.cu").read_text(),
                 bb.NEW_VARIANTS["no_stores"])
    assert "tma_store_2d(" not in stores
    assert "__stcs(" not in stores


def test_cut_matches_any_white_space_and_refuses_other_text():
    from repro_torch.launch.kernel_cuts import cut
    src = "if (a)\n        f(x,\n          y);\nf(x, y);"
    assert cut(src, [("f(x, y);", "{}")]) == "if (a)\n        {}\nf(x, y);"
    with pytest.raises(SystemExit, match="not found"):
        cut(src, [("g(x, y);", "")])
