"""Launcher of the CUDA kernel B5 (the k smallest of each row) in
``csrc/topk_select.cu``.

Counterpart of the JAX package's ``kernels/topk_select.py``.  Takes an
fp32 CUDA tensor whose rows are contiguous (any row stride, so the
transposed view of B4's column-major output goes in as it is), checked by
``kernels/ops.py``; an int32 tensor takes the int32 key mode (the exact
lattice distances of B6 and the ADC distances of B8).

Two routes by k (``route``), counted in ``ROUTE_LAUNCHES``: ``filter``
(k <= ``FILTER_K_MAX``: one read of each element against a threshold,
rows split across blocks by ``split_rows`` where R is small) and
``radix`` (any larger k).  Both modes share both routes.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gemm import sm_count

_STEM = "topk_select"
FILTER_K_MAX = 2048     # the filter route's longest list (the source's)
MERGE_KEYS = 2048       # n_splits * k is at most this
MIN_SPLIT = 16384       # elements: no split of a row is shorter
SPLIT_ALIGN = 1024      # splits are whole multiples of this many elements
BLOCKS_PER_SM = 2       # split rows until about this many blocks an SM

# launches per route since the last ``ops.reset_launches``
ROUTE_LAUNCHES: Dict[str, int] = {"filter": 0, "radix": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_fns = {}


def _fn(name: str):
    if name not in _fns:
        for const, want in (("topk_filter_k_max", FILTER_K_MAX),
                            ("topk_merge_keys", MERGE_KEYS)):
            got = _build.bind(_STEM, const, [])()
            if got != want:
                raise RuntimeError(f"{const}() = {got} in the built "
                                   f"library, the wrapper expects {want}")
        _fns[name] = _build.bind(
            _STEM, name,
            [_P, ctypes.c_longlong, _I, _I, _I, _P, _P, _P, _I, _I, _I, _P])
    return _fns[name]


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def route(k: int) -> str:
    """``filter`` for k <= ``FILTER_K_MAX``, else ``radix``.  Alignment
    does not choose: the filter route reads a row's 16-byte-aligned
    middle with 16-byte loads and its ragged head and tail element by
    element."""
    return "filter" if k <= FILTER_K_MAX else "radix"


def split_rows(R: int, n: int, k: int, sms: int) -> Tuple[int, int]:
    """(n_splits, seg) of the filter route: split each row of n into
    n_splits segments of seg elements (a multiple of ``SPLIT_ALIGN``; the
    last may be shorter, none is empty) until the grid (R x n_splits)
    holds about ``BLOCKS_PER_SM`` blocks on each of ``sms`` SMs, with no
    segment under ``MIN_SPLIT`` elements and n_splits * k <=
    ``MERGE_KEYS``, the keys the split merge sorts."""
    want = max(1, -(-BLOCKS_PER_SM * sms // R))
    want = min(want, max(1, MERGE_KEYS // k), max(1, n // MIN_SPLIT))
    seg = -(-(-(-n // want)) // SPLIT_ALIGN) * SPLIT_ALIGN
    return -(-n // seg), seg


def launch(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """B5: x (R, n) fp32 or int32 on the card with ``x.stride(1) == 1`` ->
    (values (R, k) of x's dtype, indices (R, k) int32), ascending, ties to
    the first index, NaN last, indices distinct; 1 <= k <= n."""
    fn = _fn("topk_smallest_i32" if x.dtype == torch.int32
             else "topk_smallest_f32")
    R, n = x.shape
    way = route(k)
    n_splits, seg = split_rows(R, n, k, sm_count(x.device)) \
        if way == "filter" else (1, n)
    vals = torch.empty((R, k), dtype=x.dtype, device=x.device)
    idx = torch.empty((R, k), dtype=torch.int32, device=x.device)
    part = torch.empty((R, n_splits * k), dtype=torch.int64,
                       device=x.device) if n_splits > 1 else None
    ld = x.stride(0) if R > 1 else n
    err = fn(x.data_ptr(), ld, R, n, k, vals.data_ptr(), idx.data_ptr(),
             None if part is None else part.data_ptr(), n_splits, seg,
             int(way == "filter"), _stream())
    _build.check(_STEM, err, f"topk_smallest R={R} n={n} k={k} ld={ld} "
                             f"{way} splits={n_splits}")
    ROUTE_LAUNCHES[way] += 1
    return vals, idx
