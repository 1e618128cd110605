"""Launcher of the CUDA kernel B4 (full squared-distance matrix) in
``csrc/pairwise_sq_dist.cu``.

Counterpart of the JAX package's ``kernels/distance.py``.  Takes fp32,
contiguous CUDA tensors that ``kernels/ops.py`` has already checked,
allocates the output with ``torch.empty`` and launches on the current
stream without synchronising.

B4 stages its row tiles by B1's alignment rule (``distance_topk.route``):
``bulk`` (1-D bulk asynchronous copies) for rows whose base is 16-byte
aligned and d <= ``BULK_MAX_D``, ``plain`` (element loads) otherwise.
``ROUTE_LAUNCHES`` counts them.  ``plan`` sizes the grid of persistent
blocks that walk the 128 x 128 tiles, about ``BLOCKS_PER_SM`` an SM.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.distance_topk import route as _route
from repro_torch.kernels.gemm import sm_count

_STEM = "pairwise_sq_dist"
TILE = 128              # rows and queries of a tile
BULK_MAX_D = 32         # widest row of the bulk route
BLOCKS_PER_SM = 2       # persistent blocks an SM

# launches per route since the last ``ops.reset_launches``
ROUTE_LAUNCHES: Dict[str, int] = {"bulk": 0, "plain": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_fns = {}


def _fn():
    if "dist" not in _fns:
        for const, want in (("pairwise_bulk_max_d", BULK_MAX_D),
                            ("pairwise_tile", TILE)):
            got = _build.bind(_STEM, const, [])()
            if got != want:
                raise RuntimeError(f"{const}() = {got} in the built "
                                   f"library, the wrapper expects {want}")
        _fns["dist"] = _build.bind(_STEM, "pairwise_sq_dist_f32",
                                   [_P] * 3 + [_I] * 6 + [_P])
    return _fns["dist"]


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def route(a: torch.Tensor) -> str:
    """``bulk`` or ``plain``: B1's rule (``distance_topk.route``)."""
    return _route(a, BULK_MAX_D)


def plan(N: int, K: int, sms: int) -> int:
    """The grid: persistent blocks that walk the tiles w = b, b + grid, ..
    (tile w: row tile w // q_tiles, query tile w % q_tiles).  About
    ``BLOCKS_PER_SM`` blocks on each of ``sms`` SMs, a multiple of the
    query tiles where they are fewer, so that each block keeps one query
    tile; at most one block a tile."""
    row_tiles, q_tiles = -(-N // TILE), -(-K // TILE)
    want = BLOCKS_PER_SM * sms
    if q_tiles >= want:
        return min(want, row_tiles * q_tiles)
    return q_tiles * min(row_tiles, want // q_tiles)


def launch(a: torch.Tensor, c: torch.Tensor, a_fast: bool) -> torch.Tensor:
    """B4: a (N, d), c (K, d) fp32 on the card -> E (N, K) f32.  With
    ``a_fast`` the kernel writes E's transpose row-major, and E comes back
    as the (N, K) view of that (K, N) buffer: ``E.T`` is contiguous."""
    fn = _fn()
    N, d = a.shape
    K = c.shape[0]
    way = route(a)
    grid = plan(N, K, sm_count(a.device))
    shape = (K, N) if a_fast else (N, K)
    out = torch.empty(shape, dtype=torch.float32, device=a.device)
    err = fn(a.data_ptr(), c.data_ptr(), out.data_ptr(), N, K, d,
             int(a_fast), int(way == "bulk"), grid, _stream())
    _build.check(_STEM, err, f"pairwise_sq_dist N={N} K={K} d={d} "
                             f"a_fast={a_fast} {way}")
    ROUTE_LAUNCHES[way] += 1
    return out.T if a_fast else out
