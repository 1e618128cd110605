"""Launcher of the CUDA kernel B1 (distance -> top-k) in
``csrc/distance_topk.cu``.

Counterpart of the JAX package's ``kernels/distance_topk.py`` (its B2,
``distance_argmin``, is ``kernels/distance_argmin.py`` here).  These
functions take fp32, contiguous CUDA tensors that ``kernels/ops.py`` has
already checked, allocate outputs and scratch with ``torch.empty``, and
launch on the current stream; they never synchronise.

B1 stages its row tiles by one of two routes, by a stated alignment rule
(``route``): ``bulk`` (1-D bulk asynchronous copies) for rows whose base
is 16-byte aligned and d <= ``BULK_MAX_D``, ``plain`` (element loads in
the kernel) for any other rows, such as the view ``A[1:]``.
``ROUTE_LAUNCHES`` counts them, beside ``ops.LAUNCHES``.  B6
(``kernels/quantized.py``) plans its splits with the same ``split_rows``.

A grouped launch (a multi-tenant model group) takes G same-shape tenants
at once: data (G, N, d) against queries (G, Q, d), the tenant on the
grid's third axis, one launch for the group.  Its bulk route needs every
tenant's rows 16-byte aligned; its splits fill the card with all G
tenants' query tiles; each lane is bit-equal to the G = 1 launch on that
tenant's operands.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gemm import sm_count

_STEM = "distance_topk"
# the longest per-query list B1 keeps (TOPK_K_MAX in the source); the
# library's own values of these are checked against them at first bind
TOPK_K_MAX = 32
QUERY_TILE = 128        # queries of a block (bsel::QB)
TILE_ROWS = 128         # rows of a tile (bsel::RB)
BULK_MAX_D = 32         # widest row of the bulk route
SPLIT_ROWS = 32         # splits are whole multiples of this many rows
BLOCKS_PER_SM = 2       # B1 and B6 split N until about this many blocks
ALIGN = 16              # bytes: the bulk copy's alignment

# launches per route since the last ``ops.reset_launches``
ROUTE_LAUNCHES: Dict[str, int] = {"bulk": 0, "plain": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_fns = {}


def _fn(name: str, argtypes):
    if name not in _fns:
        for const, want in (("distance_topk_k_max", TOPK_K_MAX),
                            ("distance_topk_query_tile", QUERY_TILE),
                            ("distance_topk_tile_rows", TILE_ROWS),
                            ("distance_topk_bulk_max_d", BULK_MAX_D)):
            got = _build.bind(_STEM, const, [])()
            if got != want:
                raise RuntimeError(f"{const}() = {got} in the built "
                                   f"library, the wrapper expects {want}")
        _fns[name] = _build.bind(_STEM, name, argtypes)
    return _fns[name]


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def split_rows(N: int, Q: int, sms: int, groups: int = 1
               ) -> Tuple[int, int]:
    """(n_splits, rows_per_split) of B1 and B6: split N across blocks
    until the grid (splits x query tiles of ``QUERY_TILE`` x ``groups``
    tenants) holds about ``BLOCKS_PER_SM`` blocks on each of ``sms`` SMs,
    in whole multiples of ``SPLIT_ROWS`` rows (so that every tile of the
    bulk route starts 16-byte aligned), with no split empty."""
    q_tiles = -(-Q // QUERY_TILE) * groups
    want = max(1, -(-BLOCKS_PER_SM * sms // q_tiles))
    rows_per_split = -(-(-(-N // want)) // SPLIT_ROWS) * SPLIT_ROWS
    return -(-N // rows_per_split), rows_per_split


def route(a: torch.Tensor, max_d: int = BULK_MAX_D) -> str:
    """The staging route for rows a (N, d), or a group's (G, N, d):
    ``bulk`` (1-D bulk copies of whole tiles) when every tenant's base is
    16-byte aligned and d <= ``max_d``, else ``plain`` (element loads in
    the kernel), for a view such as ``A[1:]`` or a wide row."""
    N, d = a.shape[-2:]
    aligned = a.data_ptr() % ALIGN == 0 and \
        (a.ndim == 2 or a.shape[0] == 1 or N * d * a.element_size()
         % ALIGN == 0)
    return "bulk" if d <= max_d and aligned else "plain"


def launch_topk(a: torch.Tensor, c: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1: a (N, d), c (Q, d) fp32 on the card -> (vals (Q, k) f32,
    idx (Q, k) int32), ascending by (value, row); or a group's a
    (G, N, d), c (G, Q, d) -> (G, Q, k) each, one launch."""
    fn = _fn("distance_topk_f32", [_P] * 6 + [_I] * 8 + [_P])
    N, d = a.shape[-2:]
    Q = c.shape[-2]
    G = a.shape[0] if a.ndim == 3 else 1
    n_splits, rows_per_split = split_rows(N, Q, sm_count(a.device), G)
    way = route(a)
    lead = a.shape[:-2]
    part_v = torch.empty((G * Q, n_splits * k), dtype=torch.float32,
                         device=a.device)
    part_i = torch.empty((G * Q, n_splits * k), dtype=torch.int32,
                         device=a.device)
    vals = torch.empty(lead + (Q, k), dtype=torch.float32, device=a.device)
    idx = torch.empty(lead + (Q, k), dtype=torch.int32, device=a.device)
    err = fn(a.data_ptr(), c.data_ptr(), part_v.data_ptr(),
             part_i.data_ptr(), vals.data_ptr(), idx.data_ptr(),
             N, Q, d, k, n_splits, rows_per_split, int(way == "bulk"), G,
             _stream())
    _build.check(_STEM, err, f"distance_topk G={G} N={N} Q={Q} d={d} "
                 f"k={k} {way}")
    ROUTE_LAUNCHES[way] += 1
    return vals, idx

