"""The int8 lattice: its helpers, the GNB/GMM affine scores, and the
launchers of the CUDA kernels B6 (distance -> top-k) and B7 (distance ->
argmin) in ``csrc/quantized.cu``.

Counterpart of the JAX package's ``kernels/quantized.py``.  Features are
stored as int8 on a per-feature symmetric lattice (``quantize_rows``) and
distances are exact int32 lattice integers.  ``_MAX_D``, ``dist_span`` and
``packed_rows_limit`` are the reference's API contract: d > 832 raises.
The launchers take int8, contiguous CUDA tensors that ``kernels/ops.py``
has already checked, allocate outputs and scratch with ``torch.empty``,
and launch on the current stream without synchronising.  B6 plans its
splits as B1 does and stages rows by B1's alignment rule
(``distance_topk.route``, here with ``BULK_MAX_D``); ``ROUTE_LAUNCHES``
counts its routes.  B7 keeps its centroids in shared memory (route
``resident``) or streams them in chunks where they do not fit
(``stream``; ``argmin_chunk``), counted in ``ARGMIN_ROUTE_LAUNCHES``;
``argmin_plan`` picks the warps a row tile and the grid.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.distance_topk import (QUERY_TILE, TILE_ROWS,
                                               TOPK_K_MAX, route, split_rows)
from repro_torch.kernels.gemm import sm_count

_QMAX = 127                     # symmetric int8 lattice: values in [-127, 127]
# the reference's supported feature count: its packed selection key
# dist * bn + lane must fit int32 at the minimum 32-row block
_MAX_D = 832


def feature_scales(absmax, eps: float = 1e-12) -> torch.Tensor:
    """Per-feature symmetric scale from a (d,) abs-max calibration
    vector."""
    absmax = torch.as_tensor(absmax, dtype=torch.float32)
    return torch.clamp(absmax, min=eps) / float(_QMAX)


def quantize_rows(X: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(..., d) float features -> int8 rows on the per-feature lattice;
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    q = torch.round(X.to(torch.float32) / scale)
    return torch.clamp(q, -_QMAX, _QMAX).to(torch.int8)


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def lattice_sq_norms(q: torch.Tensor) -> torch.Tensor:
    """(N, d) int8 -> (N,) int32 exact squared lattice norms."""
    qi = q.to(torch.int32)
    return torch.sum(qi * qi, dim=1, dtype=torch.int32)


def dist_span(d: int) -> int:
    """The reference's exclusive bound of its offset partial lattice
    distance ``an - 2*cross + 2*d*127^2``."""
    return 5 * d * _QMAX * _QMAX + 2


def packed_rows_limit(d: int) -> int:
    """The reference's largest block ``bn`` whose packed key ``dist * bn +
    lane`` fits int32."""
    return (2 ** 31 - 1) // dist_span(d)


def check_width(d: int, what: str) -> None:
    if d > _MAX_D:
        raise ValueError(f"{what} supports d <= {_MAX_D} (the int32 packed "
                         f"selection key of the reference), got d={d}")


def affine_scores(xq: torch.Tensor, quad: torch.Tensor, lin: torch.Tensor,
                  const: torch.Tensor) -> torch.Tensor:
    """int8 features (B, d) against fp32 per-class affine score tables:
    ``score[b, c] = sum_f quad[c, f]*xq^2 + lin[c, f]*xq + const[c]``.
    Two fp32 matmuls over exactly representable integer features, as in
    the reference (not a kernel there either); TF32 stays off
    (``kernels/ref.py``)."""
    xf = xq.to(torch.float32)
    return (xf * xf) @ quad.T + xf @ lin.T + const[None, :]


# ---------------------------------------------------------------------------
# Launchers
# ---------------------------------------------------------------------------

_STEM = "quantized"
BULK_MAX_D = 128        # widest int8 row of B6's bulk route (4 k-steps)
_P, _I = ctypes.c_void_p, ctypes.c_int
_fns = {}

# B6's launches per route (``distance_topk.route`` with ``BULK_MAX_D``)
# since the last ``ops.reset_launches``
ROUTE_LAUNCHES: Dict[str, int] = {"bulk": 0, "plain": 0}

ARGMIN_RESIDENT_MAX = 57344   # B7: bytes of staged centroid words and norms
ARGMIN_WARPS = 8              # B7: warps of a block
ARGMIN_GROUP = 32             # B7: centroids a warp takes at once
ARGMIN_BLOCKS_PER_SM = 4      # B7: persistent blocks an SM
# B7's launches per route since the last ``ops.reset_launches``
ARGMIN_ROUTE_LAUNCHES: Dict[str, int] = {"resident": 0, "stream": 0}


def _fn(name: str, argtypes):
    if name not in _fns:
        for const, want in (("q8_topk_k_max", TOPK_K_MAX),
                            ("q8_query_tile", QUERY_TILE),
                            ("q8_tile_rows", TILE_ROWS),
                            ("q8_bulk_max_d", BULK_MAX_D),
                            ("q8_max_d", _MAX_D),
                            ("q8_argmin_resident_max", ARGMIN_RESIDENT_MAX)):
            got = _build.bind(_STEM, const, [])()
            if got != want:
                raise RuntimeError(f"{const}() = {got} in the built "
                                   f"library, the wrapper expects {want}")
        _fns[name] = _build.bind(_STEM, name, argtypes)
    return _fns[name]


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def launch_topk(a: torch.Tensor, c: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B6, k <= TOPK_K_MAX: a (N, d), c (Q, d) int8 on the card -> (lattice
    distances (Q, k) int32, rows (Q, k) int32), ascending by (distance,
    row)."""
    fn = _fn("distance_topk_q8", [_P] * 6 + [_I] * 7 + [_P])
    N, d = a.shape
    Q = c.shape[0]
    n_splits, rows_per_split = split_rows(N, Q, sm_count(a.device))
    way = route(a, BULK_MAX_D)
    part_v = torch.empty((Q, n_splits * k), dtype=torch.int32,
                         device=a.device)
    part_i = torch.empty((Q, n_splits * k), dtype=torch.int32,
                         device=a.device)
    vals = torch.empty((Q, k), dtype=torch.int32, device=a.device)
    idx = torch.empty((Q, k), dtype=torch.int32, device=a.device)
    err = fn(a.data_ptr(), c.data_ptr(), part_v.data_ptr(),
             part_i.data_ptr(), vals.data_ptr(), idx.data_ptr(),
             N, Q, d, k, n_splits, rows_per_split, int(way == "bulk"),
             _stream())
    _build.check(_STEM, err,
                 f"distance_topk_q8 N={N} Q={Q} d={d} k={k} {way}")
    ROUTE_LAUNCHES[way] += 1
    return vals, idx


def launch_dist(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """B6's matrix mode: a (N, d), c (Q, d) int8 on the card -> the (Q, N)
    int32 lattice distances, one query per row."""
    fn = _fn("dist_matrix_q8", [_P] * 3 + [_I] * 3 + [_P])
    N, d = a.shape
    Q = c.shape[0]
    out = torch.empty((Q, N), dtype=torch.int32, device=a.device)
    err = fn(a.data_ptr(), c.data_ptr(), out.data_ptr(), N, Q, d, _stream())
    _build.check(_STEM, err, f"dist_matrix_q8 N={N} Q={Q} d={d}")
    return out


def argmin_chunk(K: int, d: int) -> int:
    """B7: centroids staged at once, a multiple of ``ARGMIN_GROUP``: all of
    them where their padded words (8 per 32 features, 4 more) and norms
    fit ``ARGMIN_RESIDENT_MAX`` bytes, else the most groups that do."""
    record = (8 * -(-d // 32) + 4) * 4 + 4
    padded = -(-K // ARGMIN_GROUP) * ARGMIN_GROUP
    if padded * record <= ARGMIN_RESIDENT_MAX:
        return padded
    return ARGMIN_RESIDENT_MAX // record // ARGMIN_GROUP * ARGMIN_GROUP


@functools.lru_cache(maxsize=256)
def argmin_route(K: int, d: int) -> str:
    return "resident" if argmin_chunk(K, d) >= K else "stream"


@functools.lru_cache(maxsize=256)   # a wrapper call's host time counts
def argmin_plan(N: int, K: int, d: int, sms: int) -> Tuple[int, int, int]:
    """B7: (warps a 16-row tile, centroids a chunk, blocks).  A tile takes
    the most warps, a power of two up to ``ARGMIN_WARPS`` and at most one
    a centroid group of a chunk, that keep the blocks to one an SM; blocks
    are persistent, at most ``ARGMIN_BLOCKS_PER_SM`` an SM."""
    kc = argmin_chunk(K, d)
    tiles = -(-N // 16)
    groups = -(-min(kc, K) // ARGMIN_GROUP)
    split = 1
    while split * 2 <= min(ARGMIN_WARPS, groups) and \
            -(-tiles * split * 2 // ARGMIN_WARPS) <= sms:
        split *= 2
    return split, kc, min(-(-tiles * split // ARGMIN_WARPS),
                          ARGMIN_BLOCKS_PER_SM * sms)


def launch_argmin(a: torch.Tensor, c: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B7: a (N, d), c (K, d) int8 on the card -> (lattice distance (N,)
    int32, nearest centroid (N,) int32), first index on ties."""
    fn = _fn("distance_argmin_q8", [_P] * 4 + [_I] * 6 + [_P])
    N, d = a.shape
    K = c.shape[0]
    split, kc, grid = argmin_plan(N, K, d, sm_count(a.device))
    way = argmin_route(K, d)
    vals = torch.empty((N,), dtype=torch.int32, device=a.device)
    idx = torch.empty((N,), dtype=torch.int32, device=a.device)
    err = fn(a.data_ptr(), c.data_ptr(), vals.data_ptr(), idx.data_ptr(),
             N, K, d, split, kc, grid, _stream())
    _build.check(_STEM, err, f"distance_argmin_q8 N={N} K={K} d={d} {way}")
    ARGMIN_ROUTE_LAUNCHES[way] += 1
    return vals, idx
