"""Launcher of the CUDA kernel B2 (distance -> argmin) in
``csrc/distance_argmin.cu``.

Counterpart of the JAX package's ``kernels/distance_topk.py::
distance_argmin``.  Takes fp32, contiguous CUDA tensors that
``kernels/ops.py`` has already checked, allocates the outputs with
``torch.empty`` and launches on the current stream without
synchronising.

Five routes (``route``), counted in ``ROUTE_LAUNCHES``: ``stream`` where
the centroids do not stay resident in shared memory (``resident``), else
``rows`` for d <= ``ROWS_MAX_D`` (a thread scans every centroid for its
own rows), ``narrow`` for few rows (N <= ``NARROW_MAX_ROWS``: eight rows
a block), ``bulk`` for rows whose base is 16-byte aligned and d <=
``BULK_MAX_D`` (B1's rule: 1-D bulk asynchronous copies of whole row
tiles), ``plain`` otherwise (element loads).  ``plan`` sizes the grid.

A grouped launch (a multi-tenant model group) takes G same-shape tenants
at once on every route: rows (G, N, d) against centroids (G, K, d), the
tenant on the grid's second axis, one launch for the group, each lane
bit-equal to the G = 1 launch on that tenant's operands.  Its bulk route
needs every tenant's rows 16-byte aligned.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gemm import sm_count

_STEM = "distance_argmin"
TILE = 128              # rows of a tile, centroids of a tile
BULK_MAX_D = 32         # widest row of the bulk route
RESIDENT_MAX = 57344    # bytes of resident centroid tiles and norms
NARROW_ROWS = 8         # rows of a narrow block
NARROW_MAX_ROWS = 2048  # the narrow route takes N up to this
ROWS_MAX_D = 4          # widest row of the rows route
ROWS_BLOCK = 128        # rows of a block on the rows route
BLOCKS_PER_SM = 2       # persistent blocks an SM (bulk, plain, stream)
ALIGN = 16              # bytes: the bulk copy's alignment
ROUTES = ("bulk", "plain", "stream", "narrow", "rows")   # the kernel's codes

# launches per route since the last ``ops.reset_launches``
ROUTE_LAUNCHES: Dict[str, int] = dict.fromkeys(ROUTES, 0)

_P, _I = ctypes.c_void_p, ctypes.c_int
_fns = {}


def _fn():
    if "argmin" not in _fns:
        for const, want in (("distance_argmin_bulk_max_d", BULK_MAX_D),
                            ("distance_argmin_resident_max", RESIDENT_MAX),
                            ("distance_argmin_narrow_rows", NARROW_ROWS),
                            ("distance_argmin_rows_max_d", ROWS_MAX_D),
                            ("distance_argmin_rows_block", ROWS_BLOCK)):
            got = _build.bind(_STEM, const, [])()
            if got != want:
                raise RuntimeError(f"{const}() = {got} in the built "
                                   f"library, the wrapper expects {want}")
        _fns["argmin"] = _build.bind(_STEM, "distance_argmin_f32",
                                     [_P] * 4 + [_I] * 6 + [_P])
    return _fns["argmin"]


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def resident(K: int, d: int) -> bool:
    """Whether K centroids of d features stay in shared memory for the
    whole kernel: every 128-centroid tile, transposed, with its norms."""
    return -(-K // TILE) * TILE * (d + 1) * 4 <= RESIDENT_MAX


def route(a: torch.Tensor, c: torch.Tensor) -> str:
    """The route of rows a (N, d) against centroids c (K, d), or of a
    group's a (G, N, d) against c (G, K, d)."""
    (N, d), K = a.shape[-2:], c.shape[-2]
    if not resident(K, d):
        return "stream"
    if d <= ROWS_MAX_D:
        return "rows"
    if N <= NARROW_MAX_ROWS:
        return "narrow"
    aligned = a.data_ptr() % ALIGN == 0 and \
        (a.ndim == 2 or a.shape[0] == 1 or N * d * 4 % ALIGN == 0)
    return "bulk" if d <= BULK_MAX_D and aligned else "plain"


def plan(N: int, K: int, sms: int, way: str, groups: int = 1) -> int:
    """A tenant's blocks: one for every ``NARROW_ROWS`` rows on the narrow
    route, every ``ROWS_BLOCK`` rows on the rows route; else persistent
    blocks that walk the 128-row tiles, about ``BLOCKS_PER_SM`` on each of
    ``sms`` SMs for all ``groups`` tenants together and at most one a
    tile."""
    if way in ("narrow", "rows"):
        return -(-N // (NARROW_ROWS if way == "narrow" else ROWS_BLOCK))
    return min(-(-N // TILE), max(1, -(-BLOCKS_PER_SM * sms // groups)))


def launch(a: torch.Tensor, c: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2: a (N, d), c (K, d) fp32 on the card -> (min sq-dist (N,) f32,
    nearest id (N,) int32), first index on ties, centroid 0 at +inf for a
    row with no number distance; or a group's a (G, N, d), c (G, K, d) ->
    (G, N) each, one launch."""
    fn = _fn()
    N, d = a.shape[-2:]
    K = c.shape[-2]
    G = a.shape[0] if a.ndim == 3 else 1
    way = route(a, c)
    grid = plan(N, K, sm_count(a.device), way, G)
    lead = a.shape[:-1]
    vals = torch.empty(lead, dtype=torch.float32, device=a.device)
    idx = torch.empty(lead, dtype=torch.int32, device=a.device)
    err = fn(a.data_ptr(), c.data_ptr(), vals.data_ptr(), idx.data_ptr(),
             N, K, d, ROUTES.index(way), grid, G, _stream())
    _build.check(_STEM, err, f"distance_argmin G={G} N={N} K={K} d={d} "
                 f"{way}")
    ROUTE_LAUNCHES[way] += 1
    return vals, idx
