"""IVF-PQ asymmetric distances: the sentinel and the launchers of the CUDA
kernel B8 in ``csrc/adc_topk.cu``.

Counterpart of the JAX package's ``kernels/ann.py``.  The LUT is integer
by construction (``core/ann.py::build_query_luts`` puts it on a 0..255
step), so a candidate's ADC distance is a bounded integer and an invalid
candidate (id < 0, ragged-cell padding) takes ``adc_dmax(m)``, one past
the largest reachable distance, in value space.  The launchers take
contiguous CUDA tensors that ``kernels/ops.py`` has already checked.

Two routes by k (``route``), counted in ``ROUTE_LAUNCHES``: ``fused``
(k <= ``FUSED_K_MAX``: one kernel sums and selects, ``launch_topk``; the
candidates of a query split across blocks by ``plan`` where Q is small)
and ``matrix`` (the (Q, L) distance matrix, ``launch_dist``, for B5's
int32 key mode to select on).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gemm import sm_count

_QSTEPS = 255                  # LUT values live on the 0..255 integer step


def adc_dmax(m: int) -> int:
    """Invalid-candidate sentinel: one past the largest reachable ADC
    distance (``m`` subspaces x 255 steps)."""
    return m * _QSTEPS + 1


def packed_cols_limit(m: int) -> int:
    """The reference's largest candidate block ``bl`` whose packed key
    ``dist * bl + lane`` fits int32 (dist <= adc_dmax(m))."""
    return (2 ** 31 - 1) // (adc_dmax(m) + 1)


_STEM = "adc_topk"
FUSED_K_MAX = 256       # the fused route's longest list (the source's)
MERGE_KEYS = 2048       # n_splits * k is at most this (the split merge's)
MIN_SPAN = 2048         # candidates: no split of a query is shorter
SPAN_ALIGN = 32         # splits are whole multiples of this many
BLOCKS_PER_SM = 4       # split queries until about this many blocks an SM

# launches per route since the last ``ops.reset_launches``
ROUTE_LAUNCHES: Dict[str, int] = {"fused": 0, "matrix": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_fns = {}


def _bind(name: str, argtypes):
    if name not in _fns:
        for const, want in (("adc_fused_k_max", FUSED_K_MAX),
                            ("adc_merge_keys", MERGE_KEYS)):
            got = _build.bind(_STEM, const, [])()
            if got != want:
                raise RuntimeError(f"{const}() = {got} in the built "
                                   f"library, the wrapper expects {want}")
        _fns[name] = _build.bind(_STEM, name, argtypes)
    return _fns[name]


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def lut_in_smem(m: int, n_codes: int) -> bool:
    """Whether the fused route stages a LUT of ``m`` subspaces in shared
    memory, as one byte an entry for LUT entries in 0..255 (else it reads
    the LUT from device memory)."""
    fn = _build.bind(_STEM, "adc_lut_in_smem", [_I, _I])
    return bool(fn(m, n_codes))


def route(k: int) -> str:
    """``fused`` for k <= ``FUSED_K_MAX``, else ``matrix``."""
    return "fused" if k <= FUSED_K_MAX else "matrix"


def plan(Q: int, L: int, k: int, sms: int) -> Tuple[int, int]:
    """(n_splits, span) of the fused route: split each query's L
    candidates into n_splits spans of ``span`` (a multiple of
    ``SPAN_ALIGN``; the last may be shorter, none is empty) until the grid
    (Q x n_splits) holds about ``BLOCKS_PER_SM`` blocks on each of ``sms``
    SMs, with no span under ``MIN_SPAN`` candidates and n_splits * k <=
    ``MERGE_KEYS``, the keys the split merge sorts."""
    want = max(1, -(-BLOCKS_PER_SM * sms // Q))
    want = min(want, max(1, MERGE_KEYS // k), max(1, L // MIN_SPAN))
    span = -(-(-(-L // want)) // SPAN_ALIGN) * SPAN_ALIGN
    return -(-L // span), span


def launch_topk(qlut: torch.Tensor, codes: torch.Tensor,
                cand_ids: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B8's fused route: qlut (Q, m*n_codes) int32, codes (Q, L, m) int8
    (code - 128), cand_ids (Q, L) int32 on the card, k <= ``FUSED_K_MAX``
    -> (ADC distances (Q, k) int32, positions (Q, k) int32), ascending,
    ties to the smallest position."""
    fn = _bind("adc_topk_i32", [_P] * 6 + [_I] * 7 + [_P])
    Q, L, m = codes.shape
    n_codes = qlut.shape[1] // m
    n_splits, span = plan(Q, L, k, sm_count(codes.device))
    vals = torch.empty((Q, k), dtype=torch.int32, device=codes.device)
    idx = torch.empty((Q, k), dtype=torch.int32, device=codes.device)
    part = torch.empty((Q, n_splits * k), dtype=torch.int64,
                       device=codes.device) if n_splits > 1 else None
    err = fn(qlut.data_ptr(), codes.data_ptr(), cand_ids.data_ptr(),
             vals.data_ptr(), idx.data_ptr(),
             None if part is None else part.data_ptr(), Q, L, m, n_codes, k,
             n_splits, span, _stream())
    _build.check(_STEM, err, f"adc_topk Q={Q} L={L} m={m} n_codes={n_codes} "
                             f"k={k} splits={n_splits}")
    ROUTE_LAUNCHES["fused"] += 1
    return vals, idx


def launch_dist(qlut: torch.Tensor, codes: torch.Tensor,
                cand_ids: torch.Tensor) -> torch.Tensor:
    """B8's matrix route: qlut (Q, m*n_codes) int32, codes (Q, L, m) int8
    (code - 128), cand_ids (Q, L) int32 on the card -> (Q, L) int32 ADC
    distances, ``adc_dmax(m)`` where the id is negative."""
    fn = _bind("adc_dist_i32", [_P] * 4 + [_I] * 4 + [_P])
    Q, L, m = codes.shape
    n_codes = qlut.shape[1] // m
    out = torch.empty((Q, L), dtype=torch.int32, device=codes.device)
    err = fn(qlut.data_ptr(), codes.data_ptr(), cand_ids.data_ptr(),
             out.data_ptr(), Q, L, m, n_codes, _stream())
    _build.check(_STEM, err, f"adc_dist Q={Q} L={L} m={m} "
                             f"n_codes={n_codes}")
    ROUTE_LAUNCHES["matrix"] += 1
    return out
