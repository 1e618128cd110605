"""Launchers of the CUDA kernels B1 (distance -> top-k) and B2 (distance ->
argmin) in ``csrc/distance_topk.cu``.

Counterpart of the JAX package's ``kernels/distance_topk.py``.  These
functions take fp32, contiguous CUDA tensors that ``kernels/ops.py`` has
already checked, allocate outputs and scratch with ``torch.empty``, and
launch on the current stream; they never synchronise.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels import _build

_STEM = "distance_topk"
# the longest per-query list B1 keeps (TOPK_K_MAX in the source); the
# library's own value is checked against this at first bind
TOPK_K_MAX = 32
_LISTS_PER_SPLIT = 8     # RL in the source: one partial list per row lane
_TILE_ROWS = 64
_BLOCKS_PER_SM = 4       # B1 splits N until about this many blocks per SM

_P, _I = ctypes.c_void_p, ctypes.c_int
_fns = {}


def _fn(name: str, argtypes):
    if name not in _fns:
        for const, want in (("distance_topk_k_max", TOPK_K_MAX),
                            ("distance_topk_lists_per_split",
                             _LISTS_PER_SPLIT),
                            ("distance_topk_tile_rows", _TILE_ROWS)):
            got = _build.bind(_STEM, const, [])()
            if got != want:
                raise RuntimeError(f"{const}() = {got} in the built "
                                   f"library, the wrapper expects {want}")
        _fns[name] = _build.bind(_STEM, name, argtypes)
    return _fns[name]


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def split_rows(N: int, Q: int, sm_count: int) -> Tuple[int, int]:
    """(n_splits, rows_per_split) for B1: split N across blocks until the
    grid holds about ``_BLOCKS_PER_SM`` blocks per SM, in whole 64-row
    tiles."""
    q_tiles = -(-Q // 32)
    tiles = -(-N // _TILE_ROWS)
    want = max(1, min(tiles, math.ceil(_BLOCKS_PER_SM * sm_count / q_tiles)))
    rows_per_split = -(-tiles // want) * _TILE_ROWS
    return -(-N // rows_per_split), rows_per_split


def launch_topk(a: torch.Tensor, c: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1: a (N, d), c (Q, d) fp32 on the card -> (vals (Q, k) f32,
    idx (Q, k) int32), ascending by (value, row)."""
    fn = _fn("distance_topk_f32", [_P] * 6 + [_I] * 6 + [_P])
    N, d = a.shape
    Q = c.shape[0]
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    n_splits, rows_per_split = split_rows(N, Q, sms)
    n_cand = n_splits * _LISTS_PER_SPLIT * k
    part_v = torch.empty((Q, n_cand), dtype=torch.float32, device=a.device)
    part_i = torch.empty((Q, n_cand), dtype=torch.int32, device=a.device)
    vals = torch.empty((Q, k), dtype=torch.float32, device=a.device)
    idx = torch.empty((Q, k), dtype=torch.int32, device=a.device)
    err = fn(a.data_ptr(), c.data_ptr(), part_v.data_ptr(),
             part_i.data_ptr(), vals.data_ptr(), idx.data_ptr(),
             N, Q, d, k, n_splits, rows_per_split, _stream())
    _build.check(_STEM, err, f"distance_topk N={N} Q={Q} d={d} k={k}")
    return vals, idx


def launch_argmin(a: torch.Tensor, c: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2: a (N, d), c (K, d) fp32 on the card -> (min sq-dist (N,) f32,
    nearest id (N,) int32), first index on ties."""
    fn = _fn("distance_argmin_f32", [_P] * 4 + [_I] * 3 + [_P])
    N, d = a.shape
    K = c.shape[0]
    vals = torch.empty((N,), dtype=torch.float32, device=a.device)
    idx = torch.empty((N,), dtype=torch.int32, device=a.device)
    err = fn(a.data_ptr(), c.data_ptr(), vals.data_ptr(), idx.data_ptr(),
             N, K, d, _stream())
    _build.check(_STEM, err, f"distance_argmin N={N} K={K} d={d}")
    return vals, idx
