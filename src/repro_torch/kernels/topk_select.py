"""Launcher of the CUDA kernel B5 (the k smallest of each row) in
``csrc/topk_select.cu``.

Counterpart of the JAX package's ``kernels/topk_select.py``.  Takes an
fp32 CUDA tensor whose rows are contiguous (any row stride, so the
transposed view of B4's column-major output goes in as it is), checked by
``kernels/ops.py``; an int32 tensor takes the int32 key mode (the exact
lattice distances of B6 and the ADC distances of B8).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

_STEM = "topk_select"
_P, _I = ctypes.c_void_p, ctypes.c_int
_fns = {}


def launch(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """B5: x (R, n) fp32 or int32 on the card with ``x.stride(1) == 1`` ->
    (values (R, k) of x's dtype, indices (R, k) int32), ascending, ties to
    the first index, NaN last, indices distinct; 1 <= k <= n."""
    name = "topk_smallest_i32" if x.dtype == torch.int32 \
        else "topk_smallest_f32"
    if name not in _fns:
        _fns[name] = _build.bind(
            _STEM, name, [_P, ctypes.c_longlong, _I, _I, _I, _P, _P, _P])
    R, n = x.shape
    vals = torch.empty((R, k), dtype=x.dtype, device=x.device)
    idx = torch.empty((R, k), dtype=torch.int32, device=x.device)
    ld = x.stride(0) if R > 1 else n
    err = _fns[name](x.data_ptr(), ld, R, n, k, vals.data_ptr(),
                     idx.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(_STEM, err, f"topk_smallest R={R} n={n} k={k} ld={ld}")
    return vals, idx
