"""Launcher of the CUDA kernel B11 (attention with an online softmax) in
``csrc/flash_attention.cu``.

Counterpart of the JAX package's ``kernels/flash_attention.py``.  Takes
(B, H, S, d) CUDA tensors of one dtype that ``kernels/ops.py`` has already
checked; any (batch, head, position) strides with the d axis contiguous,
so the models' (B, S, H, d) layout goes in as a permuted view.  The output
is allocated with q's layout, so the caller's reshape back to (B, S, H·d)
is a view.  Launches on the current stream without synchronising.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from repro_torch.kernels import _build

_STEM = "flash_attention"
_P, _I = ctypes.c_void_p, ctypes.c_int
_fns: Dict[str, ctypes._CFuncPtr] = {}

D_MAX = 128           # head dims up to which the kernel runs
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def uses_tensor_cores(*ts: torch.Tensor) -> bool:
    """Whether the tensor-core kernel takes these tensors: bf16, d a
    multiple of 16, every (batch, head, position) stride a multiple of 8
    elements and every base 16-byte aligned.  Any other layout or dtype
    takes the CUDA-core kernel."""
    d = ts[0].shape[-1]
    return (ts[0].dtype == torch.bfloat16 and d % 16 == 0 and
            all(s % 8 == 0 for t in ts for s in t.stride()[:3]) and
            all(t.data_ptr() % 16 == 0 for t in ts))


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> torch.Tensor:
    """B11: q, k, v (B, H, S, d) on the card -> (B, H, S, d) in q's
    dtype and layout."""
    if "fwd" not in _fns:
        _fns["fwd"] = _build.bind(
            _STEM, "flash_attention_fwd",
            [_I, _I] + [_P] * 4 + [_I] * 5 + [ctypes.c_float, _P, _P])
    B, H, S, d = q.shape
    out = torch.empty_like(q)
    mma = uses_tensor_cores(q, k, v, out)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    err = _fns["fwd"](_DTYPES[q.dtype], int(mma), q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), B, H, S, d, int(causal),
                      1.0 / math.sqrt(d), strides,
                      torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(_STEM, err, f"flash_attention B={B} H={H} S={S} d={d} "
                             f"{q.dtype} causal={causal} mma={mma}")
    return out
