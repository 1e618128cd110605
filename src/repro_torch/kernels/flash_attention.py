"""Launcher of the CUDA kernel B11 (attention with an online softmax) in
``csrc/flash_attention.cu``.

Counterpart of the JAX package's ``kernels/flash_attention.py``.  Takes
(B, H, S, d) CUDA tensors of one dtype that ``kernels/ops.py`` has already
checked; any (batch, head, position) strides with the d axis contiguous,
so the models' (B, S, H, d) layout goes in as a permuted view.  The output
is allocated with q's layout, so the caller's reshape back to (B, S, H·d)
is a view.  Launches on the current stream without synchronising.

Two routes, by a stated layout rule (``route``): ``wgmma`` where
``uses_tensor_cores`` holds, ``cuda_core`` otherwise; any d <= ``D_MAX``.
``ROUTE_LAUNCHES`` counts launches per route, beside ``ops.LAUNCHES``.
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

D_MAX = 256           # head dims up to which the kernels run
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches per route since the last ``ops.reset_launches``
ROUTE_LAUNCHES: Dict[str, int] = {"wgmma": 0, "cuda_core": 0}


def uses_tensor_cores(*ts: torch.Tensor) -> bool:
    """Whether the wgmma kernel takes these tensors: bf16, d a multiple of
    16, every (batch, head, position) stride a multiple of 8 elements and
    every base 16-byte aligned (TMA's rules).  Any other layout or dtype
    takes the CUDA-core kernel."""
    d = ts[0].shape[-1]
    return (ts[0].dtype == torch.bfloat16 and d % 16 == 0 and
            all(s % 8 == 0 for t in ts for s in t.stride()[:3]) and
            all(t.data_ptr() % 16 == 0 for t in ts))


def route(*ts: torch.Tensor) -> str:
    """The route q, k, v (and the output) take: ``wgmma`` or
    ``cuda_core``."""
    return "wgmma" if uses_tensor_cores(*ts) else "cuda_core"


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
    way = route(q, k, v, out)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    err = _fns["fwd"](_DTYPES[q.dtype], int(way == "wgmma"), q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, S, d,
                      int(causal), 1.0 / math.sqrt(d), strides,
                      torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(_STEM, err, f"flash_attention B={B} H={H} S={S} d={d} "
                             f"{q.dtype} causal={causal} {way}")
    ROUTE_LAUNCHES[way] += 1
    return out
