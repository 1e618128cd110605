"""Launcher of the CUDA kernel B12 (the backward pass of attention) in
``csrc/flash_attention_bwd.cu``.

B12 replaces no Pallas kernel: the JAX package differentiates its jnp
attention with XLA's autodiff.  The port's forward is the hand-written B11,
whose output has no autograd graph, so training needs this kernel
(``kernels/autograd.py`` calls it as B11's backward).  Takes (B, H, S, d)
CUDA tensors of one dtype that ``kernels/ops.py`` has already checked: q,
k, v, the forward's output o and its gradient dO, any (batch, head,
position) strides with the d axis contiguous.  Returns dq, dk, dv, each
allocated with its input's layout; two fp32 (B, H, S) scratch vectors hold
each row's log-sum-exp and rowsum(dO * o) between the three kernels of a
call.  Launches on the current stream without synchronising.  One route:
fp32 sums on the CUDA cores, any d <= ``D_MAX``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

_STEM = "flash_attention_bwd"
_P, _I = ctypes.c_void_p, ctypes.c_int
_fns: Dict[str, ctypes._CFuncPtr] = {}

D_MAX = 256           # head dims up to which the kernels run
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           o: torch.Tensor, do: torch.Tensor, causal: bool
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B12: q, k, v, o, dO (B, H, S, d) on the card -> (dq, dk, dv) in
    their dtype."""
    if "bwd" not in _fns:
        _fns["bwd"] = _build.bind(
            _STEM, "flash_attention_bwd",
            [_I] + [_P] * 10 + [_I] * 5 + [ctypes.c_float, _P, _P])
    B, H, S, d = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    strides = (ctypes.c_longlong * 24)(
        *(s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]))
    err = _fns["bwd"](_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), o.data_ptr(), do.data_ptr(),
                      dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                      lse.data_ptr(), delta.data_ptr(), B, H, S, d,
                      int(causal), 1.0 / math.sqrt(d), strides,
                      torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(_STEM, err, f"flash_attention_bwd B={B} H={H} S={S} d={d} "
                             f"{q.dtype} causal={causal}")
    return dq, dk, dv
