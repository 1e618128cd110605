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
each row's log-sum-exp and rowsum(dO * o) between the kernels of a call.
Launches on the current stream without synchronising.

Two routes, by a stated rule (``route``): ``wgmma`` (two launches on the
tensor cores, P and dS each split into two bf16 terms) where
``uses_tensor_cores`` holds, ``cuda_core`` (three launches of fp32 sums on
the CUDA cores) otherwise; any d <= ``D_MAX``.  A wgmma launch that fails
raises: nothing retries it on the other route.  ``ROUTE_LAUNCHES`` counts
launches per route, beside ``ops.LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build

_STEM = "flash_attention_bwd"
_P, _I = ctypes.c_void_p, ctypes.c_int
_fns: Dict[str, ctypes._CFuncPtr] = {}

D_MAX = 256           # head dims up to which the kernels run
WGMMA_D_MAX = 128     # head dims of the wgmma route
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches per route since the last ``ops.reset_launches``
ROUTE_LAUNCHES: Dict[str, int] = {"wgmma": 0, "cuda_core": 0}


def uses_tensor_cores(*ts: torch.Tensor) -> bool:
    """Whether the wgmma kernels take these tensors: bf16, d a multiple of
    16 up to ``WGMMA_D_MAX`` (past it the dK and dV sums, two 64 x d fp32
    accumulators, do not fit a thread's registers), every (batch, head,
    position) stride a multiple of 8 elements and every base 16-byte
    aligned (B11's TMA rules).  Any other dtype, d or layout takes the
    CUDA-core kernels."""
    d = ts[0].shape[-1]
    return (ts[0].dtype == torch.bfloat16 and d % 16 == 0 and
            d <= WGMMA_D_MAX and
            all(s % 8 == 0 for t in ts for s in t.stride()[:3]) and
            all(t.data_ptr() % 16 == 0 for t in ts))


def route(*ts: torch.Tensor) -> str:
    """The route the tensors of a call (q, k, v, o, dO and the outputs)
    take: ``wgmma`` or ``cuda_core``."""
    return "wgmma" if uses_tensor_cores(*ts) else "cuda_core"


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           o: torch.Tensor, do: torch.Tensor, causal: bool,
           way: Optional[str] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B12: q, k, v, o, dO (B, H, S, d) on the card -> (dq, dk, dv) in
    their dtype.  ``way`` names the route (by default ``route``'s; naming
    ``cuda_core`` checks and times that route on inputs the rule sends to
    wgmma)."""
    if "bwd" not in _fns:
        _fns["bwd"] = _build.bind(
            _STEM, "flash_attention_bwd",
            [_I] * 2 + [_P] * 10 + [_I] * 5 + [ctypes.c_float, _P, _P])
    B, H, S, d = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    ts = (q, k, v, o, do, dq, dk, dv)
    way = way or route(*ts)
    strides = (ctypes.c_longlong * 24)(
        *(s for t in ts for s in t.stride()[:3]))
    err = _fns["bwd"](_DTYPES[q.dtype], int(way == "wgmma"), q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                      dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                      lse.data_ptr(), delta.data_ptr(), B, H, S, d,
                      int(causal), 1.0 / math.sqrt(d), strides,
                      torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(_STEM, err, f"flash_attention_bwd B={B} H={H} S={S} d={d} "
                             f"{q.dtype} causal={causal} {way}")
    ROUTE_LAUNCHES[way] += 1
    return dq, dk, dv
