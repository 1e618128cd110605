"""Launcher of the CUDA kernel B4 (full squared-distance matrix) in
``csrc/pairwise_sq_dist.cu``.

Counterpart of the JAX package's ``kernels/distance.py``.  Takes fp32,
contiguous CUDA tensors that ``kernels/ops.py`` has already checked,
allocates the output with ``torch.empty`` and launches on the current
stream without synchronising.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_STEM = "pairwise_sq_dist"
_P, _I = ctypes.c_void_p, ctypes.c_int
_fns = {}


def launch(a: torch.Tensor, c: torch.Tensor, a_fast: bool) -> torch.Tensor:
    """B4: a (N, d), c (K, d) fp32 on the card -> E (N, K) f32.  With
    ``a_fast`` the kernel writes E's transpose row-major, and E comes back
    as the (N, K) view of that (K, N) buffer: ``E.T`` is contiguous."""
    if "dist" not in _fns:
        _fns["dist"] = _build.bind(_STEM, "pairwise_sq_dist_f32",
                                   [_P] * 3 + [_I] * 4 + [_P])
    N, d = a.shape
    K = c.shape[0]
    shape = (K, N) if a_fast else (N, K)
    out = torch.empty(shape, dtype=torch.float32, device=a.device)
    err = _fns["dist"](a.data_ptr(), c.data_ptr(), out.data_ptr(), N, K, d,
                       int(a_fast), torch.cuda.current_stream().cuda_stream)
    _build.check(_STEM, err, f"pairwise_sq_dist N={N} K={K} d={d} "
                             f"a_fast={a_fast}")
    return out.T if a_fast else out
