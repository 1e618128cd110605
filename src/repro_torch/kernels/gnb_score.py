"""Launcher of the CUDA kernel B3 (batched GNB joint log-likelihood) in
``csrc/gnb_score.cu``.

Counterpart of the JAX package's ``kernels/gnb_score.py``.  Takes fp32,
contiguous CUDA tensors that ``kernels/ops.py`` has already checked.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_STEM = "gnb_score"
_P, _I = ctypes.c_void_p, ctypes.c_int
_fns = {}


def launch_scores_batch(X: torch.Tensor, mu: torch.Tensor,
                        var: torch.Tensor, log_prior: torch.Tensor
                        ) -> torch.Tensor:
    """B3: X (B, d), mu/var (C, d), log_prior (C,) fp32 on the card ->
    (B, C) joint log-likelihood."""
    if "scores" not in _fns:
        _fns["scores"] = _build.bind(_STEM, "gnb_scores_batch_f32",
                                     [_P] * 5 + [_I] * 3 + [_P])
    B, d = X.shape
    C = mu.shape[0]
    out = torch.empty((B, C), dtype=torch.float32, device=X.device)
    err = _fns["scores"](X.data_ptr(), mu.data_ptr(), var.data_ptr(),
                         log_prior.data_ptr(), out.data_ptr(), B, C, d,
                         torch.cuda.current_stream().cuda_stream)
    _build.check(_STEM, err, f"gnb_scores_batch B={B} C={C} d={d}")
    return out
