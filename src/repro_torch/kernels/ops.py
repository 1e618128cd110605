"""Public wrappers of the port's kernels.

Each wrapper checks device, dtype, shape and contiguity, then
  * for CUDA tensors launches its hand-written kernel (``csrc/``) and adds
    one to its count in ``LAUNCHES``; a failed build or launch raises,
    nothing falls back;
  * for CPU tensors runs the kernel's plain PyTorch version
    (``kernels/ref.py``).
bf16 inputs are upcast to fp32 before the kernel, as the Pallas kernels
upcast inside, so both dtypes give the fp32 arithmetic.

Counterpart of the JAX package's ``kernels/ops.py``.  The Hopper kernels
mask ragged edges themselves, so none of that module's padding to block
multiples (or the GNB padding correction) is needed.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.distance_topk import TOPK_K_MAX

# kernel launches per wrapper since the last reset: what a run reads to
# show that its main path went through the kernels
LAUNCHES: Dict[str, int] = {"distance_topk": 0, "distance_argmin": 0,
                            "gnb_scores_batch": 0}

_FLOATS = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(op: str, **tensors: Tuple[torch.Tensor, int]) -> torch.device:
    """Each argument is (tensor, ndim); all on one device, float32/bf16,
    contiguous.  Returns the device."""
    device = None
    for name, (t, ndim) in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{op}: {name} must be a torch.Tensor")
        if t.ndim != ndim:
            raise ValueError(f"{op}: {name} must be {ndim}-D, got "
                             f"{tuple(t.shape)}")
        if t.dtype not in _FLOATS:
            raise TypeError(f"{op}: {name} has dtype {t.dtype}; float32 or "
                            "bfloat16 expected")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{op}: {name} is on {t.device}, the other "
                             f"inputs on {device}")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{op}: unsupported device {device}")
    return device


def distance_topk(a: torch.Tensor, c: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A (N, d) data rows, C (Q, d) queries -> the k nearest rows per
    query: (values (Q, k) f32, row indices (Q, k) int32), ascending,
    ties to the smallest row.  k is at most ``TOPK_K_MAX``."""
    dev = _check("distance_topk", a=(a, 2), c=(c, 2))
    N, d = a.shape
    if c.shape[1] != d:
        raise ValueError(f"distance_topk: a is {tuple(a.shape)}, c is "
                         f"{tuple(c.shape)}")
    if not 1 <= k <= min(N, TOPK_K_MAX):
        raise ValueError(f"distance_topk: k={k} outside [1, min(N={N}, "
                         f"{TOPK_K_MAX})]; larger k goes to the 'ref' arm")
    if dev.type == "cpu":
        return ref.distance_topk(a, c, k)
    from repro_torch.kernels import distance_topk as _dt
    out = _dt.launch_topk(a.float(), c.float(), k)
    LAUNCHES["distance_topk"] += 1
    return out


def distance_argmin(a: torch.Tensor, c: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A (N, d), centroids C (K, d) -> (min sq-dist (N,) f32, nearest id
    (N,) int32), first index on ties."""
    dev = _check("distance_argmin", a=(a, 2), c=(c, 2))
    if c.shape[1] != a.shape[1] or a.shape[0] < 1 or c.shape[0] < 1:
        raise ValueError(f"distance_argmin: a is {tuple(a.shape)}, c is "
                         f"{tuple(c.shape)}")
    if dev.type == "cpu":
        return ref.distance_argmin(a, c)
    from repro_torch.kernels import distance_topk as _dt
    out = _dt.launch_argmin(a.float(), c.float())
    LAUNCHES["distance_argmin"] += 1
    return out


def gnb_scores_batch(X: torch.Tensor, mu: torch.Tensor, var: torch.Tensor,
                     log_prior: torch.Tensor) -> torch.Tensor:
    """X (B, d) queries, mu/var (C, d), log_prior (C,) -> (B, C) joint
    log-likelihood."""
    dev = _check("gnb_scores_batch", X=(X, 2), mu=(mu, 2), var=(var, 2),
                 log_prior=(log_prior, 1))
    C, d = mu.shape
    if X.shape[1] != d or var.shape != mu.shape or log_prior.shape[0] != C \
            or X.shape[0] < 1:
        raise ValueError(f"gnb_scores_batch: X {tuple(X.shape)}, mu "
                         f"{tuple(mu.shape)}, var {tuple(var.shape)}, "
                         f"log_prior {tuple(log_prior.shape)}")
    if dev.type == "cpu":
        return ref.gnb_scores_batch(X, mu, var, log_prior)
    from repro_torch.kernels import gnb_score as _gs
    out = _gs.launch_scores_batch(X.float(), mu.float(), var.float(),
                                  log_prior.float())
    LAUNCHES["gnb_scores_batch"] += 1
    return out
