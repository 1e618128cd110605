"""Plain PyTorch versions of the kernels' functions: what a wrapper runs
for CPU tensors, and the yardstick a kernel is held against on the card.

The arithmetic follows the JAX package's ``kernels/ref.py`` term for term
(same expansion, same operand order, fp32 accumulation); bf16 inputs are
upcast to fp32 first, as the Pallas kernels do inside.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.topk import topk_smallest_stable

# A float32 matmul (or convolution) on the card may otherwise run in TF32,
# which keeps about three decimal digits: the plain versions must stay full
# fp32, or their neighbour indices stop agreeing with the kernels'.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_LOG2PI = math.log(2.0 * math.pi)


def pairwise_sq_dist(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(N, d), (K, d) -> (N, K) squared Euclidean distances as
    ``‖a‖² − 2a·c + ‖c‖²``."""
    a = a.to(torch.float32)
    c = c.to(torch.float32)
    an = torch.sum(a * a, dim=1, keepdim=True)
    cn = torch.sum(c * c, dim=1)[None, :]
    cross = a @ c.T
    return an - 2.0 * cross + cn


def distance_topk(a: torch.Tensor, c: torch.Tensor, k: int):
    """(N, d) data, (Q, d) queries -> the k nearest rows per query as
    (values (Q, k) f32, row indices (Q, k) int32), ascending, ties to the
    smallest row."""
    e = pairwise_sq_dist(a, c)                    # (N, Q)
    return topk_smallest_stable(e.T, k, dim=1)


def distance_argmin(a: torch.Tensor, c: torch.Tensor):
    """(N, d), (K, d) -> (min sq-dist (N,) f32, nearest id (N,) int32);
    ``torch.argmin`` returns the first index on ties."""
    e = pairwise_sq_dist(a, c)                    # (N, K)
    idx = torch.argmin(e, dim=1)
    return e.gather(1, idx[:, None])[:, 0], idx.to(torch.int32)


def gnb_scores_batch(X: torch.Tensor, mu: torch.Tensor, var: torch.Tensor,
                     log_prior: torch.Tensor) -> torch.Tensor:
    """(B, d), (C, d), (C, d), (C,) -> (B, C) joint log-likelihood."""
    X, mu, var = (t.to(torch.float32) for t in (X, mu, var))
    t = -0.5 * ((X[:, None, :] - mu[None]) ** 2 / var[None]
                + torch.log(var)[None] + _LOG2PI)
    return torch.sum(t, dim=2) + log_prior.to(torch.float32)[None, :]
