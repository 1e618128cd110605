"""Plain PyTorch versions of the kernels' functions: what a wrapper runs
for CPU tensors, and the yardstick a kernel is held against on the card.

The arithmetic follows the JAX package's ``kernels/ref.py`` term for term
(same expansion, same operand order, fp32 accumulation); bf16 inputs are
upcast to fp32 first, as the Pallas kernels do inside.  The int8 lattice
and ADC versions (the oracles of ``kernels/quantized.py`` and
``kernels/ann.py`` there) compute exact integers on both devices.  The LM
stack's ``matmul`` (B10) and ``attention`` (B11) keep bf16 operands as
they are and form the fp32 product of them, rounded once to the
operands' dtype, as the reference's oracles do.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.topk import topk_smallest_stable
from repro_torch.kernels.ann import adc_dmax

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


def topk_smallest(x: torch.Tensor, k: int):
    """(R, n) -> the k smallest of each row as (values (R, k), indices
    (R, k) int32): ascending, ties to the first index, NaN after every
    number, indices always distinct (the ``lax.top_k`` rule of the JAX
    package's oracle).  Values are f32, or int32 for int32 rows (B5's
    int32 key mode)."""
    if x.dtype != torch.int32:
        x = x.to(torch.float32)
    return topk_smallest_stable(x, k, dim=1)


def distance_topk(a: torch.Tensor, c: torch.Tensor, k: int):
    """(N, d) data, (Q, d) queries -> the k nearest rows per query as
    (values (Q, k) f32, row indices (Q, k) int32), ascending, ties to the
    smallest row."""
    e = pairwise_sq_dist(a, c)                    # (N, Q)
    return topk_smallest_stable(e.T, k, dim=1)


def distance_argmin(a: torch.Tensor, c: torch.Tensor):
    """(N, d), (K, d) -> (min sq-dist (N,) f32, nearest id (N,) int32);
    the first index on ties.  B2's rule for NaN (ROADMAP C4): a NaN
    distance is never the nearest, so a row whose distances are all NaN
    takes centroid 0 at distance +inf, as the kernel's strict ``<`` scan
    from (+inf, 0) leaves it."""
    e = pairwise_sq_dist(a, c)                    # (N, K)
    e = torch.where(torch.isnan(e), torch.full_like(e, float("inf")), e)
    idx = torch.argmin(e, dim=1)
    return e.gather(1, idx[:, None])[:, 0], idx.to(torch.int32)


def gnb_scores(x: torch.Tensor, mu: torch.Tensor, var: torch.Tensor,
               log_prior: torch.Tensor) -> torch.Tensor:
    """(d,), (C, d), (C, d), (C,) -> (C,) joint log-likelihood of one
    query."""
    x, mu, var = (t.to(torch.float32) for t in (x, mu, var))
    t = -0.5 * ((x[None, :] - mu) ** 2 / var + torch.log(var) + _LOG2PI)
    return torch.sum(t, dim=1) + log_prior.to(torch.float32)


def gnb_scores_batch(X: torch.Tensor, mu: torch.Tensor, var: torch.Tensor,
                     log_prior: torch.Tensor) -> torch.Tensor:
    """(B, d), (C, d), (C, d), (C,) -> (B, C) joint log-likelihood."""
    X, mu, var = (t.to(torch.float32) for t in (X, mu, var))
    t = -0.5 * ((X[:, None, :] - mu[None]) ** 2 / var[None]
                + torch.log(var)[None] + _LOG2PI)
    return torch.sum(t, dim=2) + log_prior.to(torch.float32)[None, :]


# ---------------------------------------------------------------------------
# Grouped (multi-tenant) versions of B1, B2 and B3: G same-shape tenants
# along a leading axis, the arithmetic of the functions above batched over
# it term for term
# ---------------------------------------------------------------------------


def pairwise_sq_dist_group(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(G, N, d), (G, K, d) -> (G, N, K) squared distances as
    ``‖a‖² − 2a·c + ‖c‖²``, tenant by tenant."""
    a = a.to(torch.float32)
    c = c.to(torch.float32)
    an = torch.sum(a * a, dim=2, keepdim=True)
    cn = torch.sum(c * c, dim=2)[:, None, :]
    cross = a @ c.transpose(1, 2)
    return an - 2.0 * cross + cn


def distance_topk_group(a: torch.Tensor, c: torch.Tensor, k: int):
    """(G, N, d) data, (G, Q, d) queries -> each tenant's k nearest rows
    per query, (values (G, Q, k) f32, row indices (G, Q, k) int32)."""
    e = pairwise_sq_dist_group(a, c)              # (G, N, Q)
    return topk_smallest_stable(e.transpose(1, 2), k, dim=2)


def distance_argmin_group(a: torch.Tensor, c: torch.Tensor):
    """(G, N, d), (G, K, d) -> (min sq-dist (G, N) f32, nearest id (G, N)
    int32), ``distance_argmin``'s rules tenant by tenant."""
    e = pairwise_sq_dist_group(a, c)              # (G, N, K)
    e = torch.where(torch.isnan(e), torch.full_like(e, float("inf")), e)
    idx = torch.argmin(e, dim=2)
    return e.gather(2, idx[..., None])[..., 0], idx.to(torch.int32)


def gnb_scores_batch_group(X: torch.Tensor, mu: torch.Tensor,
                           var: torch.Tensor,
                           log_prior: torch.Tensor) -> torch.Tensor:
    """(G, B, d), (G, C, d), (G, C, d), (G, C) -> (G, B, C) joint
    log-likelihood, tenant by tenant."""
    X, mu, var = (t.to(torch.float32) for t in (X, mu, var))
    t = -0.5 * ((X[:, :, None, :] - mu[:, None]) ** 2 / var[:, None]
                + torch.log(var)[:, None] + _LOG2PI)
    return torch.sum(t, dim=3) + log_prior.to(torch.float32)[:, None, :]


# ---------------------------------------------------------------------------
# int8 lattice (B6, B7) and IVF-PQ ADC (B8)
# ---------------------------------------------------------------------------


def _lattice_dist(a8: torch.Tensor, c8: torch.Tensor) -> torch.Tensor:
    """(N, d), (Q, d) int8 -> (Q, N) int32 exact lattice distances
    ``‖a‖² − 2a·c + ‖c‖²``.  ``torch.matmul`` has no int32 kernel on the
    card, so the terms are formed in float64, which holds every one of
    them exactly (|a·c| <= d·127² < 2^53), and cast back."""
    a = a8.to(torch.float64)
    c = c8.to(torch.float64)
    an = torch.sum(a * a, dim=1)[None, :]
    cn = torch.sum(c * c, dim=1)[:, None]
    return (an - 2.0 * (c @ a.T) + cn).to(torch.int32)


def distance_topk_q8(a8: torch.Tensor, c8: torch.Tensor, k: int):
    """int8 rows (N, d), int8 queries (Q, d) -> the k nearest rows per
    query as (lattice distances (Q, k) int32, rows (Q, k) int32),
    ascending, ties to the smallest row."""
    return topk_smallest_stable(_lattice_dist(a8, c8), k, dim=1)


def distance_argmin_q8(a8: torch.Tensor, c8: torch.Tensor):
    """int8 rows (N, d), int8 centroids (K, d) -> (lattice distance (N,)
    int32, nearest centroid (N,) int32), first index on ties."""
    e = _lattice_dist(c8, a8)                     # (N, K)
    idx = torch.argmin(e, dim=1)
    return e.gather(1, idx[:, None])[:, 0], idx.to(torch.int32)


def adc_topk(qlut: torch.Tensor, codes: torch.Tensor,
             cand_ids: torch.Tensor, k: int):
    """Per-query LUTs (Q, m*n_codes) int32, candidate codes (Q, L, m) int8
    (stored code - 128), candidate ids (Q, L) int32 -> (ADC distances
    (Q, k) int32, candidate positions (Q, k) int32): the sum of each
    candidate's m LUT entries, ``adc_dmax(m)`` where the id is negative,
    ascending, ties to the smallest position.  A code past n_codes - 1 is
    held to n_codes - 1, as the kernel does (valid fits never produce
    one).  One gather per subspace keeps the index tensors at (Q, L)."""
    Q, L, m = codes.shape
    n_codes = qlut.shape[1] // m
    lut = qlut.to(torch.int32)
    dist = torch.zeros((Q, L), dtype=torch.int32, device=codes.device)
    for j in range(m):
        col = (codes[:, :, j].to(torch.int64) + 128).clamp_(
            max=n_codes - 1) + j * n_codes
        dist += torch.gather(lut, 1, col)
    dist = torch.where(cand_ids < 0, adc_dmax(m), dist)
    return topk_smallest_stable(dist, k, dim=1)


# ---------------------------------------------------------------------------
# LM stack: GEMM (B10) and causal attention (B11)
# ---------------------------------------------------------------------------


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) in a's dtype: the fp32 product of the
    operands (bf16 products are exact in fp32), rounded once."""
    return (a.to(torch.float32) @ b.to(torch.float32)).to(a.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """(B, H, S, d) x3 -> (B, H, S, d) in q's dtype, in the reference's
    order: fp32 scores scaled by 1/sqrt(d), masked to -1e30 above the
    diagonal, an fp32 softmax, p cast to v's dtype, then P·V with an fp32
    accumulator."""
    S, d = q.shape[-2], q.shape[-1]
    s = torch.matmul(q.to(torch.float32),
                     k.to(torch.float32).transpose(-1, -2)) * \
        (1.0 / math.sqrt(d))
    if causal:
        keep = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.to(torch.float32),
                        v.to(torch.float32)).to(q.dtype)
