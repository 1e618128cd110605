"""Gaussian Mixture Model via EM: the paper's future-work kernel (§6) in
the same parallel style.

  E-step = GNB's per-class log-likelihood (Fig. 5 OP1/OP2) plus a
           row-chunked responsibility computation (Fig. 6 OP1 layout);
  M-step = K-Means' local accumulate + global combine (Fig. 7 OP3/OP4)
           with soft responsibilities in place of one-hot assignments.

Diagonal covariances, log-space numerics.  Counterpart of the JAX
package's ``core/gmm.py``: the E-step keeps its chunk layout (rows padded
to ``n_cores`` chunks, one batched product over the chunks) and the
M-step sums the chunk partials in chunk order.  ``gmm_fit``'s while loop
is a Python loop that reads the log-likelihood once per EM iteration.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.distribution import pad_to_multiple, split_chunks

_LOG2PI = math.log(2.0 * math.pi)


class GMMState(NamedTuple):
    mu: torch.Tensor        # (k, d)
    var: torch.Tensor       # (k, d) diagonal covariance
    log_pi: torch.Tensor    # (k,) mixture weights
    log_lik: torch.Tensor   # () mean data log-likelihood
    n_iter: torch.Tensor    # () int32


def _log_gauss(x, mu, var):
    """x (..., m, d); mu/var (k, d) -> (..., m, k) component
    log-densities by the GEMM identity: (x - mu)² = x² − 2x·mu + mu²
    gives two products with (d, k) matrices plus an x-free constant.  The
    products sit outside any kernel of the reference, so they are
    ``torch.matmul`` here (full fp32: TF32 is off, ``kernels/ref.py``)."""
    inv = 1.0 / var                                      # (k, d)
    quad = (x * x) @ (-0.5 * inv).T                      # (..., m, k)
    lin = x @ (mu * inv).T
    const = -0.5 * torch.sum(mu * mu * inv + torch.log(var) + _LOG2PI,
                             dim=1)
    return quad + lin + const


def _chunk_sum(parts: torch.Tensor) -> torch.Tensor:
    """Sum a (n_cores, ...) stack of chunk partials in chunk order (the
    OP4 global combine)."""
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def gmm_e_step(A, mu, var, log_pi, n_cores: int = 8):
    """Row-chunked responsibilities (Fig. 6 OP1 layout).  Returns
    (log_resp (N, k), mean log-likelihood ())."""
    Ap, N = pad_to_multiple(A, n_cores, axis=0)
    chunks = split_chunks(Ap, n_cores, axis=0)           # (c, L, d)
    joint = _log_gauss(chunks, mu, var) + log_pi         # (c, L, k)
    norm = torch.logsumexp(joint, dim=2, keepdim=True)
    lr = (joint - norm).reshape(-1, mu.shape[0])[:N]
    ln = norm.reshape(-1)[:N]
    return lr, torch.mean(ln)


def gmm_m_step(A, log_resp, var_floor: float = 1e-6, n_cores: int = 8):
    """Soft-count local accumulate + global combine (Fig. 7 OP3/OP4)."""
    Ap, N = pad_to_multiple(A, n_cores, axis=0)
    Rp, _ = pad_to_multiple(torch.exp(log_resp), n_cores, axis=0)
    a_chunks = split_chunks(Ap, n_cores, axis=0)         # (c, L, d)
    r_chunks = split_chunks(Rp, n_cores, axis=0)         # (c, L, k)
    # OP3 — local accumulate per chunk
    nk_l = torch.sum(r_chunks, dim=1)                    # (c, k)
    rT = r_chunks.transpose(1, 2)
    s1_l = rT @ a_chunks                                 # (c, k, d)
    s2_l = rT @ (a_chunks * a_chunks)
    # OP4 — global combine
    nk, s1, s2 = _chunk_sum(nk_l), _chunk_sum(s1_l), _chunk_sum(s2_l)
    safe = torch.clamp(nk[:, None], min=1e-9)
    mu = s1 / safe
    var = torch.clamp(s2 / safe - mu * mu, min=var_floor)
    log_pi = torch.log(torch.clamp(nk / N, min=1e-12))
    return mu, var, log_pi


def gmm_fit(A, k: int, *, max_iters: int = 100, tol: float = 1e-4,
            n_cores: int = 8) -> Tuple[GMMState, torch.Tensor]:
    """EM until the mean log-likelihood improves by no more than tol, or
    ``max_iters`` iterations.  Initial means = the first k rows, unit
    variances.  Returns (state, responsibilities (N, k))."""
    A = A.to(torch.float32)
    d = A.shape[1]
    dev = A.device
    # the reference compares in fp32: its Python tol is weakly typed
    tol32 = float(np.float32(tol))

    def body(mu, var, log_pi):
        lr, _ = gmm_e_step(A, mu, var, log_pi, n_cores)
        mu, var, log_pi = gmm_m_step(A, lr, n_cores=n_cores)
        _, ll = gmm_e_step(A, mu, var, log_pi, n_cores)
        return mu, var, log_pi, ll

    # one warm-up iteration, so the first test has a meaningful delta
    mu, var, log_pi, ll = body(A[:k].clone(),
                               torch.ones((k, d), device=dev),
                               torch.full((k,), -math.log(k), device=dev))
    prev = torch.tensor(-math.inf, device=dev)
    n_iter = 1
    # one host read of the log-likelihood per iteration
    while float(ll - prev) > tol32 and n_iter < max_iters:
        prev = ll
        mu, var, log_pi, ll = body(mu, var, log_pi)
        n_iter += 1
    lr, _ = gmm_e_step(A, mu, var, log_pi, n_cores)
    state = GMMState(mu=mu, var=var, log_pi=log_pi, log_lik=ll,
                     n_iter=torch.tensor(n_iter, dtype=torch.int32,
                                         device=dev))
    return state, torch.exp(lr)


def gmm_predict(state: GMMState, X, n_cores: int = 8):
    """Most responsible component per row (the chunked E-step)."""
    lr, _ = gmm_e_step(X, state.mu, state.var, state.log_pi, n_cores)
    return torch.argmax(lr, dim=1).to(torch.int32)


def gmm_classify_batch(state: GMMState, X, *, policy=None,
                       path: str | None = None, n_cores: int = 8):
    """Batched component assignment through the registry (its ``blocked``
    arm is the CUDA kernel B3).  Returns (classes (B,) int32,
    log-responsibilities (B, k))."""
    from repro_torch.kernels import dispatch
    lr, _ = dispatch.gmm_responsibilities(state.mu, state.var, state.log_pi,
                                          X, policy=policy, path=path,
                                          n_cores=n_cores)
    return torch.argmax(lr, dim=1).to(torch.int32), lr
