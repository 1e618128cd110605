"""Gaussian Naive Bayes (paper §4.3, Fig. 5).

OP1 splits the per-feature class-conditional terms across cores into
R[n_cores, C]; OP2 combines the partials with the prior; OP3 is the
argmax.  Log-likelihoods are accumulated instead of densities (at d = 784
the product of densities underflows fp32), as in the JAX package's
``core/gnb.py``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.distribution import pad_to_multiple, split_chunks
from repro_torch.kernels import dispatch

_LOG2PI = math.log(2.0 * math.pi)


class GNBModel(NamedTuple):
    mu: torch.Tensor         # (n_class, d)
    var: torch.Tensor        # (n_class, d)
    log_prior: torch.Tensor  # (n_class,)


def fit_gnb(X: torch.Tensor, y: torch.Tensor, n_class: int,
            var_smoothing: float = 1e-6) -> GNBModel:
    """Maximum-likelihood per-class mean and variance.  ``jnp.var`` in the
    reference is the population variance: ``correction=0``."""
    X = X.to(torch.float32)
    onehot = (y.long()[:, None] == torch.arange(n_class, device=X.device)
              ).to(torch.float32)                       # (N, C)
    counts = onehot.sum(dim=0)
    mu = (onehot.T @ X) / counts[:, None]
    ex2 = (onehot.T @ (X * X)) / counts[:, None]
    var = ex2 - mu ** 2 + var_smoothing * torch.max(
        torch.var(X, dim=0, correction=0))
    log_prior = torch.log(counts / X.shape[0])
    return GNBModel(mu=mu, var=var, log_prior=log_prior)


def _log_gaussian(x, mu, var):
    return -0.5 * ((x - mu) ** 2 / var + torch.log(var) + _LOG2PI)


def gnb_decision(model: GNBModel, x: torch.Tensor, n_cores: int = 8):
    """Fig. 5 for one query x (d,): OP1 per-chunk partial feature sums,
    OP2 prior combine, OP3 argmax.  Returns (class, joint log-likelihood
    (n_class,))."""
    d = model.mu.shape[1]
    mup, _ = pad_to_multiple(model.mu, n_cores, axis=1)
    varp, _ = pad_to_multiple(model.var, n_cores, axis=1, value=1.0)
    xp, _ = pad_to_multiple(x, n_cores, axis=0)
    mask = torch.arange(mup.shape[1], device=x.device) < d

    mu_c = split_chunks(mup, n_cores, axis=1)           # (C, n, d/n)
    var_c = split_chunks(varp, n_cores, axis=1)
    x_c = split_chunks(xp, n_cores, axis=0)             # (n, d/n)
    m_c = split_chunks(mask, n_cores, axis=0)

    # OP1 — per-core partial sums -> R (n_cores, C); padding masked out
    R = torch.stack([
        torch.where(m_c[j][None, :],
                    _log_gaussian(x_c[j][None, :], mu_c[:, j], var_c[:, j]),
                    0.0).sum(dim=1)
        for j in range(n_cores)])

    # OP2 — combine the partials with the log-prior; OP3 — argmax
    y = R.sum(dim=0) + model.log_prior
    return torch.argmax(y).to(torch.int32), y


def gnb_predict_batch(model: GNBModel, X: torch.Tensor,
                      n_cores: int = 8) -> torch.Tensor:
    """The Fig. 5 pipeline for each query of X (B, d) -> classes (B,)
    int32 (one ``gnb_decision`` a query)."""
    return torch.stack([gnb_decision(model, x, n_cores)[0] for x in X])


def gnb_classify_batch(model: GNBModel, X: torch.Tensor, *, policy=None,
                       path: str | None = None):
    """X (B, d) through the registry (its ``blocked`` arm is the CUDA
    kernel B3) -> (classes (B,) int32, joint log-likelihood (B, C))."""
    scores = dispatch.gnb_scores(X, model.mu, model.var, model.log_prior,
                                 policy=policy, path=path)
    return torch.argmax(scores, dim=1).to(torch.int32), scores
