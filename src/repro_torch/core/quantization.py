"""Per-estimator int8 calibration: quantized params and their round trips.

Counterpart of the JAX package's ``core/quantization.py``.  Calibration
derives per-feature symmetric scales from the fitted training data
(``fit`` records the feature abs-max; ``from_params`` estimators fall back
to bounds derivable from the params themselves) and rewrites each
estimator's params into the int8 form its quantized serving path takes:

  kNN       -> int8 reference rows on the feature lattice (B6),
  K-Means   -> int8 centroids (B7), plus the mean squared scale that turns
               lattice distances back into feature units,
  GNB / GMM -> fp32 per-class affine score tables over int8 features,
  RF        -> int8 thresholds on the features' lattice (the traversal
               compares int8 against int8).

Every ``quantize_*`` has a ``dequantize_*`` inverse that rebuilds the
original params up to lattice rounding.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core.gmm import GMMState
from repro_torch.core.gnb import GNBModel
from repro_torch.core.kmeans import KMeansState
from repro_torch.core.knn import KNNModel
from repro_torch.core.random_forest import Forest
from repro_torch.kernels import quantized as qk

_LOG2PI = math.log(2.0 * math.pi)


class QuantKNNModel(NamedTuple):
    qa: torch.Tensor        # (N, d) int8 reference rows
    scale: torch.Tensor     # (d,) f32 per-feature symmetric scale
    labels: torch.Tensor    # (N,) int32
    n_class: int


class QuantKMeansParams(NamedTuple):
    qc: torch.Tensor        # (K, d) int8 centroids
    scale: torch.Tensor     # (d,) f32
    dequant: torch.Tensor   # () f32 mean squared scale: lattice -> f32 dist


class QuantGNBParams(NamedTuple):
    quad: torch.Tensor      # (C, d) f32: -0.5 * scale^2 / var
    lin: torch.Tensor       # (C, d) f32: scale * mu / var
    const: torch.Tensor     # (C,) f32: the x-free Gaussian terms
    log_prior: torch.Tensor  # (C,) f32
    scale: torch.Tensor     # (d,) f32


class QuantGMMParams(NamedTuple):
    quad: torch.Tensor      # (k, d) f32
    lin: torch.Tensor       # (k, d) f32
    const: torch.Tensor     # (k,) f32
    log_pi: torch.Tensor    # (k,) f32
    scale: torch.Tensor     # (d,) f32


class QuantForest(NamedTuple):
    feature: torch.Tensor     # (T, M) int32; < 0 marks a leaf (unchanged)
    qthreshold: torch.Tensor  # (T, M) int8 thresholds on the lattice
    left: torch.Tensor        # (T, M) int32
    right: torch.Tensor       # (T, M) int32
    scale: torch.Tensor       # (d,) f32
    n_class: int


QUANT_PARAM_TYPES = (QuantKNNModel, QuantKMeansParams, QuantGNBParams,
                     QuantGMMParams, QuantForest)


def is_quantized_params(params) -> bool:
    return isinstance(params, QUANT_PARAM_TYPES)


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------


def calibrate_absmax(X) -> torch.Tensor:
    """Per-feature abs-max of the training data: what ``fit`` records."""
    return torch.amax(torch.abs(torch.as_tensor(X, dtype=torch.float32)),
                      dim=0)


def gauss_absmax(mu, var, n_sigma: float = 4.0) -> torch.Tensor:
    """Feature range implied by per-class Gaussians, |mu| + n_sigma*sigma,
    max over classes: the fallback when no training data was recorded."""
    return torch.amax(torch.abs(mu) + n_sigma * torch.sqrt(var), dim=0)


def forest_absmax(feature, threshold, d: int) -> torch.Tensor:
    """Per-feature abs-max over the thresholds that test that feature
    (leaves excluded); features never tested get the scale-neutral 1.0."""
    f = feature.reshape(-1)
    t = torch.abs(threshold.reshape(-1).to(torch.float32))
    valid = f >= 0
    out = torch.zeros((d,), dtype=torch.float32, device=t.device)
    out = out.scatter_reduce(0, torch.where(valid, f, 0).long(),
                             torch.where(valid, t, 0.0), reduce="amax")
    return torch.where(out > 0, out, 1.0)


# ---------------------------------------------------------------------------
# kNN and K-Means
# ---------------------------------------------------------------------------


def quantize_knn(model: KNNModel,
                 absmax: Optional[torch.Tensor] = None) -> QuantKNNModel:
    absmax = calibrate_absmax(model.A) if absmax is None else absmax
    scale = qk.feature_scales(absmax)
    return QuantKNNModel(qa=qk.quantize_rows(model.A, scale).contiguous(),
                         scale=scale, labels=model.labels,
                         n_class=model.n_class)


def dequantize_knn(qp: QuantKNNModel) -> KNNModel:
    return KNNModel(A=qk.dequantize_rows(qp.qa, qp.scale), labels=qp.labels,
                    n_class=qp.n_class)


def quantize_kmeans(state: KMeansState,
                    absmax: Optional[torch.Tensor] = None
                    ) -> QuantKMeansParams:
    absmax = calibrate_absmax(state.centroids) if absmax is None else absmax
    scale = qk.feature_scales(absmax)
    return QuantKMeansParams(
        qc=qk.quantize_rows(state.centroids, scale).contiguous(),
        scale=scale, dequant=torch.mean(scale * scale))


def dequantize_kmeans(qp: QuantKMeansParams) -> KMeansState:
    dev = qp.qc.device
    return KMeansState(centroids=qk.dequantize_rows(qp.qc, qp.scale),
                       shift=torch.zeros((), device=dev),
                       n_iter=torch.zeros((), dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# GNB / GMM: the Gaussian log-density as affine tables over the lattice
# ---------------------------------------------------------------------------


def gauss_score_tables(mu, var, scale):
    """Fold the diagonal-Gaussian log-density into per-class affine tables
    over int8 lattice features: with x ~= scale * xq,

      sum_f -0.5*((x-mu)^2/var + log var + log 2pi)
        = sum_f quad[c,f]*xq^2 + lin[c,f]*xq + const[c].
    """
    mu = mu.to(torch.float32)
    var = var.to(torch.float32)
    quad = -0.5 * (scale * scale)[None, :] / var
    lin = (scale[None, :] * mu) / var
    const = -0.5 * torch.sum(mu * mu / var + torch.log(var) + _LOG2PI,
                             dim=1)
    return quad, lin, const


def _tables_to_gauss(quad, lin, scale):
    """Invert ``gauss_score_tables`` (exact up to float rounding)."""
    var = -0.5 * (scale * scale)[None, :] / quad
    mu = lin * var / scale[None, :]
    return mu, var


def quantize_gnb(model: GNBModel,
                 absmax: Optional[torch.Tensor] = None) -> QuantGNBParams:
    absmax = gauss_absmax(model.mu.float(), model.var.float()) \
        if absmax is None else absmax
    scale = qk.feature_scales(absmax)
    quad, lin, const = gauss_score_tables(model.mu, model.var, scale)
    return QuantGNBParams(quad=quad, lin=lin, const=const,
                          log_prior=model.log_prior, scale=scale)


def dequantize_gnb(qp: QuantGNBParams) -> GNBModel:
    mu, var = _tables_to_gauss(qp.quad, qp.lin, qp.scale)
    return GNBModel(mu=mu, var=var, log_prior=qp.log_prior)


def quantize_gmm(state: GMMState,
                 absmax: Optional[torch.Tensor] = None) -> QuantGMMParams:
    absmax = gauss_absmax(state.mu.float(), state.var.float()) \
        if absmax is None else absmax
    scale = qk.feature_scales(absmax)
    quad, lin, const = gauss_score_tables(state.mu, state.var, scale)
    return QuantGMMParams(quad=quad, lin=lin, const=const,
                          log_pi=state.log_pi, scale=scale)


def dequantize_gmm(qp: QuantGMMParams) -> GMMState:
    mu, var = _tables_to_gauss(qp.quad, qp.lin, qp.scale)
    dev = mu.device
    return GMMState(mu=mu, var=var, log_pi=qp.log_pi,
                    log_lik=torch.zeros((), device=dev),
                    n_iter=torch.zeros((), dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# RF: int8 threshold-compare traversal
# ---------------------------------------------------------------------------


def quantize_forest(forest: Forest, absmax: Optional[torch.Tensor] = None,
                    d: Optional[int] = None) -> QuantForest:
    if absmax is None:
        d = int(torch.max(forest.feature)) + 1 if d is None else d
        absmax = forest_absmax(forest.feature, forest.threshold, d)
    scale = qk.feature_scales(absmax).to(forest.threshold.device)
    node_scale = scale[torch.clamp(forest.feature, min=0).long()]
    qt = torch.round(forest.threshold.to(torch.float32) / node_scale)
    qt = torch.where(forest.feature >= 0,
                     torch.clamp(qt, -qk._QMAX, qk._QMAX), 0.0)
    return QuantForest(feature=forest.feature,
                       qthreshold=qt.to(torch.int8), left=forest.left,
                       right=forest.right, scale=scale,
                       n_class=forest.n_class)


def dequantize_forest(qp: QuantForest) -> Forest:
    node_scale = qp.scale[torch.clamp(qp.feature, min=0).long()]
    thr = torch.where(qp.feature >= 0,
                      qp.qthreshold.to(torch.float32) * node_scale, 0.0)
    return Forest(feature=qp.feature, threshold=thr, left=qp.left,
                  right=qp.right, n_class=qp.n_class)
