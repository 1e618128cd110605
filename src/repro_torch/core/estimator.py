"""Estimator API over the ported pipelines (kNN, K-Means, GNB).

The same train-offline / infer-on-device shape as the JAX package's
``core/estimator.py``:

    fit(X, y=None)          -> self              (params as a NamedTuple)
    predict(x)              -> (prediction, aux)
    predict_batch(X)        -> (predictions (B,), aux (B, ...))

``predict_batch_fn()`` returns a function ``(params, X) -> (preds, aux)``
with the static configuration closed over; the serving engine calls it
once per bucket.  Every hot path goes through the dispatch registry.  An
estimator lives on one device: the card unless ``device="cpu"`` is named
(``repro_torch.device.resolve_device``).  GMM, RF and ANN are not ported
yet: ``make_estimator`` raises ``KeyError`` for them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import gnb as _gnb
from repro_torch.core import kmeans as _kmeans
from repro_torch.core import knn as _knn
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.dispatch import PrecisionPolicy

# algorithms of the JAX package that the port does not carry yet, with the
# ROADMAP item that brings each
NOT_PORTED = {"gmm": "A4", "rf": "A5", "ann": "A10"}


class _EstimatorBase:
    """Shared plumbing: device placement, policy casting, single-query
    predict through the batch path, the fitted-params handshake."""

    algorithm: str = "?"

    def __init__(self, *, policy: Optional[PrecisionPolicy] = None,
                 path: Optional[str] = None, device: DeviceLike = None):
        self.policy = policy
        self.path = path
        self.device = resolve_device(device)
        self._params: Optional[NamedTuple] = None

    @property
    def params(self) -> NamedTuple:
        if self._params is None:
            raise ValueError(f"{type(self).__name__} is not fitted")
        return self._params

    @property
    def fitted(self) -> bool:
        return self._params is not None

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _cast(self, x) -> torch.Tensor:
        x = self._tensor(x)
        return self.policy.cast(x) if self.policy else x

    def predict_batch(self, X) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.predict_batch_fn()(self.params, self._tensor(X))

    def predict(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        preds, aux = self.predict_batch(self._tensor(x)[None])
        return preds[0], aux[0]

    def predict_batch_fn(self) -> Callable:
        raise NotImplementedError

    def serve_cost_shape(self) -> Dict[str, int]:
        raise NotImplementedError

    def empty_aux(self) -> torch.Tensor:
        """Zero-query aux with the trailing shape and dtype of
        ``predict_batch``'s aux."""
        raise NotImplementedError


class KNNEstimator(_EstimatorBase):
    """Fig. 6; hot path ("knn", "distance_topk").  aux = neighbour indices
    (B, k) int32."""

    algorithm = "knn"

    def __init__(self, k: int = 4, *, n_class: Optional[int] = None,
                 policy: Optional[PrecisionPolicy] = None,
                 path: Optional[str] = None, device: DeviceLike = None):
        super().__init__(policy=policy, path=path, device=device)
        self.k = int(k)
        self.n_class = n_class

    def fit(self, X, y=None) -> "KNNEstimator":
        if y is None:
            raise ValueError("kNN is supervised: fit(X, y)")
        y = self._tensor(y, torch.int32)
        n_class = self.n_class or int(y.max()) + 1
        self._params = _knn.KNNModel(A=self._cast(X).contiguous(), labels=y,
                                     n_class=n_class)
        return self

    @classmethod
    def from_params(cls, model: _knn.KNNModel, k: int = 4,
                    **kw) -> "KNNEstimator":
        est = cls(k, n_class=model.n_class, **kw)
        est._params = _knn.KNNModel(
            A=est._cast(model.A).contiguous(),
            labels=est._tensor(model.labels, torch.int32),
            n_class=int(model.n_class))
        return est

    def predict_batch_fn(self) -> Callable:
        k, policy, path = self.k, self.policy, self.path
        n_class = self.params.n_class

        def fn(params: _knn.KNNModel, X):
            X = policy.cast(X) if policy else X
            model = _knn.KNNModel(A=params.A, labels=params.labels,
                                  n_class=n_class)
            return _knn.knn_classify_batch(model, X, k, policy=policy,
                                           path=path)

        return fn

    def serve_cost_shape(self) -> Dict[str, int]:
        A = self.params.A
        return {"N": int(A.shape[0]), "d": int(A.shape[1]), "k": self.k}

    def empty_aux(self) -> torch.Tensor:
        return torch.zeros((0, self.k), dtype=torch.int32,
                           device=self.device)


class KMeansEstimator(_EstimatorBase):
    """Fig. 7; hot path ("kmeans", "distance_argmin").  aux = squared
    distance to the assigned centroid (B,)."""

    algorithm = "kmeans"

    def __init__(self, n_clusters: int = 4, *, threshold: float = 1e-4,
                 max_iters: int = 100, n_cores: int = 8,
                 policy: Optional[PrecisionPolicy] = None,
                 path: Optional[str] = None, device: DeviceLike = None):
        super().__init__(policy=policy, path=path, device=device)
        self.n_clusters = int(n_clusters)
        self.threshold = threshold
        self.max_iters = max_iters
        self.n_cores = n_cores

    def fit(self, X, y=None) -> "KMeansEstimator":
        # the fit runs in fp32 (the paper trains offline at full
        # precision); only the fitted params take the policy dtype
        state, _ = _kmeans.kmeans_fit(
            self._tensor(X, torch.float32), self.n_clusters,
            threshold=self.threshold, max_iters=self.max_iters,
            n_cores=self.n_cores, path=self.path)
        self._params = state._replace(
            centroids=self._cast(state.centroids).contiguous())
        return self

    @classmethod
    def from_params(cls, state: _kmeans.KMeansState,
                    **kw) -> "KMeansEstimator":
        est = cls(n_clusters=state.centroids.shape[0], **kw)
        est._params = _kmeans.KMeansState(
            centroids=est._cast(state.centroids).contiguous(),
            shift=est._tensor(state.shift, torch.float32),
            n_iter=est._tensor(state.n_iter, torch.int32))
        return est

    def predict_batch_fn(self) -> Callable:
        from repro_torch.kernels import dispatch
        policy, path = self.policy, self.path

        def fn(params: _kmeans.KMeansState, X):
            X = policy.cast(X) if policy else X
            dist, ids = dispatch.distance_argmin(X, params.centroids,
                                                 policy=policy, path=path)
            return ids, dist

        return fn

    def serve_cost_shape(self) -> Dict[str, int]:
        c = self.params.centroids
        return {"K": int(c.shape[0]), "d": int(c.shape[1])}

    def empty_aux(self) -> torch.Tensor:
        return torch.zeros((0,), dtype=torch.float32, device=self.device)


class GNBEstimator(_EstimatorBase):
    """Fig. 5; hot path ("gnb", "scores").  aux = joint log-likelihood
    per class (B, C)."""

    algorithm = "gnb"

    def __init__(self, n_class: Optional[int] = None, *,
                 var_smoothing: float = 1e-6,
                 policy: Optional[PrecisionPolicy] = None,
                 path: Optional[str] = None, device: DeviceLike = None):
        super().__init__(policy=policy, path=path, device=device)
        self.n_class = n_class
        self.var_smoothing = var_smoothing

    def fit(self, X, y=None) -> "GNBEstimator":
        if y is None:
            raise ValueError("GNB is supervised: fit(X, y)")
        y = self._tensor(y, torch.int32)
        n_class = self.n_class = self.n_class or int(y.max()) + 1
        model = _gnb.fit_gnb(self._tensor(X, torch.float32), y, n_class,
                             self.var_smoothing)
        self._params = _gnb.GNBModel(mu=self._cast(model.mu).contiguous(),
                                     var=self._cast(model.var).contiguous(),
                                     log_prior=model.log_prior)
        return self

    @classmethod
    def from_params(cls, model: _gnb.GNBModel, **kw) -> "GNBEstimator":
        est = cls(n_class=model.mu.shape[0], **kw)
        est._params = _gnb.GNBModel(
            mu=est._cast(model.mu).contiguous(),
            var=est._cast(model.var).contiguous(),
            log_prior=est._tensor(model.log_prior, torch.float32))
        return est

    def predict_batch_fn(self) -> Callable:
        policy, path = self.policy, self.path

        def fn(params: _gnb.GNBModel, X):
            X = policy.cast(X) if policy else X
            return _gnb.gnb_classify_batch(params, X, policy=policy,
                                           path=path)

        return fn

    def serve_cost_shape(self) -> Dict[str, int]:
        m = self.params.mu
        return {"C": int(m.shape[0]), "d": int(m.shape[1])}

    def empty_aux(self) -> torch.Tensor:
        n_class = self.n_class or self.params.mu.shape[0]
        return torch.zeros((0, n_class), dtype=torch.float32,
                           device=self.device)


ESTIMATORS: Dict[str, type] = {
    "knn": KNNEstimator,
    "kmeans": KMeansEstimator,
    "gnb": GNBEstimator,
}

# each algorithm's "how many groups" constructor kwarg
_GROUP_KWARG = {"kmeans": "n_clusters", "knn": "n_class", "gnb": "n_class"}


def make_estimator(algorithm: str, **kwargs: Any) -> _EstimatorBase:
    """Construct a registered estimator by algorithm name."""
    if algorithm in NOT_PORTED:
        raise KeyError(f"algorithm {algorithm!r} is not yet ported to the "
                       f"PyTorch package (ROADMAP {NOT_PORTED[algorithm]}); "
                       f"ported: {sorted(ESTIMATORS)}")
    if algorithm not in ESTIMATORS:
        raise KeyError(f"unknown algorithm {algorithm!r}; "
                       f"registered: {sorted(ESTIMATORS)}")
    return ESTIMATORS[algorithm](**kwargs)


def make_fitted(algorithm: str, X, y=None, *,
                n_groups: Optional[int] = None, device: DeviceLike = None,
                **kwargs: Any) -> _EstimatorBase:
    """Construct AND fit on ``device`` (the card unless "cpu" is named),
    mapping the generic ``n_groups`` (classes or clusters) onto the
    algorithm's kwarg."""
    if n_groups is not None and algorithm in _GROUP_KWARG:
        kwargs.setdefault(_GROUP_KWARG[algorithm], n_groups)
    return make_estimator(algorithm, device=device, **kwargs).fit(X, y)
