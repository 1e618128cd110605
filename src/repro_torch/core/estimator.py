"""Estimator API over the ported pipelines (kNN, K-Means, GNB, GMM, RF, and
IVF-PQ approximate kNN).

The same train-offline / infer-on-device shape as the JAX package's
``core/estimator.py``:

    fit(X, y=None)          -> self              (params as a NamedTuple)
    predict(x)              -> (prediction, aux)
    predict_batch(X)        -> (predictions (B,), aux (B, ...))

``predict_batch_fn()`` returns a function ``(params, X) -> (preds, aux)``
with the static configuration closed over; the serving engine calls it
once per bucket.  Every fp hot path goes through the dispatch registry.
Under the ``int8`` policy (or after ``quantize()``) the params are the
int8 lattice form of ``core/quantization.py`` and the hot path calls the
int8 kernels directly, as the reference's does; ``path="ref"`` (or
``REPRO_BACKEND=ref``) runs their plain versions instead.  An estimator
lives on one device: the card unless ``device="cpu"`` is named
(``repro_torch.device.resolve_device``).

Multi-tenant serving (``serving/model_store.py``): params NamedTuples
whose tensor leaves have the same shapes across same-config fits (RF after
``random_forest.pad_nodes``) stack leaf-wise along a leading tenant axis
(``stack_params``), and ``predict_batch_group_fn()`` serves such a group,
``(stacked, Xg (G, B, d)) -> (preds (G, B), aux (G, B, ...))``, through
the dispatch registry's grouped arm (``dispatch.grouped``): B1, B2 and B3
with a tenant axis, one launch for the group, each lane bit-equal to the
one-tenant call.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import ann as _ann
from repro_torch.core import gmm as _gmm
from repro_torch.core import gnb as _gnb
from repro_torch.core import kmeans as _kmeans
from repro_torch.core import knn as _knn
from repro_torch.core import quantization as _quant
from repro_torch.core import random_forest as _rf
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import dispatch
from repro_torch.kernels import ops as _ops
from repro_torch.kernels import quantized as _qk
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.dispatch import PrecisionPolicy


# ---------------------------------------------------------------------------
# Model-group stacking (multi-tenant serving, serving/model_store.py)
# ---------------------------------------------------------------------------
#
# The one place the tensor-versus-static distinction lives: a tensor leaf
# stacks, anything else (``n_class``) must be equal across the group and
# passes through.  Leaf paths are named as the JAX package names them
# (``.A``, ``.n_class``), so the errors read the same.


def _is_array_leaf(leaf) -> bool:
    return isinstance(leaf, torch.Tensor)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def group_axes(params) -> Any:
    """The tenant axis of each leaf of a (stacked or template) params
    NamedTuple: 0 on tensor leaves, None on static metadata."""
    return type(params)(*(0 if _is_array_leaf(v) else None for v in params))


def stack_params(params_list) -> NamedTuple:
    """Stack G same-shape params NamedTuples along a new leading axis.

    Static (non-tensor) leaves must be equal across the group: they are
    configuration like ``n_class``.  A type, shape or dtype mismatch
    raises with the leaf's path and the model's index in the group (the
    error a ``ModelStore`` registration surfaces)."""
    if not params_list:
        raise ValueError("stack_params needs at least one model")
    ref = params_list[0]
    for g, p in enumerate(params_list[1:], start=1):
        if type(p) is not type(ref):
            raise ValueError(f"model {g} has params {type(p).__name__}, "
                             f"expected {type(ref).__name__}")
        for name, leaf0, leaf in zip(ref._fields, ref, p):
            path = f".{name}"
            if _is_array_leaf(leaf0) != _is_array_leaf(leaf):
                raise ValueError(f"model {g} leaf {path}: array/static "
                                 f"mismatch vs model 0")
            if _is_array_leaf(leaf0):
                if leaf0.shape != leaf.shape or leaf0.dtype != leaf.dtype:
                    raise ValueError(
                        f"model {g} leaf {path}: {tuple(leaf.shape)}/"
                        f"{_dtype_name(leaf.dtype)} vs model 0's "
                        f"{tuple(leaf0.shape)}/{_dtype_name(leaf0.dtype)} — "
                        f"same-shape fits only (RF forests must be "
                        f"pad_nodes-normalized to one node capacity)")
                if leaf0.device != leaf.device:
                    raise ValueError(
                        f"model {g} leaf {path}: on {leaf.device}, model 0's "
                        f"on {leaf0.device} — one group lives on one device")
            elif leaf0 != leaf:
                raise ValueError(
                    f"model {g} static leaf {path}: {leaf!r} != model 0's "
                    f"{leaf0!r} — static config must match across a group")
    return type(ref)(*(
        torch.stack(leaves) if _is_array_leaf(leaves[0]) else leaves[0]
        for leaves in zip(*params_list)))


def unstack_params(stacked, i: int) -> NamedTuple:
    """Tenant ``i``'s params sliced back out of a stacked group (the
    inverse of ``stack_params`` a lane): views of the stacked tensors."""
    return type(stacked)(*(v[i] if _is_array_leaf(v) else v
                           for v in stacked))


def _q8(path: Optional[str]):
    """The int8 kernels' wrappers, or their plain versions where ``path``
    (or ``REPRO_BACKEND``) asks for ``ref``."""
    return _ref if dispatch.requested(path) == "ref" else _ops


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
        self._cal_absmax: Optional[torch.Tensor] = None  # fit's |X| max

    @property
    def params(self) -> NamedTuple:
        if self._params is None:
            raise ValueError(f"{type(self).__name__} is not fitted")
        return self._params

    @property
    def fitted(self) -> bool:
        return self._params is not None

    @property
    def quantized(self) -> bool:
        """True once the params are their int8 lattice form: the hot path
        then runs the int8 kernels, or their plain versions under
        ``path="ref"``, whatever other arm ``path`` names."""
        return self._params is not None and \
            _quant.is_quantized_params(self._params)

    def _finalize_fit(self, X):
        """Record the per-feature abs-max every fit leaves behind, then
        quantize in place when the policy is the int8 tier."""
        self._cal_absmax = _quant.calibrate_absmax(
            self._tensor(X, torch.float32))
        if self.policy is not None and self.policy.quantized:
            self.quantize()
        return self

    def quantize(self):
        """Rewrite the fitted params into their int8 lattice form
        (idempotent).  Scales come from the training data the fit
        recorded; ``from_params`` estimators fall back to bounds derived
        from the params."""
        if not self.fitted:
            raise ValueError(f"fit {type(self).__name__} before quantize()")
        if not self.quantized:
            self._params = self._quantize(self._params, self._cal_absmax)
        return self

    def quantized_copy(self):
        """A shallow copy whose params are the int8 lattice form, leaving
        this estimator untouched: what a serving engine under the int8
        policy serves.  ``self`` when the params are already quantized."""
        if self.quantized:
            return self
        import copy
        est = copy.copy(self)
        est._params = self._quantize(self._params, self._cal_absmax)
        return est

    def dequantize_params(self) -> NamedTuple:
        """The fp32 params rebuilt from the int8 form (up to lattice
        rounding)."""
        if not self.quantized:
            raise ValueError(f"{type(self).__name__} is not quantized")
        return self._dequantize(self._params)

    def _quantize(self, params, absmax) -> NamedTuple:
        raise NotImplementedError

    def _dequantize(self, qparams) -> NamedTuple:
        raise NotImplementedError

    def _place_params(self, params: NamedTuple) -> NamedTuple:
        """Params (int8 lattice forms carried across, say) on this
        estimator's device, dtypes kept; static ints pass through."""
        return type(params)(*(
            self._tensor(v).contiguous()
            if isinstance(v, (torch.Tensor, np.ndarray)) else v
            for v in params))

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        """``x`` on this estimator's device, as ``dtype`` if one is named;
        float64 becomes float32 (what the JAX package's arrays do with x64
        off), so float64 inputs reach the kernels as float32."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if dtype is None and getattr(x, "dtype", None) == torch.float64:
            dtype = torch.float32
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

    def predict_batch_group_fn(self) -> Callable:
        """``(stacked params, Xg (G, B, d)) -> (preds (G, B), aux (G, B,
        ...))``: the multi-tenant grouped launch, built by the dispatch
        registry's grouped arm for this algorithm with this estimator's
        static configuration (``dispatch.grouped``); each lane equal to
        ``predict_batch_fn`` on that tenant's params.  Raises KeyError for
        an algorithm with no grouped arm (ANN overrides with the
        reason)."""
        return dispatch.grouped(self.algorithm)(self)

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
        return self._finalize_fit(X)

    @classmethod
    def from_params(cls, model, k: int = 4, **kw) -> "KNNEstimator":
        """fp32 ``KNNModel`` or its int8 form ``QuantKNNModel``."""
        est = cls(k, n_class=model.n_class, **kw)
        if _quant.is_quantized_params(model):
            est._params = est._place_params(model)
            return est
        est._params = _knn.KNNModel(
            A=est._cast(model.A).contiguous(),
            labels=est._tensor(model.labels, torch.int32),
            n_class=int(model.n_class))
        return est

    def _quantize(self, params, absmax):
        return _quant.quantize_knn(params, absmax)

    def _dequantize(self, qparams):
        return _quant.dequantize_knn(qparams)

    def predict_batch_fn(self) -> Callable:
        k, policy, path = self.k, self.policy, self.path
        n_class = self.params.n_class
        if self.quantized:
            def qfn(params: _quant.QuantKNNModel, X):
                xq = _qk.quantize_rows(X, params.scale)
                _, nbr = _q8(path).distance_topk_q8(params.qa, xq, k)
                return _knn._vote(params.labels, nbr, n_class), nbr

            return qfn

        def fn(params: _knn.KNNModel, X):
            X = policy.cast(X) if policy else X
            model = _knn.KNNModel(A=params.A, labels=params.labels,
                                  n_class=n_class)
            return _knn.knn_classify_batch(model, X, k, policy=policy,
                                           path=path)

        return fn

    def serve_cost_shape(self) -> Dict[str, int]:
        A = self.params.qa if self.quantized else self.params.A
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
        return self._finalize_fit(X)

    @classmethod
    def from_params(cls, state, **kw) -> "KMeansEstimator":
        """fp32 ``KMeansState`` or its int8 form ``QuantKMeansParams``."""
        if _quant.is_quantized_params(state):
            est = cls(n_clusters=state.qc.shape[0], **kw)
            est._params = est._place_params(state)
            return est
        est = cls(n_clusters=state.centroids.shape[0], **kw)
        est._params = _kmeans.KMeansState(
            centroids=est._cast(state.centroids).contiguous(),
            shift=est._tensor(state.shift, torch.float32),
            n_iter=est._tensor(state.n_iter, torch.int32))
        return est

    def _quantize(self, params, absmax):
        return _quant.quantize_kmeans(params, absmax)

    def _dequantize(self, qparams):
        return _quant.dequantize_kmeans(qparams)

    def predict_batch_fn(self) -> Callable:
        policy, path = self.policy, self.path
        if self.quantized:
            def qfn(params: _quant.QuantKMeansParams, X):
                xq = _qk.quantize_rows(X, params.scale)
                lat, ids = _q8(path).distance_argmin_q8(xq, params.qc)
                return ids, lat.to(torch.float32) * params.dequant

            return qfn

        def fn(params: _kmeans.KMeansState, X):
            X = policy.cast(X) if policy else X
            dist, ids = dispatch.distance_argmin(X, params.centroids,
                                                 policy=policy, path=path)
            return ids, dist

        return fn

    def serve_cost_shape(self) -> Dict[str, int]:
        c = self.params.qc if self.quantized else self.params.centroids
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
        return self._finalize_fit(X)

    @classmethod
    def from_params(cls, model, **kw) -> "GNBEstimator":
        """fp32 ``GNBModel`` or its int8 form ``QuantGNBParams``."""
        if _quant.is_quantized_params(model):
            est = cls(n_class=model.quad.shape[0], **kw)
            est._params = est._place_params(model)
            return est
        est = cls(n_class=model.mu.shape[0], **kw)
        est._params = _gnb.GNBModel(
            mu=est._cast(model.mu).contiguous(),
            var=est._cast(model.var).contiguous(),
            log_prior=est._tensor(model.log_prior, torch.float32))
        return est

    def _quantize(self, params, absmax):
        return _quant.quantize_gnb(params, absmax)

    def _dequantize(self, qparams):
        return _quant.dequantize_gnb(qparams)

    def predict_batch_fn(self) -> Callable:
        policy, path = self.policy, self.path
        if self.quantized:
            def qfn(params: _quant.QuantGNBParams, X):
                scores = _qk.affine_scores(
                    _qk.quantize_rows(X, params.scale), params.quad,
                    params.lin, params.const + params.log_prior)
                return torch.argmax(scores, dim=1).to(torch.int32), scores

            return qfn

        def fn(params: _gnb.GNBModel, X):
            X = policy.cast(X) if policy else X
            return _gnb.gnb_classify_batch(params, X, policy=policy,
                                           path=path)

        return fn

    def serve_cost_shape(self) -> Dict[str, int]:
        m = self.params.quad if self.quantized else self.params.mu
        return {"C": int(m.shape[0]), "d": int(m.shape[1])}

    def empty_aux(self) -> torch.Tensor:
        # the class count from the static config: the int8 form stores
        # score tables, not moments
        n_class = self.n_class or self.params.mu.shape[0]
        return torch.zeros((0, n_class), dtype=torch.float32,
                           device=self.device)


class GMMEstimator(_EstimatorBase):
    """EM mixture (the paper's §6 future-work kernel); hot path ("gmm",
    "responsibilities").  aux = log-responsibilities (B, k)."""

    algorithm = "gmm"

    def __init__(self, n_components: int = 4, *, max_iters: int = 100,
                 tol: float = 1e-4, n_cores: int = 8,
                 policy: Optional[PrecisionPolicy] = None,
                 path: Optional[str] = None, device: DeviceLike = None):
        super().__init__(policy=policy, path=path, device=device)
        self.n_components = int(n_components)
        self.max_iters = max_iters
        self.tol = tol
        self.n_cores = n_cores

    def fit(self, X, y=None) -> "GMMEstimator":
        # EM runs in fp32 (offline training, as K-Means' fit); only the
        # inference-time params take the policy dtype
        state, _ = _gmm.gmm_fit(self._tensor(X, torch.float32),
                                self.n_components, max_iters=self.max_iters,
                                tol=self.tol, n_cores=self.n_cores)
        self._params = state._replace(mu=self._cast(state.mu),
                                      var=self._cast(state.var))
        return self._finalize_fit(X)

    @classmethod
    def from_params(cls, state, **kw) -> "GMMEstimator":
        """fp32 ``GMMState`` or its int8 form ``QuantGMMParams``."""
        if _quant.is_quantized_params(state):
            est = cls(n_components=state.quad.shape[0], **kw)
            est._params = est._place_params(state)
            return est
        est = cls(n_components=state.mu.shape[0], **kw)
        est._params = _gmm.GMMState(
            mu=est._cast(state.mu), var=est._cast(state.var),
            log_pi=est._tensor(state.log_pi, torch.float32),
            log_lik=est._tensor(state.log_lik, torch.float32),
            n_iter=est._tensor(state.n_iter, torch.int32))
        return est

    def _quantize(self, params, absmax):
        return _quant.quantize_gmm(params, absmax)

    def _dequantize(self, qparams):
        return _quant.dequantize_gmm(qparams)

    def predict_batch_fn(self) -> Callable:
        policy, path, n_cores = self.policy, self.path, self.n_cores
        if self.quantized:
            def qfn(params: _quant.QuantGMMParams, X):
                joint = _qk.affine_scores(
                    _qk.quantize_rows(X, params.scale), params.quad,
                    params.lin, params.const + params.log_pi)
                lr = joint - torch.logsumexp(joint, dim=1, keepdim=True)
                return torch.argmax(lr, dim=1).to(torch.int32), lr

            return qfn

        def fn(params: _gmm.GMMState, X):
            X = policy.cast(X) if policy else X
            return _gmm.gmm_classify_batch(params, X, policy=policy,
                                           path=path, n_cores=n_cores)

        return fn

    def serve_cost_shape(self) -> Dict[str, int]:
        m = self.params.quad if self.quantized else self.params.mu
        return {"K": int(m.shape[0]), "d": int(m.shape[1])}

    def empty_aux(self) -> torch.Tensor:
        return torch.zeros((0, self.n_components), dtype=torch.float32,
                           device=self.device)


class RandomForestEstimator(_EstimatorBase):
    """Fig. 8; hot path ("rf", "forest_votes"), whose only arm is the
    torch traversal.  aux = vote counts (B, C) int32."""

    algorithm = "rf"

    def __init__(self, n_class: Optional[int] = None, *, n_trees: int = 16,
                 max_depth: int = 8, min_samples: int = 2, seed: int = 0,
                 policy: Optional[PrecisionPolicy] = None,
                 path: Optional[str] = None, device: DeviceLike = None):
        super().__init__(policy=policy, path=path, device=device)
        self.n_class = n_class
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_samples = min_samples
        self.seed = seed
        self._depth: Optional[int] = None

    def _place(self, forest: _rf.Forest) -> _rf.Forest:
        """The forest on this estimator's device, with its traversal depth
        worked out once."""
        forest = _rf.Forest(
            feature=self._tensor(forest.feature, torch.int32),
            threshold=self._tensor(forest.threshold, torch.float32),
            left=self._tensor(forest.left, torch.int32),
            right=self._tensor(forest.right, torch.int32),
            n_class=int(forest.n_class))
        self._depth = _rf.forest_depth(forest)
        return forest

    def fit(self, X, y=None) -> "RandomForestEstimator":
        if y is None:
            raise ValueError("RF is supervised: fit(X, y)")
        # CART trains on the host in numpy (offline, as the paper's sklearn)
        X, y = (t.cpu().numpy() if isinstance(t, torch.Tensor)
                else np.asarray(t) for t in (X, y))
        n_class = self.n_class or int(np.max(y)) + 1
        self._params = self._place(_rf.train_forest(
            X, y, n_class, n_trees=self.n_trees, max_depth=self.max_depth,
            min_samples=self.min_samples, seed=self.seed))
        return self._finalize_fit(X)

    @classmethod
    def from_params(cls, forest, **kw) -> "RandomForestEstimator":
        """fp32 ``Forest`` or its int8 form ``QuantForest``."""
        est = cls(n_class=int(forest.n_class), **kw)
        if _quant.is_quantized_params(forest):
            est._params = est._place_params(forest)
            est._depth = _rf.forest_depth(est._params)
            return est
        est._params = est._place(forest)
        return est

    def _quantize(self, params, absmax):
        return _quant.quantize_forest(params, absmax)

    def _dequantize(self, qparams):
        return _quant.dequantize_forest(qparams)

    def predict_batch_fn(self) -> Callable:
        policy, path, depth = self.policy, self.path, self._depth
        if self.quantized:
            n_class = self.params.n_class

            def qfn(params: _quant.QuantForest, X):
                # int8-vs-int8 node compares through the same traversal
                forest = _rf.Forest(feature=params.feature,
                                    threshold=params.qthreshold,
                                    left=params.left, right=params.right,
                                    n_class=n_class)
                xq = _qk.quantize_rows(X, params.scale)
                return _rf.forest_classify_batch(forest, xq, depth=depth)

            return qfn

        def fn(params: _rf.Forest, X):
            X = policy.cast(X) if policy else X
            return dispatch.forest_votes(params, X, policy=policy, path=path,
                                         depth=depth)

        return fn

    def serve_cost_shape(self) -> Dict[str, int]:
        return {"T": int(self.params.feature.shape[0]),
                "depth": self.max_depth, "C": int(self.params.n_class)}

    def empty_aux(self) -> torch.Tensor:
        return torch.zeros((0, self.params.n_class), dtype=torch.int32,
                           device=self.device)


class ANNKNNEstimator(_EstimatorBase):
    """IVF-PQ approximate kNN (``core/ann.py``); hot path ("ann",
    "adc_topk"), B8, plus the shared ("knn", "distance_topk") coarse probe
    over the cell centroids (B1).  ``nprobe`` is the recall-vs-latency
    knob.  aux = global neighbour ids (B, k) int32, -1 where a query's
    probed cells held fewer than k members."""

    algorithm = "ann"

    def __init__(self, k: int = 4, *, n_class: Optional[int] = None,
                 n_cells: Optional[int] = None, nprobe: int = 4,
                 pq_m: int = 4, n_codes: int = 256, refine: int = 0,
                 train_iters: int = 25,
                 policy: Optional[PrecisionPolicy] = None,
                 path: Optional[str] = None, device: DeviceLike = None):
        if policy is not None and policy.quantized:
            raise NotImplementedError(
                "ANN has no int8 policy tier: the PQ codes ARE the int8 "
                "representation and the ADC LUT is already integer "
                "(DESIGN.md §10) — serve with policy fp32/bf16")
        super().__init__(policy=policy, path=path, device=device)
        self.k = int(k)
        self.n_class = n_class
        self.n_cells = n_cells
        self.nprobe = int(nprobe)
        self.pq_m = int(pq_m)
        self.n_codes = int(n_codes)
        # refine > 0: exact re-rank of the ADC top-``refine`` survivors
        self.refine = int(refine)
        self.train_iters = int(train_iters)

    def fit(self, X, y=None) -> "ANNKNNEstimator":
        if y is None:
            raise ValueError("ANN kNN is supervised: fit(X, y)")
        y = self._tensor(y, torch.int32)
        n_class = self.n_class or int(y.max()) + 1
        N, d = X.shape
        # sqrt(N) cells is the IVF rule of thumb, clamped so that tiny
        # problems still index and every cell can be real
        n_cells = min(self.n_cells or max(1, min(64, round(N ** 0.5))), N)
        m = max(1, min(self.pq_m, d))
        n_codes = max(1, min(self.n_codes, N, 256))
        self._params = _ann.fit_ivf_pq(
            self._tensor(X, torch.float32), y, n_cells=n_cells, m=m,
            n_codes=n_codes, n_class=n_class, max_iters=self.train_iters,
            cast=lambda t: self._cast(t).contiguous())
        return self._finalize_fit(X)

    @classmethod
    def from_params(cls, params: _ann.ANNParams,
                    **kw) -> "ANNKNNEstimator":
        est = cls(n_class=int(params.n_class), **kw)
        placed = est._place_params(params)
        est._params = placed._replace(
            centroids=est._cast(placed.centroids).contiguous(),
            codebooks=est._cast(placed.codebooks),
            refs=est._cast(placed.refs))
        return est

    def predict_batch_fn(self) -> Callable:
        k, nprobe, refine = self.k, self.nprobe, self.refine
        policy, path = self.policy, self.path

        def fn(params: _ann.ANNParams, X):
            X = policy.cast(X) if policy else X
            return _ann.ann_classify_batch(params, X, k, nprobe,
                                           refine=refine, policy=policy,
                                           path=path)

        return fn

    def predict_batch_group_fn(self) -> Callable:
        raise NotImplementedError(
            "ANN has no grouped (multi-tenant) serving arm: the IVF "
            "inverted-list capacities and PQ code shapes are data-"
            "dependent per fit, so independently-fitted indexes do not "
            "stack into one leading axis (DESIGN.md §11) — register ANN "
            "tenants in their own single-model engines")

    def serve_cost_shape(self) -> Dict[str, int]:
        C, cap = self.params.cell_ids.shape
        m, n_codes, _ = self.params.codebooks.shape
        L = min(self.nprobe, int(C)) * int(cap)
        return {"C": int(C), "d": int(self.params.centroids.shape[1]),
                "m": int(m), "n_codes": int(n_codes), "L": L, "k": self.k,
                "R": min(self.refine, L) if self.refine > 0 else 0}

    def empty_aux(self) -> torch.Tensor:
        return torch.zeros((0, self.k), dtype=torch.int32,
                           device=self.device)


ESTIMATORS: Dict[str, type] = {
    "knn": KNNEstimator,
    "kmeans": KMeansEstimator,
    "gnb": GNBEstimator,
    "gmm": GMMEstimator,
    "rf": RandomForestEstimator,
    "ann": ANNKNNEstimator,
}

# each algorithm's "how many groups" constructor kwarg
_GROUP_KWARG = {"kmeans": "n_clusters", "gmm": "n_components",
                "knn": "n_class", "gnb": "n_class", "rf": "n_class",
                "ann": "n_class"}


def make_estimator(algorithm: str, **kwargs: Any) -> _EstimatorBase:
    """Construct a registered estimator by algorithm name."""
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
