"""Carry fitted weights across from the JAX package.

The JAX package's fitted params (``KNNModel``, ``KMeansState``,
``GNBModel``, ``GMMState``, ``Forest``, ``ANNParams``, and the int8 forms
``QuantKNNModel``, ``QuantKMeansParams``, ``QuantGNBParams``,
``QuantGMMParams``, ``QuantForest``) reach this module as plain numpy
leaves — anything with ``_asdict()`` or a mapping of field name to array,
plus the static ``n_class`` — so the port never imports that package.
The field names say which form they are.  The result is the port's
NamedTuple of tensors on ``device``; hand it to the estimator's
``from_params`` to serve it.

``group_from_numpy`` carries a stacked model group across (the
reference's ``stack_params`` output, every tensor leaf with a leading
tenant axis, ``n_class`` static), for ``ModelStore``-style grouped
serving.

``linear_from_numpy`` carries an LR or SVM ``LinearModel`` (``W``
(C, d), ``b`` (C,)) across for ``core.gemm_based``.

``lm_params_from_numpy`` carries a dense LM's params tree across (the
reference's ``init_params`` tree with numpy leaves) for
``serving.ServeEngine``.
"""
from __future__ import annotations

from typing import Any, Mapping, NamedTuple

import numpy as np
import torch

from repro_torch.core import quantization as _q
from repro_torch.core.ann import ANNParams
from repro_torch.core.gemm_based import LinearModel
from repro_torch.core.gmm import GMMState
from repro_torch.core.gnb import GNBModel
from repro_torch.core.kmeans import KMeansState
from repro_torch.core.knn import KNNModel
from repro_torch.core.random_forest import Forest
from repro_torch.device import DeviceLike, resolve_device

PARAM_TYPES = {"knn": KNNModel, "kmeans": KMeansState, "gnb": GNBModel,
               "gmm": GMMState, "rf": Forest, "ann": ANNParams}
# each algorithm's int8 lattice form
QUANT_TYPES = {"knn": _q.QuantKNNModel, "kmeans": _q.QuantKMeansParams,
               "gnb": _q.QuantGNBParams, "gmm": _q.QuantGMMParams,
               "rf": _q.QuantForest}


def _leaf(value: Any, device: torch.device) -> torch.Tensor:
    # a copy: arrays exported from JAX are read-only views of its buffers
    return torch.tensor(np.asarray(value), device=device)


def params_from_numpy(algorithm: str, leaves: Any, *,
                      device: DeviceLike = None) -> NamedTuple:
    """``leaves``: the reference's fitted params as numpy-convertible
    leaves (a NamedTuple or a mapping), in the fp form or the int8 form.
    Returns the port's params of the same form for ``algorithm`` on
    ``device``; dtypes are kept (float32 stays float32, int8 codes and
    lattices stay int8, int32 labels, ids and tree arrays stay int32)."""
    if algorithm not in PARAM_TYPES:
        raise KeyError(f"no params conversion for {algorithm!r}; known: "
                       f"{sorted(PARAM_TYPES)}")
    fields: Mapping[str, Any] = leaves._asdict() \
        if hasattr(leaves, "_asdict") else dict(leaves)
    cls = PARAM_TYPES[algorithm]
    quant = QUANT_TYPES.get(algorithm)
    if quant is not None and set(quant._fields) <= set(fields):
        cls = quant
    missing = set(cls._fields) - set(fields)
    if missing:
        raise KeyError(f"{algorithm} params lack {sorted(missing)}")
    dev = resolve_device(device)
    out = {}
    for name in cls._fields:
        value = fields[name]
        out[name] = int(value) if name == "n_class" else _leaf(value, dev)
    return cls(**out)


def group_from_numpy(algorithm: str, leaves: Any, *,
                     device: DeviceLike = None) -> NamedTuple:
    """``leaves``: a stacked model group of the reference (its
    ``core.estimator.stack_params``), numpy-convertible, every tensor
    leaf with one leading tenant axis.  Returns the port's stacked params
    of the same form on ``device``, as ``core.estimator.stack_params``
    builds them; a leaf whose tenant axis differs raises."""
    group = params_from_numpy(algorithm, leaves, device=device)
    sizes = {name: v.shape[0] if v.ndim else None
             for name, v in zip(group._fields, group)
             if isinstance(v, torch.Tensor)}
    if None in sizes.values() or len(set(sizes.values())) != 1:
        raise ValueError(f"{algorithm} group leaves have tenant axes "
                         f"{sizes}; one leading axis expected")
    return group


def linear_from_numpy(leaves: Any, *,
                      device: DeviceLike = None) -> LinearModel:
    """``leaves``: an LR or SVM model of the reference (``W`` (C, d) and
    ``b`` (C,), numpy-convertible, a NamedTuple or a mapping).  Returns
    the port's ``LinearModel`` on ``device`` as float32."""
    fields: Mapping[str, Any] = leaves._asdict() \
        if hasattr(leaves, "_asdict") else dict(leaves)
    missing = set(LinearModel._fields) - set(fields)
    if missing:
        raise KeyError(f"linear model lacks {sorted(missing)}")
    W, b = (np.asarray(fields[f], np.float32) for f in LinearModel._fields)
    if W.ndim != 2 or b.shape != (W.shape[0],):
        raise ValueError(f"W {W.shape} and b {b.shape}: (C, d) and (C,) "
                         "expected")
    dev = resolve_device(device)
    return LinearModel(W=_leaf(W, dev), b=_leaf(b, dev))


def _lm_leaf(value: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        # numpy's bfloat16 (from JAX) has no torch counterpart: every
        # bfloat16 is exact in float32, so go through it
        return torch.tensor(arr.astype(np.float32),
                            device=device).to(torch.bfloat16)
    return torch.tensor(arr, device=device)


def lm_params_from_numpy(cfg, tree: Mapping[str, Any], *,
                         device: DeviceLike = None) -> dict:
    """``tree``: the reference's LM params for ``cfg`` with numpy leaves
    (``jax.tree.map(np.asarray, params)``): ``embed`` (``tok``,
    ``unembed``), ``final_norm`` and ``layers/sub0`` with every layer's
    weights stacked on a leading axis.  Returns the port's params, the
    same tree of tensors on ``device`` with dtypes kept.  Missing leaves
    raise ``KeyError`` and wrong shapes ``ValueError``, each naming the
    leaf; non-dense configs raise ``NotImplementedError``."""
    from repro_torch.models.transformer import param_shapes
    want = param_shapes(cfg)
    dev = resolve_device(device)

    def carry(node, shapes, where):
        if isinstance(shapes, dict):
            if not isinstance(node, Mapping):
                raise KeyError(f"{where}: a mapping expected, got "
                               f"{type(node).__name__}")
            missing = set(shapes) - set(node)
            if missing:
                raise KeyError(f"{where} lacks {sorted(missing)}")
            return {k: carry(node[k], shapes[k], f"{where}/{k}")
                    for k in shapes}
        if tuple(np.shape(node)) != shapes:
            raise ValueError(f"{where}: shape {tuple(np.shape(node))}, "
                             f"{shapes} expected for {cfg.arch_id}")
        return _lm_leaf(node, dev)

    return carry(tree, want, "params")
