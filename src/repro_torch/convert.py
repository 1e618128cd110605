"""Carry fitted weights across from the JAX package.

The JAX package's fitted params (``KNNModel``, ``KMeansState``,
``GNBModel``) reach this module as plain numpy leaves — anything with
``_asdict()`` or a mapping of field name to array, plus the static
``n_class`` of kNN — so the port never imports that package.  The result
is the port's NamedTuple of tensors on ``device``; hand it to the
estimator's ``from_params`` to serve it.
"""
from __future__ import annotations

from typing import Any, Mapping, NamedTuple

import numpy as np
import torch

from repro_torch.core.gnb import GNBModel
from repro_torch.core.kmeans import KMeansState
from repro_torch.core.knn import KNNModel
from repro_torch.device import DeviceLike, resolve_device

PARAM_TYPES = {"knn": KNNModel, "kmeans": KMeansState, "gnb": GNBModel}


def _leaf(value: Any, device: torch.device) -> torch.Tensor:
    # a copy: arrays exported from JAX are read-only views of its buffers
    return torch.tensor(np.asarray(value), device=device)


def params_from_numpy(algorithm: str, leaves: Any, *,
                      device: DeviceLike = None) -> NamedTuple:
    """``leaves``: the reference's fitted params as numpy-convertible
    leaves (a NamedTuple or a mapping).  Returns the port's params for
    ``algorithm`` on ``device``; dtypes are kept (float32 stays float32,
    int32 labels stay int32)."""
    if algorithm not in PARAM_TYPES:
        raise KeyError(f"no params conversion for {algorithm!r}; known: "
                       f"{sorted(PARAM_TYPES)}")
    fields: Mapping[str, Any] = leaves._asdict() \
        if hasattr(leaves, "_asdict") else dict(leaves)
    cls = PARAM_TYPES[algorithm]
    missing = set(cls._fields) - set(fields)
    if missing:
        raise KeyError(f"{algorithm} params lack {sorted(missing)}")
    dev = resolve_device(device)
    out = {}
    for name in cls._fields:
        value = fields[name]
        out[name] = int(value) if name == "n_class" else _leaf(value, dev)
    return cls(**out)
