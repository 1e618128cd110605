"""Byte accounting of the int8 serving tier.

The part of the JAX package's ``serving/quant.py`` that the engine's
``quant_report`` needs: ``_should_quantize``, ``quant_bytes`` and
``param_bytes``.  A params NamedTuple's leaves are its tensor fields;
static ints (``n_class``) carry no bytes.
"""
from __future__ import annotations

import torch


def _leaves(params):
    return [p for p in params if isinstance(p, torch.Tensor)]


def _should_quantize(p: torch.Tensor, min_size: int) -> bool:
    """The one quantise-this-leaf predicate ``quant_bytes`` applies."""
    return p.is_floating_point() and p.numel() >= min_size and p.ndim >= 2


def quant_bytes(params, *, min_size: int = 1 << 16) -> int:
    """Serialized size if every float leaf of at least ``min_size``
    elements (and two dimensions) were stored int8 with f32
    per-output-channel scales."""
    total = 0
    for p in _leaves(params):
        if _should_quantize(p, min_size):
            total += p.numel()             # int8 payload
            total += 4 * p.shape[-1]       # f32 per-output-channel scales
        else:
            total += p.numel() * p.element_size()
    return total


def param_bytes(params) -> int:
    """Actual byte count of a params NamedTuple, any leaf dtypes."""
    return sum(p.numel() * p.element_size() for p in _leaves(params))
