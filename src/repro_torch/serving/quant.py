"""Generic int8 codec and byte accounting of the serving tiers.

Counterpart of the JAX package's ``serving/quant.py``: symmetric
per-output-channel int8 (``QuantTensor``: the int8 payload and one f32
scale a channel of the last axis) for any params NamedTuple.  The engine's
``quant_report`` reads ``quant_bytes``/``param_bytes``; the model store
(``serving/model_store.py``) keeps evicted tenants in this at-rest form.

The arithmetic is the reference's operation for operation, so the at-rest
payload is bit-equal to the JAX package's and requantizing a dequantized
tensor gives it back (the int8 lattice is a fixed point):
``scale = max(amax, 1e-12) / 127`` in f32, a true division ``w / scale``
(not a multiply by its reciprocal), round half to even, clip to ±127.
A params NamedTuple's leaves are its fields; static ints (``n_class``)
carry no bytes and pass through.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class QuantTensor(NamedTuple):
    q: torch.Tensor        # int8, the original's shape
    scale: torch.Tensor    # f32, one a channel of ``axis`` (keepdims)


def _leaves(params):
    """The tensors of a params NamedTuple, a ``QuantTensor`` leaf as its
    payload and its scales."""
    out = []
    for p in params:
        if isinstance(p, QuantTensor):
            out.extend((p.q, p.scale))
        elif isinstance(p, torch.Tensor):
            out.append(p)
    return out


def quantize_weight(w: torch.Tensor, axis: int = -1) -> QuantTensor:
    """Symmetric per-channel int8 along ``axis`` (default: the last,
    the output channels)."""
    wf = w.to(torch.float32)
    keep = axis % w.ndim
    dims = tuple(i for i in range(w.ndim) if i != keep)
    amax = torch.amax(torch.abs(wf), dim=dims, keepdim=True) if dims \
        else torch.abs(wf)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QuantTensor(q=q, scale=scale.to(torch.float32))


def dequantize(qt: QuantTensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (qt.q.to(torch.float32) * qt.scale).to(dtype)


def _should_quantize(p: torch.Tensor, min_size: int) -> bool:
    """The one quantise-this-leaf predicate: ``quantize_params`` and
    ``quant_bytes`` apply the same one."""
    return p.is_floating_point() and p.numel() >= min_size and p.ndim >= 2


def quantize_params(params, *, min_size: int = 1 << 16):
    """Every float leaf of at least ``min_size`` elements and two
    dimensions as a ``QuantTensor``; the other leaves (small tensors,
    integer tensors, static ints) as they are.  Same NamedTuple type."""
    def one(p):
        if isinstance(p, torch.Tensor) and _should_quantize(p, min_size):
            return quantize_weight(p)
        return p

    return type(params)(*(one(p) for p in params))


def dequantize_params(qparams, dtype=torch.bfloat16):
    """The inverse of ``quantize_params`` up to the lattice rounding:
    ``QuantTensor`` leaves back to ``dtype``, the rest as they are."""
    return type(qparams)(*(dequantize(p, dtype) if isinstance(p, QuantTensor)
                           else p for p in qparams))


def quant_bytes(params, *, min_size: int = 1 << 16) -> int:
    """Serialized size if quantised with ``quantize_params(min_size=...)``:
    the int8 payload and f32 per-output-channel scales of each quantised
    leaf, the other tensors at their own width."""
    total = 0
    for p in _leaves(params):
        if _should_quantize(p, min_size):
            total += p.numel()             # int8 payload
            total += 4 * p.shape[-1]       # f32 per-output-channel scales
        else:
            total += p.numel() * p.element_size()
    return total


def param_bytes(params) -> int:
    """Actual byte count of a params NamedTuple, any leaf dtypes (int8
    payloads one byte an element)."""
    return sum(p.numel() * p.element_size() for p in _leaves(params))


def relative_error(w: torch.Tensor, qt: QuantTensor) -> float:
    """‖dequantize(qt) − w‖ / ‖w‖ in f32."""
    deq = dequantize(qt, torch.float32)
    wf = w.to(torch.float32)
    return float(torch.linalg.norm(deq - wf)
                 / torch.clamp(torch.linalg.norm(wf), min=1e-12))
