"""Gradient compression for the data-parallel all-reduce: int8 quantise ->
sum -> dequantise with an error-feedback accumulator.

Counterpart of the JAX package's ``training/grad_compression.py``: one
symmetric int8 scale per tensor (amax / 127, values rounded half to even
as ``jnp.round`` does), and the quantisation error of step t added back
into the gradient of step t+1, which keeps the scheme convergent.  On one
card there is no all-reduce; the round trip is what a step applies.

Unlike the reference, ``compress_tree`` updates a given residual tree IN
PLACE (and returns it): at stablelm-3b's width a second fp32 residual
tree would take 11 GB.
"""
from __future__ import annotations

import torch

from repro_torch import tree as T


def quantize_int8(g: torch.Tensor):
    """Per-tensor symmetric int8 quantisation. Returns (q, scale)."""
    gf = g.to(torch.float32)
    amax = torch.clamp(torch.max(torch.abs(gf)), min=1e-12)
    scale = amax / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_tree(grads, residuals=None):
    """Quantise a gradient tree with error feedback.

    Returns (tree of (q, scale), residuals): the residual of each leaf is
    corrected - dequantised, written into ``residuals`` in place where it
    is given."""
    if residuals is None:
        residuals = T.map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                device=g.device), grads)
    qs = []
    for g, r in zip(T.leaves(grads), T.leaves(residuals)):
        r.add_(g.to(torch.float32))             # the corrected gradient
        q, s = quantize_int8(r)
        r.sub_(dequantize_int8(q, s))
        qs.append((q, s))
    return T.unflatten(grads, iter(qs)), residuals


def decompress_tree(qtree):
    """The fp32 tree of a tree of (q, scale) pairs."""
    if isinstance(qtree, dict):
        return {k: decompress_tree(v) for k, v in qtree.items()}
    return dequantize_int8(*qtree)


def roundtrip_error(g: torch.Tensor) -> torch.Tensor:
    """Relative L2 error of one quantise/dequantise pass."""
    q, s = quantize_int8(g)
    deq = dequantize_int8(q, s)
    gf = g.to(torch.float32)
    return torch.linalg.norm(deq - gf) / torch.clamp(torch.linalg.norm(gf),
                                                     min=1e-12)
