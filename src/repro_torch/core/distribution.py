"""Horizontal / vertical chunking helpers (paper §4.1).

The paper dispatches work to 8 PULP cores with offline-chosen chunk sizes;
the port keeps the same decomposition as a reshape over a "cores" axis
(counterpart: the JAX package's ``core/distribution.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_to_multiple(x: torch.Tensor, n_cores: int, axis: int = 0,
                    value: float = 0.0):
    """Pad ``axis`` up to a multiple of ``n_cores``; returns (padded,
    original length)."""
    n = x.shape[axis]
    pad = (-n) % n_cores
    if pad == 0:
        return x, n
    widths = [0, 0] * x.ndim            # F.pad lists the LAST axis first
    widths[2 * (x.ndim - 1 - axis) + 1] = pad
    return F.pad(x, widths, value=value), n


def split_chunks(x: torch.Tensor, n_cores: int, axis: int = 0):
    """(n, ...) -> (n_cores, n/n_cores, ...) along ``axis`` (pre-padded)."""
    n = x.shape[axis]
    if n % n_cores:
        raise ValueError(f"axis {axis} of length {n} does not split into "
                         f"{n_cores} chunks; pad_to_multiple first")
    new_shape = x.shape[:axis] + (n_cores, n // n_cores) + x.shape[axis + 1:]
    return x.reshape(new_shape)
