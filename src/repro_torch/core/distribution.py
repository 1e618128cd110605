"""Horizontal / vertical workload distribution (paper §4.1) and the
two-phase (local -> global) reduction schemes (paper §4.2-4.4).

The paper dispatches work to 8 PULP cores with offline-chosen chunk sizes
and runtime lb/ub bounds; the port keeps the same decomposition as a
reshape over a "cores" axis (counterpart: the JAX package's
``core/distribution.py``).  The paper's shared intermediate
R[n_cores, N_class] and OP2's re-partitioned combine stay visible in
``two_phase_matvec`` rather than folded into one ``W @ x``.
``two_phase_matvec_shardmap`` is the same scheme over a mesh axis
(``launch/mesh.py``): OP1 a per-shard partial product, OP2 their psum.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# §4.1 — partitioning strategy and chunk bounds
# ---------------------------------------------------------------------------


def choose_partition(r: int, c: int) -> str:
    """Paper §4.1: r >> c favours row-wise (horizontal), c >> r
    column-wise (vertical) decomposition of an (r x c) operand."""
    return "horizontal" if r >= c else "vertical"


def chunk_bounds(n: int, n_cores: int, core_id):
    """Runtime lb/ub computation, the paper's formula:
    chunk = n / n_cores; lb = core_id * chunk; ub = lb + chunk."""
    chunk = n // n_cores
    lb = core_id * chunk
    return lb, lb + chunk


def pad_to_multiple(x: torch.Tensor, n_cores: int, axis: int = 0,
                    value: float = 0.0):
    """Pad ``axis`` up to a multiple of ``n_cores``; returns (padded,
    original length)."""
    axis = axis % x.ndim
    n = x.shape[axis]
    pad = (-n) % n_cores
    if pad == 0:
        return x, n
    widths = [0, 0] * x.ndim            # F.pad lists the LAST axis first
    widths[2 * (x.ndim - 1 - axis) + 1] = pad
    return F.pad(x, widths, value=value), n


def split_chunks(x: torch.Tensor, n_cores: int, axis: int = 0):
    """(n, ...) -> (n_cores, n/n_cores, ...) along ``axis`` (pre-padded)."""
    axis = axis % x.ndim
    n = x.shape[axis]
    if n % n_cores:
        raise ValueError(f"axis {axis} of length {n} does not split into "
                         f"{n_cores} chunks; pad_to_multiple first")
    new_shape = x.shape[:axis] + (n_cores, n // n_cores) + x.shape[axis + 1:]
    return x.reshape(new_shape)


# ---------------------------------------------------------------------------
# Two-phase matvec (paper Fig. 4 OP1/OP2): y = W @ x + b
# ---------------------------------------------------------------------------


def two_phase_matvec(W: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                     n_cores: int = 8) -> torch.Tensor:
    """Vertical (column-wise) split of the contraction dim, per-core
    partial products into R[n_cores, C], then a row-wise combine with the
    bias.

    W: (C, d); x: (d,) or (B, d) queries; b: (C,).  Returns y: (C,) or
    (B, C).  A batch of queries runs both phases for every query at once
    (R is (B, n_cores, C)).
    """
    C, d = W.shape
    Wp, _ = pad_to_multiple(W, n_cores, axis=1)
    xp, _ = pad_to_multiple(x, n_cores, axis=-1)
    Wc = split_chunks(Wp, n_cores, axis=1)        # (C, n_cores, d/n)
    xc = split_chunks(xp, n_cores, axis=-1)       # (..., n_cores, d/n)

    # OP1 — each core: partial dot over its d-chunk, all classes
    R = torch.einsum("cnk,...nk->...nc", Wc, xc)  # (..., n_cores, C)

    # OP2 — row-wise re-partition: each core combines the R rows of its
    # classes (summing over the source cores) and adds their bias
    Rp, C_orig = pad_to_multiple(R, n_cores, axis=-1)
    bp, _ = pad_to_multiple(b, n_cores, axis=0)
    Rc = split_chunks(Rp, n_cores, axis=-1)       # (..., src, n_cores, C/n)
    bc = split_chunks(bp, n_cores, axis=0)        # (n_cores, C/n)
    y = Rc.sum(dim=-3) + bc                       # (..., n_cores, C/n)
    return y.reshape(*y.shape[:-2], -1)[..., :C_orig]


def two_phase_matvec_shardmap(W: torch.Tensor, x: torch.Tensor,
                              b: torch.Tensor, mesh,
                              axis: str = "data") -> torch.Tensor:
    """``two_phase_matvec`` over a mesh axis: the d-contraction sharded
    (zero-padded to a multiple of the shard count), OP1 each shard's
    partial product over its feature chunk, OP2 the psum of the partials
    plus the bias.  W: (C, d); x: (d,) or (B, d); b: (C,)."""
    from repro_torch.core import collectives as col
    devs = mesh.shard_devices(axis)
    n = len(devs)
    Wp, _ = pad_to_multiple(W, n, axis=1)
    xp, _ = pad_to_multiple(x, n, axis=-1)
    L = Wp.shape[1] // n
    partial = []
    for i, d in enumerate(devs):
        with col.on(d):
            partial.append(xp[..., i * L:(i + 1) * L].to(d)
                           @ Wp[:, i * L:(i + 1) * L].to(d).T)   # OP1
    return col.psum(partial, x.device) + b                   # OP2


# ---------------------------------------------------------------------------
# Two-phase chunked reduction (GNB-style: per-chunk sums -> combine)
# ---------------------------------------------------------------------------


def two_phase_reduce(fn: Callable, combine: Callable, x: torch.Tensor,
                     n_cores: int = 8, axis: int = 0):
    """OP1: apply ``fn`` per core chunk (mapped with ``torch.func.vmap``);
    OP2: ``combine`` the stacked (n_cores, ...) partials.

    fn maps a chunk (n/n_cores, ...) -> partial.
    """
    xc = split_chunks(x, n_cores, axis=axis)
    moved = torch.movedim(xc, axis % x.ndim, 0)
    partials = torch.func.vmap(fn)(moved)
    return combine(partials)
