"""Collectives between the shards of a single-process mesh.

A ``shard_map`` body in the JAX package runs on every shard at once and
meets the others at a collective.  One process cannot stop shard 0 at an
``all_gather`` and wait for shard 7, so the port's sharded layer
(``core/cluster.py``) writes each body as phases: a per-shard local step
over a list of shard tensors (``on(device)`` around it), a collective over
that list (below), then a per-shard or replicated merge.

Shard ``i`` of a row partition holds the contiguous rows
``[i * L, (i + 1) * L)`` of the operand padded to a multiple of the shard
count (``shard_rows``), so position order is global row order.  Tensors
move between shards' devices by ``.to(device)``; on a mesh of one device
(``launch.mesh.make_local_mesh``) every move is a no-op, the shards are
views of one tensor (but for a block off a 16-byte boundary, which
``shard_rows`` copies), and a collective is one ``torch.stack`` or
``torch.cat`` on that device, with no host copy.
"""
from __future__ import annotations

import contextlib
from typing import Iterable, List, Sequence, Tuple, Union

import torch

from repro_torch.core.distribution import pad_to_multiple

Shards = List[torch.Tensor]

_ALIGN = 16      # bytes: the base alignment of the kernels' bulk routes


def on(device: torch.device):
    """The context a shard's local step runs in: its card current (the
    kernels launch on the current device's stream), nothing on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def replicate(x: torch.Tensor, devices: Sequence[torch.device]) -> Shards:
    """One copy of ``x`` a shard (the same tensor where it already lies on
    the shard's device)."""
    return [x.to(d) for d in devices]


def shard_rows(x: torch.Tensor, devices: Sequence[torch.device],
               value: float = 0.0) -> Tuple[Shards, int]:
    """Axis 0 padded with ``value`` to a multiple of the shard count and
    cut into contiguous blocks, block i on shard i's device.  A block
    whose base lies off a 16-byte boundary gets storage of its own: the
    kernels stage aligned rows by bulk copies, and B2 also sums them in
    another order than unaligned ones, so an unaligned shard would not
    reproduce the one-device rows bit for bit.  Returns (blocks,
    unpadded length)."""
    c = len(devices)
    xp, n = pad_to_multiple(x, c, axis=0, value=value)
    L = xp.shape[0] // c
    blocks = [xp[i * L:(i + 1) * L].to(d) for i, d in enumerate(devices)]
    return [b if b.data_ptr() % _ALIGN == 0 else b.clone()
            for b in blocks], n


def as_replicas(x: Union[torch.Tensor, Sequence[torch.Tensor]],
                devices: Sequence[torch.device]) -> Shards:
    """``x`` replicated, unless it is already a list of one copy a shard
    (params a serving engine placed once)."""
    if isinstance(x, (list, tuple)):
        _check_count(x, devices)
        return list(x)
    return replicate(x, devices)


def as_row_shards(x: Union[torch.Tensor, Sequence[torch.Tensor]],
                  devices: Sequence[torch.device],
                  value: float = 0.0) -> Shards:
    """``x`` cut into row blocks (``shard_rows``), unless it is already a
    list of equal blocks, one a shard."""
    if isinstance(x, (list, tuple)):
        _check_count(x, devices)
        if len({int(t.shape[0]) for t in x}) != 1:
            raise ValueError("row shards of unequal length: "
                             f"{[int(t.shape[0]) for t in x]}")
        return list(x)
    return shard_rows(x, devices, value)[0]


def _check_count(parts: Sequence[torch.Tensor],
                 devices: Sequence[torch.device]) -> None:
    if len(parts) != len(devices):
        raise ValueError(f"{len(parts)} shards for a {len(devices)}-shard "
                         "mesh axis")


def all_gather(parts: Iterable[torch.Tensor],
               device: torch.device) -> torch.Tensor:
    """(c, ...) on ``device``: every shard's tensor, in shard order."""
    return torch.stack([p.to(device) for p in parts])


def gather_rows(parts: Iterable[torch.Tensor],
                device: torch.device) -> torch.Tensor:
    """The row blocks concatenated in shard order on ``device`` (the
    inverse of ``shard_rows``, padding still on)."""
    return torch.cat([p.to(device) for p in parts])


def psum(parts: Sequence[torch.Tensor],
         device: torch.device) -> torch.Tensor:
    """The shards' tensors summed in shard order, on ``device``."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def ppermute(parts: Sequence[torch.Tensor],
             perm: Sequence[Tuple[int, int]],
             devices: Sequence[torch.device]) -> Shards:
    """``out[j] = parts[i]`` on shard j's device for each (i, j) of
    ``perm``, as ``jax.lax.ppermute`` sends; a shard no pair names gets
    zeros."""
    out: List = [None] * len(parts)
    for src, dst in perm:
        out[dst] = parts[src].to(devices[dst])
    return [o if o is not None else torch.zeros_like(p)
            for o, p in zip(out, parts)]
