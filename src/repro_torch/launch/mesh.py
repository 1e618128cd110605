"""Device meshes for the sharded fit/serve layer.

Counterpart of the JAX package's ``launch/mesh.py``.  A ``Mesh`` names
its axes and holds one ``torch.device`` a shard; one process drives every
shard, as one controller drives a ``shard_map`` (``core/collectives.py``
runs the collectives between the shards' tensors).  The builders are
functions, never module-level constants, so importing this module touches
no device.

``_mk`` (and the builders over it) takes the visible cards in order and
raises, naming the count, where fewer exist than shards.
``make_local_mesh(n, device)`` puts all ``n`` shards on one named device:
the counterpart of the JAX package's forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=n``), which the tests
use on the CPU and ``chip_smoke.py`` on the one card.  No builder places a
shard on a device other than the ones it was given or found.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import MeshConfig
from repro_torch.device import DeviceLike, resolve_device


class Mesh:
    """Named axes over a grid of devices, one device a shard.  ``shape``
    maps each axis name to its size, in axis order, as
    ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D device grid for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def shard_devices(self, axis: str) -> List[torch.device]:
        """The device of each shard along ``axis`` (index 0 on every other
        axis: the sharded layer partitions one axis and replicates over
        the rest)."""
        if axis not in self.shape:
            raise KeyError(f"mesh has no axis {axis!r}; axes "
                           f"{self.axis_names}")
        pos = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        out = []
        for i in range(self.shape[axis]):
            index[pos] = i
            out.append(self.devices[tuple(index)])
        return out

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices.flat})
        return f"Mesh(shape={self.shape}, devices={devs})"


def visible_cards() -> List[torch.device]:
    """The visible CUDA devices, in order (none without a card)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _mk(shape, axes, devices: Optional[Sequence[DeviceLike]] = None
        ) -> Mesh:
    """A mesh of ``shape`` over the first prod(shape) of ``devices`` (the
    visible cards when None)."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    devs = visible_cards() if devices is None else \
        [torch.device(d) for d in devices]
    if len(devs) < n:
        raise RuntimeError(
            f"a mesh of shape {shape} needs {n} devices, only {len(devs)} "
            f"visible; on fewer cards use make_local_mesh({n}, device), "
            f"which runs the {n} shards on one device")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devs[:n]):
        grid[i] = d
    return Mesh(grid.reshape(shape), axes)


def make_local_mesh(n: int, device: DeviceLike, axis: str = "data") -> Mesh:
    """``n`` shards on one explicit device along ``axis``: the counterpart
    of the JAX package's forced host devices, for the CPU tests and for a
    machine with one card."""
    dev = resolve_device(device)
    return _mk((n,), (axis,), devices=[dev] * int(n))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single-pod (256 devices) or 2x16x16 multi-pod (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk(shape, axes)


def mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    return MeshConfig(data=16, model=16, pods=2 if multi_pod else 1)


def make_mesh_from_config(mesh_cfg: MeshConfig) -> Mesh:
    return _mk(mesh_cfg.shape, mesh_cfg.axis_names)


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A small mesh over however many cards are visible."""
    n = len(visible_cards())
    if data * model > n:
        raise RuntimeError(f"a ({data}, {model}) mesh needs {data * model} "
                           f"devices, only {n} visible")
    return _mk((data, model), ("data", "model"))
