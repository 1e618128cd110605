"""Logical-axis partitioning rules -> PartitionSpec, for the port's LM stack.

Counterpart of the JAX package's ``sharding/partitioning.py``: the
production-scale form of the paper's §4.1 horizontal / vertical workload
distribution.  *Horizontal* (row/sample) splits map to the data axes,
*vertical* (feature/contraction) splits to the model axis.

Every parameter, cache and input leaf carries a tuple of *logical* axis
names; ``to_pspec`` resolves it against a ``MeshConfig`` with the
reference's divisibility fix-up (a logical axis whose dimension does not
divide its mesh axes falls back to shorter prefixes, and is left
unsharded, recorded in ``audit``, where none divides).  The specs are
pure functions of a config, a shape and a mesh: no device is touched, so
the dry run (``launch/dryrun.py``) builds them for the 256- and 512-chip
production meshes on any machine.

The port's ``PartitionSpec`` is its own small immutable value: a tuple of
entries, each ``None``, a mesh axis name or a tuple of axis names, as
``jax.sharding.PartitionSpec`` holds them; ``tuple(spec)`` of either
gives the same entries.  ``ParallelPlan`` names the axes of a port
``launch.mesh.Mesh`` for the layers that run explicit per-shard phases
(``models/moe.py::apply_moe_two_phase``).

The reference's ``compat.py`` (its jax version shims) and
``named_sharding`` (a ``jax.sharding.NamedSharding``) have no
counterpart: the port places each shard's tensors itself
(``core/collectives.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

from repro_torch.configs.base import MeshConfig

Entry = Union[None, str, Tuple[str, ...]]


class PartitionSpec:
    """An immutable tuple of per-dimension entries (``None``, an axis name
    or a tuple of axis names).  Not a Python tuple, so the port's tree
    helpers (``repro_torch.tree``) take it as one leaf."""

    __slots__ = ("_entries",)

    def __init__(self, *entries: Entry):
        for e in entries:
            if not (e is None or isinstance(e, str) or (
                    isinstance(e, tuple)
                    and all(isinstance(a, str) for a in e))):
                raise TypeError(f"a PartitionSpec entry is None, an axis "
                                f"name or a tuple of names, not {e!r}")
        object.__setattr__(self, "_entries", tuple(entries))

    def __setattr__(self, name, value):
        raise AttributeError("PartitionSpec is immutable")

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, PartitionSpec) and \
            self._entries == other._entries

    def __hash__(self) -> int:
        return hash(self._entries)

    def __repr__(self) -> str:
        return "PartitionSpec(" + ", ".join(map(repr, self._entries)) + ")"


@dataclass(frozen=True)
class ParallelPlan:
    """Mesh + axis names threaded into the layers that run explicit
    per-shard phases (the paper-style two-phase schedules).  ``None`` in
    their place runs the one-device route."""

    mesh: Any                          # repro_torch.launch.mesh.Mesh
    dp_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"

    @property
    def dp_total(self) -> int:
        n = 1
        for a in self.dp_axes:
            n *= self.mesh.shape[a]
        return n


# logical axis -> tuple of mesh axis *roles*; "dp" expands to the mesh's data
# axes (("pod","data") multi-pod, ("data",) single-pod).
DEFAULT_RULES: Dict[Optional[str], Tuple[str, ...]] = {
    "batch": ("dp",),
    "seq": (),
    "kv_seq": (),            # long-context decode overrides to ("dp",)
    "embed": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    # KV-cache head_dim: claims the model axis when kv_heads can't divide it
    # (GQA kv=4/8 on a 16-way axis) -- the paper's vertical/contraction split
    # applied to decode attention. to_pspec's used-set keeps at most one of
    # kv_heads/kv_hd on the model axis.
    "kv_hd": ("model",),
    "qkv": ("model",),        # fused q/kv output dim
    "mlp": ("model",),
    "experts": ("model",),
    "expert_cap": (),
    "vocab": ("model",),
    "layers": (),
    "blocks": (),
    "state": (),
    "ssm_heads": ("model",),
    "d_inner": ("model",),
    "conv": (),
    "frames": (),
    "patches": (),
    "zero1": ("dp",),         # ZeRO-1 optimizer-state extra axis
    None: (),
}

Logical = Tuple[Optional[str], ...]


def is_logical(x) -> bool:
    """A logical leaf: a plain tuple of axis names and ``None``s (the
    reference's ``_LOGICAL_LEAF``)."""
    return type(x) is tuple and all(isinstance(e, (str, type(None)))
                                    for e in x)


def map_logical(fn: Callable, tree, *rest):
    """``fn(leaf, *matching leaves of rest)`` over a tree of dicts and
    NamedTuples, into a tree of the same structure: every other node is a
    leaf, so a logical tuple (``is_logical``), a PartitionSpec or a shape
    tuple is one.  ``None`` stays ``None`` (an absent field, as in the
    reference's ``DecodeCache``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_logical(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_logical(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    return fn(tree, *rest)


def leaf_shape(leaf) -> tuple:
    """A leaf's shape: a tensor's, a shape tuple itself, or () for a host
    scalar (the decode cache's ``length``)."""
    if hasattr(leaf, "shape"):
        return tuple(leaf.shape)
    return tuple(leaf) if isinstance(leaf, tuple) else ()


def _expand(role: str, mesh_cfg: MeshConfig) -> Tuple[str, ...]:
    if role == "dp":
        return mesh_cfg.dp_axes
    return (role,)


def mesh_axis_size(mesh_cfg: MeshConfig, axis: str) -> int:
    return {"pod": mesh_cfg.pods, "data": mesh_cfg.data,
            "model": mesh_cfg.model}[axis]


def to_pspec(
    logical: Logical,
    mesh_cfg: MeshConfig,
    shape: Optional[Sequence[int]] = None,
    rules: Optional[Dict[str, Tuple[str, ...]]] = None,
    audit: Optional[list] = None,
) -> PartitionSpec:
    """Resolve logical axes to a PartitionSpec, dropping non-divisible
    axes (shorter prefixes first; ``audit`` gets (logical, dim, name,
    shape) for each dimension left unsharded that way)."""
    rules = {**DEFAULT_RULES, **(rules or {})}
    out = []
    used: set = set()
    for i, name in enumerate(logical):
        roles = rules.get(name, ())
        axes: Tuple[str, ...] = ()
        for r in roles:
            axes += _expand(r, mesh_cfg)
        # never reuse a mesh axis across dims of one array
        axes = tuple(a for a in axes if a not in used
                     and a in mesh_cfg.axis_names)
        if shape is not None and axes:
            total = math.prod(mesh_axis_size(mesh_cfg, a) for a in axes)
            if shape[i] % total != 0:
                # try progressively shorter prefixes
                while axes:
                    total = math.prod(mesh_axis_size(mesh_cfg, a)
                                      for a in axes)
                    if shape[i] % total == 0:
                        break
                    axes = axes[:-1]
                if not axes and audit is not None:
                    audit.append((logical, i, name, tuple(shape)))
        used.update(axes)
        if len(axes) == 0:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(tuple(axes))
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def tree_to_pspecs(logical_tree, mesh_cfg: MeshConfig, shape_tree=None,
                   rules=None):
    """Map a tree of logical tuples (+ optional matching shapes) to
    pspecs."""
    if shape_tree is None:
        return map_logical(lambda lg: to_pspec(lg, mesh_cfg, rules=rules),
                           logical_tree)
    return map_logical(
        lambda lg, sh: to_pspec(lg, mesh_cfg, shape=sh, rules=rules),
        logical_tree, shape_tree)


def zero1_pspec(pspec: PartitionSpec, shape: Sequence[int],
                mesh_cfg: MeshConfig) -> PartitionSpec:
    """ZeRO-1: additionally shard an optimizer-state tensor over the data
    axes.

    Finds the first dimension that (a) is not already sharded and (b) is
    divisible by the total data-parallel degree, and assigns the dp axes
    to it.  Falls back to the original spec when no dimension qualifies.
    """
    dp_axes = mesh_cfg.dp_axes
    dp_total = math.prod(mesh_axis_size(mesh_cfg, a) for a in dp_axes)
    entries = list(pspec) + [None] * (len(shape) - len(pspec))
    for i, (dim, cur) in enumerate(zip(shape, entries)):
        if cur is None and dim % dp_total == 0:
            entries[i] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
            while entries and entries[-1] is None:
                entries.pop()
            return PartitionSpec(*entries)
    return pspec


def validate_pspec(pspec: PartitionSpec, shape: Sequence[int],
                   mesh_cfg: MeshConfig) -> None:
    """Raise if a sharded dim is not divisible by its mesh axes
    product."""
    for i, entry in enumerate(pspec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        total = math.prod(mesh_axis_size(mesh_cfg, a) for a in axes)
        if shape[i] % total != 0:
            raise ValueError(
                f"dim {i} of shape {tuple(shape)} not divisible by mesh "
                f"axes {axes} (={total}) in spec {pspec}")


def shards_of(pspec: PartitionSpec, mesh_cfg: MeshConfig) -> int:
    """How many pieces a leaf with ``pspec`` is cut into: the product of
    the sizes of the mesh axes it names (a leaf's bytes over this are its
    bytes on one device)."""
    n = 1
    for entry in pspec:
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            n *= mesh_axis_size(mesh_cfg, a)
    return n
