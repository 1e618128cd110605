"""Trees of tensors: nested dicts and NamedTuples, the port's pytrees.

The training path's params, optimizer state and checkpoints are such
trees.  Leaves are visited in the JAX package's order (a dict's keys
sorted, a NamedTuple's fields in order), so a flat list of leaves, a
global norm summed over them and a checkpoint's paths line up with the
reference's.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in the reference's order; a path joins keys and
    field names with "/"."""
    out: List[Tuple[str, Any]] = []
    if isinstance(tree, dict):
        for key in sorted(tree):
            out += flatten(tree[key], f"{prefix}{key}/")
    elif _is_namedtuple(tree):
        for key, value in zip(tree._fields, tree):
            out += flatten(value, f"{prefix}{key}/")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            out += flatten(value, f"{prefix}{i}/")
    else:
        out.append((prefix.rstrip("/"), tree))
    return out


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(like: Any, values: Iterator[Any]) -> Any:
    """A tree shaped as ``like`` holding ``values`` in ``flatten`` order."""
    if isinstance(like, dict):
        return {key: unflatten(like[key], values) for key in sorted(like)}
    if _is_namedtuple(like):
        return type(like)(*(unflatten(v, values) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(unflatten(v, values) for v in like)
    return next(values)


def map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the leaves of ``tree``, in a tree of the same
    structure."""
    return unflatten(tree, (fn(leaf) for leaf in leaves(tree)))
