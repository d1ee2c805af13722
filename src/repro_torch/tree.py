"""Pytrees of nested dicts, tuples and lists, flattened in ``jax.tree_util``'s
order: a dict's values in sorted key order, a sequence's in its own order.

The traced ``input`` nodes, the sharding-spec leaves and the base/dist input
lists all come from :func:`tree_flatten`, so leaf ``i`` is the same
parameter everywhere.  A :class:`~repro_torch.parallel.sharding.PartitionSpec`
is a leaf, not a sequence.
"""
from __future__ import annotations

from typing import Any, Callable


def _is_node(x, is_leaf) -> bool:
    if is_leaf is not None and is_leaf(x):
        return False
    if isinstance(x, dict):
        return True
    return type(x) in (tuple, list)


def _children(x):
    if isinstance(x, dict):
        keys = sorted(x)
        return keys, [x[k] for k in keys]
    return list(range(len(x))), list(x)


def _flatten(x, path, is_leaf, out) -> Any:
    if not _is_node(x, is_leaf):
        out.append((path, x))
        return "*"
    keys, vals = _children(x)
    kids = tuple(_flatten(v, path + (k,), is_leaf, out) for k, v in zip(keys, vals))
    if isinstance(x, dict):
        return ("dict", tuple(keys), kids)
    return (type(x).__name__, len(kids), kids)


def tree_flatten_with_path(tree, is_leaf: Callable | None = None):
    """``([(path, leaf), ...], treedef)``; a path is the tuple of dict keys
    and sequence indices from the root to the leaf.  (The recursion is a
    module function: a recursive closure is a reference cycle, which would
    keep the leaves alive until the cyclic collector runs.)"""
    out: list = []
    treedef = _flatten(tree, (), is_leaf, out)
    return out, treedef


def tree_flatten(tree, is_leaf: Callable | None = None) -> tuple[list, Any]:
    pairs, treedef = tree_flatten_with_path(tree, is_leaf)
    return [leaf for _, leaf in pairs], treedef


def tree_leaves(tree, is_leaf: Callable | None = None) -> list:
    return tree_flatten(tree, is_leaf)[0]


def _build(td, it) -> Any:
    if td == "*":
        return next(it)
    kind, keys, kids = td
    vals = [_build(k, it) for k in kids]
    if kind == "dict":
        return dict(zip(keys, vals))
    return tuple(vals) if kind == "tuple" else list(vals)


def tree_unflatten(treedef, leaves) -> Any:
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree holds")
    return out


_END = object()


def tree_map(fn: Callable, tree, is_leaf: Callable | None = None) -> Any:
    leaves, treedef = tree_flatten(tree, is_leaf)
    return tree_unflatten(treedef, [fn(x) for x in leaves])


def tree_map_with_path(fn: Callable, tree, is_leaf: Callable | None = None) -> Any:
    """``fn(path, leaf)`` on every leaf; ``path`` as in
    :func:`tree_flatten_with_path`."""
    pairs, treedef = tree_flatten_with_path(tree, is_leaf)
    return tree_unflatten(treedef, [fn(p, x) for p, x in pairs])
