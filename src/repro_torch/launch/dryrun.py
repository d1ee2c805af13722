"""The ZeRO-1 spec helpers of the JAX package's dry-run launcher.

Only these are ported so far.  ``_zero_flags_from_specs`` gives the
per-leaf ZeRO-1 shard dims that the trainer's ZeRO-1 path takes; the
moment specs and shapes have no caller in the port yet and are held to the
JAX package's by its tests.  The dry run itself (lowering every cell for
the production mesh) is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ShapeDtype
from repro_torch.parallel.sharding import P, is_spec
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


def _f32_like(spec_tree):
    return tree_map(lambda s: ShapeDtype(tuple(s.shape), torch.float32), spec_tree)


def _zip_map(fn, tree, *others):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``others`` (PartitionSpecs and ints are leaves), in ``tree``'s shape."""
    leaves, treedef = tree_flatten(tree, is_leaf=is_spec)
    rest = [tree_flatten(o, is_leaf=is_spec)[0] for o in others]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *rest)])


def _opt_specs(pspecs, *, zero1: bool, dp_last: str | None, flags=None):
    """Optimizer-moment PartitionSpecs: same as params; with ZeRO-1 the shard
    dim per leaf (from _zero_flags_from_specs; -1 = replicated) additionally
    shards over the given axis."""

    def visit(spec, dim):
        if not zero1 or dp_last is None or dim is None or dim < 0:
            return spec
        entries = list(tuple(spec))
        entries += [None] * (dim + 1 - len(entries))
        entries[dim] = dp_last
        return P(*entries)

    if flags is None:
        flags = tree_map(lambda _: 0, pspecs, is_leaf=is_spec)
    m = _zip_map(visit, pspecs, flags)
    return {"m": m, "v": m, "step": P()}


def _zero_flags_from_specs(param_shapes, dp_size: int, pspecs):
    """Per-leaf ZeRO shard dim: the first dim that is spec-unsharded and
    divisible by the shard group size (-1 = keep replicated)."""

    def visit(s, spec):
        entries = tuple(spec)
        for i, size in enumerate(s.shape):
            e = entries[i] if i < len(entries) else None
            if e is None and size % dp_size == 0 and size >= dp_size:
                return i
        return -1

    return _zip_map(visit, param_shapes, pspecs)


def _zero_opt_shapes(param_shapes):
    # global view: moments keep full shape; sharding comes from specs
    m = _f32_like(param_shapes)
    return {"m": m, "v": m, "step": ShapeDtype((), torch.int32)}
