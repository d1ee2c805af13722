"""Shared layout helpers used across rule modules."""
from __future__ import annotations

from typing import Sequence

from ..bijection import Layout, NotSplitMerge
from ..relations import Fact

# elementwise ops that are linear (distribute over add-partials)
LINEAR_UNARY = frozenset({"neg"})


def move_dim(rank: int, src: int, dst: int) -> tuple[int, ...]:
    dims = [i for i in range(rank) if i != src]
    dims.insert(dst, src)
    return tuple(dims)


_SHARD_STACK_CACHE: dict[tuple, Layout] = {}


def shard_stack_layout(shape: Sequence[int], dim: int, c: int) -> Layout:
    """Layout mapping a global tensor to its rank-stacked shards:
    ``B(shape) -> (c, *local)`` with dim ``dim`` chunked by ``c``.
    Interned: rules construct the same handful of layouts per graph pair."""
    shape = tuple(int(s) for s in shape)
    key = (shape, dim, c)
    lay = _SHARD_STACK_CACHE.get(key)
    if lay is not None:
        return lay
    if shape[dim] % c != 0:
        raise NotSplitMerge(f"dim {dim} of {shape} not divisible by {c}")
    lay = Layout.identity(shape)
    split = shape[:dim] + (c, shape[dim] // c) + shape[dim + 1 :]
    lay = lay.then_reshape(split)
    lay = lay.then_transpose(move_dim(len(split), dim, 0))
    _SHARD_STACK_CACHE[key] = lay
    return lay


def dup_id(f: Fact) -> bool:
    """Dup fact whose layout is identity up to unit-dim bookkeeping."""
    return (f.layout.effectively_identity
            and f.layout.src_shape == f.layout.dst_shape)


# ops that preserve all-zero-ness when walking back to a const leaf
_ZERO_CHAIN_OPS = frozenset({"broadcast", "reshape", "copy", "transpose", "convert"})


def is_zero_const(g, nid: int) -> bool:
    """True when ``nid`` is (a broadcast/reshape/transpose/copy chain over) a
    constant whose payload is all zeros — the additive identity that makes
    scatter-add accumulation and zero-padding distribute over partial sums."""
    n = g[nid]
    while n.op in _ZERO_CHAIN_OPS and n.inputs:
        n = g[n.inputs[0]]
    return n.op == "const" and bool(n.param("zero"))
