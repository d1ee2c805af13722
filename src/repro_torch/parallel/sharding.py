"""Sharding rules: map every parameter/input leaf to a PartitionSpec.

These rules ARE the verifier's input relation registration: a leaf spec that
shards dim d over the tp axis registers ``sharded(b, d', d)``; replicated
leaves register ``duplicate``.  The same table cuts one single-device
parameter set into the per-rank shards that TP execution runs on
(``shard_params``), and gathers the shards back into the logical leaves that
a checkpoint stores (``unshard_params``).

Megatron-style TP over axis "model" (the JAX package's table, dim for dim):
  embed (V,D)        -> vocab-parallel      P('model', None)
  lm_head (D,V)      -> column-parallel     P(None, 'model')
  vis_proj w, b      -> replicated          P(None, None), P(None)
  wq/wk/wv (D,Hhd)   -> column-parallel     P(None, 'model')   [heads sharded]
  wo (Hhd,D)         -> row-parallel        P('model', None)
  mlp wg/wu (D,F)    -> column-parallel     P(None, 'model')
  mlp wo (F,D)       -> row-parallel        P('model', None)
  moe router w (D,E) -> replicated          P(None, None)
  moe wg/wu/wo       -> expert-parallel     P('model', None, None)   [over E]
  ssm wx/wz/wdt      -> head-column         P(None, 'model')
  ssm conv_x, its bias -> channel-sharded   P(None, 'model'), P('model')
  norms, B/C         -> replicated
(stacked block params carry a leading None for the n_blocks dim.)  The
serving caches (``cache_specs``) shard attention k/v and the SSM state on
their head dim and the SSM ``conv_x`` buffer on its channel dim; the
``conv_B``/``conv_C`` buffers are replicated, as ``wB``/``wC`` are.
"""
from __future__ import annotations

from typing import Any

from repro_torch.tree import tree_map, tree_map_with_path

TP = "model"


class PartitionSpec(tuple):
    """One entry per dim: the mesh axis name the dim is sharded over, or
    None for a replicated dim (the counterpart of jax's PartitionSpec)."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _spec_for(path: tuple, ndim: int, tp: str) -> PartitionSpec:
    """PartitionSpec for one param leaf, identified by its tree path."""
    names = [str(p) for p in path]
    leaf = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    gparent = names[-3] if len(names) >= 3 else ""
    stacked = "blocks" in names  # leading n_blocks dim
    lead = (None,) if stacked else ()

    def mk(*dims):
        return P(*(lead + dims))

    # --- embeddings / head -------------------------------------------------
    if parent == "embed":
        return P(tp, None)
    if parent == "lm_head":
        return P(None, tp)
    if parent == "vis_proj":
        return P(None, None) if leaf == "w" else P(None)
    # --- norms (replicated) -------------------------------------------------
    if parent in ("ln1", "ln2", "ln_f", "qnorm", "knorm") or leaf == "s":
        if parent == "out_norm":  # ssm gated norm: DI is head-sharded
            return mk(tp)
        return mk(*([None] * (ndim - (1 if stacked else 0))))
    # --- attention -----------------------------------------------------------
    if parent in ("wq", "wk", "wv"):
        return mk(None, tp) if leaf == "w" else mk(tp)
    if parent == "wo" and gparent == "attn":
        return mk(tp, None) if leaf == "w" else mk(None)
    # --- dense mlp -------------------------------------------------------------
    if parent in ("wg", "wu", "wi") and gparent in ("mlp", "shared"):
        return mk(None, tp) if leaf == "w" else mk(tp)
    if parent == "wo" and gparent in ("mlp", "shared"):
        return mk(tp, None) if leaf == "w" else mk(None)
    # --- moe -----------------------------------------------------------------
    if parent == "router":
        return mk(None, None)
    if parent == "moe":
        if leaf in ("wg", "wu", "wo"):
            return mk(tp, None, None)  # expert-parallel over E
    # --- ssm -------------------------------------------------------------------
    if parent in ("wx", "wz", "wdt") and gparent == "ssm":
        return mk(None, tp) if leaf == "w" else mk(tp)
    if parent in ("wB", "wC") and gparent == "ssm":
        return mk(None, None) if leaf == "w" else mk(None)
    if parent == "wo" and gparent == "ssm":
        return mk(tp, None) if leaf == "w" else mk(None)
    if parent == "ssm":
        if leaf in ("dt_bias", "A_log", "Dskip"):
            return mk(tp)
        if leaf == "conv_x":
            return mk(None, tp)
        if leaf in ("conv_B", "conv_C"):
            return mk(None, None)
    if gparent == "conv_bias":  # conv_bias/{x,B,C}/b: sharded as its conv's channels
        return mk(tp) if parent == "x" else mk(None)
    # fallback: replicate
    return P(*([None] * ndim))


def param_specs(param_shapes: Any, tp: str = TP):
    """PartitionSpec tree matching a params tree (of tensors, fake tensors or
    anything with a ``shape``)."""
    return tree_map_with_path(lambda path, leaf: _spec_for(path, len(leaf.shape), tp),
                              param_shapes)


def batch_spec(batch: Any, dp):
    """Input sharding: batch dim over the dp axis (None: replicated)."""

    def visit(leaf):
        nd = len(leaf.shape)
        if nd == 0:
            return P()
        return P(dp, *([None] * (nd - 1)))

    return tree_map(visit, batch)


def cache_specs(cache_shapes: Any, dp=None, tp: str = TP, cp=None):
    """KV/SSM cache sharding.  attn k/v: (nb, B, Hkv, S, hd); ssm state:
    (nb, B, H, P, N); conv buffers (nb, B, K-1, C).  ``dp`` and ``cp`` (the
    batch and sequence axes) are None on every path the port runs."""

    def visit(path, leaf):
        leafname = str(path[-1]) if path else ""
        nd = len(leaf.shape)
        if leafname in ("k", "v"):
            return P(None, dp, tp, cp, None) if nd == 5 else P(dp, tp, cp, None)
        if leafname == "state":
            return P(None, dp, tp, None, None) if nd == 5 else P(dp, tp, None, None)
        if leafname == "conv_x":
            return P(None, dp, None, tp) if nd == 4 else P(dp, None, tp)
        if leafname in ("conv_B", "conv_C"):
            return P(None, dp, None, None) if nd == 4 else P(dp, None, None)
        return P(*([None] * nd))

    return tree_map_with_path(visit, cache_shapes)


def shard_params(params: Any, specs: Any, rank, size, axis: str = TP):
    """This rank's shard of every leaf: each dim that ``specs`` shards over a
    mesh axis cut into that axis' size in equal blocks, the block at this
    rank's coordinate kept (a contiguous copy).  ``rank`` and ``size`` are
    ints for one axis (``axis``), or dicts ``{axis: coordinate}`` and
    ``{axis: size}`` over a mesh; a spec entry may name one axis or a tuple
    of them, the first the outermost."""
    from repro_torch.tree import tree_flatten, tree_unflatten

    ranks = rank if isinstance(rank, dict) else {axis: rank}
    sizes = size if isinstance(size, dict) else {axis: size}
    leaves, treedef = tree_flatten(params)
    spec_leaves = tree_flatten(specs, is_leaf=is_spec)[0]
    out = []
    for t, spec in zip(leaves, spec_leaves):
        for d, entry in enumerate(spec):
            for a in entry if isinstance(entry, tuple) else (entry,):
                if a in sizes:
                    n = t.shape[d] // sizes[a]
                    t = t.narrow(d, ranks[a] * n, n)
        out.append(t.contiguous())
    return tree_unflatten(treedef, out)


def unshard_params(shards: Any, specs: Any, ctx) -> Any:
    """The inverse of ``shard_params`` on every rank of ``ctx``'s mesh: each
    dim that ``specs`` shards over a mesh axis of ``ctx`` all_gathered along
    that axis (``ctx.all_gather``), so every rank holds the full logical
    leaves.  A spec axis the context lacks is left as it is."""
    from repro_torch.tree import tree_flatten, tree_unflatten

    leaves, treedef = tree_flatten(shards)
    spec_leaves = tree_flatten(specs, is_leaf=is_spec)[0]
    out = []
    for t, spec in zip(leaves, spec_leaves):
        for d, entry in reversed(list(enumerate(spec))):
            for a in reversed(entry if isinstance(entry, tuple) else (entry,)):
                if a is not None and a in ctx.mesh_axes:
                    t = ctx.all_gather(t, a, d)
        out.append(t)
    return tree_unflatten(treedef, out)
