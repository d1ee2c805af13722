"""Collective op family: all_reduce discharges partials (and unrolled-loop
accumulations), all_gather materializes shards, reduce_scatter splits
partials, all_to_all reshards — each by symbolic layout composition on the
rank-stacked tensor."""
from __future__ import annotations

from typing import Optional

from ..bijection import Layout, NotSplitMerge
from ..ir import Node
from ..relations import DUP, LOOPRED, PARTIAL, SHARD, Fact
from .common import move_dim, shard_stack_layout
from .registry import DEFAULT_REGISTRY as R


def _axis_match(prop, d: Node) -> bool:
    axes = d.param("axes") or (d.param("axis"),)
    if isinstance(axes, str):
        axes = (axes,)
    return prop.axis in tuple(axes)


def _full_group(d: Node) -> bool:
    groups = d.param("groups")
    return groups is None or groups == "full"


# dims a collective moves data along (SHARD facts on any *other* dim carry
# through an orthogonal-axis collective untouched)
def _touched_dims(d: Node) -> tuple:
    if d.op == "all_gather":
        return (d.param("all_gather_dimension", 0),)
    if d.op == "reduce_scatter":
        return (d.param("scatter_dimension", 0),)
    if d.op == "all_to_all":
        return (d.param("split_axis"), d.param("concat_axis"))
    return ()


@R.rule("orthogonal_collective",
        ("all_reduce", "all_gather", "reduce_scatter", "all_to_all"),
        consumes=(DUP, SHARD, PARTIAL), produces=(DUP, SHARD, PARTIAL))
def orthogonal_collective(prop, d: Node) -> None:
    """Collective over a *different* mesh axis than the one being verified
    (composite tp x dp plans verify the data axis of a 2D program whose
    baseline is the 1D tensor-parallel per-device program): at every rank of
    the verified axis the op applies the same deterministic function, so it
    is congruence-transparent — dup/shard/partial(add) facts carry to the
    matching baseline collective (same op, identical params).  Shard facts
    require the sharded dim untouched by the collective (the op then
    commutes with stacking over the verified axis); partial(add) requires a
    linear collective (sum/data movement, not max/min)."""
    axes = d.param("axes") or ()
    if prop.axis in tuple(axes):
        return  # this axis's collectives are handled by the rules above
    linear = d.param("reduce_op", "add") == "add"
    touched = _touched_dims(d)
    for f in prop.store.facts(d.inputs[0]):
        if f.kind == DUP:
            if not (f.layout.effectively_identity
                    and f.layout.src_shape == f.layout.dst_shape):
                continue
        elif f.kind == SHARD:
            k = prop._shard_src_dim(f)
            if k is None or k in touched:
                continue
        elif f.kind == PARTIAL:
            if f.reduce_op != "add" or not linear:
                continue
            if not (f.layout.effectively_identity
                    and f.layout.src_shape == f.layout.dst_shape):
                continue
        else:
            continue
        for z in prop._base_candidates(d.op, [f.base], d.params, layer=d.layer):
            if not prop._dtype_ok(z, d):
                continue
            if f.kind == DUP:
                prop.emit(Fact(DUP, z.id, d.id, prop.size, Layout.identity(z.shape)))
            elif f.kind == PARTIAL:
                prop.emit(Fact(PARTIAL, z.id, d.id, prop.size,
                               Layout.identity(z.shape), reduce_op="add"))
            else:
                if z.shape[k] % prop.size != 0:
                    continue
                try:
                    lay = shard_stack_layout(z.shape, k, prop.size)
                except NotSplitMerge:
                    continue
                prop.emit(Fact(SHARD, z.id, d.id, prop.size, lay))


@R.rule("all_reduce", ("all_reduce",), consumes=(PARTIAL, DUP, LOOPRED),
        produces=(DUP,))
def all_reduce(prop, d: Node) -> None:
    op = d.param("reduce_op", "add")
    if not _axis_match(prop, d):
        return
    for f in prop.store.facts(d.inputs[0]):
        if f.kind == PARTIAL and f.reduce_op == op:
            if not _full_group(d):
                prop.store.diag(
                    d.id,
                    "wrong_replica_groups",
                    f"all_reduce at {d.src or '?'} uses replica groups "
                    f"{d.param('groups')} — partial tensors require the full axis group",
                )
                continue
            prop.emit(Fact(DUP, f.base, d.id, prop.size, f.layout))
        elif f.kind == DUP:
            prop.store.diag(
                d.id,
                "redundant_all_reduce",
                f"all_reduce at {d.src or '?'} over a replicated tensor multiplies "
                f"it by the axis size — likely a redundant collective",
            )
        elif f.kind == LOOPRED and op == "add":
            total = f.nchunk * prop.size
            if f.idxset == frozenset(range(f.nchunk)) and _full_group(d):
                target = loopred_base_target(prop, f.base, f.dim, total)
                if target is not None:
                    z = prop.base[target]
                    prop.emit(Fact(DUP, z.id, d.id, prop.size, Layout.identity(z.shape)))


@R.rule("all_gather", ("all_gather",), consumes=(SHARD, DUP),
        produces=(DUP,))
def all_gather(prop, d: Node) -> None:
    if not _axis_match(prop, d):
        return
    gdim = d.param("all_gather_dimension", 0)
    tiled = d.param("tiled", False)
    for f in prop.store.facts(d.inputs[0]):
        if f.kind != SHARD:
            if f.kind == DUP:
                prop.store.diag(
                    d.id,
                    "redundant_all_gather",
                    f"all_gather at {d.src or '?'} over a replicated tensor tiles it "
                    f"{prop.size}x — likely redundant",
                )
            continue
        lay = f.layout  # B -> (c, *local)
        rank = len(lay.dst_shape)
        try:
            if tiled:
                new_lay = lay.then_transpose(move_dim(rank, 0, gdim))
                merged = list(new_lay.dst_shape)
                merged[gdim] = merged[gdim] * merged[gdim + 1]
                del merged[gdim + 1]
                new_lay = new_lay.then_reshape(tuple(merged))
            else:
                new_lay = lay.then_transpose(move_dim(rank, 0, gdim))
        except (NotSplitMerge, ValueError):
            continue
        prop.emit(Fact(DUP, f.base, d.id, prop.size, new_lay))


@R.rule("reduce_scatter", ("reduce_scatter",), consumes=(PARTIAL,),
        produces=(SHARD,))
def reduce_scatter(prop, d: Node) -> None:
    if not _axis_match(prop, d):
        return
    sdim = d.param("scatter_dimension", 0)
    op = d.param("reduce_op", "add")
    for f in prop.store.facts_kind(d.inputs[0], PARTIAL):
        if f.reduce_op != op:
            continue
        lay = f.layout  # B -> D_shape (pre-scatter local shape)
        shape = lay.dst_shape
        if shape[sdim] % prop.size != 0:
            continue
        try:
            split = shape[:sdim] + (prop.size, shape[sdim] // prop.size) + shape[sdim + 1 :]
            new_lay = lay.then_reshape(split).then_transpose(move_dim(len(split), sdim, 0))
        except (NotSplitMerge, ValueError):
            continue
        prop.emit(Fact(SHARD, f.base, d.id, prop.size, new_lay))


@R.rule("all_to_all", ("all_to_all",), consumes=(SHARD,),
        produces=(SHARD,))
def all_to_all(prop, d: Node) -> None:
    if not _axis_match(prop, d):
        return
    sa = d.param("split_axis")
    ca = d.param("concat_axis")
    for f in prop.store.facts_kind(d.inputs[0], SHARD):
        lay = f.layout  # B -> (c, *local)
        stacked = lay.dst_shape
        c = prop.size
        if stacked[sa + 1] % c != 0:
            continue
        try:
            # split the split_axis into (c, rest)
            split = stacked[: sa + 1] + (c, stacked[sa + 1] // c) + stacked[sa + 2 :]
            new_lay = lay.then_reshape(split)
            rank = len(split)
            # new device dim = the freshly split chunk index (at sa+1);
            # old device dim (0) becomes the outer factor of concat dim.
            # permute: [sa+1, 0, rest...] then position old-0 before concat.
            order = [sa + 1] + [i for i in range(rank) if i != sa + 1]
            new_lay = new_lay.then_transpose(tuple(order))
            # now dims: [newdev, olddev, locals...(sa slot now rest)]
            # move olddev (pos 1) to just before concat dim ca (local dims
            # offset by 1 for the stacked dev dim)
            target = ca + 1
            new_lay = new_lay.then_transpose(move_dim(rank, 1, target))
            merged = list(new_lay.dst_shape)
            merged[target] = merged[target] * merged[target + 1]
            del merged[target + 1]
            new_lay = new_lay.then_reshape(tuple(merged))
        except (NotSplitMerge, ValueError):
            continue
        prop.emit(Fact(SHARD, f.base, d.id, prop.size, new_lay))


def loopred_base_target(prop, base_tensor: int, dim: int, total_chunks: int) -> Optional[int]:
    """Find the baseline node summing *all* chunks of ``base_tensor`` along
    ``dim`` (paper's loop_red_B): an add-chain over slices covering every
    chunk, or a reshape+reduce_sum."""
    key = (base_tensor, dim, total_chunks)
    if key in prop._loopred_base_cache:
        return prop._loopred_base_cache[key]
    g = prop.base
    tshape = g[base_tensor].shape
    chunk = tshape[dim] // total_chunks
    cover: dict[int, frozenset] = {}
    order = g.toposort()
    for nid in order:
        z = g[nid]
        if z.op == "slice" and z.inputs and prop.base_eg.same(z.inputs[0], base_tensor):
            start = z.param("start_indices")
            limit = z.param("limit_indices")
            if start is None:
                continue
            full = all(
                (s == 0 and lim == tshape[k]) or k == dim
                for k, (s, lim) in enumerate(zip(start, limit))
            )
            if full and limit[dim] - start[dim] == chunk and start[dim] % chunk == 0:
                cover[nid] = frozenset([start[dim] // chunk])
        elif z.op == "add" and len(z.inputs) == 2:
            c0, c1 = cover.get(z.inputs[0]), cover.get(z.inputs[1])
            if c0 is not None and c1 is not None and not (c0 & c1):
                cover[nid] = c0 | c1
    result = None
    for nid, s in cover.items():
        if len(s) == total_chunks and g[nid].op == "add":
            result = nid
            break
    prop._loopred_base_cache[key] = result
    return result
