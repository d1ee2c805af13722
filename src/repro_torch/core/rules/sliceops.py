"""Slice/concat op family: structural ops over sharded tensors — aligned
chunks of a sharded dim become slicegrp facts (paper Fig. 8), slices and
concats along unsharded dims keep the shard relation, and KV-cache style
dynamic slicing carries clean shards through replicated indices."""
from __future__ import annotations

import itertools
import re
from typing import Optional

from ..bijection import Layout, NotSplitMerge
from ..ir import Node
from ..relations import DUP, LOOPRED, PARTIAL, SHARD, SLICEGRP, Fact
from .common import dup_id, is_zero_const, shard_stack_layout
from .congruence import generic
from .registry import DEFAULT_REGISTRY as R


@R.rule("slice", ("slice",), consumes=(DUP, SHARD, PARTIAL),
        produces=(DUP, SHARD, PARTIAL, SLICEGRP))
def slice_rule(prop, d: Node) -> None:
    start = d.param("start_indices")
    limit = d.param("limit_indices")
    strides = d.param("strides")
    if strides is not None and any(s != 1 for s in strides):
        generic(prop, d)
        return
    x = d.inputs[0]
    xshape = prop.dist[x].shape
    for f in prop.store.facts(x):
        if f.kind == DUP and dup_id(f):
            for z in prop._base_candidates("slice", [f.base], d.params, layer=d.layer):
                if prop._dtype_ok(z, d):
                    prop.emit(Fact(DUP, z.id, d.id, prop.size, Layout.identity(z.shape)))
        if f.kind == SHARD:
            _shard_slice_unsharded_dims(prop, d, f, start, limit, xshape)
            _slicegrp_from_slice(prop, d, f, start, limit, xshape)
        if f.kind == PARTIAL and f.reduce_op == "add" and dup_id(f):
            for z in prop._base_candidates("slice", [f.base], d.params, layer=d.layer):
                if prop._dtype_ok(z, d):
                    prop.emit(
                        Fact(PARTIAL, z.id, d.id, prop.size, Layout.identity(z.shape), reduce_op="add")
                    )


def _shard_slice_unsharded_dims(prop, d: Node, f: Fact, start, limit, xshape) -> None:
    """d = slice(x') touching only *unsharded* dims of a cleanly sharded
    tensor: the shard relation carries through to the baseline slice with
    identical coordinates (the sharded dim taken whole on both sides)."""
    k = prop._shard_src_dim(f)
    if k is None or start is None or k >= len(start) or k >= len(xshape):
        return
    if not (start[k] == 0 and limit[k] == xshape[k]):
        return
    bshape = prop.base[f.base].shape
    for zid in prop.base.consumers(f.base):
        z = prop.base[zid]
        if z.op != "slice" or not prop.base_eg.same(z.inputs[0], f.base):
            continue
        zs, zl = z.param("start_indices"), z.param("limit_indices")
        zstr = z.param("strides")
        if zstr is not None and any(s != 1 for s in zstr):
            continue
        ok = True
        for i in range(len(bshape)):
            if i == k:
                ok &= zs[i] == 0 and zl[i] == bshape[i]
            else:
                ok &= zs[i] == start[i] and zl[i] == limit[i]
        if ok and prop._dtype_ok(z, d):
            try:
                lay = shard_stack_layout(z.shape, k, prop.size)
            except NotSplitMerge:
                continue
            prop.emit(Fact(SHARD, z.id, d.id, prop.size, lay))


def _slicegrp_from_slice(prop, d: Node, f: Fact, start, limit, xshape) -> None:
    """d = slice(x') taking an aligned chunk of the *sharded* dim of x'
    (paper's fine-grained slicing, Fig. 8)."""
    k = prop._shard_src_dim(f)
    if k is None or start is None:
        return
    # slice must be full on all dims except the local image of k (== k for
    # clean layouts) and chunk-aligned there
    sliced_dims = [
        i for i, (s, lim) in enumerate(zip(start, limit)) if not (s == 0 and lim == xshape[i])
    ]
    if sliced_dims != [k]:
        return
    length = limit[k] - start[k]
    if length <= 0 or xshape[k] % length != 0 or start[k] % length != 0:
        return
    n = xshape[k] // length
    prop.emit(
        Fact(
            SLICEGRP,
            f.base,
            d.id,
            prop.size,
            f.layout,
            dim=k,
            nchunk=n,
            index=start[k] // length,
        )
    )


@R.rule("concat_shard", ("concat",), consumes=(SHARD,),
        produces=(SHARD,))
def concat(prop, d: Node) -> None:
    """concat: dup operands verify via the generic congruence rule; shard
    operands concat along a non-sharded dim keep the shard relation."""
    dim = d.param("dimension")
    fls = [prop.store.facts_kind(i, SHARD) for i in d.inputs]
    if not all(fls) or dim is None:
        return
    for combo in itertools.product(*[fl[:4] for fl in fls]):
        ks = {prop._shard_src_dim(f) for f in combo}
        if len(ks) != 1 or None in ks or dim in ks:
            continue
        k = next(iter(ks))
        b_inputs = [f.base for f in combo]
        for z in prop._base_candidates("concat", b_inputs, d.params, layer=d.layer):
            if prop._dtype_ok(z, d):
                try:
                    lay = shard_stack_layout(z.shape, k, prop.size)
                except NotSplitMerge:
                    continue
                prop.emit(Fact(SHARD, z.id, d.id, prop.size, lay))


@R.rule("dynamic_slice_shard", ("dynamic_slice", "dynamic_update_slice"),
        consumes=(DUP, SHARD, PARTIAL, SLICEGRP, LOOPRED),
        produces=(SHARD,))
def dynamic_sliceish(prop, d: Node) -> None:
    """dynamic_slice / dynamic_update_slice (KV-cache reads/writes):
    dup via congruence (the generic rule); clean shard facts carry through
    when the sharded dim is untouched by the dynamic indexing (start
    operands replicated and congruent with the baseline's)."""
    n_data = 2 if d.op == "dynamic_update_slice" else 1
    data_in = d.inputs[:n_data]
    idx_in = d.inputs[n_data:]
    idx_fact_lists = [
        [f for f in prop.store.facts_kind(i, DUP) if dup_id(f)][:4]
        for i in idx_in
    ]
    if not all(idx_fact_lists):
        return
    data_fact_lists = [prop.store.facts(i) for i in data_in]
    if not all(data_fact_lists):
        return
    for combo_all in itertools.product(*[fl[:6] for fl in data_fact_lists],
                                       *idx_fact_lists):
        combo = combo_all[:len(data_in)]
        idx_facts = combo_all[len(data_in):]
        if not any(f.kind == SHARD for f in combo):
            continue
        negs = set()
        ok = True
        for f in combo:
            if f.kind == SHARD:
                k = prop._shard_src_dim(f)
                if k is None:
                    ok = False
                    break
                negs.add(k - len(prop.base[f.base].shape))
            elif not (f.kind == DUP and dup_id(f)):
                ok = False
                break
        if not ok or len(negs) != 1:
            continue
        k_neg = next(iter(negs))
        b_inputs = [f.base for f in combo] + [f.base for f in idx_facts]
        for z in prop._base_candidates(d.op, b_inputs, d.params, layer=d.layer):
            if not prop._dtype_ok(z, d):
                continue
            k_out = len(z.shape) + k_neg
            if k_out < 0 or z.shape[k_out] % prop.size != 0:
                continue
            try:
                lay = shard_stack_layout(z.shape, k_out, prop.size)
            except NotSplitMerge:
                continue
            prop.emit(Fact(SHARD, z.id, d.id, prop.size, lay))


def _zero_index(g, nid: int) -> bool:
    n = g[nid]
    while n.op == "convert" and n.inputs:
        n = g[n.inputs[0]]
    return n.op == "const" and (bool(n.param("zero"))
                                or n.param("value") == 0)


def _unwrap_index(g, n):
    """Strip value-preserving index wrappers: converts and the negative-
    index wrap ``select(lt(s, 0), s, s + dim)`` jnp's dynamic_slice_in_dim
    emits (a no-op for the non-negative rank-scaled starts we match)."""
    while True:
        if n.op == "convert" and n.inputs:
            n = g[n.inputs[0]]
            continue
        if n.op == "select" and len(n.inputs) == 3:
            # select_n picks cases[pred]: c0 when s >= 0 (the value we
            # return), c1 = s + dim when s < 0.  Only this orientation is
            # value-preserving for non-negative starts — the mirrored
            # select(lt(s,0), s+K, s) evaluates to s+K and must NOT unwrap.
            pred, c0, c1 = (g[i] for i in n.inputs)
            if (pred.op == "lt" and len(pred.inputs) == 2
                    and _zero_index(g, pred.inputs[1])):
                s = pred.inputs[0]
                if (c0.id == s and c1.op == "add" and s in c1.inputs):
                    n = g[s]
                    continue
        return n


def _rank_scaled_chunk(prop, nid: int) -> Optional[int]:
    """Chunk size when ``nid`` computes ``axis_index(verified_axis) * chunk``
    (or bare ``axis_index``, chunk=1); None otherwise."""
    g = prop.dist
    n = _unwrap_index(g, g[nid])
    if n.op == "axis_index":
        return 1 if prop.axis in tuple(n.param("axes") or ()) else None
    if n.op == "mul" and len(n.inputs) == 2:
        a, b = (_unwrap_index(g, g[i]) for i in n.inputs)
        if b.op == "axis_index":
            a, b = b, a
        if (a.op == "axis_index" and prop.axis in tuple(a.param("axes") or ())
                and b.op == "const" and isinstance(b.param("value"), int)
                and b.param("value") > 0):
            return b.param("value")
    return None


@R.rule("rank_dynamic_slice", ("dynamic_slice",), consumes=(DUP,),
        produces=(SHARD,))
def rank_dynamic_slice(prop, d: Node) -> None:
    """``dynamic_slice(x', starts...)`` taking this rank's contiguous chunk
    of a replicated tensor: exactly one start is ``axis_index * chunk`` with
    ``chunk`` the local extent of that dim, the rest are zero — stacking the
    per-rank chunks reconstructs the baseline tensor, a clean SHARD fact.
    This is how per-device programs enter a sharded region from replicated
    data (sequence-parallel slicing of a replicated frontend prefix, the
    expert-parallel slice of the dense routing weights)."""
    x = d.inputs[0]
    idx_in = d.inputs[1:]
    if not idx_in:
        return
    xshape = prop.dist[x].shape
    if len(idx_in) != len(xshape):
        return
    k = None
    for i, nid in enumerate(idx_in):
        if _zero_index(prop.dist, nid):
            continue
        chunk = _rank_scaled_chunk(prop, nid)
        if chunk is None or k is not None:
            return  # a non-zero start that is not the rank chunk, or two
        if chunk != d.shape[i] or xshape[i] != chunk * prop.size:
            return
        k = i
    if k is None:
        return
    # every non-k dim must be taken whole
    if any(d.shape[i] != xshape[i] for i in range(len(xshape)) if i != k):
        return
    for f in prop.store.facts_kind(x, DUP):
        if not dup_id(f):
            continue
        bshape = prop.base[f.base].shape
        if len(bshape) != len(xshape) or bshape[k] % prop.size != 0:
            continue
        try:
            lay = shard_stack_layout(bshape, k, prop.size)
        except NotSplitMerge:
            continue
        if prop.base[f.base].dtype == d.dtype:
            prop.emit(Fact(SHARD, f.base, d.id, prop.size, lay))


def _gather_dims(dn: str, name: str) -> tuple:
    """Parse one tuple field out of the stringified GatherDimensionNumbers
    (trace.py stores ``str(dimension_numbers)`` because the object itself is
    not comparable across jax versions)."""
    m = re.search(name + r"=\((.*?)\)", dn)
    if not m:
        return ()
    return tuple(int(x) for x in m.group(1).replace(" ", "").split(",") if x)


@R.rule("gather_batch", ("gather",), consumes=(DUP, SHARD),
        produces=(SHARD,))
def gather_batch(prop, d: Node) -> None:
    """gather with a replicated operand and a *batch* dim of the indices
    sharded: each rank looks up its own rows of the same table, so the shard
    relation carries to the matching output batch dim.  This is the
    embedding lookup under data parallelism (tokens batch-sharded, table
    replicated)."""
    if len(d.inputs) != 2:
        return
    op_in, idx_in = d.inputs
    dn = str(d.param("dimension_numbers") or "")
    if (_gather_dims(dn, "operand_batching_dims")
            or _gather_dims(dn, "start_indices_batching_dims")):
        return
    offset = set(_gather_dims(dn, "offset_dims"))
    batch_out = [i for i in range(len(d.shape)) if i not in offset]
    # indices dims: leading batch dims + trailing index-vector dim
    idx_ndim = len(prop.dist[idx_in].shape)
    for fo in prop.store.facts_kind(op_in, DUP):
        if not dup_id(fo):
            continue
        for fi in prop.store.facts_kind(idx_in, SHARD):
            k = prop._shard_src_dim(fi)
            if k is None or k >= idx_ndim - 1 or k >= len(batch_out):
                continue
            out_dim = batch_out[k]
            for z in prop._base_candidates("gather", [fo.base, fi.base],
                                           d.params, layer=d.layer):
                if not prop._dtype_ok(z, d):
                    continue
                try:
                    lay = shard_stack_layout(z.shape, out_dim, prop.size)
                except NotSplitMerge:
                    continue
                prop.emit(Fact(SHARD, z.id, d.id, prop.size, lay))


@R.rule("scatter_add_partial", ("scatter_add",), consumes=(DUP, SHARD),
        produces=(PARTIAL,))
def scatter_add_partial(prop, d: Node) -> None:
    """scatter-add onto an all-zero operand with the scatter batch dim of
    the indices and updates sharded: each rank accumulates its own rows onto
    the same zero base, and add-scatter is linear in the (index, update)
    rows, so the rank-sum equals the full scatter — a ``partial(add)`` fact.
    This is the embedding-table gradient under data parallelism."""
    if len(d.inputs) != 3:
        return
    op_in, idx_in, upd_in = d.inputs
    if not is_zero_const(prop.dist, op_in):
        return
    dn = str(d.param("dimension_numbers") or "")
    if (_gather_dims(dn, "operand_batching_dims")
            or _gather_dims(dn, "scatter_indices_batching_dims")):
        return
    window = set(_gather_dims(dn, "update_window_dims"))
    upd_batch = [i for i in range(len(prop.dist[upd_in].shape)) if i not in window]
    idx_ndim = len(prop.dist[idx_in].shape)
    for fo in prop.store.facts_kind(op_in, DUP):
        if not dup_id(fo):
            continue
        for fi in prop.store.facts_kind(idx_in, SHARD):
            k = prop._shard_src_dim(fi)
            if k is None or k >= idx_ndim - 1 or k >= len(upd_batch):
                continue
            for fu in prop.store.facts_kind(upd_in, SHARD):
                if prop._shard_src_dim(fu) != upd_batch[k]:
                    continue
                for z in prop._base_candidates(
                        "scatter_add", [fo.base, fi.base, fu.base], d.params,
                        layer=d.layer):
                    if prop._dtype_ok(z, d):
                        prop.emit(Fact(PARTIAL, z.id, d.id, prop.size,
                                       Layout.identity(z.shape),
                                       reduce_op="add"))
