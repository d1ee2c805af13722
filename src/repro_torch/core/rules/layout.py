"""Layout op family: reshape/transpose carry facts through symbolic layout
composition (Algorithm 2); convert/broadcast/pad/axis-ops preserve facts
under the op-specific side conditions."""
from __future__ import annotations

from dataclasses import replace

from ..bijection import Layout, NotSplitMerge
from ..ir import Node
from ..relations import DUP, LOOPRED, PARTIAL, SHARD, SLICEGRP, Fact
from .common import is_zero_const, shard_stack_layout
from .registry import DEFAULT_REGISTRY as R


@R.rule("layout_compose", ("reshape", "transpose"),
        consumes=(DUP, SHARD, PARTIAL, SLICEGRP),
        produces=(DUP, SHARD, PARTIAL, SLICEGRP))
def layout_op(prop, d: Node) -> None:
    x = d.inputs[0]
    for f in prop.store.facts(x):
        if f.kind == LOOPRED:
            continue
        try:
            if f.kind == SHARD:
                # lift to the stacked tensor: device dim 0 untouched
                if d.op == "reshape":
                    new_lay = f.layout.then_reshape((prop.size,) + d.shape)
                else:
                    perm = tuple([0] + [p + 1 for p in d.param("permutation")])
                    new_lay = f.layout.then_transpose(perm)
            else:
                if d.op == "reshape":
                    new_lay = f.layout.then_reshape(d.shape)
                else:
                    new_lay = f.layout.then_transpose(d.param("permutation"))
        except (NotSplitMerge, ValueError):
            continue
        prop.emit(replace(f, base=f.base, dist=d.id, layout=new_lay))
        # direct baseline congruence (same op on base side) is reached via
        # the baseline layout closure in emit().


@R.rule("convert", ("convert",),
        consumes=(DUP, SHARD, PARTIAL, SLICEGRP, LOOPRED),
        produces=(DUP, SHARD, PARTIAL, SLICEGRP, LOOPRED))
def convert(prop, d: Node) -> None:
    x = d.inputs[0]
    for f in prop.store.facts(x):
        matched = False
        for z in prop._base_candidates("convert", [f.base], layer=d.layer):
            if z.dtype == d.dtype:
                prop.emit(replace(f, base=z.id, dist=d.id))
                matched = True
        if not matched:
            prop.store.diag(
                d.id,
                "precision_mismatch",
                f"distributed graph converts to {d.dtype} at {d.src or '?'} with no "
                f"matching baseline conversion (baseline stays {prop.base[f.base].dtype})",
            )


@R.rule("broadcast", ("broadcast",), consumes=(DUP, SHARD, PARTIAL),
        produces=(DUP, SHARD, PARTIAL))
def broadcast(prop, d: Node) -> None:
    x = d.inputs[0]
    bd = d.param("broadcast_dimensions") or ()
    for f in prop.store.facts(x):
        for z in prop._base_candidates("broadcast", [f.base], layer=d.layer):
            if z.param("broadcast_dimensions") != tuple(bd) or not prop._dtype_ok(z, d):
                continue
            if len(z.shape) != len(d.shape):
                continue
            if z.shape == d.shape and f.kind in (DUP, PARTIAL):
                prop.emit(replace(f, base=z.id, dist=d.id,
                                  layout=Layout.identity(z.shape) if f.layout.is_identity else f.layout))
                continue
            if f.kind == SHARD:
                # broadcast of a sharded tensor (e.g. keepdims expansion):
                # shapes must agree except the sharded dim scaled by c
                k = prop._shard_src_dim(f)
                if k is None:
                    continue
                # the sharded input dim maps through bd to an output dim
                if k >= len(tuple(bd)):
                    continue
                out_k = tuple(bd)[k]
                ok = all(
                    z.shape[i] == d.shape[i] * (prop.size if i == out_k else 1)
                    for i in range(len(z.shape))
                )
                if ok:
                    try:
                        lay = shard_stack_layout(z.shape, out_k, prop.size)
                    except NotSplitMerge:
                        continue
                    prop.emit(Fact(SHARD, z.id, d.id, prop.size, lay))
                continue
            if f.kind == DUP and f.layout.is_identity:
                # replicated operand broadcast to a *sharded* shape: derive a
                # shard fact for every dim consistent with c-chunking
                for k in range(len(z.shape)):
                    if z.shape[k] == d.shape[k] * prop.size:
                        src_dim_ok = k not in bd or prop.base[f.base].shape[bd.index(k)] == 1 if bd else True
                        if k in bd:
                            j = tuple(bd).index(k)
                            src_dim_ok = prop.base[f.base].shape[j] == 1
                        else:
                            src_dim_ok = True
                        if not src_dim_ok:
                            continue
                        try:
                            lay = shard_stack_layout(z.shape, k, prop.size)
                        except NotSplitMerge:
                            continue
                        prop.emit(Fact(SHARD, z.id, d.id, prop.size, lay))


@R.rule("pad_shard", ("pad",),
        consumes=(DUP, SHARD, PARTIAL, SLICEGRP, LOOPRED),
        produces=(SHARD, PARTIAL))
def pad(prop, d: Node) -> None:
    """pad: dup via congruence (the generic rule); shard preserved when the
    sharded dim is not padded (same padding config on the baseline
    candidate); partial(add) carries through zero-padding (padding with the
    additive identity distributes over the rank sum — cotangents of sliced
    stacked parameters under data parallelism)."""
    pc = d.param("padding_config")
    if len(d.inputs) > 1 and is_zero_const(prop.dist, d.inputs[1]):
        for f in prop.store.facts_kind(d.inputs[0], PARTIAL):
            if f.reduce_op != "add" or not (f.layout.effectively_identity
                                            and f.layout.src_shape == f.layout.dst_shape):
                continue
            for vf in prop.store.facts_kind(d.inputs[1], DUP)[:4]:
                for z in prop._base_candidates(
                        d.op, [f.base, vf.base], d.params, layer=d.layer):
                    if prop._dtype_ok(z, d):
                        prop.emit(Fact(PARTIAL, z.id, d.id, prop.size,
                                       Layout.identity(z.shape),
                                       reduce_op="add"))
    for f in prop.store.facts_kind(d.inputs[0], SHARD):
        k = prop._shard_src_dim(f)
        if k is None:
            continue
        if pc is not None and k < len(pc) and tuple(pc[k]) != (0, 0, 0):
            continue
        val_facts = prop.store.facts(d.inputs[1]) if len(d.inputs) > 1 else [None]
        for vf in val_facts[:4] or [None]:
            b_ins = [f.base] + ([vf.base] if vf else [])
            for z in prop._base_candidates(d.op, b_ins, d.params):
                if not prop._dtype_ok(z, d):
                    continue
                try:
                    lay = shard_stack_layout(z.shape, k, prop.size)
                except NotSplitMerge:
                    continue
                prop.emit(Fact(SHARD, z.id, d.id, prop.size, lay))


@R.rule("axis_op_shard", ("cumsum", "rev"), consumes=(SHARD,),
        produces=(SHARD,))
def axis_op(prop, d: Node) -> None:
    """Ops acting along one axis (cumsum/rev): dup facts propagate via the
    generic congruence rule; shard facts carry through when the op axis is
    not the sharded dim."""
    ax = d.param("axis")
    if ax is None:
        return
    for f in prop.store.facts_kind(d.inputs[0], SHARD):
        k = prop._shard_src_dim(f)
        if k is None or k == ax:
            continue
        for z in prop._base_candidates(d.op, [f.base], d.params, layer=d.layer):
            if prop._dtype_ok(z, d):
                try:
                    lay = shard_stack_layout(z.shape, k, prop.size)
                except NotSplitMerge:
                    continue
                prop.emit(Fact(SHARD, z.id, d.id, prop.size, lay))
