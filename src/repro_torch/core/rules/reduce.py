"""Reduction op family: reductions over dup inputs stay dup; reducing the
sharded dim yields a partial; reducing other dims keeps the shard; partials
commute with matching reductions."""
from __future__ import annotations

from ..bijection import Layout, NotSplitMerge
from ..ir import Node
from ..relations import DUP, PARTIAL, SHARD, Fact
from .common import dup_id, shard_stack_layout
from .registry import DEFAULT_REGISTRY as R

REDUCE_OPS = ("reduce_sum", "reduce_max", "reduce_min", "reduce_prod")


@R.rule("reduce", REDUCE_OPS, consumes=(DUP, SHARD, PARTIAL),
        produces=(DUP, SHARD, PARTIAL))
def reduce_rule(prop, d: Node) -> None:
    axes = tuple(d.param("axes") or ())
    red = {"reduce_sum": "add", "reduce_max": "max", "reduce_min": "min"}.get(d.op)
    for f in prop.store.facts(d.inputs[0]):
        if f.kind == DUP and dup_id(f):
            for z in prop._base_candidates(d.op, [f.base], d.params, layer=d.layer):
                if prop._dtype_ok(z, d):
                    prop.emit(Fact(DUP, z.id, d.id, prop.size, Layout.identity(z.shape)))
        elif f.kind == SHARD:
            k = prop._shard_src_dim(f)
            if k is None:
                continue
            for z in prop._base_candidates(d.op, [f.base], d.params, layer=d.layer):
                if not prop._dtype_ok(z, d):
                    continue
                if k in axes:
                    if red is None:
                        continue
                    prop.emit(
                        Fact(PARTIAL, z.id, d.id, prop.size, Layout.identity(z.shape), reduce_op=red)
                    )
                else:
                    new_k = k - sum(1 for a in axes if a < k)
                    try:
                        lay = shard_stack_layout(z.shape, new_k, prop.size)
                    except NotSplitMerge:
                        continue
                    prop.emit(Fact(SHARD, z.id, d.id, prop.size, lay))
        elif f.kind == PARTIAL and dup_id(f):
            commutes = (f.reduce_op == "add" and d.op == "reduce_sum") or (
                f.reduce_op == "max" and d.op == "reduce_max"
            ) or (f.reduce_op == "min" and d.op == "reduce_min")
            if commutes:
                for z in prop._base_candidates(d.op, [f.base], d.params, layer=d.layer):
                    if prop._dtype_ok(z, d):
                        prop.emit(
                            Fact(
                                PARTIAL, z.id, d.id, prop.size, Layout.identity(z.shape),
                                reduce_op=f.reduce_op,
                            )
                        )
