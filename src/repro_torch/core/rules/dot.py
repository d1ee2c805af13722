"""Dot op family: contraction/batch/free-dim case analysis over
dup/shard/partial operand facts (the paper's row/column-parallel matmul
rules, generalized over dimension_numbers)."""
from __future__ import annotations

import itertools

from ..bijection import Layout, NotSplitMerge
from ..ir import Node
from ..relations import DUP, PARTIAL, SHARD, Fact
from .common import dup_id, shard_stack_layout
from .registry import DEFAULT_REGISTRY as R


def _dnums(d: Node):
    dn = d.param("dimension_numbers")
    (lc, rc), (lb, rb) = dn
    return tuple(lc), tuple(rc), tuple(lb), tuple(rb)


@R.rule("dot", ("dot",), consumes=(DUP, SHARD, PARTIAL),
        produces=(DUP, SHARD, PARTIAL))
def dot(prop, d: Node) -> None:
    fx = prop.store.facts(d.inputs[0])
    fy = prop.store.facts(d.inputs[1])
    if not fx or not fy:
        return
    lc, rc, lb, rb = _dnums(d)
    for f1, f2 in itertools.product(fx[:6], fy[:6]):
        _try_dot(prop, d, f1, f2, lc, rc, lb, rb)


def _try_dot(prop, d: Node, f1: Fact, f2: Fact, lc, rc, lb, rb) -> None:
    kinds = (f1.kind, f2.kind)
    b_inputs = [f1.base, f2.base]

    def bases():
        return [
            z
            for z in prop._base_candidates("dot", b_inputs, d.params, layer=d.layer)
            if prop._dtype_ok(z, d)
        ]

    id1 = dup_id(f1) or (f1.kind == SHARD and prop._shard_src_dim(f1) is not None)
    id2 = dup_id(f2) or (f2.kind == SHARD and prop._shard_src_dim(f2) is not None)
    if not (id1 and id2):
        if f1.kind in (DUP, SHARD) and f2.kind in (DUP, SHARD):
            prop._diag_layout(d, (f1, f2))
        return

    if kinds == (DUP, DUP):
        for z in bases():
            prop.emit(Fact(DUP, z.id, d.id, prop.size, Layout.identity(z.shape)))
    elif kinds == (PARTIAL, DUP) and f1.reduce_op == "add":
        for z in bases():
            prop.emit(Fact(PARTIAL, z.id, d.id, prop.size, Layout.identity(z.shape), reduce_op="add"))
    elif kinds == (DUP, PARTIAL) and f2.reduce_op == "add":
        for z in bases():
            prop.emit(Fact(PARTIAL, z.id, d.id, prop.size, Layout.identity(z.shape), reduce_op="add"))
    elif kinds == (SHARD, SHARD):
        k1, k2 = prop._shard_src_dim(f1), prop._shard_src_dim(f2)
        if k1 is None or k2 is None:
            return
        if k1 in lc and k2 in rc and lc.index(k1) == rc.index(k2):
            # contracted on matching positions -> partial sum
            for z in bases():
                prop.emit(
                    Fact(PARTIAL, z.id, d.id, prop.size, Layout.identity(z.shape), reduce_op="add")
                )
        elif k1 in lb and k2 in rb and lb.index(k1) == rb.index(k2):
            for z in bases():
                lay = shard_stack_layout(z.shape, lb.index(k1), prop.size)
                prop.emit(Fact(SHARD, z.id, d.id, prop.size, lay))
        else:
            prop.store.diag(
                d.id,
                "wrong_axis_split",
                f"dot at {d.src or '?'} contracts shards along mismatched dims "
                f"({k1} vs {k2})",
            )
    elif SHARD in kinds and DUP in kinds:
        fs = f1 if f1.kind == SHARD else f2
        side = "l" if f1.kind == SHARD else "r"
        k = prop._shard_src_dim(fs)
        if k is None:
            return
        contract = lc if side == "l" else rc
        if k in contract:
            prop.store.diag(
                d.id,
                "missing_all_reduce",
                f"dot at {d.src or '?'} contracts a sharded dim against a replicated "
                f"operand — result would be partial but pairing shard is absent",
            )
            return
        for z in bases():
            lhs_rank = len(prop.base[z.inputs[0]].shape)
            # output dim layout: batch dims, then lhs free, then rhs free
            if side == "l":
                if k in lb:
                    out_dim = lb.index(k)
                else:
                    free = [i for i in range(lhs_rank) if i not in lc and i not in lb]
                    out_dim = len(lb) + free.index(k)
            else:
                rhs_rank = len(prop.base[z.inputs[1]].shape)
                if k in rb:
                    out_dim = rb.index(k)
                else:
                    lfree = [i for i in range(lhs_rank) if i not in lc and i not in lb]
                    rfree = [i for i in range(rhs_rank) if i not in rc and i not in rb]
                    out_dim = len(lb) + len(lfree) + rfree.index(k)
            try:
                lay = shard_stack_layout(z.shape, out_dim, prop.size)
            except NotSplitMerge:
                continue
            prop.emit(Fact(SHARD, z.id, d.id, prop.size, lay))
