"""Elementwise op family: unary/n-ary joins over every fact kind, including
the numpy-style broadcast join of shard facts and the unrolled-loop
accumulation (paper loop_red, Fig. 8)."""
from __future__ import annotations

import itertools
from dataclasses import replace
from typing import Optional, Sequence

from ..bijection import Layout, NotSplitMerge
from ..ir import ELEMENTWISE, Node
from ..relations import DUP, LOOPRED, PARTIAL, SHARD, SLICEGRP, Fact
from .common import LINEAR_UNARY, shard_stack_layout
from .registry import DEFAULT_REGISTRY as R

ALL_KINDS = (DUP, SHARD, PARTIAL, SLICEGRP, LOOPRED)


@R.rule("elementwise", ELEMENTWISE, consumes=ALL_KINDS,
        produces=ALL_KINDS)
def elementwise(prop, d: Node) -> None:
    n = len(d.inputs)
    if n == 1:
        _unary(prop, d)
    elif n >= 2:
        _nary(prop, d)


def _unary(prop, d: Node) -> None:
    x = d.inputs[0]
    for f in prop.store.facts(x):
        if f.kind in (DUP, SHARD, SLICEGRP):
            for z in prop._base_candidates(d.op, [f.base], d.params, layer=d.layer):
                if prop._dtype_ok(z, d):
                    prop.emit(replace(f, base=z.id, dist=d.id))
        elif f.kind == PARTIAL and (d.op in LINEAR_UNARY and f.reduce_op == "add"):
            for z in prop._base_candidates(d.op, [f.base], d.params, layer=d.layer):
                if prop._dtype_ok(z, d):
                    prop.emit(replace(f, base=z.id, dist=d.id))


def _nary(prop, d: Node) -> None:
    fls = [prop.store.facts(i) for i in d.inputs]
    if not all(fls):
        diagnose_join(prop, d, fls)
        return
    for combo in itertools.product(*[fl[:6] for fl in fls]):
        _try_combo(prop, d, combo)
    diagnose_join(prop, d, fls)


def _try_combo(prop, d: Node, combo: Sequence[Fact]) -> None:
    kinds = {f.kind for f in combo}
    f0 = combo[0]
    b_inputs = [f.base for f in combo]
    if kinds == {DUP}:
        # effectively-identity dups (unit-dim moves only) broadcast freely
        all_id = all(f.layout.effectively_identity for f in combo)
        if not all_id and not all(prop._layouts_joinable(f0, f) for f in combo[1:]):
            prop._diag_layout(d, combo)
            return
        for z in prop._base_candidates(d.op, b_inputs, d.params, layer=d.layer):
            if prop._dtype_ok(z, d):
                if all_id:
                    prop.emit(Fact(DUP, z.id, d.id, prop.size, Layout.identity(z.shape)))
                else:
                    prop.emit(replace(f0, base=z.id, dist=d.id))
    elif kinds == {SLICEGRP}:
        if not all(prop._layouts_joinable(f0, f) for f in combo[1:]):
            return
        if not all(
            (f.dim, f.nchunk, f.index) == (f0.dim, f0.nchunk, f0.index) for f in combo
        ):
            # different chunk indices under add: the unrolled-loop
            # accumulation (paper loop_red, Fig. 8)
            if d.op == "add":
                loopred_accumulate(prop, d, combo)
            return
        for z in prop._base_candidates(d.op, b_inputs, d.params, layer=d.layer):
            if prop._dtype_ok(z, d):
                prop.emit(replace(f0, base=z.id, dist=d.id))
    elif kinds == {PARTIAL}:
        # add-partials combine under add; max-partials under max
        ops = {f.reduce_op for f in combo}
        if ops == {"add"} and d.op == "add" or ops == {"max"} and d.op == "max":
            if all(prop._layouts_joinable(f0, f) for f in combo[1:]):
                for z in prop._base_candidates(d.op, b_inputs, d.params, layer=d.layer):
                    if prop._dtype_ok(z, d):
                        prop.emit(replace(f0, base=z.id, dist=d.id))
    elif kinds <= {SHARD, DUP} and SHARD in kinds:
        _shard_broadcast_join(prop, d, combo, b_inputs)
    elif kinds == {PARTIAL, DUP}:
        # linearity: mul/div by a replicated value distributes over add-partial
        if d.op in ("mul", "div") and len(combo) == 2:
            fp = combo[0] if combo[0].kind == PARTIAL else combo[1]
            if fp.reduce_op == "add":
                if d.op == "div" and combo[1].kind != DUP:
                    return  # partial must be the numerator
                for z in prop._base_candidates(d.op, b_inputs, d.params, layer=d.layer):
                    if prop._dtype_ok(z, d):
                        prop.emit(replace(fp, base=z.id, dist=d.id))
    elif kinds <= {LOOPRED, SLICEGRP} and d.op == "add":
        loopred_accumulate(prop, d, combo)


def _shard_broadcast_join(prop, d: Node, combo: Sequence[Fact], b_inputs) -> None:
    """Elementwise join of shard facts (+ replicated operands) with
    numpy-style trailing-dim broadcast alignment.

    All shard operands must be clean and shard the *same trailing-aligned
    dim* (k - rank equal); replicated operands must be constant along that
    dim (size-1, lower rank, or scalar).  The result is sharded on the
    output dim at the same trailing offset."""
    negs = []
    for f, inp in zip(combo, d.inputs):
        if f.kind == SHARD:
            k = prop._shard_src_dim(f)
            if k is None:
                prop._diag_layout(d, [f for f in combo if f.kind == SHARD])
                return
            negs.append(k - len(prop.base[f.base].shape))
    if len(set(negs)) != 1:
        prop._diag_layout(d, [f for f in combo if f.kind == SHARD])
        return
    k_neg = negs[0]
    for f, inp in zip(combo, d.inputs):
        if f.kind != DUP:
            continue
        shape = prop.dist[inp].shape
        pos = len(shape) + k_neg
        ok = pos < 0 or (pos < len(shape) and shape[pos] == 1)
        if not (f.layout.effectively_identity and ok):
            return
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


def diagnose_join(prop, d: Node, fls: Sequence[list]) -> None:
    if d.op != "add" or len(fls) != 2 or not all(fls):
        return
    k0 = {f.kind for f in fls[0]}
    k1 = {f.kind for f in fls[1]}
    if (PARTIAL in k0) != (PARTIAL in k1):
        prop.store.diag(
            d.id,
            "missing_all_reduce",
            f"add at {d.src or '?'} consumes a partial and a non-partial tensor "
            f"— a reduction collective is likely missing before this add",
        )


# -- loop_red (unrolled expert loops, paper Fig. 8) ---------------------------
def loopred_accumulate(prop, d: Node, combo: Sequence[Fact]) -> None:
    def as_set(f: Fact) -> Optional[tuple]:
        if f.kind == SLICEGRP:
            return (f.base, f.dim, f.nchunk, frozenset([f.index]))
        if f.kind == LOOPRED and f.reduce_op == "add":
            return (f.base, f.dim, f.nchunk, f.idxset)
        return None

    sets = [as_set(f) for f in combo]
    if any(s is None for s in sets):
        return
    base0, dim0, n0 = sets[0][0], sets[0][1], sets[0][2]
    if not all(s[0] == base0 and s[1] == dim0 and s[2] == n0 for s in sets):
        return
    union: frozenset = frozenset()
    total = 0
    for s in sets:
        total += len(s[3])
        union = union | s[3]
    if len(union) != total:  # reused index — not a disjoint accumulation
        return
    f0 = combo[0]
    prop.emit(
        Fact(
            LOOPRED,
            base0,
            d.id,
            prop.size,
            f0.layout,
            reduce_op="add",
            dim=dim0,
            nchunk=n0,
            idxset=union,
        )
    )
