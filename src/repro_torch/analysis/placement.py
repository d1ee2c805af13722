"""Single-graph abstract placement interpreter (the baseline-free tier).

The relational verifier proves facts *between* a baseline and a distributed
graph; this module instead abstract-interprets **one** per-device graph over
a placement lattice seeded from its input PartitionSpecs:

=================  =======================================================
state              meaning (w.r.t. the conceptual global value)
=================  =======================================================
``rep``            every rank holds the same, complete value
``("shard", d)``   each rank holds a contiguous chunk along dim ``d``
                   (``d`` may be None when layout ops obscured the dim)
``partial``        each rank holds an *addend*: the global value is the
                   sum over ranks (the state an ``all_reduce(add)`` or
                   ``reduce_scatter`` must discharge)
``rank``           a rank-dependent scalar index value (``axis_index``
                   arithmetic — feeds rank-slicing, never data)
``unk``            the analysis gave up (sound: suppresses every
                   downstream lint rather than guessing)
=================  =======================================================

Transfer functions follow the rule families (``repro.core.rules``): dots
contracting a sharded dim produce ``partial``; linear ops (add/sub/neg,
scaling by a replicated factor, reshape/transpose/broadcast/slice/pad-with-
zero, reduce_sum, cumsum) carry ``partial`` through; ``all_reduce(add)`` /
``reduce_scatter`` over the verified axis discharge it.  A **leak** is a
definite ``partial`` reaching a consumer whose semantics do not commute
with the rank sum (a nonlinear op, a join with a non-partial operand, a
graph output not declared partial) — the static signature of a missing
``all_reduce``, flagged with zero baseline traces.

Everything uncertain degrades to ``unk``, never to a definite state: on
clean graphs the interpreter must produce no false leaks (the lint gate
analogue of the paper's zero-false-positive claim).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.ir import ELEMENTWISE, Node
from repro_torch.core.rules.common import is_zero_const as _is_zero_const

REP = ("rep",)
PART = ("partial",)
RANK = ("rank",)
UNK = ("unk",)


def shard(dim=None) -> tuple:
    return ("shard", dim)


def is_shard(state: tuple) -> bool:
    return state[0] == "shard"


def shard_dim_of(state: tuple):
    return state[1] if is_shard(state) else None


# elementwise ops linear in every operand (rank-sum commutes)
_LINEAR_EW = frozenset({"add", "sub", "neg"})
# elementwise ops linear in ONE operand when the others are replicated
_SCALE_EW = frozenset({"mul", "div"})
# axis ops that are linear maps (carry partial through)
_LINEAR_AXIS = frozenset({"cumsum", "rev"})


@dataclass
class Leak:
    """A definite ``partial`` consumed where its addends are meaningless."""

    node: int  # the faulty consumer (or the producer, for output leaks)
    producer: int  # the partial-valued input node
    reason: str  # nonlinear_consumer | join_with_nonpartial | graph_output
    detail: str = ""


@dataclass
class PlacementResult:
    states: dict = field(default_factory=dict)  # node id -> state tuple
    leaks: list = field(default_factory=list)  # [Leak]

    def state(self, nid: int) -> tuple:
        return self.states.get(nid, UNK)


def _collective_axes(d: Node) -> tuple:
    axes = d.param("axes") or (d.param("axis"),)
    if isinstance(axes, str):
        axes = (axes,)
    return tuple(a for a in axes if a)


def _full_group(d: Node) -> bool:
    groups = d.param("groups")
    return groups is None or groups == "full"


def _reshape_shard_dim(in_shape, out_shape, d):
    """Map a sharded *input* dim through a reshape, or None.

    Greedy split/merge factorization of the (local, per-device) shapes:
    the shard dim survives only when it is the **outermost** dim of its
    factor group (contiguous chunking along an outer factor stays
    contiguous chunking of the group's outer output factor)."""
    i = j = 0
    while i < len(in_shape) and j < len(out_shape):
        pi, pj = in_shape[i], out_shape[j]
        gi, gj = [i], [j]
        while pi != pj:
            if pi < pj:
                i += 1
                if i >= len(in_shape):
                    return None
                pi *= in_shape[i]
                gi.append(i)
            else:
                j += 1
                if j >= len(out_shape):
                    return None
                pj *= out_shape[j]
                gj.append(j)
        if d in gi:
            # contiguous chunking survives iff d is the outermost non-unit
            # dim of its factor group; it lands on the outermost non-unit
            # output dim of the group (unit dims carry no layout)
            if any(in_shape[k] > 1 for k in gi if k < d):
                return None
            return next((j for j in gj if out_shape[j] > 1), gj[0])
        i += 1
        j += 1
    return None


def _elementwise(g, d: Node, ins: list, leaks: list) -> tuple:
    if any(s == UNK for s in ins):
        return UNK
    partials = [i for i, s in zip(d.inputs, ins) if s == PART]
    if partials:
        return _elementwise_partial(g, d, ins, partials, leaks)
    if any(s == RANK for s in ins):
        # rank-index arithmetic (e.g. axis_index * chunk) stays rank-local
        return RANK if all(s in (RANK, REP) for s in ins) else UNK
    shards = [s for s in ins if is_shard(s)]
    if shards:
        dims = {shard_dim_of(s) for s in shards}
        if len(dims) == 1 and all(is_shard(s) or s == REP for s in ins):
            return shard(dims.pop())
        return UNK
    return REP


def _elementwise_partial(g, d: Node, ins, partials, leaks) -> tuple:
    others = [(i, s) for i, s in zip(d.inputs, ins) if s != PART]
    if d.op in _LINEAR_EW:
        # add/sub of partial with zero-const is still partial (zero-padding
        # style); with anything else replicated/sharded it is the classic
        # missing-all_reduce join
        bad = [(i, s) for i, s in others if not _is_zero_const(g, i)]
        if not bad:
            return PART
        leaks.append(Leak(
            d.id, partials[0], "join_with_nonpartial",
            f"{d.op} joins a partial value (%{partials[0]}) with a "
            f"non-partial operand — the rank sum is incomplete here"))
        return UNK
    if d.op in _SCALE_EW:
        if d.op == "div" and ins[0] != PART:
            # div(rep, partial): nonlinear in the partial operand
            leaks.append(Leak(
                d.id, partials[0], "nonlinear_consumer",
                f"{d.op} divides by a partial value (%{partials[0]})"))
            return UNK
        if len(partials) == 1 and all(s == REP for _, s in others):
            return PART  # scaling by a replicated factor is linear
        return UNK  # partial*partial / partial*shard: no claim either way
    if d.op == "select":
        # select(pred_rep, partial, zero) == mask * partial: linear
        pred_rep = ins[0] == REP
        val_ok = all(
            s == PART or _is_zero_const(g, i)
            for i, s in list(zip(d.inputs, ins))[1:])
        if pred_rep and val_ok:
            return PART
        return UNK
    # every other elementwise op (exp/tanh/rsqrt/max/compare/pow/...) does
    # not commute with the rank sum: a definite partial here is a bug
    leaks.append(Leak(
        d.id, partials[0], "nonlinear_consumer",
        f"nonlinear {d.op} consumes a partial value (%{partials[0]}) "
        f"with no all_reduce/reduce_scatter on the path"))
    return UNK


def _dot(d: Node, sl: tuple, sr: tuple) -> tuple:
    dn = d.param("dimension_numbers")
    if dn is None:
        return UNK
    (lc, rc), (lb, rb) = dn
    lc, rc, lb, rb = tuple(lc), tuple(rc), tuple(lb), tuple(rb)
    if UNK in (sl, sr) or RANK in (sl, sr):
        return UNK
    if PART in (sl, sr):
        other = sr if sl == PART else sl
        if other == REP and not (sl == PART and sr == PART):
            return PART  # linear in the partial operand
        return UNK
    if sl == REP and sr == REP:
        return REP
    dl, dr = shard_dim_of(sl), shard_dim_of(sr)
    if is_shard(sl) and dl is None:
        return UNK
    if is_shard(sr) and dr is None:
        return UNK
    if is_shard(sl) and dl in lc:
        # contracting a sharded dim: partial iff the rhs contracts its
        # matching sharded dim (per-device shapes could not line up
        # otherwise, but stay conservative)
        if is_shard(sr) and dr == rc[lc.index(dl)]:
            return PART
        return UNK
    if is_shard(sr) and dr in rc:
        return UNK  # rhs contracted-sharded without matching lhs
    if is_shard(sl) and dl in lb:
        if sr == REP or (is_shard(sr) and dr == rb[lb.index(dl)]):
            return shard(lb.index(dl))
        return UNK
    if is_shard(sr) and dr in rb:
        return UNK  # rhs batch-sharded without (handled) lhs counterpart
    # free-dim sharding: exactly one operand sharded, the other replicated
    if is_shard(sl) and sr == REP:
        # output rank layout: batch + lhs free + rhs free; we need the lhs
        # rank to enumerate free dims — recover it from the input node via
        # the caller (shapes travel with states in analyze_placements)
        return ("shard_dot_l", dl)
    if is_shard(sr) and sl == REP:
        return ("shard_dot_r", dr)
    return UNK


def _resolve_dot_free(d: Node, g, marker: tuple) -> tuple:
    """Resolve the free-dim output position for a one-sided sharded dot."""
    dn = d.param("dimension_numbers")
    (lc, rc), (lb, rb) = dn
    lhs, rhs = g[d.inputs[0]], g[d.inputs[1]]
    lfree = [k for k in range(len(lhs.shape))
             if k not in tuple(lc) and k not in tuple(lb)]
    rfree = [k for k in range(len(rhs.shape))
             if k not in tuple(rc) and k not in tuple(rb)]
    side, dim = marker[0], marker[1]
    if side == "shard_dot_l":
        if dim not in lfree:
            return UNK
        return shard(len(tuple(lb)) + lfree.index(dim))
    if dim not in rfree:
        return UNK
    return shard(len(tuple(lb)) + len(lfree) + rfree.index(dim))


def _reduce(d: Node, s: tuple, leaks) -> tuple:
    axes = tuple(d.param("axes") or ())
    if s == UNK:
        return UNK
    if d.op == "reduce_sum":
        if s == PART:
            return PART
        if s == RANK:
            return RANK
        if is_shard(s):
            k = shard_dim_of(s)
            if k is None:
                return UNK
            if k in axes:
                return PART  # summing the sharded dim: each rank an addend
            return shard(k - sum(1 for a in axes if a < k))
        return REP
    # max/min/prod/and/or do not commute with the rank sum
    if s == PART:
        leaks.append(Leak(
            d.id, d.inputs[0], "nonlinear_consumer",
            f"{d.op} consumes a partial value (%{d.inputs[0]})"))
        return UNK
    if s == REP:
        return REP
    if is_shard(s):
        k = shard_dim_of(s)
        if k is not None and k not in axes:
            return shard(k - sum(1 for a in axes if a < k))
    return UNK


def _collective(ctx, d: Node, s: tuple, leaks) -> tuple:
    axes = _collective_axes(d)
    if ctx.axis not in axes:
        # orthogonal (or undeclared — the collective-axis pass flags it):
        # make no claim about the result
        return s if set(axes) <= set(ctx.mesh_axes) else UNK
    if d.op == "all_reduce":
        if s == PART and d.param("reduce_op", "add") != "add":
            leaks.append(Leak(
                d.id, d.inputs[0], "nonlinear_consumer",
                f"all_reduce({d.param('reduce_op')}) consumes partial "
                f"addends — only all_reduce(add) discharges a partial sum"))
            return UNK
        if not _full_group(d):
            return UNK  # subgroup reduce: partial across groups
        return REP if d.param("reduce_op", "add") == "add" or s != PART \
            else UNK
    if d.op == "all_gather":
        if s == PART:
            leaks.append(Leak(
                d.id, d.inputs[0], "nonlinear_consumer",
                "all_gather concatenates partial addends instead of "
                "reducing them"))
            return UNK
        if is_shard(s):
            gdim = d.param("all_gather_dimension", 0)
            k = shard_dim_of(s)
            if k is not None and k != gdim:
                return UNK  # the collective-dim pass flags this
            return REP
        return REP if s in (REP, UNK, RANK) else UNK
    if d.op == "reduce_scatter":
        # whatever the operand, each rank ends with one contiguous chunk of
        # the (summed) value along scatter_dimension
        return shard(d.param("scatter_dimension", 0))
    if d.op == "all_to_all":
        return shard(None) if is_shard(s) else UNK
    if d.op == "ppermute":
        return s if s in (REP, PART, RANK) or is_shard(s) else UNK
    return UNK


def analyze_placements(ctx) -> PlacementResult:
    """One forward walk in SSA order; see the module docstring."""
    g = ctx.graph
    res = PlacementResult()
    st = res.states
    leaks = res.leaks
    for d in g:
        ins = [st.get(i, UNK) for i in d.inputs]
        if d.op in ("input", "param"):
            out = ctx.input_placements.get(d.id, REP if ctx.size == 1 else UNK)
        elif d.op in ("const", "iota"):
            out = REP
        elif d.op == "axis_index":
            out = RANK if ctx.axis in _collective_axes(d) else REP
        elif d.op in ("all_reduce", "all_gather", "reduce_scatter",
                      "all_to_all", "ppermute"):
            out = _collective(ctx, d, ins[0] if ins else UNK, leaks)
        elif d.op in ELEMENTWISE:
            out = _elementwise(g, d, ins, leaks)
        elif d.op == "dot":
            out = _dot(d, ins[0], ins[1])
            if out[0] in ("shard_dot_l", "shard_dot_r"):
                out = _resolve_dot_free(d, g, out)
        elif d.op == "reshape":
            out = _transfer_reshape(g, d, ins[0])
        elif d.op == "transpose":
            out = _transfer_transpose(d, ins[0])
        elif d.op == "broadcast":
            out = _transfer_broadcast(d, ins[0])
        elif d.op == "convert":
            out = ins[0]
        elif d.op == "slice":
            out = ins[0]
        elif d.op == "pad":
            out = _transfer_pad(g, d, ins)
        elif d.op == "concat":
            out = _transfer_concat(ins)
        elif d.op in ("reduce_sum", "reduce_max", "reduce_min", "reduce_prod",
                      "reduce_and", "reduce_or"):
            out = _reduce(d, ins[0], leaks)
        elif d.op in _LINEAR_AXIS:
            out = ins[0] if ins[0] in (REP, PART) or is_shard(ins[0]) else UNK
        elif d.op in ("argmax", "argmin", "sort", "top_k"):
            if ins and ins[0] == PART:
                leaks.append(Leak(
                    d.id, d.inputs[0], "nonlinear_consumer",
                    f"{d.op} consumes a partial value (%{d.inputs[0]})"))
            out = REP if all(s == REP for s in ins) else UNK
        elif d.op == "dynamic_slice":
            out = _transfer_dynamic_slice(ins)
        elif d.op == "dynamic_update_slice":
            out = _transfer_dus(ins)
        else:
            # opaque (gather/scatter/conv/custom kernels): a deterministic
            # function of replicated operands is replicated; otherwise give up
            out = REP if ins and all(s == REP for s in ins) else UNK
        st[d.id] = out

    # graph outputs declared non-partial must not carry a definite partial
    for pos, oid in enumerate(g.outputs):
        expected = (ctx.output_placements[pos]
                    if pos < len(ctx.output_placements) else None)
        kind = getattr(expected, "kind", expected)
        if st.get(oid) == PART and kind != "partial":
            leaks.append(Leak(
                oid, oid, "graph_output",
                f"graph output {pos} is a partial sum but is declared "
                f"{kind or 'replicated'} — missing all_reduce before the "
                f"output"))
    return res


def _transfer_reshape(g, d: Node, s: tuple) -> tuple:
    if s in (REP, PART, RANK, UNK):
        return s
    k = shard_dim_of(s)
    if k is None:
        return shard(None)
    in_shape = g[d.inputs[0]].shape
    return shard(_reshape_shard_dim(in_shape, d.shape, k))


def _transfer_transpose(d: Node, s: tuple) -> tuple:
    if s in (REP, PART, RANK, UNK):
        return s
    k = shard_dim_of(s)
    perm = d.param("permutation")
    if k is None or perm is None:
        return shard(None)
    return shard(tuple(perm).index(k))


def _transfer_broadcast(d: Node, s: tuple) -> tuple:
    if s in (REP, PART, RANK, UNK):
        return s
    k = shard_dim_of(s)
    bd = tuple(d.param("broadcast_dimensions") or ())
    if k is None or k >= len(bd):
        return shard(None)
    return shard(bd[k])


def _transfer_pad(g, d: Node, ins: list) -> tuple:
    s = ins[0] if ins else UNK
    if s == PART:
        zero = len(d.inputs) > 1 and _is_zero_const(g, d.inputs[1])
        return PART if zero else UNK
    if s in (REP, RANK):
        return s if all(x == REP for x in ins[1:]) or s == RANK else UNK
    if is_shard(s):
        return s
    return UNK


def _transfer_concat(ins: list) -> tuple:
    if not ins or any(s == UNK for s in ins):
        return UNK
    if all(s == ins[0] for s in ins):
        return ins[0] if ins[0] in (REP, PART) or is_shard(ins[0]) else UNK
    return UNK


def _transfer_dynamic_slice(ins: list) -> tuple:
    x, idx = (ins[0] if ins else UNK), ins[1:]
    if any(s == RANK for s in idx):
        # rank-dependent slicing of a replicated tensor yields per-rank
        # chunks (the rank_dynamic_slice rule's territory)
        return shard(None) if x == REP else UNK
    if all(s == REP for s in idx):
        return x
    return UNK


def _transfer_dus(ins: list) -> tuple:
    if len(ins) < 2:
        return UNK
    x, upd, idx = ins[0], ins[1], ins[2:]
    if not all(s == REP for s in idx):
        return UNK
    if x == upd and (x in (REP, PART) or is_shard(x)):
        return x
    return UNK
