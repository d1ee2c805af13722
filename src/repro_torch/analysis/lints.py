"""The registered lint passes (imported for side effect, like rule modules).

Two families:

* ``ir`` — single-graph well-formedness: SSA reference validity, per-op
  shape/dtype/param consistency, the layer-tag monotonicity the stamping
  pipeline (:mod:`repro.core.stamp`) assumes, dead collectives.
* ``sharding`` — placement semantics over the verified mesh axis, driven by
  the abstract interpreter (:mod:`repro.analysis.placement`): unreduced
  partials, collectives over orthogonal/undeclared axes or subgroup replica
  sets, wrong-dim gathers, redundant back-to-back collectives.

Severity policy: ``error`` only for conditions that cannot occur in a
well-formed clean graph (the lint gate's zero-false-positive analogue of
the paper's detection claim); anything heuristic stays ``warning``.
"""
from __future__ import annotations

from repro_torch.core.ir import COLLECTIVES, ELEMENTWISE, Graph, Node

from .placement import (
    PART,
    REP,
    _collective_axes,
    _full_group,
    is_shard,
    shard_dim_of,
)
from .registry import DEFAULT_LINTS as L
from .registry import LintContext
from .report import ERROR, WARNING, LintFinding

_LEAK_CATEGORY = {
    "nonlinear_consumer": "missing_all_reduce",
    "join_with_nonpartial": "missing_all_reduce",
    "graph_output": "missing_all_reduce",
}


def _finding(pass_name: str, severity: str, category: str, n: Node,
             detail: str) -> LintFinding:
    return LintFinding(pass_name, severity, category, n.id, n.op, n.src,
                       detail)


# ---------------------------------------------------------------------------
# ir family


@L.lint("ir-ssa", family="ir",
        doc="dangling input/output references; SSA (topological) ordering")
def ir_ssa(ctx: LintContext):
    g = ctx.graph
    for n in g:
        for i in n.inputs:
            if i < 0 or i >= len(g):
                yield _finding("ir-ssa", ERROR, "ir_invalid", n,
                               f"input %{i} does not exist")
            elif i >= n.id:
                yield _finding("ir-ssa", ERROR, "ir_invalid", n,
                               f"input %{i} is not defined before use "
                               f"(append-only SSA violated)")
    for pos, o in enumerate(g.outputs):
        if o < 0 or o >= len(g):
            yield LintFinding("ir-ssa", ERROR, "ir_invalid", o, "?", "",
                              f"graph output {pos} references missing "
                              f"node %{o}")


@L.lint("ir-shapes", family="ir",
        doc="shape/dtype/param consistency per op family")
def ir_shapes(ctx: LintContext):
    g = ctx.graph
    for n in g:
        for f in _shape_check(g, n):
            yield f


def _shape_check(g: Graph, n: Node):
    ins = [g[i] for i in n.inputs if 0 <= i < len(g)]
    if len(ins) != len(n.inputs):
        return  # ir-ssa already flagged the dangling reference
    if n.op == "reshape":
        if ins and n.size != ins[0].size:
            yield _finding("ir-shapes", ERROR, "ir_invalid", n,
                           f"reshape changes element count "
                           f"{ins[0].size} -> {n.size}")
        new_sizes = n.param("new_sizes")
        if new_sizes is not None and tuple(new_sizes) != n.shape:
            yield _finding("ir-shapes", ERROR, "ir_invalid", n,
                           f"new_sizes {new_sizes} != node shape {n.shape}")
    elif n.op == "transpose":
        perm = n.param("permutation")
        if perm is None or sorted(perm) != list(range(len(n.shape))):
            yield _finding("ir-shapes", ERROR, "ir_invalid", n,
                           f"permutation {perm} is not a permutation of "
                           f"rank {len(n.shape)}")
        elif ins and n.shape != tuple(ins[0].shape[p] for p in perm):
            yield _finding("ir-shapes", ERROR, "ir_invalid", n,
                           f"shape {n.shape} inconsistent with permuting "
                           f"{ins[0].shape} by {perm}")
    elif n.op == "convert":
        nd = n.param("new_dtype")
        if ins and n.shape != ins[0].shape:
            yield _finding("ir-shapes", ERROR, "ir_invalid", n,
                           "convert changes shape")
        if nd is not None and str(nd) != n.dtype:
            yield _finding("ir-shapes", ERROR, "ir_invalid", n,
                           f"new_dtype {nd} != node dtype {n.dtype}")
    elif n.op == "slice":
        st, li = n.param("start_indices"), n.param("limit_indices")
        strides = n.param("strides") or (st and (1,) * len(st))
        if st is not None and li is not None and ins:
            want = tuple(
                -(-(lim - s) // k) for s, lim, k in zip(st, li, strides))
            if want != n.shape:
                yield _finding("ir-shapes", ERROR, "ir_invalid", n,
                               f"slice shape {n.shape} != "
                               f"{want} from start/limit/strides")
            if any(lim > d for lim, d in zip(li, ins[0].shape)):
                yield _finding("ir-shapes", ERROR, "ir_invalid", n,
                               f"limit_indices {li} exceed operand shape "
                               f"{ins[0].shape}")
    elif n.op == "concat":
        dim = n.param("dimension")
        if dim is not None and ins:
            total = sum(x.shape[dim] for x in ins)
            rest_ok = all(
                x.shape[:dim] == n.shape[:dim]
                and x.shape[dim + 1:] == n.shape[dim + 1:] for x in ins)
            if n.shape[dim] != total or not rest_ok:
                yield _finding("ir-shapes", ERROR, "ir_invalid", n,
                               f"concat of {[x.shape for x in ins]} along "
                               f"dim {dim} != {n.shape}")
    elif n.op == "broadcast":
        bd = tuple(n.param("broadcast_dimensions") or ())
        if ins and len(bd) != len(ins[0].shape):
            yield _finding("ir-shapes", ERROR, "ir_invalid", n,
                           f"broadcast_dimensions {bd} rank != operand "
                           f"rank {len(ins[0].shape)}")
        elif ins and any(
                ins[0].shape[i] not in (1, n.shape[b])
                for i, b in enumerate(bd)):
            yield _finding("ir-shapes", ERROR, "ir_invalid", n,
                           f"operand {ins[0].shape} does not broadcast to "
                           f"{n.shape} via {bd}")
    elif n.op in ELEMENTWISE and n.op != "select":
        # traced elementwise operands are scalars or rank-equal broadcast
        # shapes (size-1 dims expand to the output dim)
        for x in ins:
            ok = x.shape == () or (
                len(x.shape) == len(n.shape)
                and all(a in (1, b) for a, b in zip(x.shape, n.shape)))
            if not ok:
                yield _finding("ir-shapes", ERROR, "ir_invalid", n,
                               f"elementwise {n.op} operand %{x.id} shape "
                               f"{x.shape} does not broadcast to {n.shape}")
                break


@L.lint("ir-tags", family="ir",
        doc="layer-tag monotonicity the stamping pipeline assumes")
def ir_tags(ctx: LintContext):
    """Stamping (repro.core.stamp) partitions the trace into contiguous id
    ranges per layer period; a tagged node appearing after a higher tag
    breaks that contract silently."""
    g = ctx.graph
    last_tag = None
    for n in g:
        if n.layer is None:
            continue
        if last_tag is not None and n.layer < last_tag:
            yield _finding("ir-tags", ERROR, "ir_invalid", n,
                           f"layer tag {n.layer} appears after tag "
                           f"{last_tag} — tags must be monotone in trace "
                           f"order for stamping")
            return  # one finding suffices; later tags are all suspect
        last_tag = n.layer


@L.lint("dead-collective", family="ir",
        doc="collective whose result is never consumed nor output")
def dead_collective(ctx: LintContext):
    g = ctx.graph
    for nid in sorted(g.dead_ids()):
        n = g[nid]
        if n.op not in COLLECTIVES or n.op == "ppermute":
            continue
        yield _finding("dead-collective", WARNING, "dead_collective", n,
                       f"{n.op} result is never consumed — dead "
                       f"communication")


# ---------------------------------------------------------------------------
# sharding family


@L.lint("partial-leak", family="sharding",
        doc="partial value reaches an output or non-reducing consumer "
            "with no all_reduce/reduce_scatter on the path")
def partial_leak(ctx: LintContext):
    g = ctx.graph
    for leak in ctx.placement.leaks:
        n = g[leak.node]
        yield _finding("partial-leak", ERROR,
                       _LEAK_CATEGORY.get(leak.reason, "missing_all_reduce"),
                       n, leak.detail)


@L.lint("collective-axis", family="sharding",
        doc="collective over an undeclared mesh axis or subgroup replica "
            "sets where the full axis is required")
def collective_axis(ctx: LintContext):
    g = ctx.graph
    states = ctx.placement.states
    declared = set(ctx.mesh_axes)
    for n in g:
        if n.op not in COLLECTIVES:
            continue
        axes = _collective_axes(n)
        ghost = [a for a in axes if a not in declared]
        if ghost:
            yield _finding("collective-axis", ERROR, "wrong_mesh_axis", n,
                           f"{n.op} over mesh axis "
                           f"{', '.join(map(str, ghost))} which the "
                           f"program's mesh does not declare "
                           f"(declared: {', '.join(ctx.mesh_axes)})")
            continue
        if n.op in ("all_reduce", "reduce_scatter") and not _full_group(n):
            if n.inputs and states.get(n.inputs[0]) == PART:
                yield _finding(
                    "collective-axis", ERROR, "wrong_replica_groups", n,
                    f"{n.op} discharges a partial sum over subgroup "
                    f"replica sets {n.param('groups')} — every rank of "
                    f"axis {ctx.axis!r} holds an addend, so the reduction "
                    f"must span the full axis")
            else:
                yield _finding(
                    "collective-axis", WARNING, "wrong_replica_groups", n,
                    f"{n.op} uses subgroup replica sets "
                    f"{n.param('groups')} (full-axis collectives expected "
                    f"in single-axis programs)")


@L.lint("collective-dim", family="sharding",
        doc="all_gather along a different dim than the operand's shard dim")
def collective_dim(ctx: LintContext):
    g = ctx.graph
    states = ctx.placement.states
    for n in g:
        if n.op != "all_gather" or ctx.axis not in _collective_axes(n):
            continue
        s = states.get(n.inputs[0]) if n.inputs else None
        if s is None or not is_shard(s):
            continue
        k, gdim = shard_dim_of(s), n.param("all_gather_dimension", 0)
        if k is not None and k != gdim:
            yield _finding(
                "collective-dim", ERROR, "wrong_axis_split", n,
                f"all_gather concatenates along dim {gdim} but the operand "
                f"is sharded along dim {k} — the gathered tensor "
                f"interleaves chunks in the wrong axis")


@L.lint("redundant-collective", family="sharding",
        doc="back-to-back all_reduce and collectives over already-"
            "replicated values")
def redundant_collective(ctx: LintContext):
    g = ctx.graph
    states = ctx.placement.states
    for n in g:
        if ctx.axis not in _collective_axes(n):
            continue
        if n.op == "all_reduce" and n.inputs:
            prev = g[n.inputs[0]]
            if prev.op == "all_reduce" and prev.params == n.params:
                yield _finding(
                    "redundant-collective", ERROR, "redundant_all_reduce", n,
                    f"all_reduce applied twice back-to-back — the value is "
                    f"already replicated after %{prev.id}, so the second "
                    f"reduce scales it by the axis size")
                continue
            if (states.get(n.inputs[0]) == REP
                    and n.param("reduce_op", "add") == "add"):
                yield _finding(
                    "redundant-collective", ERROR, "redundant_all_reduce", n,
                    f"all_reduce(add) over a replicated value scales it by "
                    f"the axis size ({ctx.size})")
        elif n.op == "all_gather" and n.inputs:
            if states.get(n.inputs[0]) == REP:
                yield _finding(
                    "redundant-collective", WARNING, "redundant_all_gather",
                    n, "all_gather of an already-replicated value tiles it "
                       "along the gather dim")
