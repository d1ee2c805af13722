"""Baseline-free tracing: ONE graph per (arch, tp), no golden pair.

The lint tier's whole point is working where no baseline exists, so this
module traces only the program under analysis: at ``tp == 1`` the plain
single-device forward (every leaf replicated), at ``tp > 1`` the TP/SP
per-rank forward under the tracer's fake process group, the rank a traced
input emitted as ``axis_index`` — exactly the distributed half of the
``tp-forward`` / ``sp-forward`` scenario builders, minus the baseline trace
the relational verifier would also need.  Leaf placements are seeded from
the same PartitionSpecs the scenarios register as input facts.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace

from repro_torch.verify.plan import PlanError, TP_AXIS

from .placement import REP, shard as _shard_state


@dataclass
class LintUnit:
    """One traced graph plus the seed the lint passes need."""

    graph: object  # repro_torch.core.ir.Graph
    size: int
    axis: str = TP_AXIS
    mesh_axes: tuple = (TP_AXIS,)
    input_placements: dict = field(default_factory=dict)
    output_placements: list = field(default_factory=list)
    arch: str = ""
    trace_s: float = 0.0

    def mutate(self, fn) -> "LintUnit":
        """A copy with ``fn(graph)`` applied (bug injection for testing).

        Input placements carry over by node id: leaves precede every
        injector edit site in SSA order, so graph surgery preserves them."""
        return replace(self, graph=fn(self.graph))


def placements_from_specs(flat_specs, in_ids, axis: str) -> dict:
    """Leaf node id -> abstract state, from flattened PartitionSpecs."""
    from repro_torch.verify.specs import shard_dim

    placements = {}
    for spec, nid in zip(flat_specs, in_ids):
        d = shard_dim(spec, axis)
        placements[nid] = REP if d is None else _shard_state(d)
    return placements


def trace_lint_unit(arch: str, tp: int = 1, *, sp: bool = False,
                    layers=None, batch: int = 1, seq: int = 32,
                    smoke: bool = False) -> LintUnit:
    """Trace ``arch``'s forward at parallelism ``tp`` for linting.

    Unlike :class:`~repro_torch.verify.plan.Plan`, ``tp == 1`` is legal
    here: single-device graphs still get the full IR family of lints (and
    the sharding family trivially passes — everything is replicated)."""
    from repro_torch.core.trace import trace, trace_sharded
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.parallel.sharding import P
    from repro_torch.tree import tree_map
    from repro_torch.verify.scenarios import get_arch_config
    from repro_torch.verify.scenarios.harness import (
        batch_avals,
        flat_spec_leaves,
        model_pair,
        round_layers,
        verify_pspecs,
    )
    from repro_torch.verify.scenarios.tp import _with_rank

    if tp < 1:
        raise PlanError(f"tp must be a positive int, got {tp!r}")
    if sp and tp == 1:
        raise PlanError("sp shards activations over the tp axis: need tp > 1")
    cfg = round_layers(get_arch_config(arch, smoke=smoke), layers)
    t0 = time.perf_counter()
    b, seq = batch_avals(cfg, batch, seq)

    if tp == 1:
        model, _, param_shapes = model_pair(cfg, ParallelCtx.single())
        g, in_ids, _ = trace(
            lambda p, bb: model.forward(p, bb, unroll=True),
            param_shapes, b, name=f"{arch}-lint")
        return LintUnit(
            graph=g, size=1,
            input_placements={i: REP for i in in_ids},
            output_placements=["dup"] * len(g.outputs),
            arch=arch, trace_s=time.perf_counter() - t0)

    pctx = ParallelCtx.tensor_parallel(tp, axis=TP_AXIS, sp=sp)
    _, model_d, param_shapes = model_pair(cfg, pctx)
    pspecs = verify_pspecs(param_shapes)
    bspecs = tree_map(lambda _: P(), b)

    def dist_fn(c, p, bb):
        return _with_rank(model_d, c.rank).forward(p, bb, unroll=True)

    g, in_ids, _ = trace_sharded(
        dist_fn, tp, (pspecs, bspecs), param_shapes, b, axis=TP_AXIS,
        name=f"{arch}-lint-tp{tp}{':sp' if sp else ''}")
    return LintUnit(
        graph=g, size=tp,
        input_placements=placements_from_specs(
            flat_spec_leaves((pspecs, bspecs)), in_ids, TP_AXIS),
        output_placements=[("shard", 2)] * len(g.outputs),
        arch=arch, trace_s=time.perf_counter() - t0)


def pair_lint_unit(pair, arch: str = "") -> LintUnit:
    """A :class:`LintUnit` over the *distributed* half of a traced
    :class:`~repro_torch.verify.scenarios.harness.GraphPair` (the Session's
    lint preflight): leaf placements come from the pair's registered input
    facts, output expectations straight from its ``output_specs``."""
    placements = {}
    for f in pair.input_facts:
        nid = pair.dist_inputs[f.dist_index]
        placements[nid] = REP if f.kind == "dup" else _shard_state(f.dim)
    return LintUnit(
        graph=pair.dist, size=pair.size, axis=pair.axis,
        mesh_axes=tuple(getattr(pair, "mesh_axes", ()) or (pair.axis,)),
        input_placements=placements,
        output_placements=list(pair.output_specs),
        arch=arch)


def unit_context(unit: LintUnit):
    """The :class:`~repro_torch.analysis.registry.LintContext` for one unit."""
    from .registry import LintContext

    return LintContext(
        graph=unit.graph, size=unit.size, axis=unit.axis,
        mesh_axes=unit.mesh_axes,
        input_placements=unit.input_placements,
        output_placements=unit.output_placements,
        arch=unit.arch)
