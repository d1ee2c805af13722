"""Composite scenario: ``tpdp-forward``, the tp x dp 2-D program verified
along the data axis against the 1-D tensor-parallel per-rank program.

Per-axis scenarios (tp-forward, dp-forward) each compare against the
single-device baseline and never check the *interaction* of the two axes.
The composite closes that gap with a chain argument:

    single-device  ==  TP per-rank program      (tp-forward)
    TP per-rank    ==  tp x dp per-rank program (THIS scenario)

The 2-D per-rank program (weights sharded over "model", batch sharded over
"data", traced over a ``{"data": dp, "model": tp}`` mesh whose collectives
each carry the axis of their group) is verified with the TP program as its
*baseline*: weight shards are duplicates across data ranks, the batch input
is data-sharded, and the model-axis collectives appearing in BOTH graphs
discharge through the orthogonal-collective rule (a collective over another
mesh axis applies the same deterministic function at every data rank, so it
commutes with stacking over the verified axis).  ``Plan(tp=T, dp=D,
composite=True)`` expands to [tp-forward, tpdp-forward].
"""
from __future__ import annotations

import copy
import time

from repro_torch.core.trace import trace_sharded
from repro_torch.core.verifier import OutputSpec
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.sharding import P
from repro_torch.tree import tree_map

from ..plan import DP_AXIS, TP_AXIS, PlanError
from ..specs import spec_input_facts
from .harness import (
    BuildCtx,
    GraphPair,
    batch_avals,
    flat_spec_leaves,
    model_pair,
    verify_pspecs,
)
from .registry import DEFAULT_SCENARIOS as S
from .tp import _with_rank


def _with_ctx(model, ctx: ParallelCtx):
    """``model`` running under ``ctx`` (the tracer's mesh context)."""
    model = copy.copy(model)
    model.ctx = ctx
    return model


@S.scenario("tpdp-forward", DP_AXIS,
            doc="tp x dp composite forward: the 2D per-device program vs "
                "the 1D TP program (axis interaction)",
            requires="dense archs")
def tpdp_forward(arch: str, cfg, plan, scen, ctx: BuildCtx) -> GraphPair:
    dp, tp = scen.size, plan.tp
    batch = plan.scenario_batch(scen)
    if cfg.n_experts:
        raise PlanError(
            f"{arch}: dense-masked MoE gating scatters against local token "
            f"ids — composite plans for MoE archs are covered by numerical "
            f"tests")
    if batch % dp:
        raise PlanError(f"batch={batch} not divisible by dp={dp}")
    t0 = time.perf_counter()

    pctx = ParallelCtx.tensor_parallel(tp, axis=TP_AXIS)
    _, model_d, param_shapes = model_pair(cfg, pctx)  # baseline == TP program
    pspecs = verify_pspecs(param_shapes)
    b, _ = batch_avals(cfg, batch, plan.seq)

    # baseline: the 1-D TP per-rank program over the full batch, the same
    # trace (and tag) as tp-forward's distributed side, shared through the
    # session's base-trace cache when the shapes coincide
    bspecs_tp = tree_map(lambda _: P(), b)
    gb, b_in = ctx.trace_base_sharded(
        f"fwd:dense:dist:tp{tp}",
        lambda c, p, bb: _with_rank(model_d, c.rank).forward(p, bb), tp,
        (pspecs, bspecs_tp), param_shapes, b, name=f"{arch}-tp-base")

    # distributed: the 2-D (data, model) per-rank program, batch sharded
    bspecs_2d = tree_map(lambda _: P(DP_AXIS), b)
    gd, d_in, _ = trace_sharded(
        lambda c, p, bb: _with_ctx(model_d, c).forward(p, bb),
        {DP_AXIS: dp, TP_AXIS: tp}, (pspecs, bspecs_2d), param_shapes, b,
        name=f"{arch}-tpdp-dist")

    # relative to the data axis: per-shard weights are duplicates, the
    # batch input is sharded on dim 0 (model-axis sharding is invisible:
    # it is identical in both per-rank programs)
    return GraphPair(
        gb, gd, b_in, d_in,
        input_facts=spec_input_facts(flat_spec_leaves((pspecs, bspecs_2d)),
                                     axis=DP_AXIS),
        output_specs=[OutputSpec(kind="shard", dim=0)],
        size=dp, axis=DP_AXIS, mesh_axes=(DP_AXIS, TP_AXIS),
        trace_s=time.perf_counter() - t0, base_cached=ctx.base_cached)
