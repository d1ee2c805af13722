"""Expert-parallel scenario: ``ep-moe-forward``.

Experts are sharded over the mesh axis (the execution sharding from
``parallel/sharding.py``): each rank computes its local expert slice of the
dense-masked expert sum as an **unrolled slice/add loop** and one
all_reduce discharges the accumulation against the baseline's add-chain
over all experts: the paper's slice / loop_red_B / loop_red_D relation
family (Fig. 8), verified on whole MoE models (mixtral_8x7b/8x22b,
granite_moe_3b, moonshot_v1_16b, jamba_1_5_large).

The rank's slice of the dense routing mask (``dynamic_slice`` at
``axis_index * E_loc``) is discharged by the rank-indexed dynamic-slice
rule; non-expert parameters stay replicated so the scenario verifies the
expert axis in isolation (per-technique verification).  The per-rank
program runs with an expert axis and no tensor-parallel axis; its rank is
the traced input, as in ``tp-forward``.
"""
from __future__ import annotations

from repro_torch.core.verifier import OutputSpec
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.sharding import P
from repro_torch.tree import tree_map

from ..plan import TP_AXIS, PlanError
from ..specs import spec_input_facts
from .harness import (
    BuildCtx,
    GraphPair,
    batch_avals,
    ep_pspecs,
    flat_spec_leaves,
    model_pair,
    stamped_or_full,
)
from .registry import DEFAULT_SCENARIOS as S
from .tp import _with_rank


def _ep_forward_parts(arch: str, cfg, ep: int, batch: int, seq: int,
                      ctx: BuildCtx):
    pctx = ParallelCtx(ep_axis=TP_AXIS, ep_size=ep)
    model_s, model_d, param_shapes = model_pair(cfg, pctx, moe_impl="ep")
    pspecs = ep_pspecs(param_shapes, TP_AXIS)
    b, seq = batch_avals(cfg, batch, seq)
    bspecs = tree_map(lambda _: P(), b)

    def dist_fn(c, p, bb):
        return _with_rank(model_d, c.rank).forward(p, bb)

    gb, b_in = ctx.trace_base("fwd:ep", lambda p, bb: model_s.forward(p, bb),
                              param_shapes, b, name=f"{arch}-ep-base")
    gd, d_in = ctx.trace_base_sharded(
        f"fwd:ep:dist:ep{ep}", dist_fn, ep, (pspecs, bspecs), param_shapes, b,
        name=f"{arch}-ep-dist")
    return gb, b_in, gd, d_in, flat_spec_leaves((pspecs, bspecs))


@S.scenario("ep-moe-forward", TP_AXIS,
            doc="per-rank expert-slice accumulation + all_reduce vs the "
                "dense expert sum",
            requires="MoE archs")
def ep_moe_forward(arch: str, cfg, plan, scen, ctx: BuildCtx) -> GraphPair:
    ep, batch = scen.size, plan.scenario_batch(scen)
    if not cfg.n_experts:
        raise PlanError(
            f"{arch} has no experts: ep-moe-forward needs a MoE arch")
    if cfg.experts % ep:
        raise PlanError(
            f"{arch}: {cfg.experts} experts not divisible by ep={ep}")
    pair_fn = lambda c: _ep_forward_parts(arch, c, ep, batch, plan.seq, ctx)  # noqa: E731
    parts, trace_s, stamp_s, stamped = stamped_or_full(
        cfg, pair_fn, cfg.block_period, ctx.stamp)
    gb, b_in, gd, d_in, flat_specs = parts
    return GraphPair(
        gb, gd, b_in, d_in,
        input_facts=spec_input_facts(flat_specs, axis=TP_AXIS),
        output_specs=[OutputSpec(kind="dup")],
        size=ep, axis=TP_AXIS,
        trace_s=trace_s, stamp_s=stamp_s, stamped=stamped,
        base_cached=ctx.base_cached)
