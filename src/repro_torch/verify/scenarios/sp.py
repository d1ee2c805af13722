"""Sequence-parallel scenario: ``sp-forward``.

Under sequence parallelism the row-parallel psum around each norm region is
replaced by a reduce_scatter along the sequence dim (``ParallelCtx.sp_enter``)
and the entry of each column-parallel region gathers it back
(``sp_exit``) — activations between regions are sequence-sharded, cutting
activation memory and collective volume by ``1/tp``.  The scenario proves
the reduce_scatter/all_gather formulation equivalent to the single-device
baseline: partial sums become shard facts through the reduce_scatter rule,
seq-axis all_gathers discharge them back to duplicates, and the
sequence-parallel vocab embedding verifies through the ``vp_embed_sp``
trusted template + the same reduce_scatter rule.
"""
from __future__ import annotations

from repro_torch.core.verifier import OutputSpec

from ..plan import TP_AXIS, PlanError
from ..specs import spec_input_facts
from .harness import BuildCtx, GraphPair, stamped_or_full
from .registry import DEFAULT_SCENARIOS as S
from .tp import _tp_forward_parts


@S.scenario("sp-forward", TP_AXIS,
            doc="sequence-parallel forward (reduce_scatter/all_gather "
                "around norm regions vs psum baseline)")
def sp_forward(arch: str, cfg, plan, scen, ctx: BuildCtx) -> GraphPair:
    tp, batch = scen.size, plan.scenario_batch(scen)
    # validate against the seq actually traced: vision frontends grow it
    # (batch_avals) and the grown length is what gets sequence-sharded
    seq = (max(plan.seq, cfg.frontend_len + 32)
           if cfg.frontend == "vision_patches" else plan.seq)
    if seq % tp:
        raise PlanError(
            f"sp-forward shards the sequence: seq={seq} not divisible "
            f"by tp={tp}")
    pair_fn = lambda c: _tp_forward_parts(arch, c, tp, batch, plan.seq, ctx,
                                          sp=True)
    parts, trace_s, stamp_s, stamped = stamped_or_full(
        cfg, pair_fn, cfg.block_period, ctx.stamp)
    gb, b_in, gd, d_in, flat_specs = parts
    return GraphPair(
        gb, gd, b_in, d_in,
        input_facts=spec_input_facts(flat_specs, axis=TP_AXIS),
        output_specs=[OutputSpec(kind="shard", dim=2)],
        size=tp, axis=TP_AXIS,
        trace_s=trace_s, stamp_s=stamp_s, stamped=stamped,
        base_cached=ctx.base_cached)
