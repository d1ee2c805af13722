"""Data-parallel scenarios: ``dp-forward`` (batch-sharded forward — catches
improper cross-batch interaction) and ``dp-grad`` (the DP gradient-sync
contract: per-device sum-loss gradients + psum == full-batch gradients).

DP scenarios skip MoE archs: the dense-masked gating scatters against
*local* token ids (data-dependent indexing outside the relational
language); those paths are covered by numerical equivalence tests.

The dp-grad pair is traced through ``torch.autograd`` (the tracer's
gradient path), and its per-rank side is ``parallel/spmd.dp_grad``, the
program the card runs.
"""
from __future__ import annotations

import time

from repro_torch.core.verifier import OutputSpec
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.sharding import P
from repro_torch.parallel.spmd import dp_grad as dp_grad_program
from repro_torch.parallel.spmd import sum_grads
from repro_torch.tree import tree_leaves, tree_map

from ..plan import DP_AXIS, PlanError
from ..specs import spec_input_facts
from .harness import (
    BuildCtx,
    GraphPair,
    batch_avals,
    flat_spec_leaves,
    model_pair,
)
from .registry import DEFAULT_SCENARIOS as S


def _dp_setup(arch: str, cfg, dp: int, batch: int, seq: int):
    if cfg.n_experts:
        raise PlanError(
            f"{arch}: dense-masked MoE gating scatters against local token "
            f"ids — DP plans for MoE archs are covered by numerical tests")
    if batch % dp:
        raise PlanError(f"batch={batch} not divisible by dp={dp}")
    pctx = ParallelCtx(dp_axis=(DP_AXIS,), dp_size=dp)
    model_s, model_d, param_shapes = model_pair(cfg, pctx)
    pspecs = tree_map(lambda _: P(), param_shapes)
    b, seq = batch_avals(cfg, batch, seq)
    bspecs = tree_map(lambda _: P(DP_AXIS), b)
    return model_s, model_d, param_shapes, pspecs, b, bspecs


def dp_forward_pair(arch: str, cfg, dp: int, batch: int, seq: int,
                    ctx: BuildCtx = None) -> GraphPair:
    """Batch-sharded forward equivalence over the data axis: params
    replicated, inputs sharded on dim 0, logits sharded on dim 0 — proves
    the model has no improper cross-batch interaction under DP."""
    ctx = ctx if ctx is not None else BuildCtx()
    t0 = time.perf_counter()
    model_s, model_d, param_shapes, pspecs, b, bspecs = _dp_setup(
        arch, cfg, dp, batch, seq)

    gb, b_in = ctx.trace_base("fwd:dense", lambda p, bb: model_s.forward(p, bb),
                              param_shapes, b, name=f"{arch}-dp-base")
    gd, d_in = ctx.trace_base_sharded(
        f"fwd:dense:dist:dp{dp}", lambda c, p, bb: model_d.forward(p, bb), dp,
        (pspecs, bspecs), param_shapes, b, axis=DP_AXIS, name=f"{arch}-dp-dist")
    return GraphPair(
        gb, gd, b_in, d_in,
        input_facts=spec_input_facts(flat_spec_leaves((pspecs, bspecs)),
                                     axis=DP_AXIS),
        output_specs=[OutputSpec(kind="shard", dim=0)],
        size=dp, axis=DP_AXIS,
        trace_s=time.perf_counter() - t0, base_cached=ctx.base_cached)


@S.scenario("dp-forward", DP_AXIS,
            doc="batch-sharded forward (catches cross-batch interaction)",
            requires="dense archs")
def dp_forward(arch: str, cfg, plan, scen, ctx: BuildCtx) -> GraphPair:
    return dp_forward_pair(arch, cfg, scen.size, plan.scenario_batch(scen),
                           plan.seq, ctx=ctx)


def dp_grad_pair(arch: str, cfg, dp: int, batch: int, seq: int,
                 ctx: BuildCtx = None) -> GraphPair:
    """The DP gradient-sync contract: per-device gradients of the local
    sum-loss, all-reduced over the data axis, must equal the full-batch
    gradients.  Sum-loss (not mean) keeps both sides free of batch-size
    constants — the mean/`1/dp` rescaling is pure scalar algebra applied
    identically by the trainer on both sides."""
    ctx = ctx if ctx is not None else BuildCtx()
    t0 = time.perf_counter()
    model_s, model_d, param_shapes, pspecs, b, bspecs = _dp_setup(
        arch, cfg, dp, batch, seq)

    gb, b_in = ctx.trace_base("grad", lambda p, bb: sum_grads(model_s, p, bb),
                              param_shapes, b, name=f"{arch}-grad-base", grad=True)
    gd, d_in = ctx.trace_base_sharded(
        f"grad:dist:dp{dp}", lambda c, p, bb: dp_grad_program(model_d, p, bb), dp,
        (pspecs, bspecs), param_shapes, b, axis=DP_AXIS, name=f"{arch}-grad-dist",
        grad=True)
    n_out = len(tree_leaves(param_shapes))
    return GraphPair(
        gb, gd, b_in, d_in,
        input_facts=spec_input_facts(flat_spec_leaves((pspecs, bspecs)),
                                     axis=DP_AXIS),
        output_specs=[OutputSpec(kind="dup")] * n_out,
        size=dp, axis=DP_AXIS,
        trace_s=time.perf_counter() - t0, base_cached=ctx.base_cached)


@S.scenario("dp-grad", DP_AXIS,
            doc="per-device sum-loss gradients + psum vs full-batch grads",
            requires="dense archs")
def dp_grad(arch: str, cfg, plan, scen, ctx: BuildCtx) -> GraphPair:
    return dp_grad_pair(arch, cfg, scen.size, plan.scenario_batch(scen),
                        plan.seq, ctx=ctx)
