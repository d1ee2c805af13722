"""Tensor-parallel scenario ``tp-forward``: Megatron column/row TP with a
vocab-parallel embedding and head, the paper's own case.

Layers run under ``layer<i>`` scopes (per-layer memoization) and deep models
are layer-stamped.  The serving step (``tp-decode``) is not ported yet.
"""
from __future__ import annotations

import copy

from repro_torch.core.verifier import OutputSpec
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.sharding import P, param_specs
from repro_torch.tree import tree_map

from ..plan import TP_AXIS
from ..specs import spec_input_facts
from .harness import (
    BuildCtx,
    GraphPair,
    batch_avals,
    flat_spec_leaves,
    model_pair,
    stamped_or_full,
)
from .registry import DEFAULT_SCENARIOS as S


def _tp_forward_parts(arch: str, cfg, tp: int, batch: int, seq: int,
                      ctx: BuildCtx):
    """Trace the (baseline, per-rank) TP forward pair for ``cfg``."""
    pctx = ParallelCtx.tensor_parallel(tp, axis=TP_AXIS)
    model_s, model_d, param_shapes = model_pair(cfg, pctx)
    pspecs = param_specs(param_shapes)
    b, seq = batch_avals(cfg, batch, seq)
    bspecs = tree_map(lambda _: P(), b)

    def dist_fn(c, p, bb):
        model = copy.copy(model_d)
        model.ctx = pctx.with_rank(c.rank)
        return model.forward(p, bb)

    gb, b_in = ctx.trace_base("fwd:dense", lambda p, bb: model_s.forward(p, bb),
                              param_shapes, b, name=f"{arch}-base")
    gd, d_in = ctx.trace_base_sharded(
        f"fwd:dense:dist:tp{tp}", dist_fn, tp,
        (pspecs, bspecs), param_shapes, b, name=f"{arch}-dist")
    return gb, b_in, gd, d_in, flat_spec_leaves((pspecs, bspecs))


def tp_forward_pair(arch: str, cfg, tp: int, batch: int, seq: int,
                    stamp: bool = True, ctx: BuildCtx = None) -> GraphPair:
    ctx = ctx if ctx is not None else BuildCtx(stamp=stamp)
    pair_fn = lambda c: _tp_forward_parts(arch, c, tp, batch, seq, ctx)  # noqa: E731
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


@S.scenario("tp-forward", TP_AXIS,
            doc="baseline forward vs TP-sharded per-rank forward")
def tp_forward(arch: str, cfg, plan, scen, ctx: BuildCtx) -> GraphPair:
    return tp_forward_pair(arch, cfg, scen.size, plan.scenario_batch(scen),
                           plan.seq, ctx=ctx)
