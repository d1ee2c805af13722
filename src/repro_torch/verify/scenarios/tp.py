"""Tensor-parallel scenarios: ``tp-forward`` (Megatron column/row TP with a
vocab-parallel embedding and head) and ``tp-decode`` (one serving step
against head-sharded KV/SSM caches — the paper's own inference-graph
setting).

Layers run under ``layer<i>`` scopes (per-layer memoization) and deep models
are layer-stamped.  MoE layers trace the dense-masked formulation
(``moe_dense_fwd``) with the expert stacks sharded over their FFN width
(``verify_pspecs``), as in the JAX package.  The decode step is the one
the serving engine runs: it writes its caches in place and is traced
functionalized, so the written caches are outputs of the trace.
"""
from __future__ import annotations

import copy

import torch

from repro_torch.core.trace import ShapeDtype
from repro_torch.core.verifier import OutputSpec
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.sharding import P, cache_specs
from repro_torch.tree import tree_map

from ..plan import TP_AXIS, PlanError
from ..specs import spec_input_facts, spec_output_specs
from .harness import (
    BuildCtx,
    GraphPair,
    batch_avals,
    cache_shapes,
    flat_spec_leaves,
    model_pair,
    stamped_or_full,
    verify_pspecs,
)
from .registry import DEFAULT_SCENARIOS as S


def _with_rank(model, rank):
    """``model`` with its context holding the traced rank."""
    model = copy.copy(model)
    model.ctx = model.ctx.with_rank(rank)
    return model


def _tp_forward_parts(arch: str, cfg, tp: int, batch: int, seq: int,
                      ctx: BuildCtx, sp: bool = False):
    """Trace the (baseline, per-rank) TP forward pair for ``cfg``."""
    pctx = ParallelCtx.tensor_parallel(tp, axis=TP_AXIS, sp=sp)
    model_s, model_d, param_shapes = model_pair(cfg, pctx)
    pspecs = verify_pspecs(param_shapes)
    b, seq = batch_avals(cfg, batch, seq)
    bspecs = tree_map(lambda _: P(), b)

    def dist_fn(c, p, bb):
        return _with_rank(model_d, c.rank).forward(p, bb)

    gb, b_in = ctx.trace_base("fwd:dense", lambda p, bb: model_s.forward(p, bb),
                              param_shapes, b, name=f"{arch}-base")
    gd, d_in = ctx.trace_base_sharded(
        f"fwd:dense:dist:tp{tp}{':sp' if sp else ''}", dist_fn, tp,
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


def _tp_decode_parts(arch: str, cfg, tp: int, batch: int, max_len: int,
                     ctx: BuildCtx):
    """Trace the (baseline, per-rank) decode-step pair for ``cfg``."""
    pctx = ParallelCtx.tensor_parallel(tp, axis=TP_AXIS)
    model_s, model_d, param_shapes = model_pair(cfg, pctx)
    pspecs = verify_pspecs(param_shapes)
    caches = cache_shapes(model_s, batch, max_len)
    cspecs = cache_specs(caches)
    tok = ShapeDtype((batch,), torch.int64)
    pos = ShapeDtype((), torch.int64)

    def dist_fn(c, p, t, cc, q):
        return _with_rank(model_d, c.rank).decode_step(p, t, cc, q)

    in_specs = (pspecs, P(), cspecs, P())
    gb, b_in = ctx.trace_base("decode", model_s.decode_step, param_shapes, tok,
                              caches, pos, name=f"{arch}-decode-base")
    gd, d_in = ctx.trace_base_sharded(
        f"decode:dist:tp{tp}", dist_fn, tp, in_specs, param_shapes, tok, caches,
        pos, name=f"{arch}-decode-dist")
    flat_specs = flat_spec_leaves(in_specs)
    return gb, b_in, gd, d_in, (flat_specs, cspecs)


def tp_decode_pair(arch: str, cfg, tp: int, batch: int, max_len: int,
                   stamp: bool = True, ctx: BuildCtx = None) -> GraphPair:
    """The paper's own setting (inference graphs): one token against KV/SSM
    caches sharded over heads, vocab-parallel head output."""
    if cfg.encoder_only:
        raise PlanError(f"{arch} is encoder-only: no decode step")
    ctx = ctx if ctx is not None else BuildCtx(stamp=stamp)
    # one decode period = one outer block scope (P sub-layers)
    pair_fn = lambda c: _tp_decode_parts(arch, c, tp, batch, max_len, ctx)  # noqa: E731
    parts, trace_s, stamp_s, stamped = stamped_or_full(cfg, pair_fn, 1, ctx.stamp)
    gb, b_in, gd, d_in, (flat_specs, cspecs) = parts

    # outputs: logits sharded over vocab (dim 1) + every cache leaf sharded
    # on its head dim (matching the input cache specs)
    out_specs = ([OutputSpec(kind="shard", dim=1)]
                 + spec_output_specs(flat_spec_leaves(cspecs), axis=TP_AXIS))
    return GraphPair(
        gb, gd, b_in, d_in,
        input_facts=spec_input_facts(flat_specs, axis=TP_AXIS),
        output_specs=out_specs,
        size=tp, axis=TP_AXIS,
        trace_s=trace_s, stamp_s=stamp_s, stamped=stamped,
        base_cached=ctx.base_cached)


@S.scenario("tp-decode", TP_AXIS,
            doc="one serving step against head-sharded KV/SSM caches")
def tp_decode(arch: str, cfg, plan, scen, ctx: BuildCtx) -> GraphPair:
    return tp_decode_pair(arch, cfg, scen.size, plan.scenario_batch(scen),
                          plan.max_len, ctx=ctx)
