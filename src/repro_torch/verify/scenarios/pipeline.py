"""Pipeline scenario: each stage's TP parallelization verified in
isolation.  Stage boundaries are replicated hidden states, exactly what
``parallel/pipeline.py`` ships over its ring, so per-stage equivalence
composes to whole-pipeline equivalence."""
from __future__ import annotations

import time

from repro_torch.configs.base import ShapeDtype
from repro_torch.core.trace import trace_sharded
from repro_torch.core.verifier import OutputSpec
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.pipeline import stage_program
from repro_torch.parallel.sharding import P
from repro_torch.tree import tree_map

from ..plan import TP_AXIS, PlanError
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


def stage_bounds(arch: str, cfg, stg: int, stages: int) -> tuple[int, int]:
    """The layers ``[lo, hi)`` of stage ``stg``; a depth that does not
    divide into the stages is a ``PlanError``."""
    if cfg.n_layers % stages:
        raise PlanError(
            f"{arch}: n_layers={cfg.n_layers} not divisible by "
            f"stages={stages} (pass layers=... to round)")
    per_stage = cfg.n_layers // stages
    return stg * per_stage, (stg + 1) * per_stage


def stage_pair(arch: str, cfg, tp: int, stg: int, stages: int,
               batch: int, seq: int, ctx: BuildCtx = None) -> GraphPair:
    """Pipeline stage ``stg`` of ``stages``: the stage's layer slice (plus
    embedding frontend on stage 0 and final norm + head on the last stage)
    with TP sharding inside the stage."""
    ctx = ctx if ctx is not None else BuildCtx()
    lo, hi = stage_bounds(arch, cfg, stg, stages)
    first, last = stg == 0, stg == stages - 1

    t0 = time.perf_counter()
    pctx = ParallelCtx.tensor_parallel(tp, axis=TP_AXIS)
    model_s, model_d, param_shapes = model_pair(cfg, pctx)
    pspecs = verify_pspecs(param_shapes)
    b, seq = batch_avals(cfg, batch, seq)

    if first:
        x_shape = b
        xspec = tree_map(lambda _: P(), b)
    else:
        x_shape = ShapeDtype((batch, seq, cfg.d_model), model_s.dtype)
        xspec = P()

    def dist_fn(c, p, x):
        return stage_program(_with_rank(model_d, c.rank), lo, hi, first=first,
                             last=last)(p, x)

    gb, b_in = ctx.trace_base(f"stage{stg}:{stages}",
                              stage_program(model_s, lo, hi, first=first, last=last),
                              param_shapes, x_shape, name=f"{arch}-stage{stg}-base")
    gd, d_in, _ = trace_sharded(dist_fn, tp, (pspecs, xspec), param_shapes, x_shape,
                                axis=TP_AXIS, name=f"{arch}-stage{stg}-dist")
    return GraphPair(
        gb, gd, b_in, d_in,
        input_facts=spec_input_facts(flat_spec_leaves((pspecs, xspec)),
                                     axis=TP_AXIS),
        output_specs=[OutputSpec(kind="shard", dim=2) if last
                      else OutputSpec(kind="dup")],
        size=tp, axis=TP_AXIS,
        trace_s=time.perf_counter() - t0, base_cached=ctx.base_cached)


@S.scenario("stage", TP_AXIS,
            doc="one pipeline stage in isolation (TP inside the stage)")
def stage(arch: str, cfg, plan, scen, ctx: BuildCtx) -> GraphPair:
    return stage_pair(arch, cfg, scen.size, scen.stage, plan.stages,
                      plan.scenario_batch(scen), plan.seq, ctx=ctx)
