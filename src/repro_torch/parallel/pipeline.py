"""GPipe-style pipeline parallelism over a mesh axis (``"pod"`` by default).

The layer stack splits into ``n_stages`` contiguous stages, one per
coordinate of the axis; microbatches stream through, each tick shipping
every stage's activation one stage to the right around a ring.  The
schedule is the JAX package's: ``n_micro + n_stages - 1`` ticks, tick ``t``
processing microbatch ``t - stage`` on each stage; idle ticks compute on
zeros and are masked out, so every rank runs the same program.  The ticks
are a Python loop (the JAX code's ``lax.scan``).

The ring shift (``lax.ppermute`` in the JAX package) is an all_to_all over
the axis' process group in which each rank sends its whole activation to
its right neighbour and receives its left neighbour's (what
``torch.distributed``'s ``permute_tensor`` does).  On a CUDA tensor it
travels through the host: the activation is copied to the CPU, shifted by
gloo's CPU all_to_all, and copied back, while each stage's compute stays on
the card (gloo's CUDA collectives stage through the host anyway, and its
CUDA all_gather did not finish in an earlier probe of the port).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.model import _tree_index
from repro_torch.models.modules import rmsnorm
from repro_torch.scope import named_scope


def ring_shift(x: torch.Tensor, group: str, n: int) -> torch.Tensor:
    """``x`` of the rank to the left along a ring of the ``n`` ranks of
    process group ``group``: an all_to_all in which each rank sends ``x``
    whole to the rank to its right."""
    import torch.distributed as dist

    c10d = torch.ops._c10d_functional
    me = dist.get_rank(dist.distributed_c10d._resolve_process_group(group))
    to, frm = (me + 1) % n, (me - 1) % n
    host = x.device.type != "cpu"
    flat = (x.cpu() if host else x).contiguous().reshape(1, -1)
    send = [int(j == to) for j in range(n)]
    recv = [int(j == frm) for j in range(n)]
    got = c10d.wait_tensor(c10d.all_to_all_single(flat, recv, send, group)).reshape(x.shape)
    return got.to(x.device) if host else got


def pipeline_forward(stage_fn: Callable, stage_params, x_micro: torch.Tensor, *,
                     axis: str = "pod", n_stages: int, ctx) -> torch.Tensor:
    """Run microbatches through the ring pipeline.

    stage_fn: (stage_params, x) -> y, this rank's stage (same shape out);
    stage_params: this rank's stage parameters;
    x_micro: (n_micro, mb, ...) microbatched inputs, held by every rank;
    stage 0 consumes them in order;
    ctx: a mesh ``ParallelCtx`` that holds ``axis`` (its group and this
    rank's coordinate along it, a 0-d tensor).
    Returns (n_micro, mb, ...), the last stage's outputs, summed over the
    axis with every other stage's masked to zero, so every rank holds
    them."""
    n_micro = x_micro.shape[0]
    stage = ctx.axis_index(axis)
    group = ctx.axis_group(axis)
    first, last = stage == 0, stage == n_stages - 1
    inflight = torch.zeros_like(x_micro[0])
    outputs = torch.zeros_like(x_micro)
    for t in range(n_micro + n_stages - 1):
        # stage 0 ingests microbatch t (the others what came from the left)
        inp = torch.where(first, x_micro[min(t, n_micro - 1)], inflight)
        act = stage_fn(stage_params, inp)
        # this tick, stage s processed microbatch t - s; kept if in range
        my_mb = t - stage
        valid = (my_mb >= 0) & (my_mb < n_micro)
        out_idx = my_mb.clamp(0, n_micro - 1)
        outputs[out_idx] = torch.where(valid & last, act, outputs[out_idx])
        inflight = ring_shift(act, group, n_stages)
    return ctx.psum(outputs * last.to(outputs.dtype), axis)


def stage_program(model, lo: int, hi: int, *, first: bool = False, last: bool = False,
                  first_block: int = 0) -> Callable:
    """``run(params, x_or_batch)``: layers ``lo..hi-1`` of ``model`` in
    ``layer<li>`` scopes (``li`` global), after the input frontend on the
    first stage, before ``sp_exit``, the final norm and the head on the
    last.  ``params["blocks"][j]`` holds layers ``j, j+P, ...`` (P the
    block period) from block ``first_block`` on: 0 for the whole stack, or
    ``lo // P`` where a rank keeps only its stage's layers."""
    cfg = model.cfg
    period = cfg.block_period

    def run(params, x_or_batch):
        x = model._inputs_to_hidden(params, x_or_batch) if first else x_or_batch
        positions = torch.arange(x.shape[1], device=x.device)
        for li in range(lo, hi):
            with named_scope(f"layer{li}"):
                lp = _tree_index(params["blocks"][li % period], li // period - first_block)
                x = model._layer_fwd(lp, x, positions, li % period)
        if last:
            x = model.ctx.sp_exit(x)
            x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
            return model._head(params, x)
        return x

    return run
