"""Trainer: the per-rank train step (loss -> grads -> DP reduction ->
AdamW/ZeRO-1 update) with microbatched gradient accumulation, remat, and
optional gradient compression.

The step is the JAX package's per-device step: run it on one device with a
single ``ParallelCtx``, or on each gloo rank of a mesh with that rank's
context (``parallel/spmd.train_step``, ``launch/train.py``), as JAX wraps
it in ``shard_map``.  Gradients come from ``torch.autograd.grad`` on
detached copies of the parameters that require grad, so every leaf gets a
gradient (zeros for a leaf the loss does not reach, as ``jax.grad`` gives).
The model must be ``impl="reference"``: the kernels have no backward and
refuse autograd (``kernels/ops.py``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models import Model
from repro_torch.scope import loop
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

from .compression import allreduce_compressed
from .optimizer import AdamWConfig, adamw_update, zero1_update


@dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    microbatches: int = 1
    remat: bool = True
    zero1: bool = False
    grad_compress: str = "none"  # none | bf16 | int8


def _split_micro(batch, n: int):
    return tree_map(lambda x: x.reshape(n, x.shape[0] // n, *x.shape[1:]), batch)


def value_and_grad(fn, params):
    """``fn(params)`` (a scalar) and its gradient with respect to every leaf
    of ``params``, through ``torch.autograd.grad`` on detached copies that
    require grad: ``jax.value_and_grad``, zeros for a leaf ``fn`` does not
    reach."""
    leaves, treedef = tree_flatten(params)
    tracked = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        out = fn(tree_unflatten(treedef, tracked))
        grads = torch.autograd.grad(out, tracked, allow_unused=True,
                                    materialize_grads=True)
    return out.detach(), tree_unflatten(treedef, list(grads))


def _value_and_grad(model: Model, tcfg: TrainConfig, params, batch):
    return value_and_grad(lambda p: model.loss(p, batch, remat=tcfg.remat), params)


def local_grads(model: Model, tcfg: TrainConfig, params, batch):
    """Per-rank loss + grads with microbatch accumulation (no DP
    reduction): the microbatches' gradients summed in a Python loop (JAX's
    ``lax.scan``) and scaled by ``1 / microbatches``."""
    if tcfg.microbatches <= 1:
        return _value_and_grad(model, tcfg, params, batch)
    micro = _split_micro(batch, tcfg.microbatches)
    loss_sum, gsum = None, None
    for i in loop(tcfg.microbatches, "micro"):
        loss, g = _value_and_grad(model, tcfg, params, tree_map(lambda x: x[i], micro))
        if gsum is None:
            loss_sum, gsum = loss, g
        else:
            loss_sum = loss_sum + loss
            acc, treedef = tree_flatten(gsum)
            gsum = tree_unflatten(treedef, [a + b for a, b in zip(acc, tree_flatten(g)[0])])
    inv = 1.0 / tcfg.microbatches
    return loss_sum * inv, tree_map(lambda g: g * inv, gsum)


def make_step_fn(model: Model, tcfg: TrainConfig, shard_flags=None):
    """The per-rank train step.

    signature: (params, opt_state, batch) -> (params, opt_state, metrics);
    params and the optimizer state are updated in place (and returned)."""
    grads_fn, update_fn = step_phases(model, tcfg, shard_flags)

    def step(params, opt_state, batch):
        loss, grads = grads_fn(params, batch)
        return update_fn(params, grads, opt_state, loss)

    return step


def step_phases(model: Model, tcfg: TrainConfig, shard_flags=None):
    """The train step's two phases: ``grads_fn(params, batch) -> (loss,
    grads)``, the loss averaged and the gradients reduced over the data axes
    as the update takes them, then ``update_fn(params, grads, opt_state,
    loss) -> (params, opt_state, metrics)``, AdamW or ZeRO-1 in place.  (A
    dry run traces the first with autograd and the second functionalized.)"""
    ctx = model.ctx
    zero1 = tcfg.zero1 and ctx.dp_axis
    axes = ctx.dp_axis if isinstance(ctx.dp_axis, tuple) else (ctx.dp_axis,)
    sizes = ctx.dp_axis_sizes or (ctx.dp_size,)

    def grads_fn(params, batch):
        loss, grads = local_grads(model, tcfg, params, batch)
        if ctx.dp_axis:
            loss = ctx.pmean_dp(loss)
        if zero1:
            for a in axes[:-1]:
                grads = tree_map(lambda g: ctx.psum(g, a), grads)
        elif ctx.dp_axis:
            grads = allreduce_compressed(grads, tcfg.grad_compress, ctx.dp_axis, ctx)
            grads = tree_map(lambda g: g / ctx.dp_size, grads)
        return loss, grads

    def update_fn(params, grads, opt_state, loss):
        if zero1:
            new_p, new_s, info = zero1_update(tcfg.opt, params, grads, opt_state,
                                              axes[-1], sizes[-1], shard_flags, ctx=ctx)
        else:
            new_p, new_s, info = adamw_update(tcfg.opt, params, grads, opt_state)
        return new_p, new_s, {"loss": loss, **info}

    return grads_fn, update_fn
