"""AdamW with warmup-cosine schedule, gradient clipping, and optional ZeRO-1
optimizer-state sharding over the data axis, the JAX package's arithmetic
in f32 and in its order of operations.

Parameters and optimizer state are dict pytrees of plain tensors, laid out
as the JAX package lays them out.  Unlike JAX's functional update, the port
updates every leaf **in place** (params, ``m`` and ``v``) and returns the
same tensors: a qwen3_4b update would otherwise hold a new copy of every
leaf, and JAX's chain of f32 temporaries (about 29 GB for its (36, 2560,
9728) MLP stack alone).  A leaf is updated in slices of its leading dim, so
the f32 temporaries are a few slices' worth.

ZeRO-1: optimizer moments are sharded over dp; each rank updates its shard
of the parameter and the updated shard is re-gathered (``zero1_update``,
with the collectives of a ``ParallelCtx``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.modules import dynamic_slice_in_dim
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

# the most elements of one leaf updated at once (f32 temporaries of 128 MiB)
_SLICE_ELEMS = 1 << 25


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_schedule(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (an int or a 0-d tensor): f32, on the
    step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.minimum(step / max(cfg.warmup_steps, 1), torch.ones_like(step))
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def adamw_init(params) -> dict:
    """Zero f32 moments shaped as ``params``, and step 0 (int32), on the
    params' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_flatten(params)[0][0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _slices(t: torch.Tensor):
    """Views of ``t`` along its leading dim, each of at most
    ``_SLICE_ELEMS`` elements (``t`` itself when it is that small)."""
    if t.ndim == 0 or t.numel() <= _SLICE_ELEMS:
        return [t]
    rows = max(1, _SLICE_ELEMS // max(1, t[0].numel()))
    return list(torch.split(t, rows))


def _sq_sum(t: torch.Tensor) -> torch.Tensor:
    """sum(square(t in f32)), a slice at a time."""
    return sum(torch.sum(torch.square(s.float())) for s in _slices(t))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(_sq_sum(leaf) for leaf in tree_flatten(tree)[0]))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state):
    """One AdamW step, in place.  Grads are assumed already averaged across
    DP.  Returns (params, state, {"grad_norm", "lr"}) with the same leaf
    tensors as given, updated.

    Fault tolerance: a non-finite gradient norm (overflow/NaN from a bad
    batch or a flipped bit) leaves params, ``m`` and ``v`` as they were,
    and ``step`` still increments: the standard skip-step guard.  It is
    selected on the device, with no host sync: a skipped step's gradient
    is zeroed (``nan_to_num`` after a zero scale) and its coefficients are
    those of the identity (``m * 1 + 0``, ``p - 0 * delta``).  (JAX's
    per-element mask of non-finite gradients is an identity whenever the
    norm is finite, so it is not applied.)"""
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    gnorm = global_norm(grads)
    ok = torch.isfinite(gnorm)
    scale = torch.minimum(torch.ones_like(gnorm),
                          cfg.grad_clip / torch.maximum(gnorm, torch.full_like(gnorm, 1e-12)))
    scale = torch.where(ok, scale, 0.0)
    b1, b2 = cfg.b1, cfg.b2
    corr1 = 1 - b1 ** step.float()
    corr2 = 1 - b2 ** step.float()
    c1, a1 = torch.where(ok, b1, 1.0), torch.where(ok, 1 - b1, 0.0)
    c2, a2 = torch.where(ok, b2, 1.0), torch.where(ok, 1 - b2, 0.0)
    step_lr = torch.where(ok, lr, 0.0)
    leaves = zip(*(tree_flatten(t)[0] for t in (params, grads, state["m"], state["v"])))
    for p, g, m, v in leaves:
        for ps, gs, ms, vs in zip(*map(_slices, (p, g, m, v))):
            gs = (gs.float() * scale).nan_to_num_()
            ms.mul_(c1).add_(a1 * gs)
            vs.mul_(c2).add_(a2 * gs * gs)
            delta = (ms / corr1) / (torch.sqrt(vs / corr2) + cfg.eps)
            p32 = ps.float()
            delta += cfg.weight_decay * p32
            ps.copy_(p32 - step_lr * delta)
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# ZeRO-1: shard optimizer moments (and the f32 update math) over dp


def _shardable(shape, dp: int) -> bool:
    return len(shape) > 0 and shape[0] % dp == 0


def zero1_init(params, dp: int, shard_flags=None) -> dict:
    """Optimizer moments holding only this rank's 1/dp slice: of the leading
    dim (where it divides, as in JAX), or of each leaf's ``shard_flags``
    dim (-1 = replicated)."""
    leaves, treedef = tree_flatten(params)
    if shard_flags is None:
        dims = [0 if _shardable(p.shape, dp) else -1 for p in leaves]
    else:
        dims = tree_flatten(shard_flags)[0]

    def zeros():
        out = []
        for p, d in zip(leaves, dims):
            shape = list(p.shape)
            if d >= 0:
                shape[d] //= dp
            out.append(torch.zeros(shape, dtype=torch.float32, device=p.device))
        return tree_unflatten(treedef, out)

    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=leaves[0].device)}


def zero1_shard_dim(shape, dp: int, blocked_dims=()) -> int:
    """First dim divisible by dp (excluding blocked dims), or -1."""
    for i, s in enumerate(shape):
        if i not in blocked_dims and s % dp == 0 and s >= dp:
            return i
    return -1


def zero1_shard_flags(params, dp: int):
    """Per-leaf shard dim for ZeRO-1 moments (pytree of int; -1 = replicated)."""
    return tree_map(lambda p: zero1_shard_dim(p.shape, dp), params)


@torch.no_grad()
def zero1_update(cfg: AdamWConfig, params, grads, state, dp_axis: str, dp: int,
                 shard_flags=None, *, ctx):
    """ZeRO-1 step over ``ctx``'s ``dp_axis``: psum_scatter the grads, update
    the local parameter shard, all_gather the updated shards into the
    params (in place).  ``shard_flags`` is a pytree of shard dims per leaf
    (-1 = replicated moments).  As in JAX, a non-finite norm zeroes the
    gradient's scale (the moments still decay and weight decay applies)."""
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    corr1 = 1 - b1 ** step.float()
    corr2 = 1 - b2 ** step.float()

    flat_p, treedef = tree_flatten(params)
    flat_g = tree_flatten(grads)[0]
    flat_m = tree_flatten(state["m"])[0]
    flat_v = tree_flatten(state["v"])[0]
    if shard_flags is None:
        flat_dims = [zero1_shard_dim(p.shape, dp) for p in flat_p]
    else:
        flat_dims = [(0 if f is True else -1 if f is False else int(f))
                     for f in tree_flatten(shard_flags)[0]]

    # pass 1: average + shard the grads (reduce_scatter replaces all_reduce)
    gsh_all = []
    for g, dim in zip(flat_g, flat_dims):
        g32 = g.float()
        if dim >= 0:
            gsh = ctx.psum_scatter(g32, dp_axis, dim) / dp
        else:
            gsh = ctx.psum(g32, dp_axis) / dp
        gsh_all.append(gsh)

    # global grad norm from the scattered shards (replicated leaves counted once)
    local_sq = sum(torch.sum(torch.square(g)) if dim >= 0 else torch.sum(torch.square(g)) / dp
                   for g, dim in zip(gsh_all, flat_dims))
    gnorm = torch.sqrt(ctx.psum(local_sq, dp_axis))
    scale = torch.minimum(torch.ones_like(gnorm),
                          cfg.grad_clip / torch.maximum(gnorm, torch.full_like(gnorm, 1e-12)))
    scale = torch.where(torch.isfinite(gnorm), scale, 0.0)  # skip-step guard

    # pass 2: AdamW on the local shard, then re-gather parameters
    for p, gsh, m, v, dim in zip(flat_p, gsh_all, flat_m, flat_v, flat_dims):
        if dim >= 0:
            chunk = p.shape[dim] // dp
            psh = dynamic_slice_in_dim(p, ctx.axis_index(dp_axis) * chunk, chunk,
                                       dim).float()
        else:
            psh = p.float()
        g = gsh * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / corr1) / (torch.sqrt(v / corr2) + cfg.eps) + cfg.weight_decay * psh
        new_psh = (psh - lr * delta).to(p.dtype)
        p.copy_(ctx.all_gather(new_psh, dp_axis, dim) if dim >= 0 else new_psh)

    new_state = {"m": state["m"], "v": state["v"], "step": step}
    return tree_unflatten(treedef, flat_p), new_state, {"grad_norm": gnorm, "lr": lr}
