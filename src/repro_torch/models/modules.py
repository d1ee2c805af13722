"""Primitive modules (functional): init + apply pairs over plain dict params.

Initializers draw from an explicit ``torch.Generator`` on the device the
parameters live on.  Apply functions round where the JAX package rounds.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def einsum_f32(equation: str, a, b):
    """``jnp.einsum(equation, a, b, preferred_element_type=jnp.float32)``:
    the product of two operands of one type, accumulated and returned in
    float32 (the verifier's tracer lowers it to one such ``dot_general``)."""
    if torch.overrides.has_torch_function((a, b)):
        return torch.overrides.handle_torch_function(einsum_f32, (a, b), equation, a, b)
    return torch.einsum(equation, a.float(), b.float())


def silu(x):
    """``jax.nn.silu`` as the reference's serving step rounds it: ``x *
    logistic(x)``, with ``logistic`` as XLA expands it, ``1 / (1 +
    exp(-x))``, each step in x's dtype.  In its forward pass XLA fuses silu
    into the loops around it and rounds once, as ``F.silu`` does; in the
    decode step it does not, and ``F.silu`` there moved a bf16 hybrid's
    decode logits from the jitted JAX model by 4x JAX's own jit-against-eager
    spread (tests/ssm_bf16_tolerances.py).  The verifier's tracer records
    it as ``F.silu``, whose lowering is ``jax.nn.silu``'s: ``logistic`` and
    ``mul``."""
    if torch.overrides.has_torch_function((x,)):
        return torch.overrides.handle_torch_function(silu, (x,), x)
    return x * torch.reciprocal(1 + torch.exp(-x))


@torch.library.custom_op("repro_torch::dynamic_slice", mutates_args=())
def _dynamic_slice(x: torch.Tensor, start: torch.Tensor, axis: int,
                   size: int) -> torch.Tensor:
    """``lax.dynamic_slice_in_dim`` at a 0-d integer ``start`` on x's device:
    a negative start counts from the end once, then the start is clamped so
    the slice lies inside ``x``.  The indices are formed on the device, so
    the slice needs no host sync (``narrow`` would read ``start`` back)."""
    n = x.shape[axis]
    s = torch.where(start < 0, start + n, start).clamp(0, n - size)
    return x.index_select(axis, s + torch.arange(size, device=x.device))


@_dynamic_slice.register_fake
def _dynamic_slice_fake(x, start, axis, size):
    shape = list(x.shape)
    shape[axis] = size
    return x.new_empty(shape)


def _dynamic_slice_setup(ctx, inputs, output):
    x, start, axis, size = inputs
    ctx.save_for_backward(start)
    ctx.shape, ctx.axis = x.shape, axis


def _dynamic_slice_backward(ctx, g):
    """The slice's cotangent placed back at its (clamped) start."""
    (start,) = ctx.saved_tensors
    n, size = ctx.shape[ctx.axis], g.shape[ctx.axis]
    s = torch.where(start < 0, start + n, start).clamp(0, n - size)
    gx = g.new_zeros(ctx.shape)
    return gx.index_add(ctx.axis, s + torch.arange(size, device=g.device), g), None, None, None


_dynamic_slice.register_autograd(_dynamic_slice_backward, setup_context=_dynamic_slice_setup)


def _wrap_ids(ids, n: int):
    """A negative id counts from the end once; the mask of ids in range."""
    ids = torch.where(ids < 0, ids + n, ids)
    return ids, (ids >= 0) & (ids < n)


@torch.library.custom_op("repro_torch::take", mutates_args=())
def _take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)``: rows of ``table``, a negative id
    counting from the end once, an id out of range giving a row of NaN
    (the gather's fill)."""
    w, valid = _wrap_ids(ids, table.shape[0])
    x = table[w.clamp(0, table.shape[0] - 1)]
    return torch.where(valid[..., None], x, torch.full((), float("nan"), dtype=x.dtype,
                                                       device=x.device))


@_take.register_fake
def _take_fake(table, ids):
    return table.new_empty((*ids.shape, *table.shape[1:]))


@torch.library.custom_op("repro_torch::take_transpose", mutates_args=())
def _take_transpose(g: torch.Tensor, ids: torch.Tensor, rows: int) -> torch.Tensor:
    """The transpose of ``take``: ``zeros.at[ids].add(g)`` over a table of
    ``rows`` rows, an id out of range dropped (the scatter's drop: it adds
    into an extra row, cut off after, so no mask selects on the host)."""
    w, valid = _wrap_ids(ids, rows)
    tail = g.shape[ids.ndim:]
    out = g.new_zeros((rows + 1, *tail))
    out.index_add_(0, torch.where(valid, w, rows).reshape(-1), g.reshape(-1, *tail))
    return out[:rows].clone()


@_take_transpose.register_fake
def _take_transpose_fake(g, ids, rows):
    return g.new_empty((rows, *g.shape[ids.ndim:]))


def _take_setup(ctx, inputs, output):
    table, ids = inputs
    ctx.save_for_backward(ids)
    ctx.rows = table.shape[0]


def _take_backward(ctx, g):
    (ids,) = ctx.saved_tensors
    return _take_transpose(g, ids, ctx.rows), None


_take.register_autograd(_take_backward, setup_context=_take_setup)


def take(table, ids):
    """Row lookup with ``jnp.take``'s default semantics (the verifier's
    tracer lowers it, and its gradient, as JAX traces ``jnp.take`` and its
    transpose: one filling ``gather``, one dropping ``scatter_add``)."""
    return _take(table, ids)


def dynamic_slice_in_dim(x, start, size: int, axis: int):
    """``size`` entries of ``x`` along ``axis`` from the 0-d tensor ``start``
    (a traced rank under the verifier's tracer, which lowers this op as
    ``lax.dynamic_slice_in_dim`` traces)."""
    return _dynamic_slice(x, start, axis % x.ndim, size)


# A leaf whose f32 draw would pass this many bytes is drawn a block at a
# time along its leading (stacked) dim.  Block-wise Philox draws do not equal
# one whole draw, so the threshold sits above every leaf drawn whole today,
# whose values it keeps bit for bit: the largest is internvl2_26b's MLP
# stack, (48, 6144, 16384), 18 GiB in f32 (mixtral_8x7b's expert stack cut
# to 8 layers is 14 GiB).  moonshot_v1_16b's (48, 64, 2048, 1408) expert
# stacks (33 GiB in f32) pass it: drawn whole, one would not fit on an 80 GB
# card beside the bf16 weights already drawn.  (The largest stacks of
# llama3_70b, llama3_405b, mixtral_8x7b, mixtral_8x22b and jamba_1_5_large
# at full depth pass it too; their bf16 weights do not fit on the card.)
BLOCK_DRAW_BYTES = 24 * 2**30


def _draw(generator: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return x.mul_(scale).to(dtype)


def drawn_in_blocks(shape) -> bool:
    """Whether ``_init`` draws a leaf of ``shape`` a block at a time."""
    return len(shape) > 1 and math.prod(shape) * 4 > BLOCK_DRAW_BYTES


def _init(generator: torch.Generator, shape, scale: Optional[float] = None,
          dtype=torch.bfloat16):
    """N(0, scale^2) values drawn in f32, scaled in place (one f32 copy
    of the leaf at a time) and rounded to ``dtype``; past
    ``BLOCK_DRAW_BYTES``, one slice of the leading dim at a time, each
    drawn, scaled and rounded before the next is drawn."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0] if shape else 1)
    if not drawn_in_blocks(shape):
        return _draw(generator, shape, scale, dtype)
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    for i in range(shape[0]):
        out[i] = _draw(generator, shape[1:], scale, dtype)
    return out


def linear_init(generator, d_in: int, d_out: int, *, bias: bool = False,
                dtype=torch.bfloat16, stacked: tuple = ()):
    p = {"w": _init(generator, (*stacked, d_in, d_out), 1.0 / math.sqrt(d_in), dtype)}
    if bias:
        p["b"] = torch.zeros((*stacked, d_out), dtype=dtype, device=generator.device)
    return p


def linear(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm_init(generator, d: int, dtype=torch.bfloat16, stacked: tuple = ()):
    return {"s": torch.ones((*stacked, d), dtype=dtype, device=generator.device)}


def rmsnorm(p, x, eps: float = 1e-5):
    """f32 mean of squares, rsqrt, cast to x's dtype, then ``* scale``."""
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * p["s"]


def gated_rmsnorm(p, x, z, eps: float = 1e-5, group: int = 0):
    """Mamba-2 style RMSNormGated: norm(x * silu(z)) * scale.

    ``group`` > 0 normalizes over groups of that many channels (one group per
    SSD head).  Rounds where JAX rounds: silu(z) in f32 rounded to x's dtype,
    the product in x's dtype, the norm in f32 rounded to x's dtype, then
    ``* scale``."""
    dt = x.dtype
    xf = (x * F.silu(z.float()).to(dt)).float()
    if group and group < xf.shape[-1]:
        shp = xf.shape
        xg = xf.reshape(*shp[:-1], shp[-1] // group, group)
        var = (xg * xg).mean(dim=-1, keepdim=True)
        xf = (xg * torch.rsqrt(var + eps)).reshape(shp)
    else:
        var = (xf * xf).mean(dim=-1, keepdim=True)
        xf = xf * torch.rsqrt(var + eps)
    return xf.to(dt) * p["s"]


# -- rotary position embeddings ----------------------------------------------


def rope_angles(positions, rot_dim: int, theta: float):
    """(..., rot_dim/2) cos/sin tables for given integer positions."""
    inv = 1.0 / (theta ** (torch.arange(0, rot_dim, 2, dtype=torch.float32,
                                        device=positions.device) / rot_dim))
    ang = positions.float()[..., None] * inv  # (..., rot/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, fraction: float = 1.0, theta: float = 10_000.0):
    """Rotate-half RoPE on the leading ``fraction`` of the head dim.

    x: (B, H, S, hd); positions: (S,) or (B, S).  cos/sin are cast to x's
    dtype before the products, as in the JAX package.
    """
    hd = x.shape[-1]
    rot = int(hd * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    cos, sin = rope_angles(positions, rot, theta)  # (S, rot/2) or (B,S,rot/2)
    while cos.ndim < x.ndim - 1:  # align to (B, H, S, rot/2)
        cos, sin = cos[None], sin[None]
    xr = x if rot == hd else x[..., :rot]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    cos = cos.to(x.dtype)
    sin = sin.to(x.dtype)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if rot == hd:
        return out
    return torch.cat([out, x[..., rot:]], dim=-1)


ACTS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "silu": F.silu,
    "relu": F.relu,
}
