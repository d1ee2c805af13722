"""GQA/MQA/MHA attention with RoPE variants, qk-norm, biases, KV caches, and
chunked (flash-style online-softmax) computation.

``chunked_attention`` is the semantic reference, written as a Python loop
over key chunks.  ``attn_fwd(impl="kernel")`` runs the flash-attention
kernel instead (``repro_torch.kernels.ops``).  Decode keeps
``chunked_attention``, as the JAX package does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.scope import loop, named_scope, span

from .modules import apply_rope, einsum_f32, linear, linear_init, rmsnorm, rmsnorm_init


def attn_init(generator, cfg, *, stacked: tuple = (), dtype=torch.bfloat16):
    hd = cfg.hd
    p = {
        "wq": linear_init(generator, cfg.d_model, cfg.heads * hd, bias=cfg.qkv_bias,
                          dtype=dtype, stacked=stacked),
        "wk": linear_init(generator, cfg.d_model, cfg.kv_heads * hd, bias=cfg.qkv_bias,
                          dtype=dtype, stacked=stacked),
        "wv": linear_init(generator, cfg.d_model, cfg.kv_heads * hd, bias=cfg.qkv_bias,
                          dtype=dtype, stacked=stacked),
        "wo": linear_init(generator, cfg.heads * hd, cfg.d_model, dtype=dtype,
                          stacked=stacked),
    }
    if cfg.qk_norm:
        p["qnorm"] = rmsnorm_init(generator, hd, dtype, stacked)
        p["knorm"] = rmsnorm_init(generator, hd, dtype, stacked)
    return p


def _split_heads(x, n_heads: int):
    B, S, _ = x.shape
    return x.reshape(B, S, n_heads, -1).transpose(1, 2)  # (B,H,S,hd)


def chunked_attention(
    q, k, v, *, causal: bool, q_offset=0, k_offset=0, kv_len: Optional[int] = None,
    chunk: int = 1024, with_stats: bool = False, unroll: bool = False,
    scale: Optional[float] = None,
):
    """Flash-style online-softmax attention in plain torch.

    q: (B, Hq, Sq, hd); k/v: (B, Hkv, Sk, hd) with Hq = G * Hkv.
    ``kv_len``: optional valid length (decode masking).
    ``scale``: the scores' scale (None: hd ** -0.5).
    ``with_stats``: also return (m, l) running stats for cross-device merges.
    ``unroll`` is accepted for the JAX signature; the loop is always Python.
    """
    del unroll
    B, Hq, Sq, hd = q.shape
    _, Hkv, Sk, _ = k.shape
    G = Hq // Hkv
    dev = q.device
    qg = q.reshape(B, Hkv, G, Sq, hd)
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    chunk = min(chunk, Sk)
    n_chunks = (Sk + chunk - 1) // chunk
    pad = n_chunks * chunk - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    # (n_chunks, B, Hkv, chunk, hd), as the JAX version scans them
    kc = k.reshape(B, Hkv, n_chunks, chunk, hd).permute(2, 0, 1, 3, 4)
    vc = v.reshape(B, Hkv, n_chunks, chunk, hd).permute(2, 0, 1, 3, 4)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    with named_scope("flash_attn"):  # the region K1 computes on the kernel path
        neg = -1e30
        m = torch.full((B, Hkv, G, Sq), neg, dtype=torch.float32, device=dev)
        denom = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hkv, G, Sq, hd), dtype=torch.float32, device=dev)
        for ci in loop(n_chunks, "chunk"):
            kb, vb = kc[ci], vc[ci]
            s = einsum_f32("bhgqd,bhkd->bhgqk", qg, kb) * scale
            k_pos = k_offset + ci * chunk + torch.arange(chunk, device=dev)
            mask = torch.ones((Sq, chunk), dtype=torch.bool, device=dev)
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])
            if kv_len is not None:
                mask = mask & (k_pos[None, :] < kv_len)
            if pad:
                mask = mask & (ci * chunk + torch.arange(chunk, device=dev) < Sk)[None, :]
            s = torch.where(mask[None, None, None], s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            denom = denom * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + einsum_f32("bhgqk,bhkd->bhgqd", p.to(vb.dtype), vb)
            m = m_new
        if with_stats:
            return acc, m, denom
        out = acc / denom[..., None].clamp_min(1e-30)
        return out.reshape(B, Hq, Sq, hd).to(q.dtype)


def attn_fwd(cfg, ctx: ParallelCtx, p, x, positions, *, impl: str = "reference",
             unroll: bool = False, kv_out: Optional[list] = None):
    """Full-sequence attention (train / prefill).  x: (B, S, D).  ``kv_out``:
    a list the layer's K and V (B, Hkv, S, hd), after RoPE, are appended to
    (``Model.forward``'s)."""
    B, S, _ = x.shape
    hd = cfg.hd
    with span("attn.qkv"):
        q = linear(p["wq"], x)
        k = linear(p["wk"], x)
        v = linear(p["wv"], x)
        Hq_loc = q.shape[-1] // hd
        Hkv_loc = k.shape[-1] // hd
        q = _split_heads(q, Hq_loc)
        k = _split_heads(k, Hkv_loc)
        v = _split_heads(v, Hkv_loc)
        if cfg.qk_norm:
            q = rmsnorm(p["qnorm"], q, cfg.norm_eps)
            k = rmsnorm(p["knorm"], k, cfg.norm_eps)
    with span("attn.rope"):
        q = apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_fraction, cfg.rope_theta)
    if kv_out is not None:
        kv_out.append((k, v))
    scale = cfg.attention_multiplier or None
    with span("attn.core"):
        if impl == "kernel":
            out = kops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                       causal=cfg.causal, scale=scale)
        else:
            out = chunked_attention(q, k, v, causal=cfg.causal, unroll=unroll, scale=scale)
    with span("attn.out"):
        out = out.transpose(1, 2).reshape(B, S, Hq_loc * hd)
        y = linear(p["wo"], out)
    return ctx.sp_enter(y)


def attn_init_cache(cfg, batch: int, max_len: int, tp_size: int = 1, cp_size: int = 1,
                    dtype=torch.bfloat16, device="cpu"):
    """Per-layer KV cache buffers (B, Hkv, max_len, hd).  Under context
    parallelism ``max_len`` is the rank's shard of the sequence (the caller
    divides it)."""
    hd = cfg.hd
    kv = cfg.kv_heads // tp_size
    shape = (batch, kv, max_len, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def write_index(position: torch.Tensor, size: int) -> torch.Tensor:
    """The start index ``lax.dynamic_update_slice_in_dim`` uses for a
    length-1 update at ``position`` (a 0-d int64 tensor): a negative index
    counts from the end once, then the start is clamped into the buffer."""
    return torch.where(position < 0, position + size, position).clamp(0, size - 1)


def attn_decode(cfg, ctx: ParallelCtx, p, x, cache, position, write_at, *,
                unroll: bool = False):
    """Single-token decode with KV cache update.

    x: (B, 1, D); cache k/v: (B, Hkv, S, hd); ``position`` a 0-d int64
    tensor on x's device; ``write_at`` is ``write_index(position, S)[None]``,
    which the caller computes once a step for every layer.  The new K/V are
    written into ``cache`` in place with ``index_copy_`` at ``write_at``
    (the JAX version returns ``dynamic_update_slice`` copies; the verifier
    traces each write as that op, with its own index wrap), and the same
    dict is returned.

    Under context parallelism the cache holds this rank's ``S_loc``
    positions of the sequence, from ``cp_index() * S_loc``: the owning rank
    stores the new K/V (each other rank writes its old K/V back at the
    clipped index, as JAX's ``where(in_range, knew, old_k)``), every rank
    attends over its shard with the softmax stats kept, and the shards'
    partial results are merged flash-decode style over the axis.
    """
    B = x.shape[0]
    hd = cfg.hd
    q = linear(p["wq"], x)
    k = linear(p["wk"], x)
    v = linear(p["wv"], x)
    Hq_loc = q.shape[-1] // hd
    Hkv_loc = k.shape[-1] // hd
    q = _split_heads(q, Hq_loc)
    knew = _split_heads(k, Hkv_loc)
    vnew = _split_heads(v, Hkv_loc)
    if cfg.qk_norm:
        q = rmsnorm(p["qnorm"], q, cfg.norm_eps)
        knew = rmsnorm(p["knorm"], knew, cfg.norm_eps)
    q = apply_rope(q, position[None], cfg.rope_fraction, cfg.rope_theta)
    knew = apply_rope(knew, position[None], cfg.rope_fraction, cfg.rope_theta)

    scale = cfg.attention_multiplier or None
    if ctx.cp_axis:
        out = _cp_decode_attention(ctx, q, knew, vnew, cache, position, unroll, scale)
    else:
        cache["k"].index_copy_(2, write_at, knew)
        cache["v"].index_copy_(2, write_at, vnew)
        out = chunked_attention(q, cache["k"], cache["v"], causal=False,
                                kv_len=position + 1, unroll=unroll, scale=scale)
    out = out.transpose(1, 2).reshape(B, 1, Hq_loc * hd)
    y = linear(p["wo"], out)
    return ctx.sp_enter(y), cache


def _cp_decode_attention(ctx: ParallelCtx, q, knew, vnew, cache, position, unroll,
                         scale=None):
    """One token's attention over a KV cache cut along the sequence over the
    context-parallel axis (``attn_decode``'s CP branch, as the JAX
    package's): the write on the owning shard, attention over this shard at
    its global key offset with the softmax stats kept, then the
    flash-decode merge of the shards (max, rescale, sums)."""
    B, Hq_loc, _, hd = q.shape
    S_loc = cache["k"].shape[2]
    shard = ctx.cp_index()
    local_pos = position - shard * S_loc
    in_range = (local_pos >= 0) & (local_pos < S_loc)
    at = local_pos.clamp(0, S_loc - 1)[None]
    for name, new in (("k", knew), ("v", vnew)):
        old = cache[name].index_select(2, at)
        cache[name].index_copy_(2, at, torch.where(in_range, new, old))
    acc, m, denom = chunked_attention(q, cache["k"], cache["v"], causal=False,
                                      k_offset=shard * S_loc, kv_len=position + 1,
                                      with_stats=True, unroll=unroll, scale=scale)
    m_g = ctx.pmax_cp(m)
    corr = torch.exp(m - m_g)
    l_g = ctx.psum_cp(denom * corr)
    acc_g = ctx.psum_cp(acc * corr[..., None])
    out = acc_g / l_g[..., None].clamp_min(1e-30)
    return out.reshape(B, Hq_loc, 1, hd).to(q.dtype)
