"""Plain PyTorch reference of the hybrid stack the granite-4.0-h cell runs:
token embedding times ``embedding_multiplier``; pre-norm blocks whose mixer
is causal GQA attention without position embedding (NoPE, scores scaled by
``attention_multiplier``) in layers ``l % attn_period == attn_offset`` and a
Mamba-2 mixer in every other layer; after each mixer a top-k mixture of
experts with a capacity dispatch plus a SwiGLU shared expert; each branch
times ``residual_multiplier`` before its residual add; the final norm and
the tied head, its logits divided by ``logits_scaling``.

The Mamba-2 mixer (one group of B and C for all heads) is written from its
published equations, not from the program's chunked algorithm:

    xBC = silu(causal_conv(x W, w) + b)             (each of x, B, C; depth 4)
    dt  = softplus(x W_dt + dt_bias),  A = -exp(A_log)
    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,     y_t = h_t C_t + D x_t

computed in its masked quadratic form over the whole prompt, a block of
queries at a time: ``y_i = sum_{j <= i} (C_i . B_j) exp(s_i - s_j) dt_j x_j
+ D x_i`` with ``s`` the running sum of ``dt A``, accumulated in float64
and taken relative to each block's first query, so that the decays that
matter keep float32's precision.  Then the gated norm, ``rmsnorm(y *
silu(z))`` over groups of ``ssm_norm_group`` channels (granite: the whole
8192-wide inner width), and the output projection.

Departures from the published model, as the configuration's file lists
them: the depth (20 of 40 layers, stage one of a two-stage pipeline, the
tied head run as stage two would), the experts' capacity (factor 1.25,
pairs past it dropped in token order; the published router has none) and
the router in float32.  Everything else is the configuration's ``port``
section.  It imports nothing of the program and shares ``decoder.py``'s
norms, projections, capacity MoE and precisions (``Precision("f32")``:
float32 with TF32 off; ``Precision("fp8")``: the control).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .decoder import (Precision, head_weight, layer_params, linear, moe, no_tf32,  # noqa: F401
                      rmsnorm, swiglu)


def is_attention(m: dict, li: int) -> bool:
    period = m.get("attn_period", 0)
    if not m.get("ssm_state", 0):
        return True
    return bool(period) and li % period == m.get("attn_offset", 0)


def is_moe(m: dict, li: int) -> bool:
    return m.get("n_experts", 0) > 0 and li % m.get("moe_period", 1) == m.get("moe_offset", 0)


def attention(m: dict, p: dict, x: torch.Tensor, prec: Precision,
              q_block: int = 1024) -> torch.Tensor:
    """Causal GQA self-attention of x (B, S, D) with no position embedding,
    scores times ``attention_multiplier`` (or hd ** -0.5), softmax in
    float32, a block of queries at a time."""
    B, S, _ = x.shape
    hd, H, Hkv = m["head_dim"], m["n_heads"], m["n_kv_heads"]
    scale = m.get("attention_multiplier") or hd ** -0.5
    heads = lambda t, n: t.reshape(B, S, n, hd).transpose(1, 2)
    q = heads(linear(p["wq"], x, prec), H)
    k = heads(linear(p["wk"], x, prec), Hkv).repeat_interleave(H // Hkv, dim=1)
    v = heads(linear(p["wv"], x, prec), Hkv).repeat_interleave(H // Hkv, dim=1)
    out = torch.empty_like(q)
    for s0 in range(0, S, q_block):
        s1 = min(S, s0 + q_block)
        s = prec.mm(q[:, :, s0:s1], k[:, :, :s1].transpose(-1, -2)) * scale
        mask = (torch.arange(s0, s1, device=x.device)[:, None]
                >= torch.arange(s1, device=x.device)[None, :])
        w = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out[:, :, s0:s1] = prec.mm(w, v[:, :, :s1])
    return linear(p["wo"], out.transpose(1, 2).reshape(B, S, H * hd), prec)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """Depthwise causal conv along the sequence: x (B, S, C), taps w (K, C)
    (tap K - 1 on the current position), bias b (C,)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, k:k + S] * w[k] for k in range(K))
    return out if b is None else out + b


def ssd(m: dict, x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, prec: Precision, q_block: int = 128) -> torch.Tensor:
    """The recurrence's output ``y_t = C_t . h_t`` (without the D skip) of
    x (B, S, H, P), dt (B, S, H), A (H,), Bm and Cm (B, S, N), in the
    masked quadratic form, ``q_block`` queries at a time.  Returns (B, S,
    H, P)."""
    Bsz, S, H, P = x.shape
    seg = torch.cumsum((dt * A).double(), dim=1).transpose(1, 2)  # (B, H, S) float64
    xdt = (x * dt[..., None]).permute(0, 2, 1, 3)  # (B, H, S, P): dt_j x_j
    y = torch.empty((Bsz, H, S, P), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, q_block):
        s1 = min(S, s0 + q_block)
        rel = (seg[:, :, :s1] - seg[:, :, s0:s0 + 1]).float()  # s_j - s_{s0}
        cb = prec.mm(Cm[:, s0:s1], Bm[:, :s1].transpose(-1, -2))  # (B, q, s1): C_i . B_j
        later = (torch.arange(s0, s1, device=x.device)[:, None]
                 < torch.arange(s1, device=x.device)[None, :])
        decay = (rel[:, :, s0:s1, None] - rel[:, :, None, :]).masked_fill_(later, float("-inf"))
        mix = decay.exp_().mul_(cb[:, None])  # (B, H, q, s1)
        y[:, :, s0:s1] = prec.mm(mix, xdt[:, :, :s1])
        del decay, mix
    return y.permute(0, 2, 1, 3)


def mamba2(m: dict, p: dict, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """The Mamba-2 mixer of x (B, S, D), one group of B and C."""
    B, S, _ = x.shape
    P = m["ssm_head_dim"]
    bias = p.get("conv_bias") if m.get("ssm_conv_bias") else None
    xi = linear(p["wx"], x, prec)
    z = linear(p["wz"], x, prec)
    conv = lambda t, c: F.silu(causal_conv(t, p[f"conv_{c}"],
                                           None if bias is None else bias[c]["b"]))
    xi = conv(xi, "x")
    Bm = conv(linear(p["wB"], x, prec), "B")
    Cm = conv(linear(p["wC"], x, prec), "C")
    H = xi.shape[-1] // P
    dt = F.softplus(linear(p["wdt"], x, prec) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xi.reshape(B, S, H, P)
    y = ssd(m, xh, dt, A, Bm, Cm, prec) + p["Dskip"][:, None] * xh
    g = y.reshape(B, S, H * P) * F.silu(z)
    group = m.get("ssm_norm_group") or P
    gg = g.reshape(B, S, -1, group)
    g = (gg * torch.rsqrt((gg * gg).mean(-1, keepdim=True) + m["norm_eps"])).reshape(g.shape)
    return linear(p["wo"], g * p["out_norm"]["s"], prec)


def hidden(m: dict, params: dict, tokens: torch.Tensor, prec: Precision) -> torch.Tensor:
    """The final normed hidden states (B, S, D) in float32 of prompts
    ``tokens`` (B, S)."""
    r = m.get("residual_multiplier", 1.0)
    with prec.context():
        x = params["embed"]["w"][tokens].float() * m.get("embedding_multiplier", 1.0)
        for li in range(m["n_layers"]):
            p = layer_params(params, li)
            h = rmsnorm(x, p["ln1"]["s"], m["norm_eps"])
            mix = attention(m, p["attn"], h, prec) if is_attention(m, li) else mamba2(
                m, p["ssm"], h, prec)
            x = x + r * mix
            if "ln2" in p:
                h = rmsnorm(x, p["ln2"]["s"], m["norm_eps"])
                if is_moe(m, li):
                    y = moe(m, p["moe"], h, prec)[0]
                    if "shared" in p["moe"]:
                        s = p["moe"]["shared"]
                        y = y + swiglu(s["wg"]["w"], s["wu"]["w"], s["wo"]["w"], h, prec)
                else:
                    mp = p["mlp"]
                    y = swiglu(mp["wg"]["w"], mp["wu"]["w"], mp["wo"]["w"], h, prec)
                x = x + r * y
            del p
        return rmsnorm(x, params["ln_f"]["s"], m["norm_eps"])


def logits(m: dict, params: dict, h: torch.Tensor, prec: Precision,
           w_head: torch.Tensor | None = None) -> torch.Tensor:
    """Logits (..., V) over the published vocabulary of hidden states h,
    divided by ``logits_scaling``."""
    with prec.context():
        w = head_weight(m, params) if w_head is None else w_head
        return prec.mm(h, w) / m.get("logits_scaling", 1.0)
