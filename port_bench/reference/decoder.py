"""Plain PyTorch reference of the decoder the prefill cells run:
token embedding, pre-norm blocks of RMSNorm, GQA attention with biased
Q/K/V projections and RoPE on the leading ``rope_fraction`` of each head,
causal softmax, the output projection, then a SwiGLU MLP or a top-k
mixture of experts with a capacity dispatch, and the final norm and head.

It is written from the configuration's ``port`` section alone and imports
nothing of the program.  Weights come in the program's parameter layout
(``blocks[j]`` stacks layers ``j, j + P, ...`` along a leading dim, every
matrix ``(d_in, d_out)``) and are widened to float32 one layer at a time.
Every product runs in float32 with TF32 off (``Precision("f32")``), or, as
the correctness control, one step below the configuration's bfloat16: both
operands rounded to float8 e4m3 with a scale per row of the left operand
and per column of the right one (``Precision("fp8")``).
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


@contextmanager
def no_tf32():
    """Float32 products in float32 (TF32 off for matmuls and cuDNN)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def round_fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` (float32) rounded to float8 e4m3 with one scale for each slice
    along ``dim`` (its absolute maximum maps to e4m3's largest value), and
    widened back."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Precision:
    """How the reference multiplies: ``"f32"``, or as the control one step
    below bfloat16, ``"fp8"``."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"precision {kind!r}: f32 or fp8")
        self.kind = kind

    def context(self):
        return no_tf32()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a (..., K) @ b (..., K, N), contracted over K."""
        if self.kind == "fp8":
            a, b = round_fp8(a, -1), round_fp8(b, -2)
        return a @ b


def layer_params(params: dict, li: int) -> dict:
    """Layer ``li``'s parameters, each leaf widened to float32."""
    blocks = params["blocks"]
    blk = blocks[li % len(blocks)]
    i = li // len(blocks)

    def pick(t):
        if isinstance(t, dict):
            return {k: pick(v) for k, v in t.items()}
        return t[i].float()

    return pick(blk)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, fraction: float, theta: float) -> torch.Tensor:
    """Rotate-half RoPE on the first ``fraction`` of the head dim; x (B, H,
    S, hd) at positions 0 .. S - 1."""
    hd, S = x.shape[-1], x.shape[-2]
    rot = int(hd * fraction)
    rot -= rot % 2
    inv = 1.0 / theta ** (torch.arange(0, rot, 2, dtype=torch.float32, device=x.device) / rot)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : rot // 2], x[..., rot // 2: rot]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, x[..., rot:]], dim=-1)


def linear(p: dict, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    y = prec.mm(x, p["w"])
    return y + p["b"] if "b" in p else y


def attention(m: dict, p: dict, x: torch.Tensor, prec: Precision,
              q_block: int = 1024) -> torch.Tensor:
    """Causal GQA self-attention of x (B, S, D), softmax in float32, a block
    of queries at a time."""
    B, S, _ = x.shape
    hd, H, Hkv = m["head_dim"], m["n_heads"], m["n_kv_heads"]
    heads = lambda t, n: t.reshape(B, S, n, hd).transpose(1, 2)
    q = rope(heads(linear(p["wq"], x, prec), H), m.get("rope_fraction", 1.0), m["rope_theta"])
    k = rope(heads(linear(p["wk"], x, prec), Hkv), m.get("rope_fraction", 1.0),
             m["rope_theta"])
    v = heads(linear(p["wv"], x, prec), Hkv)
    k = k.repeat_interleave(H // Hkv, dim=1)
    v = v.repeat_interleave(H // Hkv, dim=1)
    out = torch.empty_like(q)
    for s0 in range(0, S, q_block):
        s1 = min(S, s0 + q_block)
        s = prec.mm(q[:, :, s0:s1], k[:, :, :s1].transpose(-1, -2)) / math.sqrt(hd)
        mask = (torch.arange(s0, s1, device=x.device)[:, None]
                >= torch.arange(s1, device=x.device)[None, :])
        w = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out[:, :, s0:s1] = prec.mm(w, v[:, :, :s1])
    return linear(p["wo"], out.transpose(1, 2).reshape(B, S, H * hd), prec)


def swiglu(wg, wu, wo, x, prec: Precision) -> torch.Tensor:
    return prec.mm(F.silu(prec.mm(x, wg)) * prec.mm(x, wu), wo)


def route(m: dict, router: torch.Tensor, x: torch.Tensor):
    """Float32 router: softmax over the experts, the top-k by value (ties to
    the lower index), renormalised.  Returns (weights (T, K), experts (T, K))."""
    probs = torch.softmax(x @ router, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, : m["top_k"]], idx[:, : m["top_k"]]
    return w / w.sum(-1, keepdim=True), idx


def capacity(m: dict, tokens: int) -> int:
    """Rows of each expert's buffer: ceil(T * K / E * capacity_factor)."""
    return math.ceil(tokens * m["top_k"] / m["n_experts"] * m["capacity_factor"])


def moe(m: dict, p: dict, x: torch.Tensor, prec: Precision):
    """Top-k experts with a capacity: each expert takes the first C of the
    (token, slot) pairs routed to it, in token order over the whole batch,
    and drops the rest.  Returns (y (B, S, D), pairs dropped)."""
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    w, idx = route(m, p["router"]["w"], xf)
    C = capacity(m, B * S)
    y = torch.zeros_like(xf)
    dropped = 0
    for e in range(m["n_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)  # in (token, slot) order
        dropped += max(0, len(tok) - C)
        tok, slot = tok[:C], slot[:C]
        out = swiglu(p["wg"][e], p["wu"][e], p["wo"][e], xf[tok], prec)
        y.index_add_(0, tok, out * w[tok, slot, None])
    return y.reshape(B, S, D), dropped


def hidden(m: dict, params: dict, tokens: torch.Tensor, prec: Precision) -> torch.Tensor:
    """The final normed hidden states (B, S, D) in float32 of prompts
    ``tokens`` (B, S)."""
    with prec.context():
        x = params["embed"]["w"][tokens].float()
        for li in range(m["n_layers"]):
            p = layer_params(params, li)
            x = x + attention(m, p["attn"], rmsnorm(x, p["ln1"]["s"], m["norm_eps"]), prec)
            h = rmsnorm(x, p["ln2"]["s"], m["norm_eps"])
            if "moe" in p:
                x = x + moe(m, p["moe"], h, prec)[0]
            else:
                mp = p["mlp"]
                x = x + swiglu(mp["wg"]["w"], mp["wu"]["w"], mp["wo"]["w"], h, prec)
            del p
        return rmsnorm(x, params["ln_f"]["s"], m["norm_eps"])


def head_weight(m: dict, params: dict) -> torch.Tensor:
    """The head's (D, V) matrix over the published vocabulary, float32."""
    w = params["embed"]["w"].T if m.get("tie_embeddings") else params["lm_head"]["w"]
    return w[:, : m["vocab"]].float()


def logits(m: dict, params: dict, h: torch.Tensor, prec: Precision,
           w_head: torch.Tensor | None = None) -> torch.Tensor:
    """Logits (..., V) over the published vocabulary of hidden states h."""
    with prec.context():
        return prec.mm(h, head_weight(m, params) if w_head is None else w_head)

