"""Architecture configuration schema + registry + input specs.

Every ported architecture gets one module in this package defining a
``CONFIG`` (full published size) and a ``SMOKE`` (reduced same-family config
for CPU tests).  The fields and derived properties are those of the JAX
package's ``ArchConfig``, so one config describes the same model in both;
the port adds a few whose defaults leave the arithmetic as it was
(``attention_multiplier``, ``ssm_conv_bias``, ``ssm_norm_group`` and the
multipliers of the embedding, the residual branches and the logits), which
only the port's own configs set (``granite_4_0_h_small``, off the JAX
package's lists).

Shape suite: train_4k / prefill_32k / decode_32k / long_500k, with per-arch
skips (encoder-only -> no decode; full-attention -> no 500k), as in the JAX
package.
"""
from __future__ import annotations

import importlib
import math
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # attention flavour
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_fraction: float = 1.0  # chatglm3 applies RoPE to half the head dim
    rope_theta: float = 10_000.0
    causal: bool = True
    attention_multiplier: float = 0.0  # softmax scale; 0 -> hd ** -0.5 (granite's 1/128)
    # mlp flavour
    mlp_act: str = "swiglu"  # swiglu | geglu | gelu
    # MoE
    n_experts: int = 0
    n_experts_padded: int = 0  # padded for EP divisibility (0 = n_experts)
    top_k: int = 0
    d_ff_expert: int = 0
    shared_expert_ff: int = 0
    moe_period: int = 1  # layer l uses MoE iff n_experts>0 and l % moe_period == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    # hybrid / SSM
    attn_period: int = 0  # 0 = attention everywhere; k>0 -> attention iff l%k==attn_offset
    attn_offset: int = 0
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128
    ssm_conv_bias: bool = False  # a bias on each causal conv (granite-4.0-h)
    ssm_norm_group: int = 0  # gated norm's group of channels; 0 -> one SSD head
    # structure
    encoder_only: bool = False
    tie_embeddings: bool = False
    frontend: str = "none"  # none | audio_frames | vision_patches
    frontend_dim: int = 0  # raw patch/frame embedding width (projected to d_model)
    frontend_len: int = 0  # number of prefix embeddings
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # granite's multipliers: the embedding, each mixer or MLP/MoE branch before
    # its residual add, and the head's logits (divided); 1.0 leaves each out
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    # padding applied for TP/EP divisibility
    n_heads_padded: int = 0
    n_kv_heads_padded: int = 0
    vocab_padded: int = 0
    ssm_heads_padded: int = 0

    # -- derived -------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def heads(self) -> int:
        return self.n_heads_padded or self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads_padded or self.n_kv_heads

    @property
    def experts(self) -> int:
        return self.n_experts_padded or self.n_experts

    @property
    def vocab_p(self) -> int:
        return self.vocab_padded or self.vocab

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def ssm_heads_p(self) -> int:
        return self.ssm_heads_padded or self.ssm_heads

    @property
    def d_inner_p(self) -> int:
        return self.ssm_heads_p * self.ssm_head_dim

    def is_attn_layer(self, layer: int) -> bool:
        if self.ssm_state == 0:
            return True
        if self.attn_period == 0:
            return False  # pure SSM
        return layer % self.attn_period == self.attn_offset

    def is_moe_layer(self, layer: int) -> bool:
        return self.n_experts > 0 and layer % self.moe_period == self.moe_offset

    @property
    def block_period(self) -> int:
        """Smallest repeating layer pattern (stacked super-block size)."""
        p = 1
        if self.n_experts > 0:
            p = math.lcm(p, self.moe_period)
        if self.ssm_state > 0 and self.attn_period > 0:
            p = math.lcm(p, self.attn_period)
        return p

    def param_count(self) -> int:
        """Approximate parameter count (true config, ignoring TP padding)."""
        hd = self.hd
        n = self.vocab * self.d_model  # embed
        if not self.tie_embeddings:
            n += self.vocab * self.d_model
        for li in range(self.n_layers):
            if self.is_attn_layer(li):
                n += self.d_model * (self.n_heads * hd) + self.d_model * (
                    2 * self.n_kv_heads * hd
                )
                n += self.n_heads * hd * self.d_model
            elif self.ssm_state > 0:
                di = self.d_inner
                n += self.d_model * (2 * di + 2 * self.ssm_state + self.ssm_heads)
                n += di * self.d_model + self.ssm_conv * (di + 2 * self.ssm_state)
                if self.ssm_conv_bias:
                    n += di + 2 * self.ssm_state
            if self.is_moe_layer(li):
                n += self.d_model * self.n_experts  # router
                n += self.n_experts * 3 * self.d_model * self.d_ff_expert
                if self.shared_expert_ff:
                    n += 3 * self.d_model * self.shared_expert_ff
            elif self.d_ff > 0:
                mult = 3 if self.mlp_act in ("swiglu", "geglu") else 2
                n += mult * self.d_model * self.d_ff
            n += 2 * self.d_model  # norms
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE top-k instead of all experts)."""
        if self.n_experts == 0:
            return self.param_count()
        full = self.param_count()
        moe_layers = sum(1 for li in range(self.n_layers) if self.is_moe_layer(li))
        all_exp = moe_layers * self.n_experts * 3 * self.d_model * self.d_ff_expert
        act_exp = moe_layers * self.top_k * 3 * self.d_model * self.d_ff_expert
        return full - all_exp + act_exp


# the fields the port added beside the JAX package's; at their defaults
# (every config the JAX package has) they leave the arithmetic as it was
PORT_FIELDS = ("attention_multiplier", "ssm_conv_bias", "ssm_norm_group",
               "embedding_multiplier", "residual_multiplier", "logits_scaling")


@dataclass(frozen=True)
class ShapeDtype:
    """A tensor's shape and dtype, the counterpart of jax's
    ``ShapeDtypeStruct``: what the tracer needs of an input."""

    shape: tuple
    dtype: torch.dtype


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = [
    "qwen1_5_4b",
    "chatglm3_6b",
    "gemma_2b",
    "qwen3_4b",
    "jamba_1_5_large",
    "hubert_xlarge",
    "mamba2_130m",
    "granite_moe_3b",
    "moonshot_v1_16b",
    "internvl2_26b",
]

# extra configs used by the verifier benchmarks (the paper's own tables)
EXTRA_IDS = ["llama3_8b", "llama3_70b", "llama3_405b", "mixtral_8x7b", "mixtral_8x22b"]


def get_config(arch: str, smoke: bool = False) -> ArchConfig:
    """Config module ``repro_torch.configs.<arch>``; an architecture whose
    family is not ported yet has no module and raises ModuleNotFoundError."""
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.SMOKE if smoke else mod.CONFIG


def skip_reason(cfg: ArchConfig, shape: str) -> Optional[str]:
    """The JAX package's skip rules, with its strings."""
    spec = SHAPES[shape]
    if cfg.encoder_only and spec.kind == "decode":
        return "encoder-only architecture has no decode step"
    if shape == "long_500k":
        sub_quadratic = cfg.ssm_state > 0  # pure SSM or hybrid
        if not sub_quadratic:
            return "pure full-attention arch: 500k decode restricted to SSM/hybrid per assignment"
    return None


def input_specs(cfg: ArchConfig, shape: str | ShapeSpec):
    """:class:`ShapeDtype` records for every model input of a shape cell
    (a name in ``SHAPES``, or a ``ShapeSpec`` of another batch and length),
    the JAX package's ``jax.ShapeDtypeStruct`` stand-ins dim for dim and
    dtype for dtype.

    train  -> {tokens, labels}            (B, S) int32
    prefill-> {tokens}                    (B, S) int32
    decode -> {token, position}           one new token at a position
    Modality frontends are stubs: precomputed frame/patch embeddings,
    ``frames`` (B, S, d_model) or ``vision_embeds`` (B, frontend_len,
    frontend_dim) in the model's dtype, which take the first positions of
    the sequence (a vision prefix leaves S - frontend_len tokens).
    """
    spec = SHAPES[shape] if isinstance(shape, str) else shape
    B, S = spec.global_batch, spec.seq_len
    i32 = torch.int32
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    out = {}
    if cfg.frontend == "vision_patches":
        out["vision_embeds"] = ShapeDtype((B, cfg.frontend_len, cfg.frontend_dim), dt)
        tok_len = S - cfg.frontend_len
    elif cfg.frontend == "audio_frames":
        out["frames"] = ShapeDtype((B, S, cfg.d_model), dt)
        tok_len = 0
    else:
        tok_len = S
    if spec.kind == "train":
        if tok_len:
            out["tokens"] = ShapeDtype((B, tok_len), i32)
        out["labels"] = ShapeDtype((B, S), i32)
    elif spec.kind == "prefill":
        if tok_len:
            out["tokens"] = ShapeDtype((B, tok_len), i32)
    else:  # decode; the caches come from the model (per-layer kinds differ)
        out["token"] = ShapeDtype((B,), i32)
        out["position"] = ShapeDtype((), i32)
    return out
