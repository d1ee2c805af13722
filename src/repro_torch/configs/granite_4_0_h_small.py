"""Granite-4.0-H-Small (32B total, 9B active) [hf:ibm-granite/granite-4.0-h-small]
— 40 layers: Mamba-2 mixers (128 heads of 64, d_state 128, one group, conv 4
with bias, expand 2) with NoPE GQA attention at layers 5, 15, 25 and 35
(32 query and 8 KV heads of 128, scores scaled by 1/128), and a MoE of 72
experts top-10 (width 768) with a SwiGLU shared expert of 1536 in every
layer; the gated norm spans the whole 8192-wide inner width; embedding x12,
residual branches x0.22, logits / 16; tied head, vocab 100352.

The port's own config: the JAX package has no such model, so it is on
neither ``ARCH_IDS`` nor ``EXTRA_IDS`` and no campaign compares it.  The
SSD chunk is the port's 128 (published 256): how the scan is computed, not
a width."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='granite_4_0_h_small',
    family='hybrid',
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=0,
    vocab=100352,
    head_dim=128,
    rope_fraction=0.0,
    attention_multiplier=1 / 128,
    n_experts=72,
    top_k=10,
    d_ff_expert=768,
    shared_expert_ff=1536,
    moe_period=1,
    attn_period=10,
    attn_offset=5,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_conv_bias=True,
    ssm_norm_group=8192,
    mlp_act='swiglu',
    norm_eps=1e-5,
    tie_embeddings=True,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
)

# the published pattern at a shorter period (attention at layer 2 of 4, MoE
# in every layer), every field the port added set away from its default, and
# a chunk of 16 so that a 48-token prompt carries the state across chunks
SMOKE = ArchConfig(
    name='granite_4_0_h_small_smoke',
    family='hybrid',
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=0,
    vocab=256,
    head_dim=16,
    rope_fraction=0.0,
    attention_multiplier=1 / 16,
    n_experts=6,
    top_k=3,
    d_ff_expert=32,
    shared_expert_ff=48,
    moe_period=1,
    attn_period=4,
    attn_offset=2,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_conv=4,
    ssm_chunk=16,
    ssm_conv_bias=True,
    ssm_norm_group=128,
    mlp_act='swiglu',
    norm_eps=1e-5,
    tie_embeddings=True,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
)
