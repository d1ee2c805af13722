"""Mixtral-8x7B [Mistral] — verifier-benchmark MoE config (paper Table 2 M1)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='mixtral_8x7b',
    family='moe',
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=0,
    vocab=32000,
    n_experts=8,
    top_k=2,
    d_ff_expert=14336,
    mlp_act='swiglu',
    n_kv_heads_padded=16,
    vocab_padded=32000,
)

SMOKE = ArchConfig(
    name='mixtral_8x7b_smoke',
    family='moe',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=0,
    vocab=256,
    n_experts=4,
    top_k=2,
    d_ff_expert=64,
    mlp_act='swiglu',
)
