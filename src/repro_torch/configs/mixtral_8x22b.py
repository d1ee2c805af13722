"""Mixtral-8x22B [Mistral] — verifier-benchmark MoE config (paper Table 2 M2)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='mixtral_8x22b',
    family='moe',
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=0,
    vocab=32768,
    n_experts=8,
    top_k=2,
    d_ff_expert=16384,
    mlp_act='swiglu',
    n_kv_heads_padded=16,
)

SMOKE = ArchConfig(
    name='mixtral_8x22b_smoke',
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
