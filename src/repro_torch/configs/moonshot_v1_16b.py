"""Moonshot-v1-16B-a3b (Moonlight) [hf:moonshotai/Moonlight-16B-A3B; hf-tier] — MoE 64e top-6 + shared expert (2x1408, folded into one 2816 shared expert, DESIGN.md §9)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='moonshot_v1_16b',
    family='moe',
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,
    vocab=163840,
    head_dim=128,
    n_experts=64,
    top_k=6,
    d_ff_expert=1408,
    shared_expert_ff=2816,
    mlp_act='swiglu',
)

SMOKE = ArchConfig(
    name='moonshot_v1_16b_smoke',
    family='moe',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=256,
    head_dim=16,
    n_experts=8,
    top_k=2,
    d_ff_expert=64,
    shared_expert_ff=128,
    mlp_act='swiglu',
)
