"""Granite-MoE-3B-a800m [hf:ibm-granite; hf-tier] — MoE 40e top-8 per the structured assignment spec (inline note says 32e; spec wins, see DESIGN.md §9). Experts padded 40->48 for 16-way EP."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='granite_moe_3b',
    family='moe',
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=0,
    vocab=49155,
    head_dim=64,
    n_experts=40,
    n_experts_padded=48,
    top_k=8,
    d_ff_expert=512,
    mlp_act='swiglu',
    n_heads_padded=32,
    n_kv_heads_padded=16,
    vocab_padded=49168,
)

SMOKE = ArchConfig(
    name='granite_moe_3b_smoke',
    family='moe',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=0,
    vocab=256,
    head_dim=16,
    n_experts=5,
    n_experts_padded=6,
    top_k=2,
    d_ff_expert=64,
    mlp_act='swiglu',
)
