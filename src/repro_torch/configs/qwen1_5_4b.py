"""Qwen1.5-4B [hf:Qwen/Qwen1.5-*; hf-tier] — dense, QKV bias, GQA kv=n_heads (MHA-like)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='qwen1_5_4b',
    family='dense',
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab=151936,
    head_dim=128,
    qkv_bias=True,
    mlp_act='swiglu',
    rope_theta=5000000.0,
    n_heads_padded=32,
    n_kv_heads_padded=32,
)

SMOKE = ArchConfig(
    name='qwen1_5_4b_smoke',
    family='dense',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    head_dim=16,
    qkv_bias=True,
    mlp_act='swiglu',
)
