"""Llama-3.1-70B [Meta] — verifier-benchmark config (paper Table 2 L2)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='llama3_70b',
    family='dense',
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    mlp_act='swiglu',
    n_kv_heads_padded=16,
)

SMOKE = ArchConfig(
    name='llama3_70b_smoke',
    family='dense',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    mlp_act='swiglu',
)
