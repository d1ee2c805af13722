"""Gemma-2B [arXiv:2403.08295; hf-tier] — dense, GeGLU, MQA (kv=1), head_dim=256."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='gemma_2b',
    family='dense',
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab=256000,
    head_dim=256,
    mlp_act='geglu',
    tie_embeddings=True,
    n_heads_padded=16,
    n_kv_heads_padded=16,
)

SMOKE = ArchConfig(
    name='gemma_2b_smoke',
    family='dense',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    n_kv_heads_padded=2,
    d_ff=128,
    vocab=256,
    head_dim=32,
    mlp_act='geglu',
    tie_embeddings=True,
)
