"""ChatGLM3-6B [arXiv:2406.12793; hf-tier] — dense, 2d (half-dim) RoPE, GQA kv=2."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='chatglm3_6b',
    family='dense',
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=65024,
    qkv_bias=True,
    rope_fraction=0.5,
    mlp_act='swiglu',
    n_kv_heads_padded=16,
)

SMOKE = ArchConfig(
    name='chatglm3_6b_smoke',
    family='dense',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    qkv_bias=True,
    rope_fraction=0.5,
    mlp_act='swiglu',
)
