"""InternVL2-26B [arXiv:2404.16821; hf-tier] — InternLM2-20B language backbone; InternViT frontend is a STUB: input_specs supplies 256 patch embeddings of width 3200 projected into the LM."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='internvl2_26b',
    family='vlm',
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    head_dim=128,
    mlp_act='swiglu',
    frontend='vision_patches',
    frontend_dim=3200,
    frontend_len=256,
    n_kv_heads_padded=16,
    vocab_padded=92560,
)

SMOKE = ArchConfig(
    name='internvl2_26b_smoke',
    family='vlm',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    head_dim=16,
    mlp_act='swiglu',
    frontend='vision_patches',
    frontend_dim=48,
    frontend_len=8,
)
