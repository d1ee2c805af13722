"""Mamba2-130M [arXiv:2405.21060; unverified-tier] — attention-free SSD (state-space duality), d_state=128, 24 ssm heads of dim 64 (padded to 32 for TP16)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='mamba2_130m',
    family='ssm',
    n_layers=24,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_period=0,
    vocab_padded=50288,
    ssm_heads_padded=32,
)

SMOKE = ArchConfig(
    name='mamba2_130m_smoke',
    family='ssm',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=256,
    ssm_state=16,
    ssm_head_dim=32,
    ssm_expand=2,
    attn_period=0,
)
