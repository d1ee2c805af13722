"""HuBERT-XLarge [arXiv:2106.07447; unverified-tier] — encoder-only audio transformer (w2v2 arch). Conv feature extractor is a STUB: input_specs supplies frame embeddings."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='hubert_xlarge',
    family='audio',
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    mlp_act='gelu',
    encoder_only=True,
    causal=False,
    frontend='audio_frames',
    vocab_padded=512,
)

SMOKE = ArchConfig(
    name='hubert_xlarge_smoke',
    family='audio',
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=60,
    mlp_act='gelu',
    encoder_only=True,
    causal=False,
    frontend='audio_frames',
    vocab_padded=64,
)
