"""Whisper-large-v3 [arXiv:2212.04356]: encoder-decoder, 32+32 layers,
d_model=1280, 20 heads (MHA: kv=20), GELU MLP, layernorm, learned decoder
positions, sinusoidal encoder positions.

The mel-spectrogram + conv feature extractor is a STUB per the assignment:
``input_specs`` provides precomputed frame embeddings (B, 1500, 1280).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    arch_type="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    mlp="gelu",
    norm="layernorm",
    pos_embedding="learned",
    encoder_layers=32,
    encoder_len=1500,
    cross_attention=True,
    source="arXiv:2212.04356 (Whisper)",
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(
        n_layers=2, encoder_layers=2, d_model=256, n_heads=8, n_kv_heads=8,
        d_ff=512, vocab_size=512, encoder_len=32, dtype="float32")
