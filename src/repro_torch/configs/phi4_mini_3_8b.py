"""Phi-4-mini 3.8B [arXiv:2412.08905]: RoPE, SwiGLU, GQA (24H / 8 KV)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    arch_type="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    mlp="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    source="arXiv:2412.08905 (Phi-4 technical report)",
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(
        n_layers=2, d_model=240, n_heads=6, n_kv_heads=2, d_ff=512,
        vocab_size=512, dtype="float32")
