"""ChatGLM3-6B [arXiv:2406.12793]: 2D/partial RoPE (half the head dims
rotated), GQA with 2 KV heads, qkv bias."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    arch_type="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    mlp="swiglu",
    norm="rmsnorm",
    qkv_bias=True,
    rope_fraction=0.5,      # "RoPE 2d": rotate half of each head's dims
    source="arXiv:2406.12793 (ChatGLM family)",
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, d_ff=512,
        vocab_size=512, dtype="float32")
