"""Qwen1.5-32B [hf:Qwen/Qwen1.5-0.5B family]: 64L, d_model=5120, MHA
(40H, kv=40), QKV bias, SwiGLU, RMSNorm."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    arch_type="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    mlp="swiglu",
    norm="rmsnorm",
    qkv_bias=True,
    source="hf:Qwen/Qwen1.5-0.5B (family card)",
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=8, d_ff=512,
        vocab_size=512, dtype="float32")
