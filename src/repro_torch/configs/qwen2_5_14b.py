"""Qwen2.5-14B [hf:Qwen/Qwen2.5-14B-Instruct] — the paper's primary
evaluation model (Table 1, Fig 8-11, Tables 2-4)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    arch_type="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    mlp="swiglu",
    norm="rmsnorm",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen2.5-14B-Instruct (paper §6.1)",
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, d_ff=512,
        vocab_size=512, dtype="float32")
