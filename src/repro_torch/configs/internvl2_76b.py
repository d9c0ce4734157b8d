"""InternVL2-Llama3-76B language backbone [arXiv:2404.16821].

InternViT-6B vision encoder + Llama-3-70B-style LLM.  Per the assignment
carve-out, the vision tower is a STUB: ``input_specs`` provides projected
patch embeddings of shape (B, num_patches, d_model); we implement the
language/decoder transformer that consumes them.
"""
from repro_torch.models.config import ModelConfig, ShardingRules

CONFIG = ModelConfig(
    name="internvl2-76b",
    arch_type="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=500_000.0,
    num_patches=256,
    sharding=ShardingRules(fsdp=("data",)),
    source="arXiv:2404.16821 (InternViT + InternLM2/Llama3 backbone)",
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, d_ff=512,
        vocab_size=512, num_patches=16, dtype="float32")
