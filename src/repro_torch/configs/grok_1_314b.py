"""Grok-1 314B [hf:xai-org/grok-1]: 64L, d_model=6144, 48H GQA(kv=8),
MoE with 8 experts top-2, expert d_ff=32768.

8 experts cannot shard over a 16-way model axis, so expert weights shard
the *FFN-hidden* dim over the model axis (TP-within-expert) and the data
axis FSDP-shards the expert stack for training.
"""
from repro_torch.models.config import ModelConfig, ShardingRules

CONFIG = ModelConfig(
    name="grok-1-314b",
    arch_type="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    mlp="swiglu",
    norm="rmsnorm",
    moe_experts=8,
    moe_top_k=2,
    moe_d_ff=32768,
    sharding=ShardingRules(fsdp=("data",)),
    source="hf:xai-org/grok-1",
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, d_ff=512,
        moe_experts=4, moe_top_k=2, moe_d_ff=512,
        vocab_size=512, moe_capacity_factor=4.0, dtype="float32")
