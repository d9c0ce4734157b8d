"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B]: 48L, d_model=2048, 32H GQA(kv=4),
128 experts top-8 with per-expert d_ff=768, q/k-norm, head_dim=128.

128 experts divide the 16-way model axis, so the *expert dim* is the
sharded axis (expert parallelism with all-to-all dispatch)."""
from repro_torch.models.config import ModelConfig, ShardingRules

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    mlp="swiglu",
    norm="rmsnorm",
    qk_norm=True,
    moe_experts=128,
    moe_top_k=8,
    moe_d_ff=768,
    rope_theta=1_000_000.0,
    sharding=ShardingRules(experts=("model",)),
    source="hf:Qwen/Qwen3-30B-A3B",
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=128, moe_experts=4, moe_top_k=2, moe_d_ff=128,
        vocab_size=512, moe_capacity_factor=4.0, dtype="float32")
