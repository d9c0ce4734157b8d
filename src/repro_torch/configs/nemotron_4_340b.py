"""Nemotron-4-340B [arXiv:2402.16819]: 96L, d_model=18432, 96H GQA(kv=8),
squared-ReLU MLP, layernorm.  Largest assigned arch: weights FSDP-shard
over the data axis in addition to tensor parallelism."""
from repro_torch.models.config import ModelConfig, ShardingRules

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    arch_type="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    mlp="squared_relu",
    norm="layernorm",
    rope_fraction=0.5,
    sharding=ShardingRules(fsdp=("data",)),
    source="arXiv:2402.16819 (Nemotron-4)",
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, d_ff=512,
        vocab_size=512, dtype="float32")
