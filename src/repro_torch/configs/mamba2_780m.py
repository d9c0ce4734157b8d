"""Mamba2-780M [arXiv:2405.21060]: 48 attention-free SSD blocks,
d_model=1536, d_state=128, expand=2 (d_inner=3072), head_dim=64
(48 SSM heads), depthwise conv k=4, no MLP (the SSD block IS the layer)."""
from repro_torch.models.config import ModelConfig, ShardingRules

CONFIG = ModelConfig(
    name="mamba2-780m",
    arch_type="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,              # attention-free; SSM heads derived below
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    mlp="none",
    norm="rmsnorm",
    pos_embedding="none",
    tie_embeddings=True,
    layer_pattern=("ssd",),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_conv=4,
    sharding=ShardingRules(heads=("model",), ffn=("model",)),
    source="arXiv:2405.21060 (Mamba-2 / SSD)",
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(
        n_layers=2, d_model=256, ssm_state=32, ssm_head_dim=32,
        vocab_size=512, dtype="float32")
