"""RecurrentGemma-9B [arXiv:2402.19427 Griffin]: 38 temporal-mixing layers
with the Griffin 1:2 mix — one local-attention layer per two RG-LRU
recurrent layers, i.e. repeating pattern (rglru, rglru, local_attn).
38 = 12 full pattern groups + 2 tail rglru blocks (handled by the model's
tail-block path).  MQA (kv=1) local attention with window 2048, GeGLU MLP.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    mlp="geglu",
    norm="rmsnorm",
    layer_pattern=("rglru", "rglru", "local_attn"),
    window=2048,
    lru_width=4096,
    source="arXiv:2402.19427 (Griffin / RecurrentGemma)",
)


def smoke_config() -> ModelConfig:
    return CONFIG.with_(
        n_layers=4,          # 1 group + 1 tail rglru: exercises both paths
        d_model=256, n_heads=8, n_kv_heads=1, d_ff=512,
        lru_width=256, window=32, vocab_size=512, dtype="float32")
