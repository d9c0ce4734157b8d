"""Model configuration for every architecture family the framework serves.

A single ``ModelConfig`` dataclass describes dense, MoE, SSM, hybrid
(RG-LRU + local attention), encoder-decoder (audio) and VLM backbones.
The unified model in ``repro_torch.models.model`` interprets it; the per-arch
files in ``repro_torch.configs`` instantiate it with the assigned hyperparams.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical-axis -> mesh-axis mapping used by launch/dryrun.

    Each value is a mesh axis name (or tuple of axis names) or None
    (replicated).  ``repro_torch.utils.sharding.spec_for`` resolves these into
    PartitionSpecs, dropping axes that do not divide the dimension.
    """
    batch: Tuple[str, ...] = ("data",)
    heads: Tuple[str, ...] = ("model",)
    kv_heads: Tuple[str, ...] = ("model",)
    ffn: Tuple[str, ...] = ("model",)
    experts: Tuple[str, ...] = ()          # expert dim (qwen3-moe shards this)
    vocab: Tuple[str, ...] = ("model",)
    fsdp: Tuple[str, ...] = ()             # extra weight sharding axis (train)
    seq: Tuple[str, ...] = ()              # sequence sharding (long-context)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # --- block flavour ---------------------------------------------------
    mlp: str = "swiglu"             # swiglu | squared_relu | gelu | geglu | none
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    qkv_bias: bool = False
    qk_norm: bool = False           # qwen3-style per-head q/k rmsnorm
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0      # fraction of head_dim rotated (chatglm 0.5)
    pos_embedding: str = "rope"     # rope | learned | sinusoidal | none

    # --- layer pattern ---------------------------------------------------
    # Repeating pattern of temporal-mixing blocks.  n_layers must be a
    # multiple of len(layer_pattern).  Kinds: attn, local_attn, rglru, ssd.
    layer_pattern: Tuple[str, ...] = ("attn",)
    window: int = 0                 # local_attn window (recurrentgemma 2048)

    # --- MoE ---------------------------------------------------------------
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0               # per-expert hidden (qwen3 768, grok 32768)
    moe_capacity_factor: float = 1.25

    # --- SSM (Mamba2 SSD) --------------------------------------------------
    ssm_state: int = 0              # N (d_state)
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 64             # SSD chunk length (training/prefill)

    # --- RG-LRU (hybrid) -----------------------------------------------------
    lru_width: Optional[int] = None  # defaults to d_model
    lru_conv: int = 4

    # --- encoder-decoder (audio) ---------------------------------------------
    encoder_layers: int = 0
    encoder_len: int = 1500         # stub conv frontend emits this many frames
    cross_attention: bool = False

    # --- VLM -------------------------------------------------------------------
    num_patches: int = 0            # stub ViT emits this many patch embeddings

    # --- numerics / sharding ----------------------------------------------------
    dtype: str = "bfloat16"
    sharding: ShardingRules = dataclasses.field(default_factory=ShardingRules)
    source: str = ""                # citation for the config

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def pattern_len(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.pattern_len

    @property
    def tail_kinds(self) -> Tuple[str, ...]:
        """Blocks left over when n_layers % pattern_len != 0 (e.g.
        RecurrentGemma's 38 layers on a period-3 pattern -> 2 tail rglru
        blocks), executed after the scanned groups."""
        return self.layer_pattern[: self.n_layers % self.pattern_len]

    @property
    def d_inner(self) -> int:       # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def lru_dim(self) -> int:
        return self.lru_width if self.lru_width is not None else self.d_model

    @property
    def is_attention_free(self) -> bool:
        return all(k in ("ssd", "rglru") for k in self.layer_pattern)

    @property
    def supports_long_decode(self) -> bool:
        """True if decode state is sub-linear in context (SSM/window)."""
        return all(k in ("ssd", "rglru", "local_attn") for k in self.layer_pattern)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Rough parameter counts (used by the roofline's MODEL_FLOPS = 6·N·D) --
    def param_count(self, active_only: bool = False) -> int:
        emb = self.vocab_size * self.d_model
        total = emb if self.tie_embeddings else 2 * emb
        dm, hd = self.d_model, self.hd
        all_kinds = [self.layer_pattern[i % self.pattern_len]
                     for i in range(self.n_layers)]
        for kind in all_kinds:
            per = 0
            if kind in ("attn", "local_attn"):
                per += dm * (self.n_heads * hd) + dm * (2 * self.n_kv_heads * hd)
                per += (self.n_heads * hd) * dm
            elif kind == "rglru":
                w = self.lru_dim
                per += 2 * dm * w + w * dm + w * self.lru_conv + 2 * w
            elif kind == "ssd":
                di, n, g = self.d_inner, self.ssm_state, self.ssm_groups
                proj_in = 2 * di + 2 * g * n + self.ssm_heads
                per += dm * proj_in + di * dm
                per += (di + 2 * g * n) * self.ssm_conv
            # mlp
            if self.moe_experts:
                per += self.moe_experts * 3 * dm * self.moe_d_ff + dm * self.moe_experts
            elif self.mlp in ("swiglu", "geglu"):
                per += 3 * dm * self.d_ff
            elif self.mlp in ("squared_relu", "gelu"):
                per += 2 * dm * self.d_ff
            total += per
        if self.cross_attention:  # decoder cross-attn + encoder stack
            total += self.n_layers * (2 * dm * dm + 2 * dm * self.n_kv_heads * hd)
            total += self.encoder_layers * (4 * dm * dm + 2 * dm * self.d_ff)
        return int(total)

    def active_param_count(self) -> int:
        """Per-token active params (MoE activates top_k of moe_experts)."""
        if not self.moe_experts:
            return self.param_count()
        dense_like = self.param_count()
        moe_all = self.n_layers * self.moe_experts * 3 * self.d_model * self.moe_d_ff
        moe_act = self.n_layers * self.moe_top_k * 3 * self.d_model * self.moe_d_ff
        return int(dense_like - moe_all + moe_act)
