"""Architecture config registry.

Every assigned architecture is a module ``repro_torch.configs.<id>`` exposing
``CONFIG`` (the exact assigned hyperparameters, citation in ``source``)
and ``smoke_config()`` (a reduced same-family variant: <=2 pattern groups,
d_model<=512, <=4 experts) used by CPU smoke tests.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig
from repro_torch.configs.shapes import INPUT_SHAPES, InputShape  # noqa: F401

ARCH_IDS: List[str] = [
    "internvl2_76b",
    "chatglm3_6b",
    "phi4_mini_3_8b",
    "whisper_large_v3",
    "grok_1_314b",
    "nemotron_4_340b",
    "qwen3_moe_30b_a3b",
    "recurrentgemma_9b",
    "qwen1_5_32b",
    "mamba2_780m",
    # paper's own evaluation models (Qwen-2.5 series)
    "qwen2_5_14b",
    "qwen2_5_32b",
    "qwen2_5_72b",
]

ASSIGNED_ARCHS = ARCH_IDS[:10]

_ALIASES = {
    "internvl2-76b": "internvl2_76b",
    "chatglm3-6b": "chatglm3_6b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "whisper-large-v3": "whisper_large_v3",
    "grok-1-314b": "grok_1_314b",
    "nemotron-4-340b": "nemotron_4_340b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "qwen1.5-32b": "qwen1_5_32b",
    "mamba2-780m": "mamba2_780m",
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen2.5-32b": "qwen2_5_32b",
    "qwen2.5-72b": "qwen2_5_72b",
}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.smoke_config()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
