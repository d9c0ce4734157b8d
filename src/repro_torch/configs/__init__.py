"""Architecture configs the port serves (the paged-KV dense path).

Each module ``repro_torch.configs.<id>`` exposes ``CONFIG`` and
``smoke_config()`` exactly as its ``repro.configs`` counterpart."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = ["qwen2_5_14b"]

_ALIASES = {"qwen2.5-14b": "qwen2_5_14b"}


def canonical(name: str) -> str:
    cid = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if cid not in ARCH_IDS:
        raise ValueError(f"{name!r} is not ported yet (ported: {ARCH_IDS}); "
                         f"see ROADMAP.md queue A")
    return cid


def get_config(name: str) -> ModelConfig:
    return importlib.import_module(f"repro_torch.configs.{canonical(name)}").CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return importlib.import_module(
        f"repro_torch.configs.{canonical(name)}").smoke_config()
