"""Parallelism bookkeeping the cost model reads.

Only the mesh-free part of ``repro.utils.sharding`` is carried over: the
rest builds ``jax.sharding`` specs, and tensor parallelism is a later
slice of the port (ROADMAP.md queue A item 10).  The three definitions
below are verbatim copies of the reference."""
from __future__ import annotations

import dataclasses
import warnings
from typing import Set

_warned: Set[tuple] = set()


def _warn_once(key: tuple, msg: str) -> None:
    if key in _warned:
        return
    _warned.add(key)
    warnings.warn(msg, stacklevel=3)


@dataclasses.dataclass(frozen=True)
class AchievedParallelism:
    """Per-model-dimension parallel degree actually reached at a
    requested TP width (a dim that the width does not divide is
    replicated, degree 1 — it gets *no* speedup)."""
    requested: int
    heads: int         # attention q/o projections
    kv_heads: int      # k/v projections + the KV cache itself
    ffn: int           # dense MLP hidden dim
    experts: int       # MoE expert dim (1 on dense archs)


def achieved_parallelism(cfg, n: int) -> "AchievedParallelism":
    """Degrees each shardable dimension of ``cfg`` reaches at TP width
    ``n`` under the divisibility rule above (no mesh needed).  Emits the
    same one-time replication warning as ``best_divisible_axes``."""
    def ach(dim: int, what: str) -> int:
        if n <= 1 or dim <= 0:
            return 1
        if dim % n == 0:
            return n
        _warn_once(
            ("tp", what, n, dim),
            f"{cfg.name}: {what}={dim} is not divisible by "
            f"devices_per_instance={n}; the {what} dimension is "
            f"replicated (achieved degree 1) and gets no TP speedup")
        return 1

    moe = bool(getattr(cfg, "moe_experts", 0))
    return AchievedParallelism(
        requested=max(1, n),
        heads=ach(cfg.n_heads, "n_heads"),
        kv_heads=ach(cfg.n_kv_heads, "n_kv_heads"),
        ffn=ach(getattr(cfg, "d_ff", 0) or 0, "d_ff") if not moe else 1,
        experts=ach(cfg.moe_experts, "moe_experts") if moe else 1,
    )
