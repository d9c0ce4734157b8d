"""The benchmark's yardstick: the card's published peaks, a kernel call's
bound, and the operations and bytes that the real rows of a step need.

Nothing here reads the program: every count is worked out from the
shapes of a step's items (tokens fed, position of the first) and the
model's widths.  The bound and the attention counts are those of
``chip_smoke.py`` (``bound`` and ``time_kernels``), frozen here so that a
later change to the program cannot move the yardstick.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple

#: NVIDIA H100 SXM data sheet, dense (no sparsity), at a 700 W limit.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

#: An item of a step: (tokens fed, position of the first of them).
Item = Tuple[int, int]


def bound_s(n_bytes: float, flops: float,
            flops_per_s: float = BF16_FLOPS_PER_S) -> float:
    """The least time the card could take: the larger of the bytes over
    HBM bandwidth and the operations over the dense bf16 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / flops_per_s)


def decode_attention_call(items: Sequence[Item], H: int, KV: int, hd: int,
                          page: int, esz: int = 2) -> Tuple[float, float]:
    """(bytes, FLOPs) of one paged-decode call over the real rows: each
    row's query in and output out, the live K and V of its context read
    once, and its block table (one int32 a page and a length a row).  A
    row fed at position p attends to p + 1 keys."""
    ctxs = [p + t for t, p in items]
    ctx = sum(ctxs)
    tbl = sum(-(-c // page) for c in ctxs) * 4 + len(items) * 4
    n_bytes = 2 * len(items) * H * hd * esz + 2 * ctx * KV * hd * esz + tbl
    return float(n_bytes), float(4 * ctx * H * hd)


def prefill_attention_call(items: Sequence[Item], H: int, KV: int, hd: int,
                           esz: int = 2) -> Tuple[float, float]:
    """(bytes, FLOPs) of one chunked-prefill call over the real rows: the
    queries in and outputs out, each row's keys and values up to its last
    position read once, its offset; the causal score and value products
    of every real query over the keys it sees."""
    rows = sum(t for t, _ in items)
    keys = sum(o + t for t, o in items)
    visible = sum(t * o + t * (t + 1) // 2 for t, o in items)
    n_bytes = 2 * rows * H * hd * esz + 2 * keys * KV * hd * esz \
        + len(items) * 4
    return float(n_bytes), float(4 * visible * H * hd)


def model_flops(cfg, items: Iterable[Tuple[int, int, bool]]) -> float:
    """FLOPs that a step's real rows need through the model: the
    projections and MLP of every real token (for a mixture of experts
    only its ``moe_top_k`` routed experts and the router), the causal
    attention of each token over its context, and the output head for
    each row whose logits are taken.  ``items``: (tokens, first
    position, logits taken)."""
    d, hd = cfg["d_model"], cfg["head_dim"]
    H, KV, L = cfg["n_heads"], cfg["n_kv_heads"], cfg["n_layers"]
    proj = d * H * hd * 2 + d * KV * hd * 2
    if cfg.get("moe_experts"):
        mlp = cfg["moe_top_k"] * 3 * d * cfg["moe_d_ff"] + d * cfg["moe_experts"]
    else:
        mlp = 3 * d * cfg["d_ff"]
    total = 0.0
    for t, o, logits in items:
        visible = t * o + t * (t + 1) // 2
        total += L * (2 * t * (proj + mlp) + 4 * visible * H * hd)
        if logits:
            total += 2 * d * cfg["vocab_size"]
    return total
