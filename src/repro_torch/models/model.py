"""The decoder forward of the paged-KV serving path.

Mirrors ``repro.models.model`` for full-attention decoders (dense or
MoE) served from a page pool: ``supports_paged_kv``, ``init_paged_cache``,
``forward(block_tables=...)`` and a torch-native ``init_params``.

Parameters are a plain dict: ``embed`` (vocab, d_model), ``layers`` (a
list with one dict per layer, the reference's per-group stacks unrolled:
layer ``g * len(pattern) + i`` is ``params["blocks"][i][g]`` there),
``final_norm`` and ``lm_head`` (d_model, vocab).  Weights keep the
reference's ``x @ W`` (in, out) orientation.  The page pools keep the
reference's ``(G, n_pages, page, KV, hd)`` layout per pattern position,
so exported pieces compare byte for byte, and are updated in place.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp_fwd, norm_fwd, rope_tables
from repro_torch.models.mixers import (
    _batch_positions, attention_fwd, paged_write_plan,
)
from repro_torch.utils.device import resolve_device, torch_dtype


# ==========================================================================
# parameter construction
# ==========================================================================
def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None):
    """Random weights with the structure the reference's ``init_params``
    builds, at ``cfg.dtype``, generated directly on ``device`` (CUDA
    unless the caller asks for the CPU).  Scales follow the reference's
    ``ParamFactory.dense``: ``1/sqrt(shape[0])`` (for an expert stack
    (E, in, out) that is ``1/sqrt(E)``), and 0.02 for ``embed``,
    ``lm_head`` and the MoE ``router``; biases start at 0 and norm scales
    at 1.  The numbers differ from JAX's for the same seed (another
    generator); tests that compare the two convert the JAX weights with
    ``convert``."""
    if not supports_paged_kv(cfg):
        raise NotImplementedError(
            f"{cfg.name} needs the dense slot cache or a recurrent, "
            f"encoder or frontend block, which are not ported yet: "
            f"ROADMAP.md queue A item 9")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    dt = torch_dtype(cfg.dtype)

    def dense(*shape, scale=None):
        if scale is None:
            scale = 1.0 / math.sqrt(shape[0])
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (w.mul_(scale)).to(dt)

    def zeros(n):
        return torch.zeros(n, dtype=dt, device=dev)

    def ones(n):
        return torch.ones(n, dtype=dt, device=dev)

    def norm():
        if cfg.norm == "layernorm":
            return {"scale": ones(dm), "bias": zeros(dm)}
        return {"scale": ones(dm)}

    def mlp():
        if cfg.moe_experts:
            E, mff = cfg.moe_experts, cfg.moe_d_ff
            return {"router": dense(dm, E, scale=0.02),
                    "wi": dense(E, dm, mff), "wg": dense(E, dm, mff),
                    "wo": dense(E, mff, dm)}
        if cfg.mlp in ("swiglu", "geglu"):
            return {"wi": dense(dm, ff), "wg": dense(dm, ff),
                    "wo": dense(ff, dm)}
        if cfg.mlp in ("squared_relu", "gelu"):
            return {"wi": dense(dm, ff), "wo": dense(ff, dm)}
        raise ValueError(cfg.mlp)

    dm, hd, H, KV, ff = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads, \
        cfg.d_ff
    params = {"embed": dense(cfg.vocab_size, dm, scale=0.02), "layers": []}
    for _ in range(cfg.n_layers):
        mixer = {"wq": dense(dm, H * hd), "wk": dense(dm, KV * hd),
                 "wv": dense(dm, KV * hd), "wo": dense(H * hd, dm)}
        if cfg.qkv_bias:
            mixer.update(bq=zeros(H * hd), bk=zeros(KV * hd),
                         bv=zeros(KV * hd))
        if cfg.qk_norm:
            mixer.update(q_norm=ones(hd), k_norm=ones(hd))
        layer = {"norm1": norm(), "mixer": mixer}
        if cfg.mlp != "none" or cfg.moe_experts:
            layer.update(norm2=norm(), mlp=mlp())
        params["layers"].append(layer)
    params["final_norm"] = norm()
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(dm, cfg.vocab_size, scale=0.02)
    return params


# ==========================================================================
# paged cache construction (block-table KV pool)
# ==========================================================================
def supports_paged_kv(cfg: ModelConfig) -> bool:
    """Paged KV applies to pure full-attention decoders: every layer's
    cache grows per token and positions are append-only."""
    return (all(k == "attn" for k in cfg.layer_pattern)
            and not cfg.tail_kinds
            and not cfg.cross_attention
            and not cfg.window
            and cfg.arch_type not in ("vlm", "audio"))


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     kv_precision=None, device=None):
    """Physical page pools, one dict per pattern position with leaves
    stacked over the G groups: ``k_pages``/``v_pages`` of shape
    (G, n_pages, page_size, KV, hd), plus (G, n_pages, page_size) f32
    ``k_scales``/``v_scales`` for a quantized (fp8/int8) pool.  Slots map
    logical positions to (page, offset) through the engine's block
    tables."""
    from repro_torch.core.precision import get_precision
    from repro_torch.kernels.ops import kv_storage_dtype

    if not supports_paged_kv(cfg):
        raise ValueError(f"{cfg.name}: layer pattern "
                         f"{cfg.layer_pattern} cannot use a paged KV cache")
    dev = resolve_device(device)
    G = cfg.n_groups
    prec = get_precision(kv_precision)
    dt = kv_storage_dtype(prec, default=torch_dtype(cfg.dtype))
    caches = []
    for _ in cfg.layer_pattern:
        shape = (G, n_pages, page_size, cfg.n_kv_heads, cfg.hd)
        c = {"k_pages": torch.zeros(shape, dtype=dt, device=dev),
             "v_pages": torch.zeros(shape, dtype=dt, device=dev)}
        if prec.quantized:
            c["k_scales"] = torch.zeros((G, n_pages, page_size),
                                        dtype=torch.float32, device=dev)
            c["v_scales"] = torch.zeros((G, n_pages, page_size),
                                        dtype=torch.float32, device=dev)
        caches.append(c)
    return {"blocks": tuple(caches)}


# ==========================================================================
# forward
# ==========================================================================
def forward(params, cfg: ModelConfig, tokens, *, cache=None, pos_offset=0,
            active=None, n_valid=None, last_only: bool = False,
            block_tables=None, page_size: int = 0):
    """Run the decoder stack over a paged cache.

    tokens: (B, T) int token ids.
    cache: from ``init_paged_cache``; written in place.
    pos_offset: absolute position of tokens[:, 0] (int or (B,) tensor).
    active: optional (B,) bool — inactive slots write no K/V.
    n_valid: optional (B,) valid-token counts; pad tokens write no K/V.
    last_only: project only each row's last valid position to vocab.
    block_tables: (B, pages_per_slot) int physical-page table.
    Returns (logits f32, cache, aux_loss): the MoE load-balance terms
    summed over layers, 0 for a dense model.
    """
    if cache is None or block_tables is None or page_size <= 0:
        raise NotImplementedError("only the paged-KV forward is ported; "
                                  "the dense and full-sequence forwards "
                                  "are ROADMAP.md queue A item 9")
    if cfg.tail_kinds or cfg.cross_attention or cfg.pos_embedding != "rope":
        raise NotImplementedError(f"{cfg.name}: tail, cross-attention and "
                                  f"non-RoPE models are not ported yet")
    dev = params["embed"].device
    dt = torch_dtype(cfg.dtype)
    x = params["embed"][tokens.long()].to(dt)
    B, T, _ = x.shape
    token_mask = None
    if n_valid is not None:
        token_mask = torch.arange(T, device=dev)[None] < n_valid[:, None]
    batch_pos = _batch_positions(pos_offset, B, T, dev)
    rope = rope_tables(batch_pos, cfg.hd, cfg.rope_theta, cfg.rope_fraction)
    plan = paged_write_plan(batch_pos, block_tables, page_size, active,
                            token_mask)

    aux_total = 0.0        # a dense MLP adds Python zeros: no launches
    pattern = cfg.layer_pattern
    for layer, bp in enumerate(params["layers"]):
        g, i = divmod(layer, len(pattern))
        bc = {key: pool[g] for key, pool in cache["blocks"][i].items()}
        h, _ = attention_fwd(
            bp["mixer"], norm_fwd(bp["norm1"], x, cfg.norm), cfg,
            kind=pattern[i], cache=bc, pos_offset=pos_offset, active=active,
            token_mask=token_mask, block_tables=block_tables,
            page_size=page_size, rope=rope, plan=plan)
        x = x + h
        if "mlp" in bp:
            h, aux = mlp_fwd(bp["mlp"], norm_fwd(bp["norm2"], x, cfg.norm),
                             cfg)
            x = x + h
            aux_total = aux_total + aux

    x = norm_fwd(params["final_norm"], x, cfg.norm)
    if last_only:
        idx = ((n_valid.long() - 1).clamp(min=0) if n_valid is not None
               else torch.full((B,), T - 1, device=dev, dtype=torch.long))
        x = x[torch.arange(B, device=dev), idx][:, None]
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head.to(x.dtype)).float()
    return logits, cache, torch.as_tensor(aux_total, dtype=torch.float32,
                                          device=dev)
