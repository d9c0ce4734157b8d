"""Attention over the paged KV pool: the serving hot path of the port.

Mirrors the paged branch of ``repro.models.mixers.attention_fwd`` and
``_paged_attention_fwd``.  The dense / ring-buffer caches and the
full-sequence branch are a later slice (ROADMAP.md queue A item 9).

Unlike the functional reference, the chunk's K/V is written into the page
pool *in place* (``index_put_``): the pool tensors the caller passes are
updated and returned.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ops import (
    chunked_prefill_attention_op, gather_pages, gather_scales,
    paged_decode_attention_op, quantize_kv,
)
from repro_torch.kernels.ref import as_indexable
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, rms_head_norm, rope_tables


def _project_qkv(p, cfg: ModelConfig, xq, xkv):
    B, Tq, _ = xq.shape
    Tk = xkv.shape[1]
    # head counts come from the *parameter* widths, not the config, as in
    # the reference (whose tensor-parallel shards see a slice of the heads)
    hd = cfg.hd
    H = p["wq"].shape[-1] // hd
    KV = p["wk"].shape[-1] // hd
    q = xq @ p["wq"]
    k = xkv @ p["wk"]
    v = xkv @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, Tq, H, hd)
    k = k.reshape(B, Tk, KV, hd)
    v = v.reshape(B, Tk, KV, hd)
    if "q_norm" in p:
        q = rms_head_norm(p["q_norm"], q)
        k = rms_head_norm(p["k_norm"], k)
    return q, k, v


def _attn_out(y, p, cfg: ModelConfig):
    """Output projection (no tensor parallelism in this slice, so no
    cross-shard sum)."""
    return y @ p["wo"]


def paged_write_plan(batch_pos, block_tables, page_size: int,
                     active=None, token_mask=None) \
        -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Where the chunk's K/V rows go: ``(rows, phys, within)`` with
    ``rows`` the flat (b*T + t) indices of the tokens that are written,
    and ``phys``/``within`` their physical page and offset.

    Pad tokens (``token_mask`` False) and inactive slots are *left out*:
    the reference drops their writes by aiming them at the nonexistent
    page ``n_pages`` with ``mode="drop"``, and ``index_put_`` has no drop
    mode.  They must never land on page 0, a real and possibly shared
    page.  The plan is the same for every layer, so ``forward`` builds it
    once (one host sync per step)."""
    B, T = batch_pos.shape
    n_pp = block_tables.shape[1]
    logical = torch.div(batch_pos, page_size, rounding_mode="floor")
    within = batch_pos - logical * page_size
    phys = torch.gather(block_tables.long(), 1,
                        logical.clamp(0, n_pp - 1))
    wmask = torch.ones((B, T), dtype=torch.bool, device=batch_pos.device)
    if active is not None:
        wmask &= active.to(torch.bool)[:, None]
    if token_mask is not None:
        wmask &= token_mask
    rows = torch.nonzero(wmask.reshape(-1)).squeeze(1)
    return rows, phys.reshape(-1)[rows], within.reshape(-1)[rows]


def _paged_attention_fwd(p, q, k, v, cfg: ModelConfig, cache, batch_pos,
                         block_tables, page_size: int, active, token_mask,
                         plan=None):
    """Attention over a paged KV pool (the DynaServe serving hot path).

    The chunk's K/V is written in place into the physical pages the
    per-slot block table names (quantized on write for fp8/int8 pools),
    then attention dispatches to the kernels: single-token batches
    (decode, T == 1) read pages straight from the pool through
    ``paged_decode_attention`` with ``lengths = batch_pos[:, 0] + 1``;
    longer chunks (prefill / mixed) gather the slots' pages to a dense
    prefix and run ``chunked_prefill_attention`` with
    ``offsets = batch_pos[:, 0]``.  On CUDA tensors both are the
    hand-written kernels; on CPU tensors their plain versions.
    Returns (y_pre_wo, cache).
    """
    B, T = batch_pos.shape
    KV, hd = k.shape[2], k.shape[3]
    if plan is None:
        plan = paged_write_plan(batch_pos, block_tables, page_size,
                                active, token_mask)
    rows, phys, within = plan
    ck, cv = cache["k_pages"], cache["v_pages"]
    kw = k.reshape(B * T, KV, hd)[rows]
    vw = v.reshape(B * T, KV, hd)[rows]
    quantized = "k_scales" in cache
    if quantized:
        # quantize-on-write: fp8/int8 codes plus one f32 amax scale per
        # token row, written at the same (phys, within) coordinates
        prec = "int8" if ck.dtype == torch.int8 else "fp8"
        kq, ksc = quantize_kv(kw, prec)
        vq, vsc = quantize_kv(vw, prec)
        as_indexable(ck)[phys, within] = as_indexable(kq)
        as_indexable(cv)[phys, within] = as_indexable(vq)
        cks, cvs = cache["k_scales"], cache["v_scales"]
        cks[phys, within] = ksc
        cvs[phys, within] = vsc
    else:
        ck[phys, within] = kw.to(ck.dtype)
        cv[phys, within] = vw.to(cv.dtype)
        cks = cvs = None
    if T == 1:
        lengths = batch_pos[:, 0] + 1
        y = paged_decode_attention_op(q[:, 0], ck, cv, block_tables, lengths,
                                      cks, cvs)
        return y.reshape(B, 1, -1), cache
    offsets = batch_pos[:, 0]
    kg = gather_pages(ck, block_tables)
    vg = gather_pages(cv, block_tables)
    ksg = None if cks is None else gather_scales(cks, block_tables)
    vsg = None if cvs is None else gather_scales(cvs, block_tables)
    y = chunked_prefill_attention_op(q, kg, vg, offsets, ksg, vsg)
    return y.reshape(B, T, -1), cache


def attention_fwd(p, x, cfg: ModelConfig, *, kind: str = "attn",
                  cache: Optional[dict] = None, pos_offset=0,
                  active: Optional[torch.Tensor] = None,
                  token_mask: Optional[torch.Tensor] = None,
                  block_tables=None, page_size: int = 0,
                  rope=None, plan=None):
    """Self-attention over a paged cache.  Returns (y, cache).

    ``pos_offset`` may be an int or a per-request (B,) tensor (unified
    batches where each request sits at a different length).
    ``active``: optional (B,) bool — inactive slots write nothing.
    ``rope`` / ``plan``: the (sin, cos) tables and the page-write plan,
    which ``forward`` computes once for all layers; built here if absent.
    """
    if kind != "attn":
        raise NotImplementedError(f"{kind!r} mixers are not ported yet "
                                  f"(ROADMAP.md queue A item 9)")
    if cache is None or "k_pages" not in cache:
        raise NotImplementedError("only the paged KV path is ported; the "
                                  "dense cache and full-sequence branches "
                                  "are ROADMAP.md queue A item 9")
    assert block_tables is not None and page_size > 0, \
        "paged cache needs block_tables + page_size"
    B, T, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, x)
    batch_pos = _batch_positions(pos_offset, B, T, x.device)
    if cfg.pos_embedding == "rope":
        if rope is None:
            rope = rope_tables(batch_pos, cfg.hd, cfg.rope_theta,
                               cfg.rope_fraction)
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)
    elif cfg.pos_embedding != "none":
        raise NotImplementedError(f"pos_embedding={cfg.pos_embedding!r} "
                                  f"is not ported yet")
    y, cache = _paged_attention_fwd(
        p, q, k, v, cfg, cache, batch_pos, block_tables, page_size,
        active, token_mask, plan=plan)
    return _attn_out(y, p, cfg), cache


def _batch_positions(pos_offset, B: int, T: int, device) -> torch.Tensor:
    """(B, T) absolute positions from a scalar or (B,) offset."""
    po = torch.as_tensor(pos_offset, device=device).long()
    ar = torch.arange(T, device=device)
    if po.dim() == 0:
        return (po + ar)[None].expand(B, T)
    return po[:, None] + ar[None]
