"""Temporal-mixing blocks: (local/full) GQA attention, Mamba2 SSD, RG-LRU.

Mirrors ``repro.models.mixers`` function for function, with the same
calling convention::

    y, new_cache = mixer_fwd(kind, params, x, cfg, cache=..., pos_offset=...)

* ``cache=None``      -> full-sequence prefill (causal), no state kept.
* ``cache={...}``     -> serving: write this chunk's state into the cache at
                         ``pos_offset`` and attend over everything cached so
                         far.  Decode is simply a chunk of length 1.

Attention caches are either a page pool (``k_pages``, the paged serving
path, through the hand-written kernels) or a dense slot cache that stores
absolute token positions per slot (``pos``, -1 = empty), so full and
sliding-window (ring-buffer) caches share one masking rule:
``valid = 0 <= kpos <= qpos  and  qpos - kpos < window``.

Unlike the functional reference, caches are written *in place*: the
tensors of the dict the caller passes are updated and the dict returned.
The dense attention, the SSD scan, the RG-LRU recurrence and the causal
convolution are plain PyTorch ops, as they are plain ``jnp`` (no Pallas
kernel) in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import (
    packed_prefill_attention_op, paged_decode_attention_op,
    paged_prefill_attention_op, quantize_kv, scatter_rows,
)
from repro_torch.kernels.ref import as_indexable
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    _gelu, apply_rope, rms_head_norm, rope_tables,
)
from repro_torch.models.tp import all_gather, all_reduce, tp_axis, tp_rank

NEG_INF = -1e30

# Below this KV length the materialized (T, S) scores are used instead of
# the block-streamed online softmax; ``FLASH_BLOCK`` keys a tile.  The
# reference's values, as module attributes that tests may set (the
# reference binds ``FLASH_BLOCK`` as ``_flash_gqa``'s default when the
# module loads, and so does the port).
FLASH_MIN_KV = 2048
FLASH_BLOCK = 1024


# ==========================================================================
# Attention (full / local window, GQA, optional qkv bias / qk-norm / cross)
# ==========================================================================
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
    """Output projection; in a sharded step a ``wo`` split over its rows
    (first dim < global H*hd) produces partial sums that are summed over
    the shards so the residual add sees replicated values.  Its rows are
    the shard's heads, or, where every shard attended with every query
    head (the sequence-sharded decode), the shard's slice of the whole
    output.  A replicated ``wo`` (heads didn't divide the width) must not
    be summed."""
    wo = p["wo"]
    if tp_axis() is None or wo.shape[0] == cfg.n_heads * cfg.hd:
        return y @ wo
    if y.shape[-1] != wo.shape[0]:
        y = y.narrow(-1, tp_rank() * wo.shape[0], wo.shape[0])
    return all_reduce(y @ wo)


def _shard_kv(cfg: ModelConfig, q, k, v):
    """``k``, ``v`` narrowed to the KV heads this shard's query heads
    attend with, where a sharded step split the query heads but kept
    every KV head (the group does not divide the KV heads): the shard's
    query heads lie within one KV head's group, or hold whole groups."""
    group = tp_axis()
    H, KV = q.shape[2], k.shape[2]
    if (group is None or group.n == 1 or H * group.n != cfg.n_heads
            or KV != cfg.n_kv_heads):
        return k, v
    qpk = cfg.n_heads // KV
    if qpk % H and H % qpk:
        raise ValueError(f"{H} query heads a shard straddle groups of "
                         f"{qpk} query heads a KV head")
    first, count = tp_rank() * H // qpk, max(1, H // qpk)
    return k.narrow(2, first, count), v.narrow(2, first, count)


def _gqa_scores_to_out(cfg: ModelConfig, q, k, v, mask):
    """q: (B,Tq,H,hd); k,v: (B,S,KV,hd); mask: (B,Tq,S) bool or None.

    The scores are taken in the operands' dtype and then widened to f32,
    and the softmax weights narrowed to v's dtype, as in the reference."""
    k, v = _shard_kv(cfg, q, k, v)
    B, Tq, H, hd = q.shape
    KV = k.shape[2]
    qpk = H // KV
    qg = q.reshape(B, Tq, KV, qpk, hd)
    scores = torch.einsum("btkgh,bskh->bkgts", qg, k).float()
    scores = scores / math.sqrt(hd)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskh->btkgh", w, v)
    return out.reshape(B, Tq, H * hd)


def _flash_gqa(cfg: ModelConfig, q, k, v, qpos, kpos, window: int = 0,
               block: int = FLASH_BLOCK, extra=None,
               return_stats: bool = False):
    """Block-streamed online-softmax attention: K/V are consumed in
    ``block``-key tiles with running (m, l, acc) statistics, so the
    (Tq, S) score matrix is never materialized.

    q: (B,Tq,H,hd); k,v: (B,S,KV,hd); qpos: (B,Tq); kpos: (B,S) with -1
    marking invalid slots.  Causal: attend iff 0 <= kpos <= qpos (and
    within ``window`` if set).  ``extra`` = (k, v, pos) is an in-flight
    tile taken after the cached ones (the decode token's own K/V, not yet
    appended).  ``return_stats`` returns (m, l, acc) instead of the
    output.

    The products take the storage-dtype operands widened to f32 and keep
    f32 results, which is what the reference's
    ``preferred_element_type=f32`` computes.  The last tile is padded to
    ``block`` with zero K/V at position -1, as in the reference: a row
    with no visible key then averages V over the padded tile too.
    A shard that holds a slice of the query heads and every KV head
    attends with its own KV heads (``_shard_kv``)."""
    k, v = _shard_kv(cfg, q, k, v)
    if extra is not None:
        extra = (*_shard_kv(cfg, q, extra[0], extra[1]), extra[2])
    B, Tq, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    qpk = H // KV
    block = min(block, S)
    nb = -(-S // block)
    # a CPU scalar in q's dtype: a CUDA op takes it by value, so nothing
    # is copied from the host inside a step
    scale = torch.tensor(1.0 / np.sqrt(hd), dtype=q.dtype)
    qg = (q * scale).reshape(B, Tq, KV, qpk, hd).float()
    f32, dev = torch.float32, q.device
    m = torch.full((B, KV, qpk, Tq), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros((B, KV, qpk, Tq), dtype=f32, device=dev)
    acc = torch.zeros((B, KV, qpk, Tq, hd), dtype=f32, device=dev)

    def tile(m, l, acc, kb, vb, kpb):
        s = torch.einsum("btkgh,bskh->bkgts", qg, kb.float())  # (B,KV,g,Tq,bk)
        ok = (kpb[:, None, :] >= 0) & (kpb[:, None, :] <= qpos[:, :, None])
        if window:
            ok &= (qpos[:, :, None] - kpb[:, None, :]) < window
        s = torch.where(ok[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + p.sum(dim=-1)
        acc_new = acc * alpha[..., None] + torch.einsum(
            "bkgts,bskh->bkgth", p.to(v.dtype).float(), vb.float())
        return m_new, l_new, acc_new

    for i in range(nb):
        kb = k[:, i * block:(i + 1) * block]
        vb = v[:, i * block:(i + 1) * block]
        kpb = kpos[:, i * block:(i + 1) * block]
        pad = block - kb.shape[1]
        if pad:
            kb = F.pad(kb, (0, 0, 0, 0, 0, pad))
            vb = F.pad(vb, (0, 0, 0, 0, 0, pad))
            kpb = F.pad(kpb, (0, pad), value=-1)
        m, l, acc = tile(m, l, acc, kb, vb, kpb)
    if extra is not None:
        m, l, acc = tile(m, l, acc, *extra)
    if return_stats:
        return m, l, acc
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.movedim(3, 1).reshape(B, Tq, H * hd)       # (B,Tq,KV,g,hd)
    return out.to(q.dtype)


def _seq_shard():
    """(n, rank) of the sequence-sharded cache this thread's shard holds,
    or None.  A group made with ``seq_shard`` (the dryrun's, for a dense
    cache whose KV heads the model axis does not divide) gives each shard
    positions ``[rank * S_buf, (rank + 1) * S_buf)`` of the whole buffer
    (ring slots, for a ring buffer).  Decode then runs flash-decoding
    over the shard's slice, merged over the group
    (``_flash_decode_seqsharded``); a full-prompt prefill keeps the
    shard's slice of the chunk's K/V, and another chunk of more than 8
    tokens writes the shard's slots and attends over the buffer gathered
    from the group.  The reference constrains a
    prefill's cache to the same sharding instead (``_constrain_cache``,
    an XLA sharding constraint the port's explicit shard shapes make
    unnecessary)."""
    group = tp_axis()
    if group is None or not group.seq_shard:
        return None
    return group.n, tp_rank()


def _flash_decode_seqsharded(cfg: ModelConfig, q, k, v, qpos, kpos,
                             window: int, extra):
    """Flash-decoding over a cache whose sequence dim is sharded over the
    group: this shard's (m, l, acc) over its slice of the cache
    (``_flash_gqa(return_stats=True)``), merged over the group with a max
    and two sums (the reference's ``pmax`` / ``psum``); the in-flight
    (unappended) tile ``extra`` = (k, v, pos) joins once, after the merge,
    with its scores taken in f32 and then scaled, as in the reference.
    q: (B,Tq,H,hd) replicated over the group (every query head: the
    merge sums statistics of the same heads); k, v: (B,S_local,KV,hd);
    kpos: (B,S_local).  Returns (B,Tq,H*hd) in q's dtype."""
    if q.shape[2] != cfg.n_heads:
        raise ValueError(f"the sequence-sharded decode takes every query "
                         f"head on each shard: {q.shape[2]} of "
                         f"{cfg.n_heads}")
    B, Tq, H, hd = q.shape
    KV = k.shape[2]
    qpk = H // KV
    m, l, acc = _flash_gqa(cfg, q, k, v, qpos, kpos, window=window,
                           return_stats=True)
    m_g = all_reduce(m, op="max")
    corr = torch.exp(m - m_g)
    l_g = all_reduce(l * corr)
    acc_g = all_reduce(acc * corr[..., None])
    if extra is not None:
        ek, ev, epos = extra
        s = torch.einsum("btkgh,bskh->bkgts",
                         q.reshape(B, Tq, KV, qpk, hd).float(), ek.float())
        s = s / math.sqrt(hd)
        ok = (epos[:, None, :] >= 0) & (epos[:, None, :] <= qpos[:, :, None])
        s = torch.where(ok[:, None, None], s, NEG_INF)
        m_n = torch.maximum(m_g, s.amax(dim=-1))
        pw = torch.exp(s - m_n[..., None])
        alpha = torch.exp(m_g - m_n)
        l_g = l_g * alpha + pw.sum(dim=-1)
        acc_g = acc_g * alpha[..., None] + torch.einsum(
            "bkgts,bskh->bkgth", pw.to(ev.dtype).float(), ev.float())
    out = acc_g / torch.clamp(l_g, min=1e-30)[..., None]
    out = out.movedim(3, 1).reshape(B, Tq, H * hd)       # (B,Tq,KV,g,hd)
    return out.to(q.dtype)


def paged_write_plan(batch_pos, block_tables, page_size: int, n_pages: int,
                     active=None, token_mask=None) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """Where the chunk's K/V rows go: ``(phys, within)``, the physical
    page and offset of every flat (b*T + t) token, B*T of each whatever
    the masks are, so nothing is read back from the device.

    Pad tokens (``token_mask`` False) and inactive slots write nothing:
    their page is ``n_pages``, which the write takes to the pool's scratch
    page (``model.cache_leaf`` allocates it after the pool's pages), as
    the reference aims them at the nonexistent page ``n_pages`` with
    ``mode="drop"``.  They must
    never land on page 0, a real and possibly shared page.  The plan is
    the same for every layer, so ``forward`` builds it once."""
    n_pp = block_tables.shape[1]
    logical = torch.div(batch_pos, page_size, rounding_mode="floor")
    within = batch_pos - logical * page_size
    phys = torch.gather(block_tables.long(), 1,
                        logical.clamp(0, n_pp - 1))
    wmask = _write_mask(*batch_pos.shape, batch_pos.device, active,
                        token_mask)
    phys = torch.where(wmask, phys, n_pages)
    return phys.reshape(-1), within.reshape(-1)


@dataclasses.dataclass
class PackedRows:
    """A paged engine's step with its tokens packed into one stream of N
    rows (``engine.layout.RowLayout``), as the forward reads it.
    ``slot`` and ``pos`` (N,): each row's slot and absolute position;
    ``last`` (B,): the row of each slot's last token; ``valid`` (N,): the
    rows that hold a token (a pad row writes nothing); ``slots`` (4, B)
    int32: each slot's pos_offset, n_valid, active and last, the engine's
    own block, as the packed attention op takes them; ``T``: the query
    rows a slot takes in the attention, 1 for the decode-only step (one
    token a slot, row b is slot b: the paged-decode kernel), else the
    chunk length of the (B, T) layout the op scatters the rows to where
    the packed-row body does not take them; ``dest`` (N,): each row's
    place in that layout (``ops.scatter_rows``), B * T for a row that
    holds no token, built once a step."""
    slot: torch.Tensor
    pos: torch.Tensor
    last: torch.Tensor
    valid: torch.Tensor
    slots: torch.Tensor
    T: int
    dest: torch.Tensor


def packed_rows(slot, pos, slots, T: int) -> PackedRows:
    """The ``PackedRows`` of a step from its per-row ``slot`` and ``pos``
    (N,) int tensors and its (4, B) int32 per-slot block ``slots``
    (pos_offset, n_valid, active and last), kept as it is.  A slot's
    tokens are the ``n_valid`` rows that end at its ``last``; every other
    row (a pad, or any row of a step whose slots are all inactive, such
    as the all-zero inputs of a graph's warm-up) is invalid, whatever its
    slot and position say."""
    dest = scatter_rows(slots, slot.shape[0], T)
    return PackedRows(slot.long(), pos.long(), slots[3].long(),
                      dest < slots.shape[1] * T, slots, T, dest)


def rows_write_plan(rows: PackedRows, block_tables, page_size: int,
                    n_pages: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``paged_write_plan`` for packed rows: the physical page and offset
    of each of the N rows, page ``n_pages`` (the scratch page) for a row
    that holds no token."""
    n_pp = block_tables.shape[1]
    logical = torch.div(rows.pos, page_size, rounding_mode="floor")
    within = rows.pos - logical * page_size
    phys = block_tables.long()[rows.slot, logical.clamp(0, n_pp - 1)]
    return torch.where(rows.valid, phys, n_pages), within


def dense_write_plan(batch_pos, S_buf: int, ring: int = 0, active=None,
                     token_mask=None, base: int = 0):
    """Where the chunk's K/V rows go in a dense slot cache of ``S_buf``
    slots a row: the flat destination ``b * S_buf + slot`` of every flat
    (b*T + t) token, B*T of them whatever the masks are, with ``slot =
    pos % ring`` for a ring buffer (``ring`` = its window) and ``pos``
    otherwise, less ``base`` (the first slot a shard of a
    sequence-sharded cache holds).

    The reference scatters with ``mode="drop"``: masked tokens (pads,
    inactive slots) and positions outside the buffer write nothing.
    Here they aim at ``B * S_buf``, which the write takes to the scratch
    row that ``model.cache_leaf`` allocates after the cache's rows.  A chunk
    longer than the ring maps positions ``p`` and ``p + ring`` to one
    slot; XLA applies such duplicate updates in order, so the last one
    wins, while ``index_put_`` leaves the winner open.  So only the last
    valid writer of each (row, slot) keeps its slot, found by a
    max-reduction, which no write order can change; the others go to the
    scratch row too.

    A ``meta`` chunk (the dryrun's) holds no positions to test: with no
    mask it is taken as whole and inside the buffer, as the dryrun's
    chunks are (a full prompt from 0, or one token a slot), and its plan
    is ``(b, t, slot)`` of the tokens written, built without reading a
    position (``_whole_chunk_plan``)."""
    if active is None and token_mask is None \
            and batch_pos.device.type == "meta":
        return _whole_chunk_plan(batch_pos, ring, base)
    B, T = batch_pos.shape
    dev = batch_pos.device
    slots = (batch_pos % ring if ring else batch_pos) - base
    wmask = _write_mask(B, T, dev, active, token_mask) \
        & (slots >= 0) & (slots < S_buf)
    t = torch.arange(T, device=dev).expand(B, T)
    target = torch.where(wmask, slots, S_buf)
    last = torch.full((B, S_buf + 1), -1, dtype=torch.long, device=dev)
    last.scatter_reduce_(1, target, torch.where(wmask, t, -1), "amax")
    keep = wmask & (last.gather(1, target) == t)
    rows = torch.arange(B, device=dev)[:, None] * S_buf + slots
    return torch.where(keep, rows, B * S_buf).reshape(-1)


def _whole_chunk_plan(batch_pos, ring: int = 0, base: int = 0) \
        -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The written ``(b, t, slot)`` of a chunk whose every token is
    written and inside the buffer, with no data read: every (b, t) in
    row-major order, or for a chunk longer than the ring each row's last
    ``ring`` tokens (a row's positions are consecutive, so those are each
    slot's last writer)."""
    B, T = batch_pos.shape
    dev = batch_pos.device
    keep = min(T, ring) if ring else T
    b = torch.arange(B, device=dev).repeat_interleave(keep)
    t = torch.arange(T - keep, T, device=dev).repeat(B)
    pos = batch_pos[b, t]
    return b, t, (pos % ring if ring else pos) - base


def _scratch_rows(t, row_dims: int, index):
    """One layer's cache leaf ``t`` (rows..., rest...) and a write plan's
    ``index`` of its flattened rows, where ``n_rows`` marks a row that
    writes nothing, as (the leaf's whole storage as a (N + 1, rest...)
    tensor of rows, the plan's index into it): ``t``'s rows at their
    offset, the others at N, the scratch row ``model.cache_leaf``
    allocated after every group's rows.  Raises for a leaf built without
    one (a row past its end may be another layer's data)."""
    n, rest = math.prod(t.shape[:row_dims]), t.shape[row_dims:]
    per_row = math.prod(rest)
    base = t if t._base is None else t._base
    off = t.storage_offset() - base.storage_offset()
    if not (t.is_contiguous() and base.is_contiguous()
            and tuple(base.shape[1:]) == tuple(rest) and off % per_row == 0
            and off // per_row + n < base.shape[0]):
        raise ValueError(f"a cache leaf of shape {tuple(t.shape)} has no "
                         f"scratch row: build caches with init_cache / "
                         f"init_paged_cache (model.cache_leaf)")
    scratch = base.shape[0] - 1
    return base, torch.where(index < n, index + off // per_row, scratch)


def _write_mask(B: int, T: int, device, active, token_mask):
    wmask = torch.ones((B, T), dtype=torch.bool, device=device)
    if active is not None:
        wmask &= active.to(torch.bool)[:, None]
    if token_mask is not None:
        wmask &= token_mask
    return wmask


def _paged_attention_fwd(q, k, v, cache, batch_pos, block_tables, plan,
                         rows: Optional[PackedRows] = None):
    """Attention over a paged KV pool (the DynaServe serving hot path).

    The chunk's K/V is written in place into the physical pages the
    per-slot block table names (quantized on write for fp8/int8 pools),
    then attention dispatches to the kernels: single-token batches
    (decode, T == 1) read pages straight from the pool through
    ``paged_decode_attention`` with ``lengths = batch_pos[:, 0] + 1``;
    longer chunks (prefill / mixed) gather the slots' pages to a dense
    prefix and run ``chunked_prefill_attention`` with
    ``offsets = batch_pos[:, 0]`` (``paged_prefill_attention_op``).  On
    CUDA tensors both are the hand-written kernels; on CPU tensors their
    plain versions.

    With ``rows`` (a paged engine's packed step) q, k and v are (1, N,
    heads, hd), one row a token: the decode-only step (``rows.T == 1``)
    runs the paged-decode kernel on its rows, one a slot; any other step
    runs ``packed_prefill_attention_op`` on its rows (on the card, bf16
    rows over a bf16 pool read the pages through the block tables).
    ``plan`` is the write plan (``paged_write_plan``, or
    ``rows_write_plan`` for ``rows``) that ``attention_fwd`` builds once a
    step.  Returns (y_pre_wo, cache).
    """
    B, T = batch_pos.shape
    KV, hd = k.shape[2], k.shape[3]
    ck, cv = cache["k_pages"], cache["v_pages"]
    phys, within = plan
    kw = k.reshape(B * T, KV, hd)
    vw = v.reshape(B * T, KV, hd)

    def put(leaf, src):
        # every row written, the dropped ones to the scratch page
        flat, at = _scratch_rows(leaf, 1, phys)
        as_indexable(flat)[at, within] = as_indexable(src.to(leaf.dtype))

    quantized = "k_scales" in cache
    if quantized:
        # quantize-on-write: fp8/int8 codes plus one f32 amax scale per
        # token row, written at the same (phys, within) coordinates
        prec = "int8" if ck.dtype == torch.int8 else "fp8"
        kq, ksc = quantize_kv(kw, prec)
        vq, vsc = quantize_kv(vw, prec)
        cks, cvs = cache["k_scales"], cache["v_scales"]
        for leaf, src in ((ck, kq), (cv, vq), (cks, ksc), (cvs, vsc)):
            put(leaf, src)
    else:
        put(ck, kw)
        put(cv, vw)
        cks = cvs = None
    if (T if rows is None else rows.T) == 1:
        # one query a slot (the decode rung's row b is slot b), at the
        # row's own position
        y = paged_decode_attention_op(q.reshape(B * T, *q.shape[2:]), ck, cv,
                                      block_tables, batch_pos.reshape(-1) + 1,
                                      cks, cvs)
    elif rows is not None:
        y = packed_prefill_attention_op(q[0], ck, cv, block_tables, rows.slots,
                                        rows.T, rows.dest, cks, cvs)
    else:
        y = paged_prefill_attention_op(q, ck, cv, block_tables,
                                       batch_pos[:, 0], cks, cvs)
    return y.reshape(B, T, -1), cache


def attention_fwd(p, x, cfg: ModelConfig, *, kind: str = "attn",
                  cache: Optional[dict] = None, pos_offset=0,
                  window_override: Optional[int] = None,
                  active: Optional[torch.Tensor] = None,
                  token_mask: Optional[torch.Tensor] = None,
                  valid_len: Optional[torch.Tensor] = None,
                  append_external: bool = False,
                  block_tables=None, page_size: int = 0,
                  rope=None, plans: Optional[dict] = None,
                  rows: Optional[PackedRows] = None):
    """Self-attention. Returns (y, new_cache).

    ``pos_offset`` may be an int or a per-request (B,) tensor (unified
    batches where each request sits at a different length).
    ``active``: optional (B,) bool — inactive slots write nothing.
    ``block_tables`` (with a paged cache holding ``k_pages``/``v_pages``)
    selects the paged-attention path.  ``append_external`` leaves a dense
    cache untouched and returns the chunk's K/V and positions as deltas.
    ``rope``: the (sin, cos) tables of the cached path's positions, and
    ``plans``: a dict in which the cache-write plans are kept; ``forward``
    shares both across layers, and they are built here if absent.
    ``rows``: a paged engine's packed step (``PackedRows``); x is then
    (1, N, d_model), one row a token, and ``pos_offset``, ``active`` and
    ``token_mask`` are not read.
    """
    B, T, _ = x.shape
    window = window_override if window_override is not None else (
        cfg.window if kind == "local_attn" else 0)
    q, k, v = _project_qkv(p, cfg, x, x)
    plans = {} if plans is None else plans

    if cache is None:
        positions = torch.arange(T, device=x.device)
        if cfg.pos_embedding == "rope":
            sin, cos = rope_tables(positions, cfg.hd, cfg.rope_theta,
                                   cfg.rope_fraction)
            q = apply_rope(q, sin, cos)
            k = apply_rope(k, sin, cos)
        if T >= FLASH_MIN_KV:
            pos_b = positions[None].expand(B, T)
            y = _flash_gqa(cfg, q, k, v, pos_b, pos_b, window=window)
            return _attn_out(y, p, cfg), None
        qpos = positions[:, None]
        kpos = positions[None, :]
        m = kpos <= qpos
        if window:
            m &= (qpos - kpos) < window
        y = _gqa_scores_to_out(cfg, q, k, v, m[None].expand(B, T, T))
        return _attn_out(y, p, cfg), None

    # ---- cached path (prefill chunk / decode) -----------------------------
    batch_pos = (rows.pos[None] if rows is not None
                 else _batch_positions(pos_offset, B, T, x.device))
    if cfg.pos_embedding == "rope":
        if rope is None:
            rope = rope_tables(batch_pos, cfg.hd, cfg.rope_theta,
                               cfg.rope_fraction)
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)

    if "k_pages" in cache:
        assert block_tables is not None and page_size > 0, \
            "paged cache needs block_tables + page_size"
        if "paged" not in plans:
            n_pages = cache["k_pages"].shape[0]
            plans["paged"] = (
                rows_write_plan(rows, block_tables, page_size, n_pages)
                if rows is not None else
                paged_write_plan(batch_pos, block_tables, page_size,
                                 n_pages, active, token_mask))
        y, cache = _paged_attention_fwd(q, k, v, cache, batch_pos,
                                        block_tables, plans["paged"], rows)
        return _attn_out(y, p, cfg), cache

    seq = _seq_shard()
    if append_external:
        # the cache is read-only here; the chunk's K/V rides as an
        # in-flight flash tile and comes back as a delta to append
        if seq is not None:
            y = _flash_decode_seqsharded(cfg, q, cache["k"], cache["v"],
                                         batch_pos, cache["pos"], window,
                                         (k, v, batch_pos))
        else:
            y = _flash_gqa(cfg, q, cache["k"], cache["v"], batch_pos,
                           cache["pos"], window=window,
                           extra=(k, v, batch_pos))
        return _attn_out(y, p, cfg), {"k_delta": k, "v_delta": v,
                                      "pos_delta": batch_pos}
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    S_buf = ck.shape[1]
    n_seq, rank = seq or (1, 0)
    base = rank * S_buf                 # this shard's first slot
    # Full-prompt prefill (pos_offset statically 0, chunk covers the whole
    # buffer): the chunk IS the cache (a sequence shard keeps its slice)
    if (T == S_buf * n_seq and isinstance(pos_offset, int)
            and pos_offset == 0 and active is None and token_mask is None):
        ck.copy_(k[:, base:base + S_buf])
        cv.copy_(v[:, base:base + S_buf])
        cpos.copy_(batch_pos[:, base:base + S_buf])
        kk, vv, kp = (ck, cv, cpos) if seq is None else (k, v, batch_pos)
        if T >= FLASH_MIN_KV:
            y = _flash_gqa(cfg, q, kk, vv, batch_pos, kp, window=window)
        else:
            qp = batch_pos[:, :, None]
            mask = kp[:, None, :] <= qp
            if window:
                mask &= (qp - kp[:, None, :]) < window
            y = _gqa_scores_to_out(cfg, q, kk, vv, mask)
        return _attn_out(y, p, cfg), cache
    ring = window if (window and S_buf * n_seq == window) else 0
    key = ("dense", S_buf, ring, base)
    if key not in plans:
        plans[key] = dense_write_plan(batch_pos, S_buf, ring, active,
                                      token_mask, base)
    plan = plans[key]
    if isinstance(plan, tuple):          # a meta chunk's (b, t, slot)
        b, t, slot = plan
        ck[b, slot] = k[b, t].to(ck.dtype)
        cv[b, slot] = v[b, t].to(cv.dtype)
        cpos[b, slot] = batch_pos[b, t].to(cpos.dtype)
    else:
        for leaf, src in ((ck, k.flatten(0, 1)), (cv, v.flatten(0, 1)),
                          (cpos, batch_pos.reshape(-1))):
            rows, at = _scratch_rows(leaf, 2, plan)
            rows[at] = src.to(leaf.dtype)

    if seq is not None:
        if T <= 8:          # decode, as the reference's criterion reads
            y = _flash_decode_seqsharded(cfg, q, ck, cv, batch_pos, cpos,
                                         window, None)
            return _attn_out(y, p, cfg), cache
        # a longer chunk attends over the whole buffer, gathered
        ck, cv, cpos = (all_gather(t, 1) for t in (ck, cv, cpos))
    if ck.shape[1] >= FLASH_MIN_KV:
        y = _flash_gqa(cfg, q, ck, cv, batch_pos, cpos, window=window)
        return _attn_out(y, p, cfg), cache
    qpos = batch_pos[:, :, None]                        # (B, T, 1)
    kpos = cpos[:, None, :]                             # (B, 1, S_buf)
    mask = (kpos >= 0) & (kpos <= qpos)
    if window:
        mask &= (qpos - kpos) < window
    y = _gqa_scores_to_out(cfg, q, ck, cv, mask)
    return _attn_out(y, p, cfg), cache


def cross_attention_fwd(p, x, cfg: ModelConfig, *, enc_out=None, cache=None):
    """Cross-attention for enc-dec decoders.  KV comes from the encoder
    output: projected when ``enc_out`` is given (for every row of the
    batch), else read from ``cache``.  Returns (y, {"xk", "xv"} or None);
    the caller stores the new cross K/V."""
    if cache is not None and enc_out is None:
        xk, xv = cache["xk"], cache["xv"]
        q, _, _ = _project_qkv(p, cfg, x, x[:, :1])   # kv unused
    else:
        q, xk, xv = _project_qkv(p, cfg, x, enc_out)
    y = _gqa_scores_to_out(cfg, q, xk, xv, None)
    new_cache = {"xk": xk, "xv": xv} if cache is not None else None
    return _attn_out(y, p, cfg), new_cache


# ==========================================================================
# Mamba2 SSD (state-space duality, chunked)
# ==========================================================================
def _segsum(x):
    """x: (..., T) -> (..., T, T) lower-tri cumulative segment sums."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return torch.where(mask, d, -math.inf)


def ssd_scan(Xd, dtA, Bm, Cm, chunk: int, init_state):
    """Chunked SSD.

    Xd:  (b, l, h, p)  dt-discretized inputs (x * dt)
    dtA: (b, l, h)     dt * A (negative)
    Bm/Cm: (b, l, h, n) per-head (groups already broadcast)
    init_state: (b, h, p, n) float32
    Returns y (b, l, h, p), final_state.

    ``torch.einsum`` contracts more than two operands from left to right
    (no ``opt_einsum`` on the card's machine), so each of the reference's
    three- and four-operand contractions is written as pairwise steps in
    an order whose largest intermediate is (nc, b, h, cs, cs) or
    (nc, b, h, p, n): C·B over n first, then the decay mask, then X.
    """
    b, l, h, pdim = Xd.shape
    cs = min(chunk, l)
    assert l % cs == 0, (l, cs)
    nc = l // cs

    def r(t):  # (b, l, ...) -> (nc, b, cs, ...)
        return t.reshape(b, nc, cs, *t.shape[2:]).movedim(1, 0)

    Xc, Ac, Bc, Cc = r(Xd), r(dtA), r(Bm), r(Cm)
    Acum = torch.cumsum(Ac, dim=2)                         # (nc,b,cs,h)
    # intra-chunk (quadratic within chunk)
    L = torch.exp(_segsum(Ac.movedim(-1, -2)))             # (nc,b,h,cs,cs)
    CB = torch.einsum("cbzhn,cbshn->cbhzs", Cc, Bc)        # (nc,b,h,cs,cs)
    Ydiag = torch.einsum("cbhzs,cbshp->cbzhp", CB * L.to(Cc.dtype), Xc)
    # states emitted by each chunk
    decay_to_end = torch.exp(Acum[:, :, -1:, :] - Acum)    # (nc,b,cs,h)
    states = torch.einsum("cbshn,cbshp->cbhpn", Bc,
                          Xc * decay_to_end.to(Bc.dtype)[..., None])
    chunk_decay = torch.exp(Acum[:, :, -1, :])             # (nc,b,h)
    # inter-chunk recurrence, one chunk at a time; each chunk sees the
    # state *before* it
    carry = init_state.float()
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[c][..., None, None].to(carry.dtype) \
            + states[c].to(carry.dtype)
    prev_states = torch.stack(prev)                        # (nc,b,h,p,n)
    # inter-chunk contribution
    decay_from_start = torch.exp(Acum)                     # (nc,b,cs,h)
    Yoff = torch.einsum("cbzhn,cbhpn->cbzhp", Cc, prev_states.to(Cc.dtype)) \
        * decay_from_start.to(Cc.dtype)[..., None]
    Y = Ydiag + Yoff
    Y = Y.movedim(0, 1).reshape(b, l, h, pdim)
    return Y, carry


def _causal_conv(x, w, b, tail=None, valid_len=None):
    """Depthwise causal conv.  x: (B, T, C), w: (K, C), tail: (B, K-1, C).

    ``valid_len``: per-row count of real (non-pad) tokens; the new tail is
    gathered from the last K-1 *valid* inputs so right-padding a chunk
    cannot pollute the next chunk's conv state."""
    K = w.shape[0]
    T = x.shape[1]
    if tail is None:
        tail = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail, x], dim=1)
    out = sum(xp[:, i:i + T] * w[i] for i in range(K))
    if K > 1:
        if valid_len is None:
            new_tail = xp[:, -(K - 1):]
        else:
            idx = valid_len.long()[:, None] + torch.arange(K - 1,
                                                           device=x.device)
            new_tail = torch.gather(
                xp, 1, idx[..., None].expand(-1, -1, xp.shape[2]))
    else:
        new_tail = tail
    return out + b, new_tail


def ssd_fwd(p, x, cfg: ModelConfig, *, cache: Optional[dict] = None,
            pos_offset=0, active: Optional[torch.Tensor] = None,
            token_mask: Optional[torch.Tensor] = None,
            valid_len: Optional[torch.Tensor] = None):
    """Mamba2 block. x: (B, T, dm). Returns (y, new_cache).

    ``token_mask`` (B, T): right-pad tokens get dt=0 — an exact identity
    recurrence step — so padded mixed batches leave the SSD state correct.
    Inactive rows (``active`` False) keep their state and conv tail.
    """
    B, T, dm = x.shape
    di, G, N, H = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    P = cfg.ssm_head_dim
    zxbcdt = x @ p["in_proj"]
    z, xbc, dt_raw = torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)
    conv_tail = cache["conv"] if cache is not None else None
    xbc, new_tail = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_tail,
                                 valid_len=valid_len)
    xbc = F.silu(xbc)
    xs, Bm, Cm = torch.split(xbc, [di, G * N, G * N], dim=-1)
    xs = xs.reshape(B, T, H, P)
    Bm = Bm.reshape(B, T, G, N)
    Cm = Cm.reshape(B, T, G, N)
    rep = H // G
    Bm = Bm.repeat_interleave(rep, dim=2)
    Cm = Cm.repeat_interleave(rep, dim=2)
    # softplus on f32, dt_bias included
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    if token_mask is not None:
        dt = dt * token_mask[..., None].to(dt.dtype)
    A = -torch.exp(p["A_log"].float())                     # (H,)
    dtA = dt * A                                           # (B,T,H)
    Xd = xs * dt[..., None].to(xs.dtype)

    state0 = (cache["state"] if cache is not None
              else torch.zeros((B, H, P, N), dtype=torch.float32,
                               device=x.device))
    chunk = 1 if T == 1 else cfg.ssm_chunk
    if T % chunk != 0:
        chunk = 1 if T < cfg.ssm_chunk else T // (T // cfg.ssm_chunk)
        while T % chunk:
            chunk -= 1
    y, state = ssd_scan(Xd, dtA.float(), Bm, Cm, chunk, state0)
    if cache is not None and active is not None:
        state = torch.where(active[:, None, None, None], state,
                            cache["state"])
        new_tail = torch.where(active[:, None, None], new_tail,
                               cache["conv"])
    y = y + xs * p["D"].to(xs.dtype)[None, None, :, None]
    y = y.reshape(B, T, di)
    # gated rmsnorm (rsqrt on f32, then cast) and out proj, mamba2 order
    y = y * F.silu(z)
    yf = y.float()
    y = (yf * torch.rsqrt(yf.square().mean(dim=-1, keepdim=True) + 1e-6)
         ).to(x.dtype) * p["norm"]
    out = y @ p["out_proj"]
    if cache is None:
        return out, None
    cache["state"].copy_(state)
    cache["conv"].copy_(new_tail)
    return out, cache


# ==========================================================================
# RG-LRU (RecurrentGemma / Griffin recurrent block)
# ==========================================================================
def _linear_scan(a, v):
    """h_t = a_t h_{t-1} + v_t along dim 1, from h_{-1} = 0: the
    reference's ``associative_scan`` of ``(a1 a2, a2 v1 + v2)``, taken as
    a Hillis–Steele scan in ceil(log2 T) doubling steps (another tree
    order than XLA's, so sums differ by rounding)."""
    T = a.shape[1]
    d = 1
    while d < T:
        v = torch.cat([v[:, :d], a[:, d:] * v[:, :-d] + v[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return v


def rglru_fwd(p, x, cfg: ModelConfig, *, cache: Optional[dict] = None,
              pos_offset=0, active: Optional[torch.Tensor] = None,
              token_mask: Optional[torch.Tensor] = None,
              valid_len: Optional[torch.Tensor] = None, c: float = 8.0):
    """Griffin recurrent block: a gelu gate branch and a conv + RG-LRU
    branch.  Pad tokens are identity steps (a = 1, v = 0); inactive rows
    keep their state and conv tail."""
    B, T, dm = x.shape
    gate = _gelu(x @ p["w_gate"])
    u = x @ p["w_in"]
    tail = cache["conv"] if cache is not None else None
    u, new_tail = _causal_conv(u, p["conv_w"], p["conv_b"], tail,
                               valid_len=valid_len)
    r = torch.sigmoid(u @ p["w_a"] + p["b_a"]).float()
    i = torch.sigmoid(u @ p["w_x"] + p["b_x"])
    log_a = -c * F.softplus(p["lam"].float()) * r          # (B,T,W)
    if token_mask is not None:
        log_a = log_a * token_mask[..., None].to(log_a.dtype)
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    v = beta * (i * u).float()                             # (B,T,W)
    if token_mask is not None:
        v = v * token_mask[..., None].to(v.dtype)

    h0 = (cache["h"] if cache is not None
          else torch.zeros((B, cfg.lru_dim), dtype=torch.float32,
                           device=x.device))
    if T == 1:
        h = a[:, 0] * h0 + v[:, 0]
        hs = h[:, None]
    else:
        # seeded with h0 folded into v_1
        v = torch.cat([(v[:, 0] + a[:, 0] * h0)[:, None], v[:, 1:]], dim=1)
        hs = _linear_scan(a, v)
        h = hs[:, -1]
    y = (hs.to(x.dtype) * gate) @ p["w_out"]
    if cache is None:
        return y, None
    if active is not None:
        h = torch.where(active[:, None], h, cache["h"])
        new_tail = torch.where(active[:, None, None], new_tail, cache["conv"])
    cache["h"].copy_(h)
    cache["conv"].copy_(new_tail)
    return y, cache


# ==========================================================================
# dispatch
# ==========================================================================
def mixer_fwd(kind: str, p, x, cfg: ModelConfig, *, cache=None, pos_offset=0,
              window_override=None, active=None, token_mask=None,
              valid_len=None, append_external=False, block_tables=None,
              page_size=0, rope=None, plans=None, rows=None):
    if kind in ("attn", "local_attn"):
        return attention_fwd(p, x, cfg, kind=kind, cache=cache,
                             pos_offset=pos_offset,
                             window_override=window_override, active=active,
                             token_mask=token_mask, valid_len=valid_len,
                             append_external=append_external,
                             block_tables=block_tables, page_size=page_size,
                             rope=rope, plans=plans, rows=rows)
    if kind == "ssd":
        return ssd_fwd(p, x, cfg, cache=cache, pos_offset=pos_offset,
                       active=active, token_mask=token_mask,
                       valid_len=valid_len)
    if kind == "rglru":
        return rglru_fwd(p, x, cfg, cache=cache, pos_offset=pos_offset,
                         active=active, token_mask=token_mask,
                         valid_len=valid_len)
    raise ValueError(kind)


def _batch_positions(pos_offset, B: int, T: int, device) -> torch.Tensor:
    """(B, T) absolute positions from a scalar or (B,) offset."""
    po = torch.as_tensor(pos_offset, device=device).long()
    ar = torch.arange(T, device=device)
    if po.dim() == 0:
        return (po + ar)[None].expand(B, T)
    return po[:, None] + ar[None]
