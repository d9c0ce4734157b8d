"""Plain PyTorch versions of the two attention kernels.

They are the CPU path of ``kernels.ops`` (the wrappers take them only for
tensors that lie on the CPU) and the reference the CUDA kernels are held
against on the card.  Scores, softmax and the weighted sum run in f32
whatever the input dtype; the output has q's dtype, as the kernels'
does.  With ``k_scales``/``v_scales`` the K/V inputs are quantized codes
and are dequantized after the f32 cast, as the kernels do in-register.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30

_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def as_indexable(t):
    """A view of ``t`` that every indexing kernel takes: fp8 tensors are
    viewed as their raw bytes (uint8), which gathers and scatters move
    unchanged; other dtypes pass through.  The view shares storage, so
    writes through it land in ``t``."""
    return t.view(torch.uint8) if t.dtype in _FP8 else t


def take(t, index):
    """``t[index]`` for any dtype, fp8 included."""
    return as_indexable(t)[index].view(t.dtype)


def _dequant(x, scales):
    xf = x.float()
    if scales is not None:
        xf = xf * scales.float()[..., None, None]
    return xf


def chunked_prefill_attention_ref(q, k, v, offsets, k_scales=None,
                                  v_scales=None):
    """Micro-request chunked prefill attention.

    q:        (B, Tq, H, hd)  — the chunk's queries (global positions
                                 offsets[b] + i)
    k, v:     (B, S, KV, hd)  — prefix KV *including* the chunk's own
                                 K/V written at [offsets, offsets+Tq)
    offsets:  (B,) int        — chunk start position per sequence
    k_scales, v_scales: optional (B, S) f32 per-token dequant scales
    Returns   (B, Tq, H, hd) in q's dtype.
    """
    B, Tq, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    qpk = H // KV
    qg = q.float().reshape(B, Tq, KV, qpk, hd)
    kf = _dequant(k, k_scales)
    vf = _dequant(v, v_scales)
    scores = torch.einsum("btkgh,bskh->bkgts", qg, kf) / math.sqrt(hd)
    ar_t = torch.arange(Tq, device=q.device)
    qpos = offsets.to(q.device).long()[:, None] + ar_t[None]       # (B, Tq)
    kpos = torch.arange(S, device=q.device)[None]                  # (1, S)
    mask = kpos[:, None, :] <= qpos[..., None]                     # (B, Tq, S)
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", w, vf)
    return out.reshape(B, Tq, H, hd).to(q.dtype)


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                               k_scales=None, v_scales=None):
    """Paged GQA decode attention (one query token per sequence).

    q:            (B, H, hd)
    k_pages:      (n_pages, page, KV, hd)
    v_pages:      (n_pages, page, KV, hd)
    block_tables: (B, pages_per_seq) int — physical page per logical page
    lengths:      (B,) int — valid context per sequence (incl. current tok)
    k_scales, v_scales: optional (n_pages, page) f32 per-token scales
    Returns       (B, H, hd) in q's dtype.
    """
    B, H, hd = q.shape
    n_pages, page, KV, _ = k_pages.shape
    pages_per_seq = block_tables.shape[1]
    S = pages_per_seq * page
    tbl = block_tables.long()
    k = take(k_pages, tbl).reshape(B, S, KV, hd)
    v = take(v_pages, tbl).reshape(B, S, KV, hd)
    ks = None if k_scales is None else k_scales[tbl].reshape(B, S)
    vs = None if v_scales is None else v_scales[tbl].reshape(B, S)
    kf = _dequant(k, ks)
    vf = _dequant(v, vs)
    qpk = H // KV
    qg = q.float().reshape(B, KV, qpk, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qg, kf) / math.sqrt(hd)
    valid = (torch.arange(S, device=q.device)[None]
             < lengths.to(q.device).long()[:, None])               # (B, S)
    scores = torch.where(valid[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", w, vf)
    return out.reshape(B, H, hd).to(q.dtype)
