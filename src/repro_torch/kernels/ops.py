"""Public attention ops and the KV quantization helpers.

Each op dispatches on the device of its query tensor: a CPU tensor runs
the plain PyTorch version in ``kernels.ref``; a CUDA tensor launches the
hand-written Hopper kernel (``kernels.paged_decode_attention`` /
``kernels.chunked_prefill_attention``), which raises if it cannot run.
There is no fallback from the card to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core.precision import get_precision
from repro_torch.kernels import chunked_prefill_attention as _cpa
from repro_torch.kernels import paged_decode_attention as _pda
from repro_torch.kernels import ref, shapes
from repro_torch.kernels.ref import take

#: quantization epsilon — the amax floor that keeps scales finite
QUANT_EPS = 1e-8


def kv_storage_dtype(precision, default=torch.bfloat16):
    """The torch dtype a KV page pool stores at ``precision``."""
    prec = get_precision(precision)
    if not prec.quantized:
        return default
    if prec.name == "int8":
        return torch.int8
    return torch.float8_e4m3fn


def quantize_kv(x, precision: str):
    """Quantize KV rows to codes + per-token scales.

    ``x``: (..., KV, hd) float; one symmetric amax scale per leading
    index (i.e. per token row across all KV heads and head dims):
    ``scale = max(amax, eps) / qmax``, ``codes ~= x / scale`` stored in
    the precision's dtype (int8 rounds half to even, then clips; fp8
    clips to +-qmax, then casts).  Returns ``(codes, scales)`` with
    ``scales.shape == x.shape[:-2]`` f32.
    """
    prec = get_precision(precision)
    assert prec.quantized, prec
    xf = x.float()
    amax = xf.abs().amax(dim=(-2, -1))
    # times the f32 reciprocal, not a division: XLA folds the reference's
    # division by the constant qmax into this product, and the scales
    # must match it bit for bit
    scales = amax.clamp_min(QUANT_EPS) * torch.tensor(1.0 / prec.qmax,
                                                      dtype=torch.float32)
    y = xf / scales[..., None, None]
    if kv_storage_dtype(prec) == torch.int8:
        codes = torch.round(y).clamp(-prec.qmax, prec.qmax).to(torch.int8)
    else:
        codes = y.clamp(-prec.qmax, prec.qmax).to(torch.float8_e4m3fn)
    return codes, scales


def dequantize_kv(codes, scales):
    """Inverse of :func:`quantize_kv`: (codes, scales) -> f32 KV rows."""
    return codes.float() * scales[..., None, None]


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"attention ops run on cpu or cuda tensors, "
                     f"not {t.device}")


def chunked_prefill_attention_op(q, k, v, offsets, k_scales=None,
                                 v_scales=None):
    """Chunked-prefill attention: (B,Tq,H,hd) queries at global positions
    ``offsets[b] + i`` against (B,S,KV,hd) KV that already holds the
    chunk's own K/V; causal.  ``k_scales``/``v_scales``: optional (B, S)
    per-token dequant scales when k/v hold quantized codes.  Ragged Tq
    and S edges are masked inside the CUDA kernel, so nothing is
    padded here."""
    if _route(q) == "cpu":
        return ref.chunked_prefill_attention_ref(q, k, v, offsets,
                                                 k_scales, v_scales)
    return _cpa.chunked_prefill_attention(q, k, v, offsets,
                                          k_scales, v_scales)


def paged_decode_attention_op(q, k_pages, v_pages, block_tables, lengths,
                              k_scales=None, v_scales=None):
    """Paged GQA decode: (B,H,hd) queries against the pages each
    sequence's block-table row names, up to ``lengths[b]`` tokens."""
    if _route(q) == "cpu":
        return ref.paged_decode_attention_ref(q, k_pages, v_pages,
                                              block_tables, lengths,
                                              k_scales, v_scales)
    return _pda.paged_decode_attention(q, k_pages, v_pages, block_tables,
                                       lengths, k_scales, v_scales)


def gather_pages(pages, block_tables):
    """Materialize a block-table-indexed page pool as dense per-sequence
    KV: (n_pages, page, KV, hd) + (B, n_pp) -> (B, n_pp*page, KV, hd).

    Logical position ``t`` of sequence ``b`` lands at index ``t`` of the
    result, so the dense causal kernels apply unchanged.  Entries past a
    sequence's allocated table repeat page 0; callers mask them (the
    chunked-prefill kernel's causal frontier never reaches them)."""
    B, n_pp = block_tables.shape
    _, page, KV, hd = pages.shape
    return take(pages, block_tables.long()).reshape(B, n_pp * page, KV, hd)


def gather_scales(scales, block_tables):
    """Per-page dequant scales -> dense per-sequence scales:
    (n_pages, page) + (B, n_pp) -> (B, n_pp*page)."""
    B, n_pp = block_tables.shape
    page = scales.shape[1]
    return scales[block_tables.long()].reshape(B, n_pp * page)


def paged_prefill_attention_op(q, k_pages, v_pages, block_tables, offsets,
                               k_scales=None, v_scales=None):
    """Chunked prefill over a paged KV pool: gathers the slots' pages to
    dense prefix KV and runs the chunked-prefill kernel.  ``q`` is the
    chunk's queries at global positions ``offsets[b] + i``; the chunk's
    own K/V must already be written into the pages.  With a quantized
    pool, ``k_scales``/``v_scales`` are the (n_pages, page) scale planes
    gathered alongside the code pages."""
    k = gather_pages(k_pages, block_tables)
    v = gather_pages(v_pages, block_tables)
    ks = None if k_scales is None else gather_scales(k_scales, block_tables)
    vs = None if v_scales is None else gather_scales(v_scales, block_tables)
    return chunked_prefill_attention_op(q, k, v, offsets, ks, vs)


def packed_prefill_attention_op(q, k_pages, v_pages, block_tables, slots,
                                chunk: int, dest, k_scales=None,
                                v_scales=None):
    """Attention of a paged engine's packed step (``InstanceEngine``'s
    rows): q (N, H, hd), one row a token, over the page pools that
    already hold the rows' K/V -> (N, H, hd).  ``slots`` (4, B) int holds
    each slot's pos_offset, n_valid, active and last row: slot b's rows
    are the ``n_valid[b]`` ending at row ``last[b]`` (none where it is
    inactive), at positions ``pos_offset[b]`` onwards, and each attends
    causally to its slot's keys up to its own position.

    On the card, bf16 queries over an unscaled bf16 pool
    (``shapes.packed_body``) take the prefill kernel's packed-row body,
    which reads the pages through the block tables and writes a row of
    no slot as zeros.  Every other call takes
    ``packed_prefill_by_scatter`` with the (B, ``chunk``) layout and each
    row's place in it, ``dest`` (``scatter_rows``, built once a step)."""
    H, hd = q.shape[1:]
    _, page, KV, _ = k_pages.shape
    if _route(q) == "cuda" and shapes.packed_body(
            q.dtype, k_pages.dtype, hd, H, KV, page, k_scales is not None):
        return _cpa.packed_prefill_attention(q, k_pages, v_pages,
                                             block_tables, slots)
    return packed_prefill_by_scatter(q, k_pages, v_pages, block_tables,
                                     slots, chunk, dest, k_scales, v_scales)


def scatter_rows(slots, N: int, chunk: int):
    """Each of N packed rows' place in the (B, ``chunk``) layout of its
    slot's queries (``slots`` as ``packed_prefill_attention_op`` takes
    them), B * chunk for a row of no slot: (N,) int64.  A packed step
    builds it once (``mixers.packed_rows``), which also reads from it
    the rows that hold a token."""
    pos_offset, n_valid, active, last = slots.long()
    B, T = last.shape[0], chunk
    n = torch.where(active.bool(), n_valid, 0)
    r = torch.arange(N, device=slots.device)[:, None]
    inside = (r > (last - n)[None]) & (r <= last[None])       # (N, B)
    b = inside.int().argmax(1)
    return torch.where(inside.any(1), b * T + r[:, 0] - (last - n + 1)[b],
                       B * T)


def packed_prefill_by_scatter(q, k_pages, v_pages, block_tables, slots,
                              chunk: int, dest, k_scales=None,
                              v_scales=None):
    """``packed_prefill_attention_op`` through the (B, ``chunk``) layout:
    each slot's rows scattered to its row of a zero (B, chunk) query
    buffer at ``dest`` (``scatter_rows``),
    ``paged_prefill_attention_op`` over the slots' gathered pages, the
    rows gathered back.  The plain version on CPU tensors, and the path
    of the pools and shapes the packed-row body does not take.  A row of
    no slot reads the (B, chunk) layout's last row."""
    B, T = slots.shape[1], chunk
    qs = q.new_zeros((B * T + 1,) + q.shape[1:])
    qs.index_copy_(0, dest, q)            # a pad row to the scratch row
    y = paged_prefill_attention_op(qs[:B * T].view(B, T, *q.shape[1:]),
                                   k_pages, v_pages, block_tables,
                                   slots[0].long(), k_scales, v_scales)
    return y.reshape(B * T, *q.shape[1:]).index_select(
        0, dest.clamp(max=B * T - 1))


def launch_counts() -> dict:
    """The kernel wrappers' launch counters: each kernel's, and the
    prefill kernel's by body (``chunked_prefill_attention/<body>``, the
    packed-row body's ``chunked_prefill_attention/packed``)."""
    out = {"paged_decode_attention": _pda.launches,
           "chunked_prefill_attention": _cpa.launches}
    out.update({f"chunked_prefill_attention/{body}": n
                for body, n in _cpa.body_launches.items()})
    return out


def add_launch_counts(delta: dict) -> None:
    """Add ``delta`` (keyed as ``launch_counts``) to the wrappers'
    counters: the launches of a replayed CUDA graph, which run no
    wrapper, or the removal of a capture's."""
    with _pda._counting:
        _pda.launches += delta.get("paged_decode_attention", 0)
    with _cpa._counting:
        _cpa.launches += delta.get("chunked_prefill_attention", 0)
        for body in _cpa.COUNTED:
            _cpa.body_launches[body] += delta.get(
                f"chunked_prefill_attention/{body}", 0)
