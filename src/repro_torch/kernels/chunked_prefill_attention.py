"""Chunked-prefill attention on the card: the wrapper of the CUDA kernel
in ``csrc/chunked_prefill_attention.cu``.

It replaces the Pallas TPU kernel
``repro/kernels/chunked_prefill_attention.py::chunked_prefill_attention``
together with its padding wrapper ``ops.chunked_prefill_attention_op``:
the CUDA kernel masks ragged Tq and S edges itself, so nothing is
padded.  It takes every head layout of ``kernels.shapes`` (hd a
multiple of 8 up to 256).  The wrapper names one of three tensor-core
bodies by dtype and shape (``shapes.prefill_body``) and the kernel
launches it: bf16 queries on an unscaled bf16 pool
(the serving path), or on fp8 or int8 codes at hd % 16 == 0, run a TMA
+ ``wgmma`` body at every head dim (rows padded to the next width in
64, 128, 192, 256); bf16 queries on an f32 pool or a scaled bf16 pool
at hd 32, 64 and 128 run ``mma.sync``; every other call, f32 queries
included, runs 3xTF32 (f32 operands split into two TF32 halves, three
products each: about 21 bits a product, so f32 callers get f32
accuracy in substance).  The wrapper checks
its inputs, allocates the output, and launches on PyTorch's current
stream; it raises on anything the kernel does not take (the C entry
point refuses a body it has no instance of for the call).  q, k and v may
be row views of larger buffers (their last two dimensions contiguous):
the kernel reads through their strides and never past Tq or S.
``launches`` counts the launches it made and ``body_launches`` splits
them by body.

``packed_prefill_attention`` wraps the kernel's packed-row body (C
entry ``packed_chunked_prefill_attention``): a paged engine's packed
step's query rows over the page pool, read a page at a time through the
block tables, with no dense copy of the pages and no (slots, chunk)
query layout; ``shapes.packed_body`` says which calls it takes.  Its
launches count under the body ``packed``.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from repro_torch.kernels import _build, shapes

#: kernel launches made by this wrapper (tests and chip_smoke.py reset it)
launches = 0
#: the bodies the C entry point takes, in the order of their codes
BODIES = shapes.PREFILL_BODIES
#: the same launches by body, the packed-row body's under ``packed``
COUNTED = BODIES + ("packed",)
body_launches = dict.fromkeys(COUNTED, 0)
_counting = threading.Lock()
#: the key spans a packed step's slot of at most one tile is split into
NSPLIT = 8

_SIG = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 4
        + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int,
                                ctypes.c_void_p])
_PACKED_SIG = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
               + [ctypes.c_longlong] + [ctypes.c_int] * 5
               + [ctypes.c_float, ctypes.c_void_p])


def _lib(entry="chunked_prefill_attention", sig=_SIG):
    lib = _build.load("chunked_prefill_attention")
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = sig
        fn.restype = ctypes.c_int
    return fn


def _count(body):
    global launches
    with _counting:             # the shards of a sharded step launch at once
        launches += 1
        body_launches[body] += 1


def _rows(t):
    """``t`` itself when the kernel can read it through its strides: the
    last two dimensions contiguous, 16-byte aligned, row strides a
    multiple of 16 bytes.  Otherwise a contiguous copy."""
    hd = t.shape[-1]
    step = 16 // t.element_size()
    if (t.stride(-1) == 1 and t.stride(-2) == hd and t.data_ptr() % 16 == 0
            and t.stride(0) % step == 0 and t.stride(1) % step == 0):
        return t
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def chunked_prefill_attention(q, k, v, offsets, k_scales=None,
                              v_scales=None):
    """q: (B,Tq,H,hd) f32|bf16 CUDA; k,v: (B,S,KV,hd) of
    f32|bf16|fp8-e4m3|int8; offsets: (B,) int; k/v_scales: optional
    (B,S) f32 per-token dequant scales -> (B,Tq,H,hd) in q's dtype."""
    B, Tq, H, hd = q.shape
    Bk, S, KV, hd_k = k.shape
    if v.shape != k.shape or v.dtype != k.dtype:
        raise ValueError("k and v differ in shape or dtype")
    if Bk != B or hd_k != hd:
        raise ValueError(f"q={tuple(q.shape)} and k={tuple(k.shape)} "
                         f"differ in batch or head dim")
    shapes.check(hd, H, KV, "chunked_prefill_attention")
    if q.device.type != "cuda":
        raise ValueError(f"chunked_prefill_attention launches a CUDA "
                         f"kernel; got a tensor on {q.device}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales or neither")
    off = offsets.to(device=q.device, dtype=torch.int32).contiguous()
    if off.shape != (B,):
        raise ValueError("offsets must be (B,)")
    tensors = [q, k, v]
    ks = vs = None
    if k_scales is not None:
        ks = k_scales.to(torch.float32).contiguous()
        vs = v_scales.to(torch.float32).contiguous()
        if ks.shape != (B, S) or vs.shape != (B, S):
            raise ValueError("scales must be (B, S)")
        tensors += [ks, vs]
    for t in tensors:
        if t.device != q.device:
            raise ValueError("all operands must be on one CUDA device")
    # the tensor-core bodies read 16-byte vectors and TMA boxes
    q, k, v = (_rows(t) for t in (q, k, v))
    if k.stride() != v.stride():     # one set of strides serves both
        k, v = k.contiguous(), v.contiguous()
    out = torch.empty(B, Tq, H, hd, dtype=q.dtype, device=q.device)
    body = shapes.prefill_body(q.dtype, k.dtype, hd, ks is not None)
    status = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), off.data_ptr(),
                    0 if ks is None else ks.data_ptr(),
                    0 if vs is None else vs.data_ptr(), out.data_ptr(),
                    B, Tq, S, H, KV, hd, q.stride(0), q.stride(1),
                    k.stride(0), k.stride(1), _build.dtype_code(q),
                    _build.dtype_code(k), 1.0 / math.sqrt(hd),
                    BODIES.index(body),
                    torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, f"chunked_prefill_attention ({body} body)")
    _count(body)
    return out


def packed_prefill_attention(q, k_pages, v_pages, block_tables, slots):
    """q: (N,H,hd) bf16 CUDA, a packed step's query rows; k/v_pages:
    (n_pages,page,KV,hd) bf16 pools that already hold the rows' K/V;
    block_tables: (B,n_pp) int; slots: (4,B) int, each slot's pos_offset,
    n_valid, active and last row -> (N,H,hd) bf16.  Slot b's rows are the
    ``n_valid[b]`` ending at row ``last[b]`` (none where it is inactive),
    at positions from ``pos_offset[b]``; each attends causally to its
    slot's keys up to its own position.  A row of no slot is written as
    zeros."""
    N, H, hd = q.shape
    n_pages, page, KV, hd_k = k_pages.shape
    B, n_pp = block_tables.shape
    if q.device.type != "cuda":
        raise ValueError(f"packed_prefill_attention launches a CUDA kernel; "
                         f"got a tensor on {q.device}")
    if v_pages.shape != k_pages.shape or v_pages.dtype != k_pages.dtype \
            or hd_k != hd:
        raise ValueError("k_pages and v_pages differ, or their head dim "
                         "is not q's")
    if not shapes.packed_body(q.dtype, k_pages.dtype, hd, H, KV, page,
                              False):
        raise ValueError(f"the packed-row body takes no {q.dtype} queries "
                         f"over a {k_pages.dtype} pool at hd={hd} H={H} "
                         f"KV={KV} page={page} (shapes.packed_body)")
    if slots.shape != (4, B):
        raise ValueError("slots must be (4, B)")
    for t in (k_pages, v_pages, block_tables, slots):
        if t.device != q.device:
            raise ValueError("all operands must be on one CUDA device")
    q = _rows(q)
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("the page pools must be contiguous")
    tables = block_tables.to(torch.int32).contiguous()
    per_slot = slots.to(torch.int32).contiguous()
    out = torch.empty(N, H, hd, dtype=q.dtype, device=q.device)
    rows = B * NSPLIT * KV * shapes.PACKED_ROWS
    part_o = torch.empty(rows * hd, dtype=torch.float32, device=q.device)
    part_ml = torch.empty(rows * 2, dtype=torch.float32, device=q.device)
    status = _lib("packed_chunked_prefill_attention", _PACKED_SIG)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        per_slot.data_ptr(), tables.data_ptr(), out.data_ptr(),
        part_o.data_ptr(), part_ml.data_ptr(), N, H, KV, hd, q.stride(0), B,
        n_pp, n_pages, page, NSPLIT, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "chunked_prefill_attention (packed body)")
    _count("packed")
    return out
