"""Paged GQA decode attention on the card: the wrapper of the CUDA kernel
in ``csrc/paged_decode_attention.cu``.

It replaces the Pallas TPU kernel
``repro/kernels/paged_decode_attention.py::paged_decode_attention``.
The kernel is split-KV: a first pass computes partial softmax states
(m, l, acc) per span of each sequence and a second pass merges them.
The wrapper checks its inputs, allocates the output and the f32 partials
(their span count comes from the table's width, never from the lengths,
so nothing is read back from the card), and launches on PyTorch's current
stream; it raises on anything the kernel does not take, and it takes
every head layout of ``kernels.shapes`` (hd a multiple of 8 up to 256:
a row of up to 128 shares a warp with others, a wider row takes the
whole warp).  ``launches``
counts wrapper calls that launched the kernel: one per call, whether the
call ran one pass (a single span) or both.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from repro_torch.kernels import _build, shapes

#: kernel calls made by this wrapper, one per call (split and merge
#: passes together); tests and chip_smoke.py reset it
launches = 0
_counting = threading.Lock()

_SIG = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                      ctypes.c_void_p]


def _lib():
    lib = _build.load("paged_decode_attention")
    fn = lib.paged_decode_attention
    if fn.argtypes is None:
        fn.argtypes = _SIG
        fn.restype = ctypes.c_int
        lib.paged_decode_attention_splits.argtypes = [ctypes.c_int] * 3
        lib.paged_decode_attention_splits.restype = ctypes.c_int
    return lib


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths,
                           k_scales=None, v_scales=None):
    """q: (B,H,hd) f32|bf16 CUDA; k/v_pages: (n_pages,page,KV,hd) of
    f32|bf16|fp8-e4m3|int8; block_tables: (B,n_pp) int; lengths: (B,)
    int; k/v_scales: optional (n_pages,page) f32 per-token dequant scales
    -> (B,H,hd) in q's dtype."""
    global launches
    B, H, hd = q.shape
    n_pages, page, KV, hd_k = k_pages.shape
    if v_pages.shape != k_pages.shape or v_pages.dtype != k_pages.dtype:
        raise ValueError("k_pages and v_pages differ in shape or dtype")
    if hd_k != hd:
        raise ValueError(f"q={tuple(q.shape)} and pages="
                         f"{tuple(k_pages.shape)} differ in head dim")
    shapes.check(hd, H, KV, "paged_decode_attention")
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention launches a CUDA kernel; "
                         f"got a tensor on {q.device}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales or neither")
    tensors = [q, k_pages, v_pages]
    tbl = block_tables.to(device=q.device, dtype=torch.int32).contiguous()
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    if tbl.shape[0] != B or lens.shape != (B,):
        raise ValueError("block_tables / lengths do not match the batch")
    ks = vs = None
    if k_scales is not None:
        ks = k_scales.to(torch.float32).contiguous()
        vs = v_scales.to(torch.float32).contiguous()
        if ks.shape != (n_pages, page) or vs.shape != (n_pages, page):
            raise ValueError("scale planes must be (n_pages, page)")
        tensors += [ks, vs]
    for t in tensors:
        if t.device != q.device:
            raise ValueError("all operands must be on one CUDA device")
    q = q.contiguous()
    # the split pass copies 16-byte chunks of the pages
    kp, vp = (t if t.data_ptr() % 16 == 0 else t.clone()
              for t in (k_pages.contiguous(), v_pages.contiguous()))
    out = torch.empty_like(q)
    lib = _lib()
    n_pp = tbl.shape[1]
    n_splits = lib.paged_decode_attention_splits(hd, page, n_pp)
    part_m = torch.empty(B, H, n_splits, dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty(B, H, n_splits, hd, dtype=torch.float32,
                           device=q.device)
    status = lib.paged_decode_attention(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tbl.data_ptr(),
        lens.data_ptr(), 0 if ks is None else ks.data_ptr(),
        0 if vs is None else vs.data_ptr(), out.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        B, H, KV, hd, page, n_pp, _build.dtype_code(q), _build.dtype_code(kp),
        1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "paged_decode_attention")
    with _counting:             # the shards of a sharded step launch at once
        launches += 1
    return out
