"""Chunked-prefill attention on the card: the wrapper of the CUDA kernel
in ``csrc/chunked_prefill_attention.cu``.

It replaces the Pallas TPU kernel
``repro/kernels/chunked_prefill_attention.py::chunked_prefill_attention``
together with its padding wrapper ``ops.chunked_prefill_attention_op``:
the CUDA kernel masks ragged Tq and S edges itself, so nothing is
padded.  The kernel picks its body by dtype and shape before it
launches: bf16 queries at hd 128 on a bf16 pool (the serving path) or
an fp8 or int8 pool run a TMA + ``wgmma`` body, other bf16 queries (hd
32 and 64, f32 pools) run ``mma.sync``, and f32 queries keep f32
arithmetic throughout.  The wrapper checks its inputs, allocates the output, and
launches on PyTorch's current stream; it raises on anything the kernel
does not take.  q, k and v may be row views of larger buffers (their
last two dimensions contiguous): the kernel reads through their strides
and never past Tq or S.  ``launches`` counts the launches it made and
``body_launches`` splits them by the body the kernel reported.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

#: kernel launches made by this wrapper (tests and chip_smoke.py reset it)
launches = 0
#: the same launches by the body the kernel took, as it reports them
BODIES = ("fma", "mma_sync", "wgmma")
body_launches = dict.fromkeys(BODIES, 0)

_SIG = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 4
        + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.POINTER(ctypes.c_int),
                                ctypes.c_void_p])


def _lib():
    lib = _build.load("chunked_prefill_attention")
    fn = lib.chunked_prefill_attention
    if fn.argtypes is None:
        fn.argtypes = _SIG
        fn.restype = ctypes.c_int
    return fn


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
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"chunked_prefill_attention launches a CUDA "
                         f"kernel; got a tensor on {q.device}")
    B, Tq, H, hd = q.shape
    Bk, S, KV, hd_k = k.shape
    if v.shape != k.shape or v.dtype != k.dtype:
        raise ValueError("k and v differ in shape or dtype")
    if Bk != B or hd_k != hd or H % KV or hd % 8 or hd > 128:
        raise ValueError(f"unsupported shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} (hd % 8 == 0, hd <= 128, "
                         f"H % KV == 0)")
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
    body = ctypes.c_int(-1)
    status = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), off.data_ptr(),
                    0 if ks is None else ks.data_ptr(),
                    0 if vs is None else vs.data_ptr(), out.data_ptr(),
                    B, Tq, S, H, KV, hd, q.stride(0), q.stride(1),
                    k.stride(0), k.stride(1), _build.dtype_code(q),
                    _build.dtype_code(k), 1.0 / math.sqrt(hd),
                    ctypes.byref(body),
                    torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "chunked_prefill_attention")
    launches += 1
    body_launches[BODIES[body.value]] += 1
    return out
