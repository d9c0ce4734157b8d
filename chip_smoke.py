#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of DynaServe on one NVIDIA GPU (an H100).

    python3 chip_smoke.py                 # every phase, as the check runs it
    python3 chip_smoke.py --phases kernels

Phases, each printing its own lines; any failure raises and the script
exits non-zero without the final result line:

1. device  — the card's name and power limit (nvidia-smi).
2. build   — both CUDA kernels compiled by nvcc for sm_90a from
             ``src/repro_torch/csrc`` (``-Xptxas -v`` report printed).
3. kernels — each kernel against its plain PyTorch version on the card,
             at the sweep shapes of the JAX kernel tests and at the main
             path's shapes, for bf16, fp8 and int8 pools, plus split-KV
             edges, poison pages and NaN past the prefill edges; then
             kernel, plain and SDPA times at the main-path shapes beside
             the kernel's bound: event time of a loop of wrapper calls and
             device time of the kernels alone (torch.profiler), the kernel
             and SDPA timed in turns.
4. model   — Qwen2.5-14B at full width and 2 layers, paged forward once
             through the kernels and once through the plain attention.
5. serve   — full Qwen2.5-14B (48 layers, random weights from a seed)
             serving 8 requests through ServeSession(EngineBackend,
             DynaServePolicy) on two instances that share the card; the
             kernels' launch counters (and the prefill kernel's per-body
             counters) are zeroed just before this run and read just
             after.  Then the same requests under colocation.

Optional, not in the default run: ``--phases profile`` profiles prefill
and decode steps of one Qwen2.5-14B engine (device time by kernel class
and the device's idle share).

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the card's name and power limit and the one before that the
kernels' JSON record.  Needs one CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("kernels", "model", "serve")      # the default run
EXTRA_PHASES = ("profile",)                 # only when asked for

# Published H100 SXM peaks (NVIDIA data sheet): the bound of a kernel is
# the larger of its bytes over HBM bandwidth and its flops over the dense
# bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

# Kernel-vs-plain tolerances (max abs error).  bf16 outputs are rounded to
# bf16 (relative step 2**-8) on unit-scale inputs, so 2e-2; f32 outputs
# differ only by summation order, so 1e-4.  Poisoned pages must leave the
# output bit-identical.
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# Full-width 2-layer model, kernels vs plain attention, max abs error of
# the f32 logits (std ~1.4): the two attentions sum in another order, so
# their bf16 outputs differ by single roundings (relative 2**-8), and
# those differences pass through two layers of bf16 products; 0.1 is 7%
# of the logits' std.
MODEL_TOL = 0.1


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
class KernelChecks:
    def __init__(self, seed: int):
        import torch
        self.torch = torch
        self.gen = torch.Generator(device="cuda").manual_seed(seed)
        self.cpu_gen = torch.Generator().manual_seed(seed)
        self.err = {"paged_decode_attention": 0.0,
                    "chunked_prefill_attention": 0.0}
        self.n_cases = 0

    def randn(self, *shape, dtype=None):
        t = self.torch.randn(shape, generator=self.gen, device="cuda")
        return t if dtype is None else t.to(dtype)

    def perm(self, n):
        return self.torch.randperm(n, generator=self.cpu_gen)

    def quant(self, x, prec):
        from repro_torch.kernels.ops import quantize_kv
        return quantize_kv(x, prec)

    def record(self, name, got, exp, tol, what, main_path=False):
        torch = self.torch
        torch.cuda.synchronize()
        err = float((got.float() - exp.float()).abs().max())
        if not math.isfinite(err) or err > tol:
            raise AssertionError(f"{name} {what}: max abs err {err:.3e} "
                                 f"> tol {tol:.1e}")
        if main_path:
            self.err[name] = max(self.err[name], err)
        self.n_cases += 1
        return err

    # ---- paged decode ----
    def decode_case(self, B, H, KV, hd, page, n_pp, dtype, lens=None,
                    prec=None, main_path=False, what="", zero_rows=()):
        torch = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.paged_decode_attention import \
            paged_decode_attention
        n_pages = B * n_pp + 1
        q = self.randn(B, H, hd, dtype=dtype)
        kp = self.randn(n_pages, page, KV, hd)
        vp = self.randn(n_pages, page, KV, hd)
        ks = vs = None
        if prec is None:
            kp, vp = kp.to(dtype), vp.to(dtype)
        else:
            kp, ks = self.quant(kp, prec)
            vp, vs = self.quant(vp, prec)
        tbl = self.perm(n_pages)[:B * n_pp].reshape(B, n_pp).to(
            torch.int32).cuda()
        for b in zero_rows:          # padded inactive slots: table entry 0
            tbl[b].zero_()
        if lens is None:
            lens = torch.randint(1, page * n_pp + 1, (B,),
                                 generator=self.cpu_gen)
        lens = torch.as_tensor(lens, dtype=torch.int32).cuda()
        out = paged_decode_attention(q, kp, vp, tbl, lens, ks, vs)
        exp = ref.paged_decode_attention_ref(q, kp, vp, tbl, lens, ks, vs)
        tol = TOL[str(dtype).replace("torch.", "")]
        return self.record("paged_decode_attention", out, exp, tol,
                           what or f"B{B} H{H} KV{KV} hd{hd} page{page} "
                                   f"{dtype} {prec}", main_path)

    def decode_poison(self, B, H, KV, hd, page, n_pp, dtype, lens,
                      prec=None):
        """Pages (and rows of the last page) past each length hold
        garbage: the output must not change at all."""
        torch = self.torch
        from repro_torch.kernels.paged_decode_attention import \
            paged_decode_attention
        from repro_torch.kernels.ref import as_indexable
        n_pages = B * n_pp
        q = self.randn(B, H, hd, dtype=dtype)
        kp = self.randn(n_pages, page, KV, hd)
        vp = self.randn(n_pages, page, KV, hd)
        ks = vs = None
        if prec is None:
            kp, vp = kp.to(dtype), vp.to(dtype)
        else:
            kp, ks = self.quant(kp, prec)
            vp, vs = self.quant(vp, prec)
        # each sequence owns its pages (a permutation within its block)
        tbl = torch.stack([b * n_pp + self.perm(n_pp) for b in range(B)])
        tbl = tbl.to(torch.int32).cuda()
        lens = torch.as_tensor(lens, dtype=torch.int32).cuda()
        clean = paged_decode_attention(q, kp, vp, tbl, lens, ks, vs)
        kp2, vp2 = kp.clone(), vp.clone()
        ks2 = None if ks is None else ks.clone()
        vs2 = None if vs is None else vs.clone()
        garbage = 1e4 if prec is None else 100.0
        for b in range(B):
            n = int(lens[b])
            for lp in range(n_pp):
                phys = int(tbl[b, lp])
                lo = max(0, n - lp * page)
                if lo >= page:
                    continue
                as_indexable(kp2)[phys, lo:] = as_indexable(
                    torch.full_like(kp2[phys, lo:], garbage, dtype=torch.float32)
                    .to(kp2.dtype))
                as_indexable(vp2)[phys, lo:] = as_indexable(
                    torch.full_like(vp2[phys, lo:], -garbage, dtype=torch.float32)
                    .to(vp2.dtype))
                if ks2 is not None:
                    ks2[phys, lo:] = 1e6
                    vs2[phys, lo:] = 1e6
        dirty = paged_decode_attention(q, kp2, vp2, tbl, lens, ks2, vs2)
        return self.record("paged_decode_attention", dirty, clean, 0.0,
                           f"poison pages past length {dtype} {prec}")

    # ---- chunked prefill ----
    def prefill_case(self, B, Tq, S, H, KV, hd, dtype, offsets=None,
                     prec=None, main_path=False, what=""):
        torch = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.chunked_prefill_attention import \
            chunked_prefill_attention
        q = self.randn(B, Tq, H, hd, dtype=dtype)
        k = self.randn(B, S, KV, hd)
        v = self.randn(B, S, KV, hd)
        ks = vs = None
        if prec is None:
            k, v = k.to(dtype), v.to(dtype)
        else:
            k, ks = self.quant(k, prec)
            v, vs = self.quant(v, prec)
        if offsets is None:
            offsets = torch.randint(0, S - Tq + 1, (B,),
                                    generator=self.cpu_gen)
        off = torch.as_tensor(offsets, dtype=torch.int32).cuda()
        out = chunked_prefill_attention(q, k, v, off, ks, vs)
        exp = ref.chunked_prefill_attention_ref(q, k, v, off, ks, vs)
        tol = TOL[str(dtype).replace("torch.", "")]
        return self.record("chunked_prefill_attention", out, exp, tol,
                           what or f"B{B} Tq{Tq} S{S} H{H} KV{KV} hd{hd} "
                                   f"{dtype} {prec}", main_path)

    def prefill_poison(self, B, Tq, S, H, KV, hd, dtype, offsets, prec=None):
        """K/V past each row's causal frontier hold garbage: the output
        must not change at all."""
        torch = self.torch
        from repro_torch.kernels.chunked_prefill_attention import \
            chunked_prefill_attention
        from repro_torch.kernels.ref import as_indexable
        q = self.randn(B, Tq, H, hd, dtype=dtype)
        k = self.randn(B, S, KV, hd)
        v = self.randn(B, S, KV, hd)
        ks = vs = None
        if prec is None:
            k, v = k.to(dtype), v.to(dtype)
        else:
            k, ks = self.quant(k, prec)
            v, vs = self.quant(v, prec)
        off = torch.as_tensor(offsets, dtype=torch.int32).cuda()
        clean = chunked_prefill_attention(q, k, v, off, ks, vs)
        k2, v2 = k.clone(), v.clone()
        ks2 = None if ks is None else ks.clone()
        vs2 = None if vs is None else vs.clone()
        garbage = 1e4 if prec is None else 100.0
        for b in range(B):
            end = int(off[b]) + Tq
            as_indexable(k2)[b, end:] = as_indexable(torch.full_like(
                k2[b, end:], garbage, dtype=torch.float32).to(k2.dtype))
            as_indexable(v2)[b, end:] = as_indexable(torch.full_like(
                v2[b, end:], -garbage, dtype=torch.float32).to(v2.dtype))
            if ks2 is not None:
                ks2[b, end:] = 1e6
                vs2[b, end:] = 1e6
        dirty = chunked_prefill_attention(q, k2, v2, off, ks2, vs2)
        return self.record("chunked_prefill_attention", dirty, clean, 0.0,
                           f"poison past causal frontier {dtype} {prec}")

    def prefill_nan_edge(self, B, Tq, S, H, KV, hd, dtype, offsets,
                         prec=None, pad=40):
        """q, k and v are row views of larger buffers whose rows past Tq
        (q) and past S (k, v) of every batch row hold NaN (int8 codes:
        the extreme code).  The kernel reads through the views' strides;
        the output must equal, bit for bit, that of clean contiguous
        copies."""
        torch = self.torch
        from repro_torch.kernels.chunked_prefill_attention import \
            chunked_prefill_attention
        from repro_torch.kernels.ref import as_indexable
        qb = self.randn(B, Tq + pad, H, hd, dtype=dtype)
        kb = self.randn(B, S + pad, KV, hd)
        vb = self.randn(B, S + pad, KV, hd)
        ks = vs = None
        if prec is None:
            kb, vb = kb.to(dtype), vb.to(dtype)
        else:
            kb, ks = self.quant(kb, prec)
            vb, vs = self.quant(vb, prec)
            ks, vs = ks[:, :S].contiguous(), vs[:, :S].contiguous()
        off = torch.as_tensor(offsets, dtype=torch.int32).cuda()
        clean = chunked_prefill_attention(
            qb[:, :Tq].clone(), kb[:, :S].clone(), vb[:, :S].clone(), off,
            ks, vs)
        qb[:, Tq:] = float("nan")
        bad = 127.0 if prec == "int8" else float("nan")
        for t in (kb, vb):
            as_indexable(t)[:, S:] = as_indexable(torch.full_like(
                t[:, S:], bad, dtype=torch.float32).to(t.dtype))
        dirty = chunked_prefill_attention(qb[:, :Tq], kb[:, :S], vb[:, :S],
                                          off, ks, vs)
        return self.record("chunked_prefill_attention", dirty, clean, 0.0,
                           f"NaN past Tq {Tq} and S {S} {dtype} {prec}")


def run_kernel_checks(seed: int):
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    kc = KernelChecks(seed)
    # sweep shapes of tests/test_kernels.py
    for dt in (f32, bf16):
        for B, H, KV, hd, page, n_pp in [(2, 8, 2, 64, 8, 4),
                                          (3, 4, 4, 32, 16, 2),
                                          (1, 16, 2, 128, 8, 8)]:
            kc.decode_case(B, H, KV, hd, page, n_pp, dt)
        for B, Tq, S, H, KV, hd in [(1, 8, 32, 4, 4, 32),
                                    (2, 24, 64, 8, 2, 64),
                                    (2, 16, 48, 6, 1, 128),
                                    (1, 33, 70, 4, 2, 64)]:
            kc.prefill_case(B, Tq, S, H, KV, hd, dt)
    for qpk in (1, 2, 4, 5, 8):
        for page in (8, 16, 32):
            kc.decode_case(3, 2 * qpk, 2, 64, page, 3, f32,
                           lens=[1, page * 2 - 3, page * 3])
    kc.prefill_case(3, 8, 40, 4, 4, 32, f32, offsets=[0, 13, 24],
                    what="per-row ragged offsets")
    for prec in ("fp8", "int8"):
        for page, qpk in [(8, 1), (16, 2), (32, 4)]:
            kc.decode_case(3, 2 * qpk, 2, 64, page, 3, f32,
                           lens=[1, page * 2 - 3, page * 3], prec=prec)
        for B, Tq, S, KV, qpk in [(2, 24, 64, 2, 4), (1, 33, 70, 2, 2),
                                  (3, 8, 40, 4, 1)]:
            for dt in (f32, bf16):
                kc.prefill_case(B, Tq, S, KV * qpk, KV, 64, dt, prec=prec)
        kc.decode_poison(1, 4, 2, 32, 8, 4, f32, [11], prec=prec)
    kc.decode_poison(1, 4, 2, 32, 8, 4, f32, [11])
    kc.prefill_poison(1, 6, 24, 4, 2, 32, f32, [4])
    # main-path shapes: Qwen2.5-14B heads, 8 slots, page 8, contexts to
    # 4096, chunks to 512
    B, H, KV, hd, page, n_pp = 8, 40, 8, 128, 8, 512
    lens = [1, 17, 300, 1024, 2047, 3000, 4095, 4096]
    for prec in (None, "fp8", "int8"):
        kc.decode_case(B, H, KV, hd, page, n_pp, bf16, lens=lens,
                       prec=prec, main_path=True,
                       what=f"main path {prec or 'bf16'} pool")
        kc.decode_poison(B, H, KV, hd, page, 64, bf16,
                         [1, 9, 100, 200, 255, 256, 511, 512], prec=prec)
        kc.prefill_case(B, 512, 4096, H, KV, hd, bf16,
                        offsets=[0, 0, 512, 1000, 1536, 2048, 3000, 3584],
                        prec=prec, main_path=True,
                        what=f"main path {prec or 'bf16'} KV")
        kc.prefill_poison(2, 512, 2048, H, KV, hd, bf16, [0, 1000],
                          prec=prec)
    # inactive padded slots: length 1 and a zero table row
    kc.decode_case(B, H, KV, hd, page, 4, bf16, lens=[1] * B,
                   main_path=True, what="inactive padded slots",
                   zero_rows=range(B))
    # split-KV edges at the main path's table width (spans of SPLIT = 256
    # tokens, 32 pages of 8): lengths 1, page-1, SPLIT-1, SPLIT, SPLIT+1
    # and the whole table, beside two padded inactive slots; poison pages
    # past lengths that end inside a span.  Prefill edges: Tq 1, 130 and
    # 512; S no multiple of the 128-key tile; S shorter than offset + Tq;
    # S = 4000, which wraps the 2-stage K/V ring 16 times; NaN past Tq
    # and S read through row views.  Every pool format.
    split = 256
    edge_lens = [1, page - 1, split - 1, split, split + 1, page * n_pp, 1, 1]
    for prec in (None, "fp8", "int8"):
        name = prec or "bf16"
        kc.decode_case(B, H, KV, hd, page, n_pp, bf16, lens=edge_lens,
                       prec=prec, zero_rows=(6, 7),
                       what=f"split edges, {name} pool")
        kc.decode_poison(B, H, KV, hd, page, 64, bf16,
                         [1, 7, 100, 255, 257, 300, 385, 511], prec=prec)
        for Tq, S, offs in [(1, 300, [0, 299]), (130, 300, [170, 250]),
                            (512, 4000, [0, 3700])]:
            kc.prefill_case(2, Tq, S, H, KV, hd, bf16, offsets=offs,
                            prec=prec, what=f"edges Tq {Tq} S {S} offsets "
                                            f"{offs}, {name} KV")
        kc.prefill_nan_edge(2, 130, 300, H, KV, hd, bf16, [170, 250],
                            prec=prec)
        kc.prefill_nan_edge(2, 512, 1000, H, KV, hd, bf16, [488, 0],
                            prec=prec)
    # the other bodies read through row views too
    kc.prefill_nan_edge(2, 33, 70, 4, 2, 64, bf16, [20, 37])
    kc.prefill_nan_edge(2, 33, 70, 4, 2, 64, f32, [20, 37])
    log(f"[kernels] {kc.n_cases} cases within tolerance "
        f"(bf16 {TOL['bfloat16']}, f32 {TOL['float32']}, poison exact); "
        f"main-path max abs err: "
        + ", ".join(f"{k} {v:.3e}" for k, v in kc.err.items()))
    return kc.err


def device_ms(fn, n: int) -> float:
    """Device time of one call of ``fn``: the summed duration of every
    kernel that ``n`` calls launch (both passes of split-KV decode), over
    ``n``, from torch.profiler's CUDA activity.  Raises if the profiler
    records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.time_range.elapsed_us() for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return us / n / 1e3


def in_turns(fns: dict, iters: int, rounds: int = 2) -> dict:
    """Event and device times of each callable, taken in turns (a, b, b,
    a, ...), so that callables timed together see the same card state;
    only ratios within one run are compared.  Means over the rounds."""
    ev = {k: [] for k in fns}
    dev = {k: [] for k in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            ev[name].append(cuda_ms(fns[name], iters))
            dev[name].append(device_ms(fns[name], iters))
    return {k: (sum(ev[k]) / rounds, sum(dev[k]) / rounds) for k in fns}


def time_kernels(seed: int):
    """Kernel, plain and SDPA times at the main-path shapes (bf16), with
    each kernel's bound from this run's inputs: event time of a loop of
    wrapper calls and device time of the kernels alone, the kernel and
    SDPA in turns."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import chunked_prefill_attention as cpa
    from repro_torch.kernels import ref
    from repro_torch.kernels.chunked_prefill_attention import \
        chunked_prefill_attention
    from repro_torch.kernels.ops import gather_pages, quantize_kv
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention
    g = torch.Generator(device="cuda").manual_seed(seed)
    gc = torch.Generator().manual_seed(seed)
    bf16 = torch.bfloat16
    res = {}

    # paged decode: 8 slots, page 8, a table of 512 pages (4096 tokens) as
    # in the serve phase; long contexts spread up to 4096, then short ones
    # (128-256 tokens, one live span) as the serve phase's decode sees
    B, H, KV, hd, page, n_pp = 8, 40, 8, 128, 8, 512
    n_pages = B * n_pp
    q = torch.randn(B, H, hd, generator=g, device="cuda").to(bf16)
    kp = torch.randn(n_pages, page, KV, hd, generator=g, device="cuda").to(bf16)
    vp = torch.randn(n_pages, page, KV, hd, generator=g, device="cuda").to(bf16)
    tbl = torch.randperm(n_pages, generator=gc).reshape(B, n_pp).to(
        torch.int32).cuda()
    kd = gather_pages(kp, tbl).transpose(1, 2).repeat_interleave(H // KV, 1)
    vd = gather_pages(vp, tbl).transpose(1, 2).repeat_interleave(H // KV, 1)
    qd = q[:, :, None, :]
    for label, lens_l in (("long", [512, 1024, 1536, 2048, 2560, 3072, 3584,
                                    4096]),
                          ("short", [128, 146, 164, 182, 201, 219, 237, 256])):
        lens = torch.tensor(lens_l, dtype=torch.int32).cuda()
        mask = (torch.arange(n_pp * page, device="cuda")[None]
                < lens[:, None])[:, None, None, :]
        t = in_turns({
            "kernel": lambda: paged_decode_attention(q, kp, vp, tbl, lens),
            "sdpa": lambda: F.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=mask)}, 50)
        plain = cuda_ms(lambda: ref.paged_decode_attention_ref(
            q, kp, vp, tbl, lens), 5)
        ctx = sum(lens_l)
        n_bytes = (2 * B * H * hd * 2                      # q in, out
                   + 2 * ctx * KV * hd * 2                 # live K and V
                   + sum(-(-n // page) for n in lens_l) * 4 + B * 4)
        r = dict(ms=t["kernel"][0], device_ms=t["kernel"][1], plain_ms=plain,
                 library_ms=t["sdpa"][0], library_device_ms=t["sdpa"][1],
                 **bound(n_bytes, 4 * ctx * H * hd),
                 shape=f"B={B} H={H} KV={KV} hd={hd} page={page} n_pp={n_pp} "
                       f"contexts={lens_l} bf16")
        res["paged_decode_attention" + ("" if label == "long" else
                                        " (short contexts)")] = r
    del kd, vd, kp, vp

    # chunked prefill: 8 rows of a 512-token chunk against S=4096
    Tq, S = 512, 4096
    offs_l = [0, 512, 1024, 1536, 2048, 2560, 3072, 3584]
    qp = torch.randn(B, Tq, H, hd, generator=g, device="cuda").to(bf16)
    k = torch.randn(B, S, KV, hd, generator=g, device="cuda").to(bf16)
    v = torch.randn(B, S, KV, hd, generator=g, device="cuda").to(bf16)
    off = torch.tensor(offs_l, dtype=torch.int32).cuda()
    qd = qp.transpose(1, 2)
    kd = k.transpose(1, 2).repeat_interleave(H // KV, 1)
    vd = v.transpose(1, 2).repeat_interleave(H // KV, 1)
    qpos = off[:, None] + torch.arange(Tq, device="cuda")[None]
    mask = (torch.arange(S, device="cuda")[None, None] <= qpos[..., None])
    t = in_turns({
        "kernel": lambda: chunked_prefill_attention(qp, k, v, off),
        "sdpa": lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask[:, None])}, 10)
    plain = cuda_ms(lambda: ref.chunked_prefill_attention_ref(
        qp, k, v, off), 3)
    visible = sum(min(S, o + i + 1) for o in offs_l for i in range(Tq))
    keys = sum(min(S, o + Tq) for o in offs_l)
    n_bytes = 2 * B * Tq * H * hd * 2 + 2 * keys * KV * hd * 2 + B * 4
    res["chunked_prefill_attention"] = dict(
        ms=t["kernel"][0], device_ms=t["kernel"][1], plain_ms=plain,
        library_ms=t["sdpa"][0], library_device_ms=t["sdpa"][1],
        **bound(n_bytes, 4 * visible * H * hd),
        shape=f"B={B} Tq={Tq} S={S} H={H} KV={KV} hd={hd} offsets={offs_l} bf16")
    # quantized pools at the same shape (their codes convert to bf16 in
    # the kernel, so the same operations bound holds)
    del kd, vd
    quant = {}
    for prec in ("fp8", "int8"):
        kq, ksq = quantize_kv(k, prec)
        vq, vsq = quantize_kv(v, prec)
        before = dict(cpa.body_launches)
        tq = in_turns({"kernel": lambda: chunked_prefill_attention(
            qp, kq, vq, off, ksq, vsq)}, 10, rounds=1)["kernel"]
        quant[prec] = (tq, [b for b in cpa.BODIES
                            if cpa.body_launches[b] != before[b]])
        del kq, vq
    for name, r in res.items():
        log(f"[time] {name}: kernel {r['ms']:.4f} ms (events), device "
            f"{r['device_ms']:.4f} ms (torch.profiler); SDPA "
            f"{r['library_ms']:.4f} ms (events), device "
            f"{r['library_device_ms']:.4f} ms; plain {r['plain_ms']:.4f} ms; "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{r['bound_ms'] / r['device_ms']:.3f} of it on the device; "
            f"device time / SDPA device time "
            f"{r['device_ms'] / r['library_device_ms']:.3f}; at {r['shape']}")
    for prec, (tq, bodies) in quant.items():
        log(f"[time] chunked_prefill_attention, {prec} pool ({'/'.join(bodies)} "
            f"body): {tq[0]:.4f} ms (events), device {tq[1]:.4f} ms, same shape")
    res.pop("paged_decode_attention (short contexts)")
    return res


def bound(n_bytes: float, flops: float) -> dict:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# ---------------------------------------------------------------------------
# phase 4: full-width model, kernels vs plain attention
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def plain_attention():
    """Route the model's attention through the plain versions on the card
    (for comparison only; the port itself never does this)."""
    from repro_torch.kernels import ref
    from repro_torch.models import mixers
    saved = (mixers.paged_decode_attention_op,
             mixers.chunked_prefill_attention_op)
    mixers.paged_decode_attention_op = ref.paged_decode_attention_ref
    mixers.chunked_prefill_attention_op = ref.chunked_prefill_attention_ref
    try:
        yield
    finally:
        (mixers.paged_decode_attention_op,
         mixers.chunked_prefill_attention_op) = saved


def model_steps(params, cfg, device, seed: int, page: int = 8, feed=None):
    """Chunked prefill (a padded row and a full row), a mixed second
    chunk, then decode steps, through the paged forward.  Decode feeds
    the greedy tokens of the previous step, or ``feed`` when given (so a
    second run sees the same inputs).  Returns (logits per step, fed
    tokens)."""
    import numpy as np
    import torch
    from repro_torch.models.model import forward, init_paged_cache
    rng = np.random.default_rng(seed)
    B, n_pp = 2, 64
    cache = init_paged_cache(cfg, B * n_pp, page, device=device)
    tbl = torch.arange(B * n_pp, dtype=torch.int32,
                       device=device).reshape(B, n_pp)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (B, 320)),
                        device=device)
    out = []

    def step(t, pos, n_valid):
        lg, _, _ = forward(params, cfg, t, cache=cache, pos_offset=pos,
                           n_valid=n_valid, last_only=True,
                           block_tables=tbl, page_size=page)
        out.append(lg)

    step(toks[:, :256], 0, torch.tensor([200, 256], device=device))
    step(torch.stack([toks[0, 200:264], toks[1, 256:320]]),
         torch.tensor([200, 256], device=device), None)
    pos = torch.tensor([264, 320], device=device)
    fed = []
    for i in range(4):
        nxt = feed[i] if feed else out[-1][:, 0].argmax(-1)[:, None]
        fed.append(nxt)
        step(nxt, pos, None)
        pos = pos + 1
    return out, fed


def run_model_check(seed: int):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg = get_config("qwen2.5-14b").with_(n_layers=2)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                         device="cuda")
    with torch.no_grad():
        got, fed = model_steps(params, cfg, "cuda", seed)
        with plain_attention():
            exp, _ = model_steps(params, cfg, "cuda", seed, feed=fed)
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, exp)):
        if a.shape != (2, 1, cfg.vocab_size) or not torch.isfinite(a).all():
            raise AssertionError(f"model step {i}: bad logits {a.shape}")
        worst = max(worst, float((a - b).abs().max()))
    if worst > MODEL_TOL:
        raise AssertionError(f"model logits kernels vs plain: max abs err "
                             f"{worst:.3e} > {MODEL_TOL}")
    log(f"[model] qwen2.5-14b full width, 2 layers, bf16: {len(got)} steps "
        f"(prefill, mixed, decode); logits kernels vs plain max abs err "
        f"{worst:.3e} (tol {MODEL_TOL}, logits std "
        f"{float(exp[0].std()):.3f})")
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: serve full Qwen2.5-14B through ServeSession
# ---------------------------------------------------------------------------
def make_requests(seed: int, vocab: int, prefill_heavy=(1024, 2048, 16),
                  decode_heavy=(64, 128, 64), n_each: int = 4):
    import numpy as np
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_each):
        for lo, hi, d in (prefill_heavy, decode_heavy):
            p = int(rng.integers(lo, hi + 1))
            reqs.append((rng.integers(0, vocab, p).astype(np.int32), d))
    return reqs


def serve(cfg, params, reqs, policy: str, *, n_slots=8, n_pages=4096,
          page=8, max_chunk=512, transfer_chunk=128, slo=0.1):
    from repro_torch.core.session import ServeSession, SessionConfig
    from repro_torch.engine.backend import EngineBackend
    from repro_torch.sim.policies import ColocationPolicy, DynaServePolicy
    backend = EngineBackend(cfg, params, n_slots=n_slots,
                            max_len=n_pages * page // n_slots,
                            page_size=page, n_pages=n_pages,
                            max_chunk=max_chunk,
                            transfer_chunk=transfer_chunk)
    pol = (DynaServePolicy(backend.cost, slo, transfer_chunk=transfer_chunk)
           if policy == "dynaserve"
           else ColocationPolicy(chunk=max_chunk, slo_aware=False))
    sess = ServeSession(backend, pol, SessionConfig(n_instances=2, slo=slo))
    t0 = time.monotonic()
    handles = [sess.generate(p, d, rid=f"r{i}")
               for i, (p, d) in enumerate(reqs)]
    outs = [list(h) for h in handles]
    wall = time.monotonic() - t0
    for (p, d), h, o in zip(reqs, handles, outs):
        if len(o) != d or not h.req.terminal:
            raise AssertionError(f"{h.rid}: {len(o)} of {d} tokens, state "
                                 f"{h.req.state}")
        if not all(0 <= t < cfg.vocab_size for t in o):
            raise AssertionError(f"{h.rid}: token out of range")
    return outs, sess.metrics(), backend.kv_bytes_moved, wall


def run_serve(seed: int, card: str, cfg=None, device="cuda", n_slots=8,
              n_pages=4096, max_chunk=512, reqs=None):
    """Serve through DynaServe (the main path, counted) then colocation.
    Returns the main path's launch counts."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import chunked_prefill_attention as cpa
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.models.model import init_params
    cfg = cfg or get_config("qwen2.5-14b")
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.monotonic()
    params = init_params(cfg, gen, device=device)
    n_params = sum(t.numel() for lp in params["layers"]
                   for d in lp.values() for t in d.values()) + \
        params["embed"].numel() + params["lm_head"].numel()
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}: {n_params / 1e9:.3f}B params "
        f"generated in {time.monotonic() - t0:.1f} s")
    reqs = reqs or make_requests(seed, cfg.vocab_size)
    pda.launches = 0
    cpa.launches = 0
    cpa.body_launches = dict.fromkeys(cpa.BODIES, 0)
    outs, m, moved, wall = serve(cfg, params, reqs, "dynaserve",
                                 n_slots=n_slots, n_pages=n_pages,
                                 max_chunk=max_chunk)
    launches = {"paged_decode_attention": pda.launches,
                "chunked_prefill_attention": cpa.launches}
    bodies = dict(cpa.body_launches)
    if moved <= 0:
        raise AssertionError("no KV handoff: DynaServe split no request")
    for name, n in launches.items():
        if n <= 0 and device == "cuda":
            raise AssertionError(f"{name} was not launched on the main path")
    report("dynaserve", m, moved, wall, card)
    log(f"[serve] main-path kernel launches: {launches}; "
        f"chunked_prefill_attention by body: {bodies}")
    if device == "cuda" and bodies["wgmma"] != cpa.launches:
        raise AssertionError(f"bf16 prefill launches that missed the wgmma "
                             f"body: {bodies}")
    if device == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
    outs_c, m_c, moved_c, wall_c = serve(cfg, params, reqs, "colocation",
                                         n_slots=n_slots, n_pages=n_pages,
                                         max_chunk=max_chunk)
    report("colocation", m_c, moved_c, wall_c, card)
    same = sum(int(a == b) for o1, o2 in zip(outs, outs_c)
               for a, b in zip(o1, o2))
    total = sum(len(o) for o in outs)
    first = sum(int(o1[0] == o2[0]) for o1, o2 in zip(outs, outs_c))
    log(f"[serve] dynaserve vs colocation: {same}/{total} tokens agree "
        f"({same / total:.3f}); first tokens agree {first}/{len(outs)} "
        f"(bf16 greedy streams diverge after a near-tie; exact equality "
        f"is asserted by the f32 CPU tests)")
    del params
    return launches


def report(name, m, moved, wall, card):
    import numpy as np
    ttft = np.asarray(m.ttfts) * 1e3
    tbt = np.asarray(m.tbts) * 1e3
    log(f"[serve] {name}: {m.completed}/{m.offered} requests, "
        f"{m.tokens_total} tokens in {wall:.2f} s wall "
        f"({m.tokens_total / wall:.2f} tok/s); TTFT mean {ttft.mean():.1f} "
        f"p50 {np.median(ttft):.1f} max {ttft.max():.1f} ms; TBT mean "
        f"{tbt.mean():.1f} p50 {np.median(tbt):.1f} p99 "
        f"{np.percentile(tbt, 99):.1f} ms; KV moved {moved} B; card "
        f"{card}.  Both instances time-share one card, so these latencies "
        f"are not what the cost model assumes for two separate instances.")


# ---------------------------------------------------------------------------
# optional phase: where a step's device time goes
# ---------------------------------------------------------------------------
def _kernel_class(name: str) -> str:
    for key, cls in (("paged_decode", "paged_decode_attention"),
                     ("chunked_prefill", "chunked_prefill_attention")):
        if key in name:
            return cls
    low = name.lower()
    if any(w in low for w in ("gemm", "xmma", "cutlass", "nvjet", "cublas")):
        return "matmul"
    return "other"


def run_profile(seed: int, card: str, cfg=None, device="cuda",
                n_slots: int = 8, ctx: int = 1024, chunk: int = 512,
                steps: int = 4):
    """One Qwen2.5-14B engine at the serve phase's sizes: ``steps``
    prefill steps (a ``chunk``-token chunk on every slot at position
    ``ctx``) and ``steps`` decode steps (every slot, contexts from
    ``ctx + chunk``), each window under torch.profiler.  Prints wall time
    per step, device time per kernel class, and the device's idle share
    (wall time with no kernel running)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.engine import BatchItem, InstanceEngine
    from repro_torch.models.model import init_params
    cfg = cfg or get_config("qwen2.5-14b")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                         device=device)
    eng = InstanceEngine(cfg, params, n_slots=n_slots, page_size=8,
                         n_pages=4096, max_chunk=chunk)
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (n_slots, ctx + chunk)).astype(np.int32)
    slots = [eng.alloc(f"r{i}") for i in range(n_slots)]

    def prefill(lo):
        eng.run_batch([BatchItem(s, toks[i, lo:lo + chunk], lo, True)
                       for i, s in enumerate(slots)])

    def decode(pos):
        eng.run_batch([BatchItem(s, toks[i, :1], pos, True)
                       for i, s in enumerate(slots)])

    for lo in range(0, ctx, chunk):          # fill the context
        prefill(lo)
    decode(ctx + chunk)                      # warm both step shapes
    for label, fn in (("prefill", lambda i: prefill(ctx)),
                      ("decode", lambda i: decode(ctx + chunk + 1 + i))):
        sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                fn(i)
            sync()
            wall_us = (time.perf_counter() - t0) * 1e6
        dev = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                cls = _kernel_class(ev.name)
                dev[cls] = dev.get(cls, 0.0) + ev.time_range.elapsed_us()
        busy = sum(dev.values())
        parts = ", ".join(f"{k} {v / steps / 1e3:.3f}" for k, v in
                          sorted(dev.items(), key=lambda kv: -kv[1]))
        log(f"[profile] {label} step (B={n_slots}, "
            f"{'T=' + str(chunk) if label == 'prefill' else 'T=1'}, "
            f"context {ctx}): wall {wall_us / steps / 1e3:.3f} ms; device "
            f"ms by kernel class: {parts or 'none recorded'}; idle share "
            f"{1 - busy / wall_us:.3f}; card {card}")
    del eng, params
    if device == "cuda":
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma list of {PHASES + EXTRA_PHASES} (device "
                         f"and build always run)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    for p in phases:
        if p not in PHASES + EXTRA_PHASES:
            ap.error(f"unknown phase {p!r}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs "
              "only on a card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    # phase 1: device
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi_line()
    log(f"[device] {kind}; nvidia-smi: {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; devices {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build, both kernels at once
    t0 = time.monotonic()
    paths = _build.build_all()
    log(f"[build] {len(paths)} kernels built in "
        f"{time.monotonic() - t0:.1f} s: "
        + ", ".join(str(p.relative_to(ROOT)) if p.is_relative_to(ROOT)
                    else str(p) for p in paths.values()))
    for name, rep in _build.ptxas_report.items():
        for line in rep.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling")):
                log(f"[build] {name}: {line.strip()}")

    errs = {}
    times = {}
    if "kernels" in phases:
        errs = run_kernel_checks(args.seed)
        times = time_kernels(args.seed)
        torch.cuda.empty_cache()
    if "model" in phases:
        run_model_check(args.seed)
    launches = {}
    if "serve" in phases:
        launches = run_serve(args.seed, card)
        gc.collect()     # the sessions' reference cycles hold the weights
        torch.cuda.empty_cache()
    if "profile" in phases:
        run_profile(args.seed, card)

    replaces = {
        "paged_decode_attention":
            "src/repro/kernels/paged_decode_attention.py:79",
        "chunked_prefill_attention":
            "src/repro/kernels/chunked_prefill_attention.py:90",
    }
    kernels = []
    for name, rep in replaces.items():
        t = times.get(name, {})
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu", "replaces": rep,
            "launches": launches.get(name), "max_abs_err": errs.get(name),
            "ms": t.get("ms"), "device_ms": t.get("device_ms"),
            "plain_ms": t.get("plain_ms"),
            "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
            "library_ms": t.get("library_ms"),
            "library_device_ms": t.get("library_device_ms")})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
