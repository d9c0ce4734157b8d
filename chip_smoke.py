#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of DynaServe on one NVIDIA GPU (an H100).

    python3 chip_smoke.py                 # every phase, as the check runs it
    python3 chip_smoke.py --phases kernels
    python3 chip_smoke.py --phases dryrun,examples

Phases, each printing its own lines; any failure raises and the script
exits non-zero without the final result line:

1. device  — the card's name and power limit (nvidia-smi).
2. build   — both CUDA kernels compiled by nvcc for sm_90a from
             ``src/repro_torch/csrc`` (``-Xptxas -v`` report printed).
3. kernels — each kernel against its plain PyTorch version on the card,
             at the sweep shapes of the JAX kernel tests, at the serving
             paths' shapes (Qwen2.5-14B: H 40, KV 8; Qwen3-30B-A3B: H 32,
             KV 4; Phi-4-mini: H 24, KV 8), for bf16, fp8 and int8 pools,
             plus split-KV edges, poison pages and NaN past the prefill
             edges, and at every other kind of head dim the kernels take
             (8, 40, 64, 96, 192, 256; f32 and bf16 queries, every pool;
             rows padded to a wgmma width read at their own extent and
             head stride, 40, 96 and 200, beside NaN heads); then kernel,
             plain and SDPA times at the three paths' shapes, at the
             phi4-mini smoke layout (H 6, KV 2, hd 40, f32 and bf16) and
             at the prefill rows of other head dims (Whisper-large-v3's
             hd 64, hd 96, RecurrentGemma-9B's hd 256, the 14B's f32
             card-vs-CPU layout) beside the kernel's bound: event time of
             a loop of wrapper calls and device time of the kernels alone
             (torch.profiler; a prefill row quotes the event time where
             the two differ by more than 10%), the kernel and SDPA timed
             in turns.  f32 prefill is held to 3e-5 (the 3xTF32 body).
4. model   — Qwen2.5-14B at full width and 2 layers, paged forward once
             through the kernels and once through the plain attention.
4b. graphs — the compiled step: for Qwen2.5-14B at full width and 2
             layers on bf16, fp8 and int8 pools, RecurrentGemma-9B and
             Mamba2-780M at full width and 4 layers on the dense cache,
             and the sharded engines (two shards time-sharing the card) of
             the 14B at TP=2 and 2 layers on a bf16 pool and on the dense
             cache and of Qwen3-30B-A3B at EP=2 and 2 layers, an eager
             engine (``graphs=False``) and a graphed one on the same
             weights take the same items (prefill chunks in three T
             buckets, a mixed batch, 8 decode steps): logits bit-equal and
             every shard's cache tensors byte-equal after every step, every
             capture's all-inactive warm-up leaving the caches' bytes as
             they were, equal launch counts, and no synchronizing call in
             ``dispatch_batch`` of a prefill, a mixed and a decode step
             under ``torch.cuda.set_sync_debug_mode("error")``; captures,
             their seconds and the shared graph pool's bytes.
5. serve   — full Qwen2.5-14B (48 layers, random weights from a seed)
             serving 8 requests through ServeSession(EngineBackend,
             DynaServePolicy) on two instances that share the card; the
             kernels' launch counters (and the prefill kernel's per-body
             counters) are zeroed just before this run and read just
             after.  Then the same requests under colocation.  Then 8
             decode steps (8 slots, context 1024) of an eager and of a
             graphed engine: wall time a step (CUDA events) and device
             time (torch.profiler).  Every serving run on the card, sharded
             instances' included, goes through CUDA graphs (checked step
             by step), and its launch counts must equal the eager step's
             for the same steps (one a paged attention layer and shard).
6. nemotron — Nemotron-4-340B (H 96, KV 8, hd 192; LayerNorm, squared
             ReLU, half rotary): (a) both kernels against their plain
             versions at its head layout and the serving shapes, bf16, fp8
             and int8 pools, split-KV edges, poison pages and NaN past the
             prefill edges; (b) both timed there; (c) full width and 2
             layers, paged forward through the kernels and through the
             plain attention (logits within ``model_tol``); (d) full width
             and 6 of 96 layers (60.32 GB of weights) serving the serve
             phase's 8 requests through DynaServe (counted; every prefill
             launch on the wgmma or the packed-row body) and colocation.
7. moe     — Qwen3-30B-A3B: (a) one MoE layer at full width in f32, card
             against CPU on the same weights (identical routing but for
             counted near-ties); (b) two layers at full width in bf16,
             paged forward through the kernels and through the plain
             attention on the same routing; (c) all 48 layers serving the
             serve phase's 8 requests through ServeSession(EngineBackend,
             DynaServePolicy) on two instances sharing the card and one
             set of weights, launch counters zeroed just before and read
             just after, dropped (token, k) MoE slots counted.
8. http    — the port's ServingServer over a fresh session on those
             weights: two /v1/completions, one streamed
             /v1/chat/completions, /metrics, clean shutdown.
9. tp      — tensor- and expert-parallel instances, two shards
             time-sharing the card, every engine graphed (one CUDA graph
             a (T, n_pp) key holds both shards and every sum): (a) both
             kernels against their plain versions and timed at the
             shards' head counts (Qwen2.5-14B H 20 / KV 4, Qwen3-30B-A3B
             H 16 / KV 2); (b) Qwen2.5-14B at full width and 2 layers,
             f32, a TP=2 instance on the card against the one-device
             engine on the CPU; (c) the whole Qwen2.5-14B in bf16 on the
             serve phase's weights: TP=2 against TP=1 (prefill logits,
             16 greedy steps), a TP=2 -> TP=1 -> TP=2 handoff re-exported
             byte-equal, a decode step of one request at width 1 and 2,
             eager and graphed (wall, device time, idle share, beside the
             cost model's price), and the serve phase's 8 requests
             through DynaServe on a [1, 2]-wide pool (counted; peak
             memory within 1.1x of the serve phase's); (d)
             Qwen3-30B-A3B: one MoE layer in f32, EP=2 against EP=1 on
             the card (identical routing), then all 48 layers serving the
             8 requests on two EP=2 instances (counted, dropped slots).
10. launch — ``repro_torch.launch.serve.main(["--smoke", "--open-loop",
             "--overlap"])`` in-process: the smoke-config path users start;
             then ``main(["--arch", "phi4-mini-3.8b", "--smoke"])``, whose
             head dim of 40 takes the decode kernel's 8-lane rows; both
             smoke configs run in f32, so every prefill launch must take
             the 3xTF32 body (both kernels must launch).
11. dense  — the dense slot cache, whose mixers are plain PyTorch ops (no
             paged kernel may launch): RecurrentGemma-9B and Mamba2-780M,
             full width and depth, serve the serve phase's 8 requests
             through DynaServe and colocation, then hand a request off
             past the window (state byte-equal after the import, both
             engines decoding alike); Whisper-large-v3 (full) and
             InternVL2-76B (full width, 8 of 80 layers) run their stub
             frontends and decode, and a second Whisper frontend replaces
             slot 0's cross K/V, as in the reference; each of the four at
             full width and two layers (RecurrentGemma five) agrees with
             the CPU in f32, and a chunk longer than the ring keeps the
             CPU's last writer on the card.
12. train  — (a) Phi-4-mini-3.8B and Mamba2-780M at full width and two
             layers, f32: one train step on the card against the CPU from
             the same weights and batch, and 4 microbatches with remat
             against 1 without; (b) the whole Phi-4-mini-3.8B trained in
             bf16 with f32 AdamW moments and remat through ``train_loop``
             (loss must fall by more than 0.5), two more steps under
             torch.profiler, and a checkpoint round trip of the whole state
             (bit-equal); (c) moments freed, the trained weights serve the
             serve phase's 8 requests through DynaServe (launch counters
             zeroed just before and read just after) and colocation.
13. dryrun — (a) ``repro_torch.launch.dryrun``'s sweep of every assigned
             arch x shape on the ``meta`` device at the one-pod H100
             layout (data 32 x model 8), in parallel processes, one line
             a combo (argument and temp GB, fits, FLOPs, the three
             roofline terms), then the two-pod layout when the first
             sweep took under ``SWEEP_SECONDS``; the combos of
             ``tests/test_dryrun.py`` must trace; (b) ``check_on_device``
             for a decode (chatglm3-6b, sequence-sharded), a prefill
             (Qwen3-30B-A3B, expert-parallel) and a train step
             (Phi-4-mini-3.8B, 4 microbatches, remat): shard 0's real
             arguments at one device's shapes, the step run for real as
             shard 0 of a recording group, its peak within
             ``PEAK_BAND`` of the trace's, what the allocator holds for
             its arguments within its rounding above the specs' bytes,
             its FlopCounterMode count equal to the trace's (the same ops
             by the same formulas: a consistency check of the trace), its
             device time beside the roofline's larger term; (c)
             chatglm3-6b at full width and 2 layers in f32, a prefill and
             decode steps through a cache whose sequence is split over
             two shards of a real ShardGroup time-sharing the card, with
             the weights at the traced decode layout (every query head,
             ``wo`` split by rows), against the whole cache and weights.
14. examples — ``examples/serve_cluster_torch.py`` and
             ``examples/multiturn_chat_torch.py`` in this process on the
             card at their smoke config (Qwen2.5-14B, paged), the kernels'
             launch counters zeroed before each and read after (both must
             launch; the saved prefill must grow turn by turn).

Optional, not in the default run: ``--phases profile`` profiles prefill
and decode steps of one engine each of Qwen2.5-14B, Qwen3-30B-A3B,
RecurrentGemma-9B and Mamba2-780M, eager and then graphed (device time
by kernel class, MoE routing and dispatch apart, the dense attention
and the scans apart where the step is eager, and the device's idle
share).  ``--phases tf32_one_pass`` builds a copy of
the prefill source whose 3xTF32 products keep only hi.hi (one TF32 pass)
and shows that f32 prefill's 3e-5 bound fails it while the real build
keeps within it.  ``--phases packed`` checks the prefill kernel's
packed-row body (a packed step's rows over the page pool through the
block tables) against the plain version at the serving head layouts and
times it at the card benchmark's mixed step, beside its bound and the
scatter + gather + wgmma path it replaces, and on decode rows beside the
paged-decode kernel.

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
PHASES = ("kernels", "model", "graphs", "serve", "nemotron", "moe", "http",
          "tp",
          "launch", "dense", "train", "dryrun", "examples")  # default
EXTRA_PHASES = ("profile", "tf32_one_pass", "packed")  # only when asked for

# Published H100 SXM peaks (NVIDIA data sheet): the bound of a kernel is
# the larger of its bytes over HBM bandwidth and its flops over the dense
# bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
# dense TF32 on the tensor cores (half the data sheet's 989 with
# sparsity), three products per f32 product: the rate at which the card
# does f32-accurate products, so the bound of an f32 row
TF32X3_FLOPS_PER_S = 494.5e12 / 3
# f32 outside the tensor cores: the bound PERF.md's f32 rows kept before
# the 3xTF32 body, still printed beside the bound for their history
F32_FLOPS_PER_S = 67e12

# Kernel-vs-plain tolerances, elementwise: |got - exp| <= abs + rel * |exp|.
# f32 outputs differ only by summation order: 1e-4 absolute.  bf16: the
# kernel and the plain version each round their f32 result to bf16, so
# where the two f32 values straddle a rounding boundary the outputs land
# one bf16 ulp apart; bf16 keeps 8 significant bits, so one ulp of x is
# at most 2**-7 * |x| (3.125e-2 for x in [4, 8)).  The rel term is that
# ulp; the 2e-2 absolute term bounds the f32 differences before rounding
# on unit-scale inputs, as the flat bound did.  Poisoned pages must leave
# the output bit-identical.
TOL = {"bfloat16": (2e-2, 2 ** -7), "float32": (1e-4, 0.0)}
# f32 queries in prefill run on the 3xTF32 body.  Its products keep
# about 21 bits (lo.lo left out, lo rounded at 2**-22 of the operand), so
# on unit-scale inputs the scores err by up to 3 * 2**-22 * 0.64 *
# sqrt(hd), 7e-6 at hd 256, and the output by a few times that.  One TF32
# pass keeps 11 bits and errs by 5e-4 to 1e-3 at the sweep's shapes,
# within TOL["float32"].  So f32 prefill is held to 3e-5, which tells
# three passes from one (the ``tf32_one_pass`` phase runs a one-pass copy
# against it).
PREFILL_TOL = {**TOL, "float32": (3e-5, 0.0)}
# Full-width 2-layer model, kernels vs plain attention, max abs error of
# the logits (std ~1.4): the two attentions sum in another order, so
# their bf16 outputs differ by single roundings (relative 2**-8), and
# those differences pass through two layers of bf16 products; 0.1 is 7%
# of the logits' std.  The logits are a bf16 product cast to f32, so two
# runs differ by whole bf16 steps of the logits they differ at: 0.1 is
# 3.2 steps of a logit in [4, 8) (the 14B's largest is about 4.5).  A
# model whose largest logit is 2**e >= 8 is held to the same 3.2 steps
# of it: MODEL_TOL * 2**(e - 2) (``model_tol``).
MODEL_TOL = 0.1


def model_tol(logits) -> float:
    """``MODEL_TOL`` where the largest |logit| is below 8; above, the
    same count of bf16 steps of it (the step doubles with each octave)."""
    top = float(logits.abs().max())
    octave = math.floor(math.log2(top)) if top > 0 else 0
    return MODEL_TOL * 2.0 ** max(0, octave - 2)


MOE_PATH = "qwen3-moe-30b-a3b"
TRAIN_PATH = "phi4-mini-3.8b"
NEMOTRON_PATH = "nemotron-4-340b"
# the launcher's phi4-mini smoke config: H 6, KV 2, hd 40, f32
PHI4_SMOKE_PATH = "phi4-mini-3.8b smoke"
#: the layouts the kernels phase times both kernels at, as
#: ``time_kernels`` takes them: the serving paths' heads (bf16, with fp8
#: and int8 pools) and the launcher's phi4-mini smoke config
TIMED_PATHS = {
    "qwen2.5-14b": dict(H=40, KV=8),
    MOE_PATH: dict(H=32, KV=4),
    TRAIN_PATH: dict(H=24, KV=8),
    PHI4_SMOKE_PATH: dict(H=6, KV=2, quant=False, hd=40, dtype="float32"),
}
# head dims the kernel checks sweep beside the serving paths' 128: the
# narrowest row (8; prefill's widest padding, to 64), rows that leave
# lanes idle (40), the 64-wide wgmma instance, a row of 96, Nemotron's 192
# and the widest, 256
HEAD_DIMS = (8, 40, 64, 96, 192, 256)
# rows below their wgmma width, read beside NaN heads (40 -> 64, 96 ->
# 128, 200 -> 256)
PADDED_HEAD_DIMS = (40, 96, 200)
KERNELS = ("paged_decode_attention", "chunked_prefill_attention")


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
        # max abs error at each serving path's shapes, by kernel
        self.err = {}
        self.n_cases = 0
        # cases within the bound only by its one-ulp term: (what, err)
        self.by_ulp = []
        # f32-query prefill cases: [count, worst max abs err]
        self.f32_prefill = [0, 0.0]

    def randn(self, *shape, dtype=None):
        t = self.torch.randn(shape, generator=self.gen, device="cuda")
        return t if dtype is None else t.to(dtype)

    def perm(self, n):
        return self.torch.randperm(n, generator=self.cpu_gen)

    def quant(self, x, prec):
        from repro_torch.kernels.ops import quantize_kv
        return quantize_kv(x, prec)

    def record(self, name, got, exp, tol, what, main_path=False, rel=0.0):
        torch = self.torch
        torch.cuda.synchronize()
        diff = (got.float() - exp.float()).abs()
        err = float(diff.max())
        over = float((diff - rel * exp.float().abs()).max())
        if not math.isfinite(err) or over > tol:
            raise AssertionError(f"{name} {what}: max abs err {err:.3e}, "
                                 f"{over:.3e} over the bound {tol:.1e} + "
                                 f"{rel:.3g} |expected|")
        if err > tol:
            self.by_ulp.append((f"{name} {what}", err))
        if main_path:
            errs = self.err.setdefault(main_path, dict.fromkeys(KERNELS, 0.0))
            errs[name] = max(errs[name], err)
        self.n_cases += 1
        return err

    # ---- paged decode ----
    def decode_case(self, B, H, KV, hd, page, n_pp, dtype, lens=None,
                    prec=None, main_path=False, what="", zero_rows=(),
                    kv_dtype=None):
        """``kv_dtype``: the pool's type when it is not quantized (q's
        type by default)."""
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
            kp, vp = kp.to(kv_dtype or dtype), vp.to(kv_dtype or dtype)
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
        tol, rel = TOL[str(dtype).replace("torch.", "")]
        return self.record("paged_decode_attention", out, exp, tol,
                           what or f"B{B} H{H} KV{KV} hd{hd} page{page} "
                                   f"{dtype} {prec or kv_dtype}", main_path,
                           rel)

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
                     prec=None, main_path=False, what="", kv_dtype=None,
                     scaled=False):
        """``kv_dtype``: the K/V type when it is not quantized (q's type
        by default); ``scaled``: unquantized K/V with per-token scales
        in [0.5, 1.5)."""
        torch = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.chunked_prefill_attention import \
            chunked_prefill_attention
        q = self.randn(B, Tq, H, hd, dtype=dtype)
        k = self.randn(B, S, KV, hd)
        v = self.randn(B, S, KV, hd)
        ks = vs = None
        if prec is None:
            k, v = k.to(kv_dtype or dtype), v.to(kv_dtype or dtype)
            if scaled:
                ks = torch.rand(B, S, generator=self.gen, device="cuda") + 0.5
                vs = torch.rand(B, S, generator=self.gen, device="cuda") + 0.5
        else:
            k, ks = self.quant(k, prec)
            v, vs = self.quant(v, prec)
        if offsets is None:
            offsets = torch.randint(0, S - Tq + 1, (B,),
                                    generator=self.cpu_gen)
        off = torch.as_tensor(offsets, dtype=torch.int32).cuda()
        out = chunked_prefill_attention(q, k, v, off, ks, vs)
        exp = ref.chunked_prefill_attention_ref(q, k, v, off, ks, vs)
        tol, rel = PREFILL_TOL[str(dtype).replace("torch.", "")]
        err = self.record("chunked_prefill_attention", out, exp, tol,
                          what or f"B{B} Tq{Tq} S{S} H{H} KV{KV} hd{hd} "
                                  f"{dtype} {prec or kv_dtype}", main_path,
                          rel)
        if dtype == torch.float32:
            self.f32_prefill[0] += 1
            self.f32_prefill[1] = max(self.f32_prefill[1], err)
        return err

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

    def prefill_nan_heads(self, hd, prec=None, B=2, Tq=130, S=300, H=2,
                          KV=1, pad=24):
        """A row below its instance width must be read at its own extent
        and head stride: q, k and v are row views of buffers laid out (B,
        rows, 2, heads, hd) whose second half of every row (with one KV
        head, the head after the valid one) and rows past Tq and S hold
        NaN (int8 codes: the extreme code).  The output must be finite and
        within tolerance of the plain version on the views."""
        torch = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.chunked_prefill_attention import \
            chunked_prefill_attention
        from repro_torch.kernels.ref import as_indexable
        bf16 = torch.bfloat16
        qb = self.randn(B, Tq + pad, 2, H, hd, dtype=bf16)
        kb = self.randn(B, S + pad, 2, KV, hd)
        vb = self.randn(B, S + pad, 2, KV, hd)
        ks = vs = None
        if prec is None:
            kb, vb = kb.to(bf16), vb.to(bf16)
        else:
            kb, ks = self.quant(kb, prec)
            vb, vs = self.quant(vb, prec)
            ks, vs = ks[:, :S, 0].contiguous(), vs[:, :S, 0].contiguous()
        qb[:, :, 1] = float("nan")
        qb[:, Tq:] = float("nan")
        bad = 127.0 if prec == "int8" else float("nan")
        for t in (kb, vb):
            for rows in ((slice(None), slice(None), 1),
                         (slice(None), slice(S, None))):
                as_indexable(t)[rows] = as_indexable(torch.full_like(
                    t[rows], bad, dtype=torch.float32).to(t.dtype))
        q, k, v = qb[:, :Tq, 0], kb[:, :S, 0], vb[:, :S, 0]
        off = torch.tensor([170, 0], dtype=torch.int32).cuda()
        out = chunked_prefill_attention(q, k, v, off, ks, vs)
        exp = ref.chunked_prefill_attention_ref(q, k, v, off, ks, vs)
        tol, rel = TOL["bfloat16"]
        return self.record("chunked_prefill_attention", out, exp, tol,
                           f"hd {hd} beside NaN heads, {prec or 'bf16'} KV",
                           rel=rel)


def serving_paths(kc, paths, hd: int = 128):
    """A serving path's shapes (8 slots, page 8, 512-page tables, 512-token
    chunks against 4096 keys) for bf16, fp8 and int8 pools: decode and
    prefill against the plain versions, poison pages past the lengths and
    inactive padded slots.  ``paths``: (name, H, KV, decode lengths), at
    head dim ``hd``."""
    import torch
    bf16 = torch.bfloat16
    B, page, n_pp = 8, 8, 512
    for path, H, KV, lens in paths:
        for prec in (None, "fp8", "int8"):
            kc.decode_case(B, H, KV, hd, page, n_pp, bf16, lens=lens,
                           prec=prec, main_path=path,
                           what=f"{path} {prec or 'bf16'} pool")
            kc.decode_poison(B, H, KV, hd, page, 64, bf16,
                             [1, 9, 100, 200, 255, 256, 511, 512], prec=prec)
            kc.prefill_case(B, 512, 4096, H, KV, hd, bf16,
                            offsets=[0, 0, 512, 1000, 1536, 2048, 3000, 3584],
                            prec=prec, main_path=path,
                            what=f"{path} {prec or 'bf16'} KV")
            kc.prefill_poison(2, 512, 2048, H, KV, hd, bf16, [0, 1000],
                              prec=prec)
        # inactive padded slots: length 1 and a zero table row
        kc.decode_case(B, H, KV, hd, page, 4, bf16, lens=[1] * B,
                       main_path=path, what=f"{path} inactive padded slots",
                       zero_rows=range(B))


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
    # the serving paths' shapes: 8 slots, page 8, contexts to 4096,
    # chunks of 512; Qwen2.5-14B (H 40, KV 8, 5 query heads a KV head),
    # Qwen3-30B-A3B (H 32, KV 4, 8 query heads a KV head) and Phi-4-mini
    # (H 24, KV 8, 3 query heads a KV head).  Drawn in this order, the fp8
    # edge case below (Tq 512, S 4000) comes out one bf16 ulp over the
    # bound's absolute term, within its ulp term.
    serving_paths(kc, (
        ("qwen2.5-14b", 40, 8, [1, 17, 300, 1024, 2047, 3000, 4095, 4096]),
        (MOE_PATH, 32, 4, [128, 300, 777, 1024, 2047, 3000, 4095, 4096]),
        (TRAIN_PATH, 24, 8, [1, 64, 513, 1024, 1999, 2048, 3333, 4096])))
    edge_cases(kc, 40, 8, 128)
    # the other bodies read through row views too
    kc.prefill_nan_edge(2, 33, 70, 4, 2, 64, bf16, [20, 37])
    kc.prefill_nan_edge(2, 33, 70, 4, 2, 64, f32, [20, 37])
    # every head dim the kernels take, not only the serving paths': rows
    # that leave lanes idle (40: 5 of 8 lanes a row in decode), that take
    # the whole warp (192, 256), the hd-192 wgmma tiles of 64 keys (S 300
    # is 5 of them, Tq 130 two q tiles) and the FMA body up to 256; qpk 6
    # leaves idle head slots in decode's last group (groups of 8 heads for
    # rows of up to 128, of 4 for wider rows)
    # f32 and bf16 queries on f32, bf16, fp8 and int8 pools
    for hd_x in HEAD_DIMS:
        for dt in (f32, bf16):
            for kv_dt, prec in ((f32, None), (bf16, None), (None, "fp8"),
                                (None, "int8")):
                kc.decode_case(2, 12, 2, hd_x, 8, 40, dt, lens=[9, 300],
                               prec=prec, kv_dtype=kv_dt)
                kc.prefill_case(2, 130, 300, 12, 2, hd_x, dt,
                                offsets=[170, 0], prec=prec, kv_dtype=kv_dt)
        kc.decode_poison(2, 4, 2, hd_x, 8, 8, bf16, [11, 40])
        kc.prefill_poison(2, 24, 96, 4, 2, hd_x, bf16, [0, 50])
        kc.prefill_poison(2, 24, 96, 4, 2, hd_x, f32, [0, 50])
        kc.prefill_nan_edge(2, 33, 70, 4, 2, hd_x, bf16, [20, 37])
        kc.prefill_nan_edge(2, 33, 70, 4, 2, hd_x, f32, [20, 37])
    for hd_x in PADDED_HEAD_DIMS:
        for prec in (None, "fp8", "int8"):
            kc.prefill_nan_heads(hd_x, prec)
    # the mma.sync body (bf16 queries on f32 pools and scaled bf16 pools
    # at its widths) and scaled bf16 pools on the 3xTF32 body beside it
    for hd_x in (32, 64, 128, 40):
        for kv_dt, scaled in ((f32, False), (bf16, True)):
            kc.prefill_case(2, 130, 300, 12, 2, hd_x, bf16, offsets=[170, 0],
                            kv_dtype=kv_dt, scaled=scaled,
                            what=f"hd {hd_x} bf16 queries, {kv_dt} KV"
                                 + (" with scales" if scaled else ""))
    log_kernel_checks(kc)
    return {name: max(errs[name] for errs in kc.err.values())
            for name in KERNELS}


def edge_cases(kc, H, KV, hd, page=8, n_pp=512, split=256):
    """Split-KV edges at a serving path's table width (spans of SPLIT =
    256 tokens, 32 pages of 8): lengths 1, page-1, SPLIT-1, SPLIT, SPLIT+1
    and the whole table, beside two padded inactive slots; poison pages
    past lengths that end inside a span.  Prefill edges: Tq 1, 130 and
    512; S no multiple of the K/V tile; S shorter than offset + Tq; S =
    4000, which wraps the K/V ring many times; NaN past Tq and S read
    through row views.  Every pool format, bf16 queries."""
    import torch
    bf16 = torch.bfloat16
    edge_lens = [1, page - 1, split - 1, split, split + 1, page * n_pp, 1, 1]
    for prec in (None, "fp8", "int8"):
        name = prec or "bf16"
        kc.decode_case(8, H, KV, hd, page, n_pp, bf16, lens=edge_lens,
                       prec=prec, zero_rows=(6, 7),
                       what=f"split edges hd {hd}, {name} pool")
        kc.decode_poison(8, H, KV, hd, page, 64, bf16,
                         [1, 7, 100, 255, 257, 300, 385, 511], prec=prec)
        for Tq, S, offs in [(1, 300, [0, 299]), (130, 300, [170, 250]),
                            (512, 4000, [0, 3700])]:
            kc.prefill_case(2, Tq, S, H, KV, hd, bf16, offsets=offs,
                            prec=prec, what=f"edges Tq {Tq} S {S} offsets "
                                            f"{offs} hd {hd}, {name} KV")
        kc.prefill_nan_edge(2, 130, 300, H, KV, hd, bf16, [170, 250],
                            prec=prec)
        kc.prefill_nan_edge(2, 512, 1000, H, KV, hd, bf16, [488, 0],
                            prec=prec)


def log_kernel_checks(kc, note=""):
    (bt, br), (ft, _) = TOL["bfloat16"], TOL["float32"]
    pt = PREFILL_TOL["float32"][0]
    log(f"[kernels] {kc.n_cases} cases within tolerance {note}(bf16 {bt} + "
        f"{br:.6g} |expected|, f32 decode {ft}, f32 prefill {pt}, poison "
        f"exact); "
        f"{len(kc.by_ulp)} bf16 cases over {bt} and within its one-ulp "
        f"term" + "".join(f"; {w}: {e:.3e}" for w, e in kc.by_ulp)
        + "; max abs err at the serving paths' shapes: "
        + "; ".join(f"{path}: " + ", ".join(f"{k} {v:.3e}"
                                            for k, v in errs.items())
                    for path, errs in kc.err.items()))
    if kc.f32_prefill[0]:
        log(f"[kernels] f32-query prefill (3xTF32 body) {note}: "
            f"{kc.f32_prefill[0]} cases, worst max abs err "
            f"{kc.f32_prefill[1]:.3e} (bound {pt})")


#: captures of one window under torch.profiler before giving up on it:
#: now and then the profiler hands back a trace that lost kernels
PROFILE_TRIES = 3


def device_ms(fn, n: int, split: dict | None = None) -> tuple:
    """Device time of one call of ``fn`` and what timed it: the summed
    duration of every kernel that ``n`` calls launch (both passes of
    split-KV decode), over ``n``, from torch.profiler's CUDA activity,
    recorded after one warm-up step of the profiler (a capture loses the
    first kernels it sees otherwise).  Every call launches the same
    kernels, so a capture whose count of kernels is no multiple of ``n``
    has lost some and is taken again.  Where ``PROFILE_TRIES`` captures
    all fail so, the CUDA-event time of ``n`` calls in its place (the
    kernels and the gaps between them), said so on the log and in the
    second value.  ``split``, where given, receives the device ms a call
    by kernel name (the sound capture's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            prof.step()
        kern = [ev for ev in prof.events()
                if ev.device_type == torch.autograd.DeviceType.CUDA]
        if kern and len(kern) % n == 0:
            for ev in kern if split is not None else ():
                name = ev.name.removeprefix("void ").removeprefix(
                    "(anonymous namespace)::")
                name = name.split("<")[0].split("(")[0].split("::")[-1]
                split[name] = (split.get(name, 0.0)
                               + ev.time_range.elapsed_us() / n / 1e3)
            return (sum(ev.time_range.elapsed_us() for ev in kern) / n / 1e3,
                    "torch.profiler")
        log(f"[timing] torch.profiler recorded {len(kern)} kernels for {n} "
            f"calls; capture taken again")
    ms = cuda_ms(fn, n, warmup=0)
    log(f"[timing] no sound torch.profiler capture in {PROFILE_TRIES}; "
        f"CUDA-event time {ms:.4f} ms a call taken as the device time")
    return ms, "events (torch.profiler lost kernels)"


#: a prefill row whose device time lies more than this share below its
#: event time quotes the event time: a prefill kernel outlasts the host's
#: launch of the next, so the two agree unless the profiler lost kernels
TIMING_GAP = 0.10


def settled(t) -> tuple:
    """``in_turns``'s (event ms, device ms, what timed it) of a prefill
    call -> (the ms to quote, what timed it): the device time, or the
    event time (which can only overstate the device's) where the two
    differ by more than ``TIMING_GAP``."""
    ev, dev, how = t
    if abs(ev - dev) <= TIMING_GAP * ev:
        return dev, how
    return ev, f"events (torch.profiler read {dev:.4f} ms)"


def in_turns(fns: dict, iters: int, rounds: int = 2) -> dict:
    """Event and device times of each callable, taken in turns (a, b, b,
    a, ...), so that callables timed together see the same card state;
    only ratios within one run are compared.  Means over the rounds, and
    what timed the device: torch.profiler, or events in the rounds where
    no capture was sound (``device_ms``)."""
    ev = {k: [] for k in fns}
    dev = {k: [] for k in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            ev[name].append(cuda_ms(fns[name], iters))
            dev[name].append(device_ms(fns[name], iters))
    out = {}
    for k in fns:
        lost = sum(how != "torch.profiler" for _, how in dev[k])
        out[k] = (sum(ev[k]) / rounds, sum(ms for ms, _ in dev[k]) / rounds,
                  "torch.profiler" if not lost else
                  f"events in {lost} of {rounds} rounds (torch.profiler "
                  f"lost kernels)")
    return out


def time_kernels(seed: int, path: str, H: int, KV: int, quant: bool = True,
                 hd: int = 128, dtype: str = "bfloat16", decode: bool = True):
    """Kernel, plain and SDPA times at one serving path's shapes (``H``
    query and ``KV`` key/value heads of ``hd``, in ``dtype``), with each
    kernel's bound from this run's inputs (f32 operations against the
    3xTF32 rate; f32 prefill also beside the bound at the f32 peak outside
    the tensor cores, which PERF.md's earlier rows used): event time of a
    loop of wrapper calls and device time of the kernels alone, each with
    what timed it, the kernel and SDPA in turns; with ``quant``, both
    kernels over fp8 and int8 pools too (no SDPA: no single PyTorch call
    attends over codes); without ``decode``, prefill alone.  The prefill
    row names the body the kernel took."""
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
    dt = getattr(torch, dtype)            # the working type of the path
    esz = torch.empty(0, dtype=dt).element_size()
    peak = BF16_FLOPS_PER_S if dtype == "bfloat16" else TF32X3_FLOPS_PER_S
    res = {}
    quant_dec = {}

    # paged decode: 8 slots, page 8, a table of 512 pages (4096 tokens) as
    # in the serve phase; long contexts spread up to 4096, then short ones
    # (128-256 tokens, one live span) as the serve phase's decode sees
    B, page, n_pp = 8, 8, 512
    n_pages = B * n_pp
    for label, lens_l in (("long", [512, 1024, 1536, 2048, 2560, 3072, 3584,
                                    4096]),
                          ("short", [128, 146, 164, 182, 201, 219, 237, 256])
                          ) if decode else ():
        if label == "long":
            q = torch.randn(B, H, hd, generator=g, device="cuda").to(dt)
            kp = torch.randn(n_pages, page, KV, hd, generator=g,
                             device="cuda").to(dt)
            vp = torch.randn(n_pages, page, KV, hd, generator=g,
                             device="cuda").to(dt)
            tbl = torch.randperm(n_pages, generator=gc).reshape(B, n_pp).to(
                torch.int32).cuda()
            kd = gather_pages(kp, tbl).transpose(1, 2).repeat_interleave(
                H // KV, 1)
            vd = gather_pages(vp, tbl).transpose(1, 2).repeat_interleave(
                H // KV, 1)
            qd = q[:, :, None, :]
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
        tbl_bytes = sum(-(-n // page) for n in lens_l) * 4 + B * 4
        n_bytes = (2 * B * H * hd * esz                    # q in, out
                   + 2 * ctx * KV * hd * esz               # live K and V
                   + tbl_bytes)
        r = dict(ms=t["kernel"][0], device_ms=t["kernel"][1],
                 timed_by=t["kernel"][2], plain_ms=plain,
                 library_ms=t["sdpa"][0], library_device_ms=t["sdpa"][1],
                 library_timed_by=t["sdpa"][2],
                 **bound(n_bytes, 4 * ctx * H * hd, peak),
                 shape=f"B={B} H={H} KV={KV} hd={hd} page={page} n_pp={n_pp} "
                       f"contexts={lens_l} {dtype}")
        res["paged_decode_attention" + ("" if label == "long" else
                                        " (short contexts)")] = r
        # quantized pools, long contexts: one byte a code and an f32 scale
        # a key row, for K and for V
        for prec in ("fp8", "int8") if quant and label == "long" else ():
            kq, ksq = quantize_kv(kp, prec)
            vq, vsq = quantize_kv(vp, prec)
            tq = in_turns({"kernel": lambda: paged_decode_attention(
                q, kq, vq, tbl, lens, ksq, vsq)}, 50, rounds=1)["kernel"]
            quant_dec[prec] = (tq, bound(
                2 * B * H * hd * esz + 2 * ctx * (KV * hd + 4) + tbl_bytes,
                4 * ctx * H * hd, peak))
            del kq, vq
    if decode:
        del kd, vd, kp, vp

    # chunked prefill: 8 rows of a 512-token chunk against S=4096
    Tq, S = 512, 4096
    offs_l = [0, 512, 1024, 1536, 2048, 2560, 3072, 3584]
    qp = torch.randn(B, Tq, H, hd, generator=g, device="cuda").to(dt)
    k = torch.randn(B, S, KV, hd, generator=g, device="cuda").to(dt)
    v = torch.randn(B, S, KV, hd, generator=g, device="cuda").to(dt)
    off = torch.tensor(offs_l, dtype=torch.int32).cuda()
    qd = qp.transpose(1, 2)
    kd = k.transpose(1, 2).repeat_interleave(H // KV, 1)
    vd = v.transpose(1, 2).repeat_interleave(H // KV, 1)
    qpos = off[:, None] + torch.arange(Tq, device="cuda")[None]
    mask = (torch.arange(S, device="cuda")[None, None] <= qpos[..., None])
    before = dict(cpa.body_launches)
    t = in_turns({
        "kernel": lambda: chunked_prefill_attention(qp, k, v, off),
        "sdpa": lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask[:, None])}, 10)
    body = [b for b in cpa.BODIES if cpa.body_launches[b] != before[b]]
    plain = cuda_ms(lambda: ref.chunked_prefill_attention_ref(
        qp, k, v, off), 3)
    visible = sum(min(S, o + i + 1) for o in offs_l for i in range(Tq))
    keys = sum(min(S, o + Tq) for o in offs_l)
    n_bytes = 2 * B * Tq * H * hd * esz + 2 * keys * KV * hd * esz + B * 4
    flops = 4 * visible * H * hd
    (dev, timed_by), (lib_dev, lib_timed_by) = (settled(t["kernel"]),
                                                settled(t["sdpa"]))
    res["chunked_prefill_attention"] = dict(
        ms=t["kernel"][0], device_ms=dev, timed_by=timed_by,
        plain_ms=plain, library_ms=t["sdpa"][0], library_device_ms=lib_dev,
        library_timed_by=lib_timed_by, **bound(n_bytes, flops, peak),
        body="/".join(body),
        shape=f"B={B} Tq={Tq} S={S} H={H} KV={KV} hd={hd} offsets={offs_l} "
              f"{dtype}")
    if dtype == "float32":
        res["chunked_prefill_attention"]["f32_cuda_core_bound_ms"] = \
            flops / F32_FLOPS_PER_S * 1e3
    # quantized pools at the same shape: their codes convert to bf16 in
    # the kernel, so the same operations count, over 1-byte codes plus an
    # f32 scale a key row
    del kd, vd
    q_bound = bound(2 * B * Tq * H * hd * esz + 2 * keys * (KV * hd + 4)
                    + B * 4, flops)
    quant_t = {}
    for prec in ("fp8", "int8") if quant else ():
        kq, ksq = quantize_kv(k, prec)
        vq, vsq = quantize_kv(v, prec)
        before = dict(cpa.body_launches)
        tq = in_turns({"kernel": lambda: chunked_prefill_attention(
            qp, kq, vq, off, ksq, vsq)}, 10, rounds=1)["kernel"]
        quant_t[prec] = (tq[0], *settled(tq), [
            b for b in cpa.BODIES if cpa.body_launches[b] != before[b]])
        del kq, vq
    for name, r in res.items():
        f32 = (f"; at the f32 CUDA-core peak {r['f32_cuda_core_bound_ms']:.4f}"
               f" ms, {r['f32_cuda_core_bound_ms'] / r['device_ms']:.3f} of it"
               if "f32_cuda_core_bound_ms" in r else "")
        log(f"[time] {path} {name}"
            + (f" ({r['body']} body)" if "body" in r else "")
            + f": kernel {r['ms']:.4f} ms (events), device "
            f"{r['device_ms']:.4f} ms ({r['timed_by']}); SDPA "
            f"{r['library_ms']:.4f} ms (events), device "
            f"{r['library_device_ms']:.4f} ms ({r['library_timed_by']}); "
            f"plain {r['plain_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), {r['bound_ms'] / r['device_ms']:.3f} of it "
            f"on the device{f32}; "
            f"device time / SDPA device time "
            f"{r['device_ms'] / r['library_device_ms']:.3f}; at {r['shape']}")
    for prec, (tq, qb) in quant_dec.items():
        log(f"[time] {path} paged_decode_attention, {prec} pool: "
            f"{tq[0]:.4f} ms (events), device {tq[1]:.4f} ms ({tq[2]}), "
            f"long contexts; bound {qb['bound_ms']:.4f} ms ({qb['bound_by']}: "
            f"codes and scales), {qb['bound_ms'] / tq[1]:.3f} of it on the "
            f"device; no single PyTorch call attends over {prec} codes with "
            f"per-token scales")
    for prec, (ev, dev, timed_by, bodies) in quant_t.items():
        log(f"[time] {path} chunked_prefill_attention, {prec} pool "
            f"({'/'.join(bodies)} body): {ev:.4f} ms (events), device "
            f"{dev:.4f} ms ({timed_by}), same shape; bound "
            f"{q_bound['bound_ms']:.4f} ms ({q_bound['bound_by']}), "
            f"{q_bound['bound_ms'] / dev:.3f} of it on the device; no single "
            f"PyTorch call attends over {prec} codes with per-token scales")
    res.pop("paged_decode_attention (short contexts)", None)
    return res


#: prefill alone at head dims the serving paths do not time, each beside
#: one SDPA call at its dtype: (label, H, KV, hd, dtype); B 8, Tq 512, S
#: 4096 as in ``time_kernels``
PREFILL_ROWS = (
    ("phi4-mini-3.8b smoke in bf16", 6, 2, 40, "bfloat16"),
    ("whisper-large-v3 attention", 20, 20, 64, "bfloat16"),
    ("hd 96", 24, 8, 96, "bfloat16"),
    ("recurrentgemma-9b attention", 16, 1, 256, "bfloat16"),
    ("qwen2.5-14b in f32 (card-vs-CPU layout)", 40, 8, 128, "float32"),
)


def time_hd32_bodies(seed: int, H: int = 32, KV: int = 8):
    """hd 32 in bf16 at the prefill shapes of ``time_kernels``: the wgmma
    body (rows padded to 64; an unscaled bf16 pool) against mma.sync at
    its native width (the same pool with unit per-token scales, which
    send it there), and one SDPA call at the shape, in turns.  Logs one
    line; the rule in ``shapes.prefill_body`` sends unscaled bf16 pools at
    hd 32 to wgmma.  Returns the ``mma.sync`` call's row (the body of
    bf16 queries on f32 or scaled bf16 pools at hd 32, 64 and 128): its
    times, bound and SDPA's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import chunked_prefill_attention as cpa
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, Tq, S, hd, bf16 = 8, 512, 4096, 32, torch.bfloat16
    qp = torch.randn(B, Tq, H, hd, generator=g, device="cuda").to(bf16)
    k = torch.randn(B, S, KV, hd, generator=g, device="cuda").to(bf16)
    v = torch.randn(B, S, KV, hd, generator=g, device="cuda").to(bf16)
    ones = torch.ones(B, S, device="cuda")
    offs = [0, 512, 1024, 1536, 2048, 2560, 3072, 3584]
    off = torch.tensor(offs, dtype=torch.int32).cuda()
    qd = qp.transpose(1, 2)
    kd = k.transpose(1, 2).repeat_interleave(H // KV, 1)
    vd = v.transpose(1, 2).repeat_interleave(H // KV, 1)
    qpos = off[:, None] + torch.arange(Tq, device="cuda")[None]
    mask = (torch.arange(S, device="cuda")[None, None] <= qpos[..., None])
    before = dict(cpa.body_launches)
    t = in_turns({
        "wgmma": lambda: cpa.chunked_prefill_attention(qp, k, v, off),
        "mma_sync": lambda: cpa.chunked_prefill_attention(qp, k, v, off,
                                                          ones, ones),
        "sdpa": lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask[:, None])}, 10)
    took = {b: cpa.body_launches[b] - before[b] for b in ("wgmma",
                                                          "mma_sync")}
    if not all(took.values()):
        raise AssertionError(f"hd 32 bodies: launches {took}")
    log(f"[time] hd 32 prefill bodies (B {B}, Tq {Tq}, S {S}, H {H}, KV "
        f"{KV}, bf16): wgmma padded to 64 device {t['wgmma'][1]:.4f} ms "
        f"(events {t['wgmma'][0]:.4f}); mma.sync at 32 with unit scales "
        f"device {t['mma_sync'][1]:.4f} ms (events {t['mma_sync'][0]:.4f}); "
        f"wgmma / mma.sync {t['wgmma'][1] / t['mma_sync'][1]:.3f}")
    # the mma.sync call: bf16 q and out, bf16 K/V rows and their f32
    # scales read once, the offsets; the causal products
    visible = sum(min(S, o + i + 1) for o in offs for i in range(Tq))
    keys = sum(min(S, o + Tq) for o in offs)
    row = dict(ms=t["mma_sync"][0], device_ms=t["mma_sync"][1],
               timed_by=t["mma_sync"][2], library_ms=t["sdpa"][0],
               library_device_ms=t["sdpa"][1], body="mma_sync",
               **bound(2 * B * Tq * H * hd * 2 + 2 * keys * (KV * hd * 2 + 4)
                       + B * 4, 4 * visible * H * hd),
               shape=f"B={B} Tq={Tq} S={S} H={H} KV={KV} hd={hd} "
                     f"offsets={offs} bfloat16, unit per-token scales")
    log(f"[time] chunked_prefill_attention (mma_sync body), hd 32, bf16 "
        f"queries on a scaled bf16 pool: device {row['device_ms']:.4f} ms "
        f"(events {row['ms']:.4f}); bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}), {row['bound_ms'] / row['device_ms']:.3f} of "
        f"it on the device; SDPA device {row['library_device_ms']:.4f} ms "
        f"(events {row['library_ms']:.4f}), device time / SDPA device time "
        f"{row['device_ms'] / row['library_device_ms']:.3f}")
    return row


#: the cross terms of the 3xTF32 body's products (hi.lo, lo.hi):
#: ``run_tf32_one_pass`` builds a copy of the source without them
TF32_CROSS_TERMS = "  mma(d, al, bh0, bh1);\n  mma(d, ah, bl0, bl1);\n"


def build_variants(name: str, edits: dict) -> dict:
    """Patched copies of the kernel source ``name``, built in parallel
    under ``build/<tag>/``: ``edits`` maps a tag to (old, new) pairs, each
    ``old`` found exactly once in the source.  Returns tag -> the loaded
    library, and the seconds the builds took."""
    import ctypes
    from repro_torch.kernels import _build
    src = (_build.CSRC / f"{name}.cu").read_text()
    procs = {}
    t0 = time.monotonic()
    for tag, pairs in edits.items():
        text = src
        for old, new in pairs:
            if text.count(old) != 1:
                raise AssertionError(f"{tag}: {old!r} is not found exactly "
                                     f"once in {name}.cu")
            text = text.replace(old, new)
        out_dir = _build.build_dir() / tag
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{name}.cu").write_text(text)
        procs[tag] = (out_dir / f"{name}.so", subprocess.Popen(
            [_build.nvcc_path(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS,
             "-o", str(out_dir / f"{name}.so"), str(out_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for tag, (so, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{tag}: nvcc failed: {err[-2000:]}")
        libs[tag] = ctypes.CDLL(str(so))
    return libs, time.monotonic() - t0


@contextlib.contextmanager
def kernel_library(name: str, lib):
    """Calls of the kernel ``name`` go to ``lib`` inside the block."""
    from repro_torch.kernels import _build
    real = _build.load(name)
    _build._libs[name] = lib
    try:
        yield
    finally:
        _build._libs[name] = real


def run_tf32_one_pass(seed: int):
    """The f32 prefill bound (``PREFILL_TOL``) tells three TF32 passes
    from one.  A copy of the prefill source without the cross terms of its
    products (hi.hi alone: one TF32 pass) is built under ``build/``, and
    f32 prefill cases run on it and on the real build at the same inputs:
    the sweep's shape at every head dim of ``HEAD_DIMS`` and the phi4-mini
    smoke layout at the timing shapes.  Fails unless the real build keeps
    every case within the bound and the one-pass copy exceeds it in
    every case."""
    import torch
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import chunked_prefill_attention as cpa
    name = "chunked_prefill_attention"
    libs, built = build_variants(
        name, {"tf32_one_pass": [(TF32_CROSS_TERMS, "")]})
    real = _build.load(name)
    g = torch.Generator(device="cuda").manual_seed(seed)
    gc_ = torch.Generator().manual_seed(seed)
    tol = PREFILL_TOL["float32"][0]
    shapes_ = [(2, 130, 300, 12, 2, hd) for hd in HEAD_DIMS]
    shapes_.append((8, 512, 4096, 6, 2, 40))
    rows = []
    for B, Tq, S, H, KV, hd in shapes_:
        q = torch.randn(B, Tq, H, hd, generator=g, device="cuda")
        k = torch.randn(B, S, KV, hd, generator=g, device="cuda")
        v = torch.randn(B, S, KV, hd, generator=g, device="cuda")
        off = torch.randint(0, S - Tq + 1, (B,), generator=gc_).to(
            torch.int32).cuda()
        exp = ref.chunked_prefill_attention_ref(q, k, v, off)
        errs = []
        for lib in (real, libs["tf32_one_pass"]):
            with kernel_library(name, lib):
                got = cpa.chunked_prefill_attention(q, k, v, off)
            torch.cuda.synchronize()
            errs.append(float((got - exp).abs().max()))
        rows.append((f"B{B} Tq{Tq} S{S} H{H} KV{KV} hd{hd}", *errs))
    log(f"[tf32_one_pass] f32 prefill, max abs err of the 3xTF32 build / a "
        f"one-pass (hi.hi) copy built in {built:.1f} s, bound {tol}: "
        + "; ".join(f"{w}: {a:.3e} / {b:.3e}" for w, a, b in rows))
    over = sum(b > tol for _, _, b in rows)
    if any(not a <= tol for _, a, _ in rows) or over < len(rows):
        raise AssertionError(f"tf32_one_pass: the bound {tol} does not tell "
                             f"three passes from one: {rows}")
    log(f"[tf32_one_pass] the one-pass copy exceeds {tol} in {over} of "
        f"{len(rows)} cases; the 3xTF32 build keeps every case within it")


# ---------------------------------------------------------------------------
# The prefill kernel's packed-row body: checks (kernels phase), planted
# faults and times (--phases packed)
# ---------------------------------------------------------------------------
#: head layouts the packed-row body is checked at: (label, H, KV, hd)
PACKED_LAYOUTS = (("qwen2.5-14b", 40, 8, 128), (MOE_PATH, 32, 4, 128),
                  ("qwen2.5-14b tp2 shard", 20, 4, 128),
                  (NEMOTRON_PATH, 96, 8, 192), ("smoke layout in bf16", 8, 2,
                                                 32))
#: the card benchmark's mixed step: a 512-token chunk at the cell's mean
#: offset beside decode rows at its contexts (2,000-4,600 tokens), in the
#: rung of 520 rows; (n_pp, [(slot, first position, tokens), ...])
PACKED_STEPS = ((512, [(0, 768, 512), (1, 2300, 1), (2, 3900, 1)]),
                (1024, [(0, 768, 512), (1, 2300, 1), (2, 4600, 1)]))
#: faults planted in copies of the prefill source, each of which the
#: packed-row check must catch: tag -> (old, new) edits
PACKED_FAULTS = {
    # the merge adds the spans' outputs without their 2^(m_s - M) weights
    "packed_fault_merge_weight": [(
        "const float f = ex2(ml[s].x - mx);", "const float f = 1.f;")],
    # the merge leaves out a split row's last span (its newest keys)
    "packed_fault_last_span": [(
        "if (s < ns) {\n        const float f = ex2(",
        "if (s + 1 < ns) {\n        const float f = ex2(")],
    # the causal frontier one key short: a row does not see its own key
    "packed_fault_frontier": [
        ("\n          x0 = (key <= qpos0 && key < kv_end)",
         "\n          x0 = (key < qpos0 && key < kv_end)"),
        ("\n          x1 = (key <= qpos1 && key < kv_end)",
         "\n          x1 = (key < qpos1 && key < kv_end)")],
}


def packed_helpers():
    """The card tests' packed-step builder and per-slot check, which this
    script shares: ``tests/test_torch_gpu.py`` loaded by its path (an
    installed package named ``tests`` may shadow the repo's)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "card_tests", ROOT / "tests" / "test_torch_gpu.py")
    t = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(t)
    return t.mixed_items, t.packed_problem, t.packed_errors, t.PACKED_ULP


def run_packed_checks(seed: int):
    """The packed-row body (a packed step's rows over the page pool
    through the block tables) against the plain version of each slot's
    attention at the serving head layouts: a 512-token chunk beside 1, 4
    and 7 long-context decode rows, tables of 512 and 1024 pages (256 at
    hd 192), each slot within ``PACKED_ULP`` of its largest output plus
    one bf16 ulp of each (the card tests' bound), pad rows zeros."""
    import torch
    from repro_torch.kernels import chunked_prefill_attention as cpa
    mixed_items, packed_problem, packed_errors, ulp = packed_helpers()
    t0 = time.monotonic()
    worst, share, n_slots = 0.0, 0.0, 0
    for i, (label, H, KV, hd) in enumerate(PACKED_LAYOUTS):
        for n_pp in ((256,) if hd > 128 else (512, 1024)):
            for n_dec in (1, 4, 7):
                q, kp, vp, tbl, slots, items, rows = packed_problem(
                    "cuda", H, KV, hd, n_pp, mixed_items(n_pp, n_dec),
                    seed=seed + i)
                got = cpa.packed_prefill_attention(q, kp, vp, tbl, slots)
                torch.cuda.synchronize()
                if not bool(torch.isfinite(got).all()) or bool(
                        got[rows:].any()):
                    raise AssertionError(f"packed {label}: non-finite "
                                         f"output or a pad row not zero")
                errs = packed_errors(got, q, kp, vp, tbl, items)
                for (b, off, n), (err, sh) in zip(items, errs):
                    if not sh <= 1.0:
                        raise AssertionError(
                            f"packed {label} n_pp {n_pp} slot {b} ({n} "
                            f"rows at {off}): max abs err {err:.3e}, "
                            f"{sh:.2f} of the bound")
                worst = max(worst, max(e for e, _ in errs))
                share = max(share, max(sh for _, sh in errs))
                n_slots += len(errs)
                del q, kp, vp, got
    torch.cuda.empty_cache()
    log(f"[kernels] packed-row body: {n_slots} slots within {ulp:.4g} "
        f"(max |expected| of the slot + |expected|) at "
        f"{', '.join(l for l, *_ in PACKED_LAYOUTS)}: max abs err "
        f"{worst:.3e}, at most {share:.3f} of the bound; pad rows zeros "
        f"({time.monotonic() - t0:.1f} s)")


def run_packed(seed: int, card: str):
    """The packed-row body's check catches planted faults, and its times:
    (a) three copies of the prefill source, each with one fault
    (``PACKED_FAULTS``), and the real build with one block-table entry of
    each slot's last page pointing at an unused page (a lost page), run
    on the cell's layout beside 7 decode rows: each fault must put a slot
    over the bound that the real build keeps; (b) timed at the card
    benchmark's mixed step beside its bound (the yardstick's) and beside
    the path for the same rows without the body (the scatter to (8, 512),
    the pages gathered, the wgmma body, the rows gathered back), in
    turns; (c) decode rows alone against ``paged_decode_attention`` on
    the same rows."""
    import torch
    from cardbench.yardstick import prefill_attention_call
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import chunked_prefill_attention as cpa
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention
    mixed_items, packed_problem, packed_errors, _ = packed_helpers()
    t0 = time.monotonic()
    name = "chunked_prefill_attention"
    libs, built = build_variants(name, PACKED_FAULTS)
    H, KV, hd, n_pp = 40, 8, 128, 512
    q, kp, vp, tbl, slots, items, _ = packed_problem(
        "cuda", H, KV, hd, n_pp, mixed_items(n_pp, 7), seed=seed)
    lost = tbl.clone()
    for b, off, n in items:
        lost[b, (off + n - 1) // 8] = kp.shape[0] - 1   # never in a table
    runs = {"real build": (_build.load(name), tbl)}
    runs.update({tag: (lib, tbl) for tag, lib in libs.items()})
    runs["real build, a lost page"] = (_build.load(name), lost)
    shares = {}
    for tag, (lib, table) in runs.items():
        with kernel_library(name, lib):
            got = cpa.packed_prefill_attention(q, kp, vp, table, slots)
        torch.cuda.synchronize()
        shares[tag] = [sh for _, sh in packed_errors(got, q, kp, vp, tbl,
                                                     items)]
    log(f"[packed] planted faults (fault copies built in {built:.1f} s), "
        f"each slot's largest share of the bound, slots {[b for b, *_ in items]}: "
        + "; ".join(f"{tag}: " + ", ".join(f"{x:.3g}" for x in sh)
                    for tag, sh in shares.items()))
    missed = [tag for tag, sh in shares.items()
              if tag != "real build" and max(sh) <= 1.0]
    if max(shares["real build"]) > 1.0 or missed:
        raise AssertionError(f"packed: the bound does not tell the real "
                             f"build from a faulty one: {missed or shares}")
    del q, kp, vp
    torch.cuda.empty_cache()
    for n_pp, items in PACKED_STEPS:
        q, kp, vp, tbl, slots, items, _ = packed_problem(
            "cuda", H, KV, hd, n_pp, items, seed=seed)
        before = dict(cpa.body_launches)
        dest = ops.scatter_rows(slots, q.shape[0], 512)   # once a step

        def t_packed():
            return cpa.packed_prefill_attention(q, kp, vp, tbl, slots)

        def t_gather():
            return ops.packed_prefill_by_scatter(q, kp, vp, tbl, slots, 512,
                                                 dest)

        t = in_turns({"packed": t_packed, "gather": t_gather}, 20)
        took = {b: n - before[b] for b, n in cpa.body_launches.items()
                if n != before[b]}
        real = [(n, off) for _, off, n in items]
        b = bound(*prefill_attention_call(real, H, KV, hd))
        split = {k: {} for k in ("packed", "gather")}
        device_ms(t_packed, 20, split["packed"])
        device_ms(t_gather, 20, split["gather"])
        # device time: a loop of wrapper calls is host-bound here (three
        # tensor maps encoded a call), which a graph's replay never is
        (_, dev, how), (_, gdev, ghow) = t["packed"], t["gather"]
        log(f"[time] packed-row body, qwen2.5-14b mixed step (H {H} / KV "
            f"{KV} / hd {hd}, page 8, n_pp {n_pp}, rows (tokens, first "
            f"position) {real} in the rung of 520): device {dev:.4f} ms "
            f"({how}), events {t['packed'][0]:.4f} ms; bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}), {b['bound_ms'] / dev:.3f}"
            f" of it on the device; the scatter + gather + wgmma path: device "
            f"{gdev:.4f} ms ({ghow}), events {t['gather'][0]:.4f} ms, "
            f"{b['bound_ms'] / gdev:.3f} of the bound; gather path / packed "
            f"{gdev / dev:.2f}x; launches by body {took}; device ms by "
            f"kernel: " + "; ".join(
                f"{k} " + ", ".join(f"{n} {ms:.4f}" for n, ms in v.items())
                for k, v in split.items()))
        del q, kp, vp
        torch.cuda.empty_cache()
    # decode rows alone: the packed body's cost of a decode row against
    # the paged-decode kernel's on the same rows
    n_pp = 1024
    ctx = [2300 + 330 * i for i in range(7)]
    q, kp, vp, tbl, slots, _, _ = packed_problem(
        "cuda", H, KV, hd, n_pp, [(b, c - 1, 1) for b, c in enumerate(ctx)],
        N=24, seed=seed)
    lens = torch.tensor(ctx + [0], dtype=torch.int32, device="cuda")
    qd = torch.zeros(8, H, hd, dtype=torch.bfloat16, device="cuda")
    qd[:7] = q[:7]

    def t_packed():
        return cpa.packed_prefill_attention(q, kp, vp, tbl, slots)

    t = in_turns({
        "packed": t_packed,
        "decode": lambda: paged_decode_attention(qd, kp, vp, tbl, lens)}, 50)
    (_, dev, how), (_, ddev, dhow) = t["packed"], t["decode"]
    split = {}
    device_ms(t_packed, 50, split)
    log(f"[time] packed-row body, 7 decode rows alone (contexts {ctx}, "
        f"n_pp {n_pp}): device {dev:.4f} ms ({how}); paged_decode_attention "
        f"on the same rows {ddev:.4f} ms ({dhow}); packed / decode "
        f"{dev / ddev:.2f}x; device ms by kernel: "
        + ", ".join(f"{n} {ms:.4f}" for n, ms in split.items()))
    log(f"[packed] phase wall {time.monotonic() - t0:.1f} s; card {card}")


def bound(n_bytes: float, flops: float,
          flops_per_s: float = BF16_FLOPS_PER_S) -> dict:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
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
    from repro_torch.kernels.ops import gather_pages, gather_scales
    from repro_torch.models import mixers

    def paged_prefill(q, kp, vp, tbl, offsets, ks=None, vs=None):
        return ref.chunked_prefill_attention_ref(
            q, gather_pages(kp, tbl), gather_pages(vp, tbl), offsets,
            None if ks is None else gather_scales(ks, tbl),
            None if vs is None else gather_scales(vs, tbl))

    saved = (mixers.paged_decode_attention_op,
             mixers.paged_prefill_attention_op)
    mixers.paged_decode_attention_op = ref.paged_decode_attention_ref
    mixers.paged_prefill_attention_op = paged_prefill
    try:
        yield
    finally:
        (mixers.paged_decode_attention_op,
         mixers.paged_prefill_attention_op) = saved


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


def run_model_check(seed: int, cfg=None, tag: str = "model"):
    """``cfg`` (Qwen2.5-14B by default) at full width and 2 layers in
    bf16: the paged forward through the kernels and through the plain
    attention on the same weights, logits within ``MODEL_TOL``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg = (cfg or get_config("qwen2.5-14b")).with_(n_layers=2)
    t0 = time.monotonic()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                         device="cuda")
    n_bytes = tensor_bytes(params)
    with torch.no_grad():
        got, fed = model_steps(params, cfg, "cuda", seed)
        with plain_attention():
            exp, _ = model_steps(params, cfg, "cuda", seed, feed=fed)
    worst, steps, same = 0.0, [], 0
    for i, (a, b) in enumerate(zip(got, exp)):
        if a.shape != (2, 1, cfg.vocab_size) or not torch.isfinite(a).all():
            raise AssertionError(f"model step {i}: bad logits {a.shape}")
        steps.append(float((a - b).abs().max()))
        worst = max(worst, steps[-1])
        same += int((a.argmax(-1) == b.argmax(-1)).sum())
    top = max(float(b.abs().max()) for b in exp)
    tol = model_tol(torch.tensor(top))
    step = 2.0 ** (math.floor(math.log2(top)) - 7)   # bf16 step at |top|
    line = (f"[{tag}] {cfg.name} full width (H {cfg.n_heads}, KV "
            f"{cfg.n_kv_heads}, hd {cfg.hd}), 2 layers, bf16, weights "
            f"{n_bytes / 1e9:.3f} GB: {len(got)} steps (prefill, mixed, "
            f"decode) in {time.monotonic() - t0:.1f} s; logits kernels vs "
            f"plain max abs err {worst:.3e} by step "
            f"[{', '.join(f'{e:.3e}' for e in steps)}] (tol {tol:.3g}: "
            f"MODEL_TOL at a largest |logit| of {top:.3f}, whose bf16 step "
            f"is {step:.3g}; the error is {worst / step:.2f} steps; logits "
            f"std {float(exp[0].std()):.3f}); argmax equal {same}/"
            f"{2 * len(got)}")
    if worst > tol:
        raise AssertionError(f"model logits kernels vs plain: {line}")
    log(line)
    del params
    gc.collect()
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
          page=8, max_chunk=512, transfer_chunk=128, slo=0.1,
          devices_per_instance=1):
    from repro_torch.core.session import ServeSession, SessionConfig
    from repro_torch.engine.backend import EngineBackend
    from repro_torch.sim.policies import ColocationPolicy, DynaServePolicy
    backend = EngineBackend(cfg, params, n_slots=n_slots,
                            max_len=n_pages * page // n_slots,
                            page_size=page, n_pages=n_pages,
                            max_chunk=max_chunk,
                            transfer_chunk=transfer_chunk,
                            devices_per_instance=devices_per_instance)
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


@contextlib.contextmanager
def step_tally():
    """Count every engine step while it runs: all of them, those a CUDA
    graph ran, and the paged kernel launches the eager step makes for
    them (one a paged attention layer and shard: ``paged_decode_attention``
    at T == 1, ``chunked_prefill_attention`` otherwise), which a graphed
    run's counters must equal; and each engine's captures and their
    seconds.  For the report and that check; the port never does this."""
    from repro_torch.engine import runner
    cls = runner.InstanceEngine
    dispatch = cls.dispatch_batch
    tally = {"steps": 0, "graphed": 0,
             "eager_launches": dict.fromkeys(KERNELS, 0), "captures": {}}

    def counted(self, items):
        handle = dispatch(self, items)
        if handle is not None:
            tally["steps"] += 1
            tally["graphed"] += int(self.graphs)
            if self.paged:
                kernel = KERNELS[0 if max(len(it.tokens) for it in items)
                                 == 1 else 1]
                tally["eager_launches"][kernel] += self.cfg.n_layers * \
                    self.tp
            tally["captures"][id(self)] = (self.captures,
                                           self.capture_seconds)
        return handle

    cls.dispatch_batch = counted
    try:
        yield tally
    finally:
        cls.dispatch_batch = dispatch


def tally_line(tally) -> str:
    n = sum(c for c, _ in tally["captures"].values())
    sec = sum(t for _, t in tally["captures"].values())
    return (f"{tally['graphed']} of {tally['steps']} steps through CUDA "
            f"graphs, {n} captures in {sec:.2f} s")


def check_graphed(tally, what: str, device: str):
    """On the card every step replays a graph (sharded instances'
    included); on the CPU none does."""
    want = tally["steps"] if device == "cuda" else 0
    if tally["graphed"] != want:
        raise AssertionError(f"{what}: {tally_line(tally)}, not {want}")


def serve_counted(cfg, params, reqs, card: str, device: str, label: str,
                  **sizes):
    """Serve through DynaServe (a main path) with the kernels' launch
    counters zeroed just before and read just after.  Fails without a KV
    handoff, and on the card when a kernel was not launched or a prefill
    launch missed the ``wgmma`` and packed-row bodies.  Returns (token
    streams, launches
    by kernel, the run's peak allocated device bytes)."""
    import torch
    from repro_torch.kernels import chunked_prefill_attention as cpa
    from repro_torch.kernels import paged_decode_attention as pda
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    pda.launches = 0
    cpa.launches = 0
    cpa.body_launches = dict.fromkeys(cpa.COUNTED, 0)
    with step_tally() as tally:
        outs, m, moved, wall = serve(cfg, params, reqs, "dynaserve",
                                     **sizes)
    launches = {"paged_decode_attention": pda.launches,
                "chunked_prefill_attention": cpa.launches}
    bodies = dict(cpa.body_launches)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    held = torch.cuda.max_memory_reserved() if device == "cuda" else 0
    pool = graph_pool_bytes(device) if device == "cuda" else 0
    if moved <= 0:
        raise AssertionError("no KV handoff: DynaServe split no request")
    report(label, m, moved, wall, card)
    log(f"[serve] {label} kernel launches: {launches}; "
        f"chunked_prefill_attention by body: {bodies}; max allocated in "
        f"the run {peak / 1e9:.3f} GB, max reserved {held / 1e9:.3f} GB "
        f"(the graph pool's temporaries are reserved, not allocated, "
        f"while a graph replays; the pool holds "
        f"{'not measured' if pool is None else f'{pool / 1e9:.3f} GB'} at "
        f"the end); {tally_line(tally)}; the eager step launches {tally['eager_launches']} for these "
        f"steps")
    check_graphed(tally, label, device)
    if device == "cuda" and launches != tally["eager_launches"]:
        raise AssertionError(f"{label}: launches counted {launches}, the "
                             f"eager step's for the same steps "
                             f"{tally['eager_launches']}")
    if device == "cuda":
        for name, n in launches.items():
            if n <= 0:
                raise AssertionError(f"{name} was not launched on the "
                                     f"{cfg.name} path")
        if bodies["wgmma"] + bodies["packed"] != cpa.launches:
            raise AssertionError(f"bf16 prefill launches that missed the "
                                 f"wgmma and packed-row bodies: {bodies}")
    return outs, launches, peak


def time_decode(cfg, params, card: str, n_slots: int = 8, ctx: int = 1024,
                chunk: int = 512, steps: int = 8, device="cuda",
                width: int = 1, tag: str = "serve"):
    """``steps`` decode steps of every slot of one engine at context
    ``ctx``, eager (``graphs=False``) and then graphed, each mode on its
    own engine (``width`` shards time-sharing the card): wall time a step
    from CUDA events around the loop (each step dispatched and its logits
    collected, as the session does), device time a step from
    torch.profiler over the same loop run again, and the idle share 1 -
    device / wall.  Returns {mode: (wall ms, device ms)}."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.engine import BatchItem, InstanceEngine
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (n_slots, ctx)).astype(np.int32)
    out = {}
    for mode in ("eager", "graphed"):
        eng = InstanceEngine(cfg, params, n_slots=n_slots, page_size=8,
                             n_pages=n_slots * (ctx + chunk) // 8,
                             max_chunk=chunk, max_len=ctx + chunk,
                             graphs=mode == "graphed",
                             devices=[device] * width)
        if eng.graphs != (mode == "graphed"):
            raise AssertionError(f"a {mode} engine of width {width} has "
                                 f"graphs={eng.graphs}")
        slots = [eng.alloc(f"r{i}") for i in range(n_slots)]
        for lo in range(0, ctx, chunk):
            eng.run_batch([BatchItem(s, toks[i, lo:lo + chunk], lo)
                           for i, s in enumerate(slots)])
        pos = [ctx]

        def decode():
            eng.run_batch([BatchItem(s, toks[i, :1], pos[0], True)
                           for i, s in enumerate(slots)])
            pos[0] += 1

        decode()
        decode()                     # the key is captured (graphed)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(steps):
            decode()
        end.record()
        torch.cuda.synchronize()
        wall = start.elapsed_time(end) / steps
        busy = 0.0
        for _ in range(PROFILE_TRIES):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(steps):
                    decode()
                torch.cuda.synchronize()
            busy = sum(ev.time_range.elapsed_us() for ev in prof.events()
                       if ev.device_type == torch.autograd.DeviceType.CUDA)
            if busy > 0:
                break
        dev = busy / steps / 1e3
        out[mode] = (wall, dev)
        log(f"[{tag}] {cfg.name} decode step, "
            f"{f'width {width} (two shards time-sharing the card), ' if width > 1 else ''}"
            f"{mode} "
            f"({'one CUDA graph a (T, n_pp) key' if mode == 'graphed' else 'graphs=False'}"
            f"): B={n_slots}, T=1, context {ctx}: wall "
            f"{wall:.3f} ms a step (CUDA events over {steps} steps, logits "
            f"collected each step), device "
            f"{f'{dev:.3f} ms' if busy else 'not measured (the profiler recorded no kernel)'}"
            f"{f', idle share {1 - dev / wall:.3f}' if busy else ''}; "
            f"{card}")
        eng.close()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


def run_serve(seed: int, card: str, cfg=None, device="cuda", n_slots=8,
              n_pages=4096, max_chunk=512, reqs=None, params=None,
              decode_timing: bool = False):
    """Serve through DynaServe (the main path, counted) then colocation,
    on ``params`` (random weights from ``seed`` when not given), and with
    ``decode_timing`` time decode steps eager against graphed
    (``time_decode``).  Returns the main path's launch counts and peak
    allocated device bytes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg = cfg or get_config("qwen2.5-14b")
    t0 = time.monotonic()
    origin = "given"
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = init_params(cfg, gen, device=device)
        origin = f"generated in {time.monotonic() - t0:.1f} s"
    n_params = sum(t.numel() for t in flat(params).values())
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}: {n_params / 1e9:.3f}B params "
        f"{origin}")
    reqs = reqs or make_requests(seed, cfg.vocab_size)
    outs, launches, peak = serve_counted(cfg, params, reqs, card, device,
                                         "dynaserve", n_slots=n_slots,
                                         n_pages=n_pages, max_chunk=max_chunk)
    if device == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
    with step_tally() as tally:
        outs_c, m_c, moved_c, wall_c = serve(cfg, params, reqs, "colocation",
                                             n_slots=n_slots,
                                             n_pages=n_pages,
                                             max_chunk=max_chunk)
    report("colocation", m_c, moved_c, wall_c, card)
    log(f"[serve] colocation: {tally_line(tally)}")
    check_graphed(tally, f"{cfg.name} colocation", device)
    same = sum(int(a == b) for o1, o2 in zip(outs, outs_c)
               for a, b in zip(o1, o2))
    total = sum(len(o) for o in outs)
    first = sum(int(o1[0] == o2[0]) for o1, o2 in zip(outs, outs_c))
    log(f"[serve] dynaserve vs colocation: {same}/{total} tokens agree "
        f"({same / total:.3f}); first tokens agree {first}/{len(outs)} "
        f"(bf16 greedy streams diverge after a near-tie; exact equality "
        f"is asserted by the f32 CPU tests)")
    if decode_timing and device == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        time_decode(cfg, params, card)
    del params
    return launches, peak


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
# phase 6: Nemotron-4-340B (hd 192) at full width
# ---------------------------------------------------------------------------
#: Nemotron-4-340B's depth in its serve run: 6 of 96 layers at full width,
#: 30.161B parameters (60.32 GB in bf16) with the embedding and the untied
#: head; depth is the one cut
NEMOTRON_LAYERS = 6
#: decode lengths of its serving-shape kernel cases
NEMOTRON_LENS = [1, 17, 300, 1024, 2047, 3000, 4095, 4096]


def run_nemotron(seed: int, card: str):
    """Nemotron-4-340B's head layout (H 96, KV 8, hd 192: 12 query heads
    a KV head, one row a warp in decode, the 64-key wgmma tiles in
    prefill): (a) both kernels against their plain versions at the
    serving shapes, with split-KV edges, poison pages and NaN past the
    prefill edges, for bf16, fp8 and int8 pools; (b) both timed there
    beside their bound and one SDPA call; (c) full width and 2 layers,
    kernels against the plain attention on the same weights; (d) full
    width and ``NEMOTRON_LAYERS`` layers serving the serve phase's 8
    requests through DynaServe (counted: every prefill launch on the
    wgmma or the packed-row body) and colocation.  Returns (max errors,
    times, launches)."""
    import torch
    from repro_torch.configs import get_config
    t0 = time.monotonic()
    cfg = get_config(NEMOTRON_PATH)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    kc = KernelChecks(seed)
    serving_paths(kc, ((NEMOTRON_PATH, H, KV, NEMOTRON_LENS),), hd=hd)
    edge_cases(kc, H, KV, hd)
    log_kernel_checks(kc, f"at H {H} / KV {KV} / hd {hd} ")
    errs = dict(kc.err[NEMOTRON_PATH])
    del kc
    torch.cuda.empty_cache()
    times = time_kernels(seed, NEMOTRON_PATH, H, KV, hd=hd)
    torch.cuda.empty_cache()
    run_model_check(seed, get_config(NEMOTRON_PATH), tag="nemotron")
    launches, peak = run_serve(seed, card,
                               cfg=cfg.with_(n_layers=NEMOTRON_LAYERS))
    gc.collect()       # the sessions' reference cycles hold the weights
    torch.cuda.empty_cache()
    log(f"[nemotron] {NEMOTRON_LAYERS} of {cfg.n_layers} layers at full "
        f"width served; max allocated in the DynaServe run "
        f"{peak / 1e9:.3f} GB of {torch.cuda.get_device_properties(0).total_memory / 1e9:.3f}; "
        f"phase wall {time.monotonic() - t0:.1f} s; card {card}")
    return errs, times, launches


# ---------------------------------------------------------------------------
# phase 7: Qwen3-30B-A3B (MoE)
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def moe_routing(tape=None, replay=None, flips=None, dropped=None):
    """Watch, and for a comparison steer, the routing of the port's
    ``moe_fwd`` (the port itself never does this).  Each ``moe_route``
    call appends its decisions to ``tape``.  With ``replay`` (an earlier
    tape of the same calls) a call takes the recorded experts, ranks and
    keeps instead of its own, its gate weights renormalised from its own
    probabilities, and appends to ``flips`` the count of tokens whose own
    top-k differed.  ``dropped`` (two 0-dim device tensors) sums the
    dropped (token, k) slots and all slots in place, without reading
    anything back; the shards of an expert-parallel step route alike, so
    only shard 0 counts.  The sums are graph-aware: a captured step
    records the in-place adds, so each replay of it adds again, and a
    capture's all-inactive warm-up step is taken off (the counters are
    restored around ``InstanceEngine._capture``)."""
    from repro_torch.engine import runner
    from repro_torch.models import layers
    from repro_torch.models.tp import tp_rank
    route = layers.moe_route
    capture = runner.InstanceEngine._capture

    def watched(p, xf, cfg, capacity_factor):
        r = route(p, xf, cfg, capacity_factor)
        if dropped is not None and tp_rank() == 0:
            dropped[0].add_((~r["keep"]).sum())
            dropped[1].add_(r["keep"].numel())
        if replay is not None:
            ref = replay[len(flips)]
            flips.append((r["gate_idx"] != ref["gate_idx"]).any(-1).sum())
            w = r["probs"].gather(1, ref["gate_idx"])
            w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
            r = dict(ref, probs=r["probs"],
                     gate_w=w * ref["keep"].to(w.dtype))
        if tape is not None:
            tape.append({k: r[k] for k in ("gate_idx", "pos_in_e", "keep",
                                            "cap")})
        return r

    def uncounted_capture(self, T, n_pp):
        saved = [d.clone() for d in dropped]
        g = capture(self, T, n_pp)
        for d, v in zip(dropped, saved):
            d.copy_(v)
        return g

    layers.moe_route = watched
    if dropped is not None:
        runner.InstanceEngine._capture = uncounted_capture
    try:
        yield
    finally:
        layers.moe_route = route
        runner.InstanceEngine._capture = capture


# One MoE layer in f32 (TF32 off), card against CPU on the same weights:
# the router and expert products differ only in the order of their f32
# sums (2048 and 768 terms, relative errors near 1e-6), so the outputs of
# tokens routed alike agree to 1e-4 of the output's largest magnitude; a
# routing or dispatch fault moves whole expert outputs.  A token may
# route differently only where two of its probabilities around its k-th
# choice lie within NEAR_TIE, which the two sums can order either way.
MOE_LAYER_RTOL = 1e-4
NEAR_TIE = 1e-5
# Two full-width layers in bf16, kernels vs plain attention on the same
# routing, max abs error of the f32 logits (std ~0.9): as in the
# Qwen2.5-14B check, the two attentions' bf16 outputs differ by single
# roundings, which reach the final hidden state's last bits; the logits
# are bf16 products, so the largest of them (several std) then differ by
# a few of their own bf16 steps (2**-5 to 2**-4 there), whatever the std.
# The bound is the 14B check's 0.1, 11% of this std; the 1/sqrt(E)
# expert scale makes the MoE outputs larger than the attention outputs,
# but the final norm rescales them.
MOE_MODEL_TOL = 0.1


def run_moe_layer_check(seed: int, cfg=None, device="cuda"):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.layers import moe_fwd, moe_route
    from repro_torch.models.model import init_params
    cfg = (cfg or get_config(MOE_PATH)).with_(n_layers=1, dtype="float32")
    gen = torch.Generator(device=device).manual_seed(seed)
    p = init_params(cfg, gen, device=device)["layers"][0]["mlp"]
    x = torch.randn(1, 256, cfg.d_model, generator=gen, device=device)
    ph = {k: v.cpu() for k, v in p.items()}
    cf = cfg.moe_capacity_factor
    with torch.no_grad():
        yc, aux_c = moe_fwd(p, x, cfg)
        yh, aux_h = moe_fwd(ph, x.cpu(), cfg)
        rc = moe_route(p, x[0], cfg, cf)
        rh = moe_route(ph, x[0].cpu(), cfg, cf)
    yc, rc = yc.cpu(), {k: v.cpu() if torch.is_tensor(v) else v
                        for k, v in rc.items()}
    K = cfg.moe_top_k
    top = torch.sort(rh["probs"], dim=-1, descending=True).values[:, :K + 1]
    near = ((top[:, :-1] - top[:, 1:]) < NEAR_TIE).any(-1)
    flipped = (rc["gate_idx"] != rh["gate_idx"]).any(-1)
    if (flipped & ~near).any():
        raise AssertionError(f"moe layer: {int((flipped & ~near).sum())} "
                             f"tokens routed differently on the card "
                             f"without a near-tie")
    # a flipped token can change the ranks (and keeps) of later slots in
    # the experts it moved between; compare keeps outside those experts
    touched = torch.zeros(cfg.moe_experts, dtype=torch.bool)
    touched[rc["gate_idx"][flipped].flatten()] = True
    touched[rh["gate_idx"][flipped].flatten()] = True
    clean = ~touched[rh["gate_idx"]]
    if not torch.equal(rc["keep"][clean], rh["keep"][clean]):
        raise AssertionError("moe layer: capacity keeps differ on the card")
    same = (~flipped & (rc["keep"] == rh["keep"]).all(-1))
    scale = float(yh.abs().max())
    err = float((yc - yh)[0, same].abs().max())
    if not math.isfinite(err) or err > MOE_LAYER_RTOL * scale:
        raise AssertionError(f"moe layer: max abs err {err:.3e} > "
                             f"{MOE_LAYER_RTOL} x {scale:.3e}")
    log(f"[moe] layer check, {cfg.name} (d_model {cfg.d_model}, "
        f"{cfg.moe_experts} experts top-{K}, expert d_ff {cfg.moe_d_ff}), "
        f"f32, 256 tokens, capacity {rc['cap']}: card vs CPU routing "
        f"identical for {int((~flipped).sum())}/256 tokens, "
        f"{int(flipped.sum())} differ, all at near-ties "
        f"({int(near.sum())} tokens have a gap under {NEAR_TIE}); dropped "
        f"slots card {int((~rc['keep']).sum())} CPU "
        f"{int((~rh['keep']).sum())}; output max abs err {err:.3e} "
        f"(tol {MOE_LAYER_RTOL} x max |y| {scale:.3e}); aux loss card "
        f"{float(aux_c):.6f} CPU {float(aux_h):.6f}")
    del p
    if device == "cuda":
        torch.cuda.empty_cache()


def run_moe_model_check(seed: int, cfg=None, device="cuda"):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg = (cfg or get_config(MOE_PATH)).with_(n_layers=2)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                         device=device)
    tape, flips = [], []
    with torch.no_grad():
        with moe_routing(tape=tape):
            got, fed = model_steps(params, cfg, device, seed)
        with plain_attention(), moe_routing(replay=tape, flips=flips):
            exp, _ = model_steps(params, cfg, device, seed, feed=fed)
    worst, std = 0.0, float(exp[0].std())
    max_logit = max(float(b.abs().max()) for b in exp)
    for i, (a, b) in enumerate(zip(got, exp)):
        if a.shape != (2, 1, cfg.vocab_size) or not torch.isfinite(a).all():
            raise AssertionError(f"moe model step {i}: bad logits {a.shape}")
        worst = max(worst, float((a - b).abs().max()))
    n_flips = int(sum(int(f) for f in flips))
    if worst > MOE_MODEL_TOL:
        raise AssertionError(f"moe model logits kernels vs plain: max abs "
                             f"err {worst:.3e} > {MOE_MODEL_TOL}")
    log(f"[moe] {cfg.name}, 2 layers, {cfg.dtype}: {len(got)} steps "
        f"(prefill, mixed, decode); logits kernels vs plain attention on "
        f"the same routing max abs err {worst:.3e} (tol {MOE_MODEL_TOL}, "
        f"logits std {std:.3f}, max |logit| {max_logit:.3f}); the plain run "
        f"would have routed {n_flips} (token, layer) pairs differently "
        f"(bf16 router logits tie)")
    del params
    if device == "cuda":
        torch.cuda.empty_cache()


def tensor_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def run_moe_serve(seed: int, card: str, cfg=None, device="cuda",
                  n_slots: int = 8, page: int = 8, max_chunk: int = 512,
                  reqs=None, devices_per_instance: int = 1):
    """Full Qwen3-30B-A3B serving the serve phase's 8 requests through
    DynaServe on two instances that share the card and one set of
    weights (each instance ``devices_per_instance`` shards wide, the
    shards time-sharing the card).  The pools take what the weights
    leave, less a headroom for a 512-token chunk on every slot, up to the
    14B run's 4096 pages an instance.  Returns (launch counts, cfg,
    params, pages an instance)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.utils.device import torch_dtype
    cfg = cfg or get_config(MOE_PATH)
    t0 = time.monotonic()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                         device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    weights = tensor_bytes(params)
    log(f"[moe] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads hd {cfg.hd}, "
        f"{cfg.moe_experts} experts top-{cfg.moe_top_k} expert d_ff "
        f"{cfg.moe_d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}: "
        f"{weights / 2 / 1e9:.3f}B params, {weights / 1e9:.3f} GB, "
        f"generated in {time.monotonic() - t0:.1f} s")
    page_bytes = 2 * cfg.n_layers * page * cfg.n_kv_heads * cfg.hd * \
        torch.finfo(torch_dtype(cfg.dtype)).bits // 8
    free, total = (torch.cuda.mem_get_info() if device == "cuda"
                   else (1 << 40, 1 << 40))
    headroom = 6 << 30
    n_pages = min(4096, (free - headroom) // (2 * page_bytes))
    if n_pages < 1024:
        raise AssertionError(f"only {free / 1e9:.2f} GB free after the "
                             f"weights: {n_pages} pages an instance")
    reqs = reqs or make_requests(seed, cfg.vocab_size)
    dropped = [torch.zeros((), dtype=torch.long, device=device)
               for _ in range(2)]
    width = f" ep{devices_per_instance}" if devices_per_instance > 1 else ""
    with moe_routing(dropped=dropped):
        _, launches, peak = serve_counted(
            cfg, params, reqs, card, device, f"{cfg.name}{width} dynaserve",
            n_slots=n_slots, n_pages=n_pages, page=page, max_chunk=max_chunk,
            devices_per_instance=devices_per_instance)
    log(f"[moe]{width} memory: weights {weights / 1e9:.3f} GB, pools 2 x "
        f"{n_pages} pages x {page_bytes} B = "
        f"{2 * n_pages * page_bytes / 1e9:.3f} GB, "
        f"{total / 1e9:.3f} GB on the card, max allocated in the run "
        f"{peak / 1e9:.3f} GB")
    log(f"[moe]{width} {cfg.name} dropped (token, k) "
        f"slots over all MoE layers and steps, pads included: "
        f"{int(dropped[0])} of {int(dropped[1])} "
        f"({int(dropped[0]) / int(dropped[1]):.4f}; capacity factor "
        f"{cfg.moe_capacity_factor})")
    return launches, cfg, params, n_pages


# ---------------------------------------------------------------------------
# phase 8: the HTTP front door over the MoE weights
# ---------------------------------------------------------------------------
def http_request(port, method, path, body=None, timeout=600.0):
    """One HTTP/1.1 exchange with the server on localhost (it closes
    every connection); returns (status, body), chunked bodies
    de-chunked."""
    import socket
    sock = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    try:
        payload = b"" if body is None else json.dumps(body).encode()
        head = f"{method} {path} HTTP/1.1\r\nHost: localhost\r\n"
        if payload:
            head += f"Content-Length: {len(payload)}\r\n"
        sock.sendall(head.encode() + b"\r\n" + payload)
        data = b""
        while chunk := sock.recv(65536):
            data += chunk
    finally:
        sock.close()
    head, _, rest = data.partition(b"\r\n\r\n")
    status = int(head.split(b" ")[1])
    if b"chunked" not in head.lower():
        return status, rest
    out = b""
    while rest:
        size, _, rest = rest.partition(b"\r\n")
        n = int(size or b"0", 16)
        if n == 0:
            break
        out, rest = out + rest[:n], rest[n + 2:]
    return status, out


def run_http(seed: int, cfg, params, n_pages: int, page: int = 8):
    import numpy as np
    from repro_torch.core.session import ServeSession, SessionConfig
    from repro_torch.engine.backend import EngineBackend
    from repro_torch.serving.http import ServerConfig, ServingServer
    from repro_torch.sim.policies import DynaServePolicy
    max_len = n_pages * page // 8
    backend = EngineBackend(cfg, params, n_slots=8, max_len=max_len,
                            page_size=page, n_pages=n_pages, max_chunk=512,
                            transfer_chunk=128)
    session = ServeSession(
        backend, DynaServePolicy(backend.cost, 0.1, transfer_chunk=128),
        SessionConfig(n_instances=2, slo=0.1, open_loop=False,
                      max_sim_time=float("inf"), retain_finished=True))
    srv = ServingServer(ServerConfig(port=0, backend="engine", arch=cfg.name,
                                     engine_max_len=max_len),
                        session=session).start()
    driver_thread = srv.driver._thread
    rng = np.random.default_rng(seed)
    t0 = time.monotonic()
    tallied = step_tally()
    tally = tallied.__enter__()
    try:
        for n_prompt, n_new in ((700, 12), (90, 20)):
            prompt = [int(t) for t in rng.integers(0, cfg.vocab_size,
                                                   n_prompt)]
            status, body = http_request(srv.port, "POST", "/v1/completions",
                                        {"prompt": prompt,
                                         "max_tokens": n_new})
            out = json.loads(body)
            n_out = len(out["choices"][0]["text"].split()) \
                if status == 200 else -1
            if status != 200 or out["usage"]["completion_tokens"] != n_new \
                    or n_out != n_new:
                raise AssertionError(f"/v1/completions: status {status}, "
                                     f"{n_out} of {n_new} tokens")
        status, body = http_request(srv.port, "POST", "/v1/chat/completions",
                                    {"messages": [{"role": "user",
                                                   "content": "Name three "
                                                   "uses of a paged KV "
                                                   "cache."}],
                                     "max_tokens": 16, "stream": True})
        events = [line[len("data: "):] for line in body.decode().split("\n")
                  if line.startswith("data: ")]
        pieces = [json.loads(e)["choices"][0]["delta"].get("content")
                  for e in events[:-1]]
        if status != 200 or events[-1:] != ["[DONE]"] or \
                len([p for p in pieces if p]) != 16:
            raise AssertionError(f"streamed chat: status {status}, "
                                 f"{len(events)} events")
        status, body = http_request(srv.port, "GET", "/metrics")
        done = sum(float(line.rsplit(" ", 1)[1])
                   for line in body.decode().splitlines()
                   if line.startswith("dynaserve_requests_total{")
                   and 'outcome="done"' in line)
        if status != 200 or done != 3:
            raise AssertionError(f"/metrics: status {status}, {done} "
                                 f"completed requests")
    finally:
        srv.stop()
        tallied.__exit__(None, None, None)
    if driver_thread.is_alive() or srv._thread is not None:
        raise AssertionError("the server did not shut down cleanly")
    log(f"[http] {cfg.name} behind the port's ServingServer: 2 "
        f"/v1/completions (12 and 20 tokens) and 1 streamed "
        f"/v1/chat/completions ({len(events) - 1} SSE events, 16 tokens) in "
        f"{time.monotonic() - t0:.2f} s; /metrics counts {int(done)} "
        f"completed requests; KV moved {backend.kv_bytes_moved} B; "
        f"{tally_line(tally)}; clean shutdown")
    check_graphed(tally, "http", params["embed"].device.type)


# ---------------------------------------------------------------------------
# phase 9: tensor- and expert-parallel instances, two shards on one card
# ---------------------------------------------------------------------------
TP_PATH = "qwen2.5-14b tp2"
EP_PATH = f"{MOE_PATH} ep2"
# The serving paths' shapes as each of two shards sees them: half the
# query and half the KV heads (Qwen2.5-14B H 20 / KV 4, Qwen3-30B-A3B
# H 16 / KV 2), the same query heads a KV head as the whole model.
SHARD_SHAPES = (
    (TP_PATH, 20, 4, [1, 17, 300, 1024, 2047, 3000, 4095, 4096]),
    (EP_PATH, 16, 2, [128, 300, 777, 1024, 2047, 3000, 4095, 4096]))
# f32, a TP=2 instance on the card against a one-device engine on the CPU:
# the shards' partial products and their sum reorder f32 sums only, as
# card against CPU does in the dense phase, so 1e-4 of the logits'
# largest magnitude.
TP_F32_RTOL = 1e-4
# bf16, TP=2 against TP=1 on the card, max abs error of the prefill
# logits over their largest magnitude.  A TP=2 sublayer rounds each
# shard's product to bf16 and rounds their sum again, where TP=1 rounds
# one product once: a 2**-8 relative difference enters each of the 96
# sublayers and travels through 48 layers of random weights to the
# logits (the 2-layer kernels-vs-plain check already differs by 0.08 on
# logits of std 1.4).  A missing or doubled shard sum moves the logits by
# their whole scale; 0.1 of it separates the two.
TP_BF16_RTOL = 0.1


@contextlib.contextmanager
def launches_by_heads(counts: dict):
    """Count the model's attention kernel calls by (kernel, H, KV) of
    their query and key tensors, from every shard thread (the wrappers
    count launches only in total).  Graph-aware, as the wrappers'
    counters are: the calls made while a thread's stream captures are
    kept with the graph and added at each of its replays, and a
    capture's warm-up counts nothing.  For the report only; the port
    itself never does this."""
    import threading
    import torch
    from repro_torch.engine import runner
    from repro_torch.models import mixers
    lock = threading.Lock()
    saved = (mixers.paged_decode_attention_op,
             mixers.paged_prefill_attention_op,
             mixers.packed_prefill_attention_op)
    cls = runner.InstanceEngine
    capture, launch = cls._capture, cls._launch
    captured, by_graph = {}, {}      # the running capture's; id(graph) ->

    def add(into, key, n):
        with lock:
            into[key] = into.get(key, 0) + n

    def counted(name, op):
        def call(q, k, *a):
            key = (name, q.shape[-2], k.shape[-2])
            add(captured if q.is_cuda and
                torch.cuda.is_current_stream_capturing() else counts, key, 1)
            return op(q, k, *a)
        return call

    def counted_capture(self, T, n_pp):
        before = dict(counts)
        captured.clear()
        g = capture(self, T, n_pp)
        with lock:                       # the warm-up's calls
            counts.clear()
            counts.update(before)
        by_graph[id(g)] = dict(captured)
        return g

    def counted_launch(self, T, n_pp, packed, sp=False):
        out = launch(self, T, n_pp, packed, sp)
        if self.graphs:                  # a replay: its capture's calls
            for key, n in by_graph[id(self._graphs[(T, n_pp)])].items():
                add(counts, key, n)
        return out

    mixers.paged_decode_attention_op = counted(KERNELS[0], saved[0])
    mixers.paged_prefill_attention_op = counted(KERNELS[1], saved[1])
    mixers.packed_prefill_attention_op = counted(KERNELS[1], saved[2])
    cls._capture, cls._launch = counted_capture, counted_launch
    try:
        yield counts
    finally:
        (mixers.paged_decode_attention_op, mixers.paged_prefill_attention_op,
         mixers.packed_prefill_attention_op) = saved
        cls._capture, cls._launch = capture, launch


def by_heads(counts: dict) -> str:
    return ", ".join(f"{k} H {h} / KV {kv}: {n}"
                     for (k, h, kv), n in sorted(counts.items()))


def greedy_pair(engines, prompt, steps: int):
    """Prefill ``prompt`` on every engine, then ``steps`` decode steps
    fed the first engine's greedy token.  Returns per engine the list of
    logits (prefill first) and its slot."""
    import numpy as np
    from repro_torch.engine import BatchItem
    slots = [e.alloc("r") for e in engines]
    logits = [[] for _ in engines]
    pos = len(prompt)
    for i, (e, s) in enumerate(zip(engines, slots)):
        logits[i].append(e.run_batch([BatchItem(s, prompt, 0, True)])[s])
    for _ in range(steps):
        tok = np.array([int(logits[0][-1].argmax())], np.int32)
        for i, (e, s) in enumerate(zip(engines, slots)):
            logits[i].append(e.run_batch([BatchItem(s, tok, pos, True)])[s])
        pos += 1
    return logits, slots


def run_tp_card_vs_cpu(seed: int, n_layers: int = 2, prompt_len: int = 300,
                       steps: int = 8, cfg=None, device="cuda"):
    """Qwen2.5-14B at full width and ``n_layers`` layers in f32: a TP=2
    instance on two shards of the card against the one-device engine on
    the CPU, same weights, prefill and ``steps`` decode steps fed the
    CPU's greedy tokens."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.engine import InstanceEngine
    from repro_torch.models.model import init_params
    cfg = (cfg or get_config("qwen2.5-14b")).with_(n_layers=n_layers,
                                                   dtype="float32")
    params = init_params(cfg, torch.Generator(device=device)
                         .manual_seed(seed), device=device)
    host = to_device(params, "cpu")
    prompt = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, prompt_len).astype(np.int32)
    kw = dict(n_slots=2, max_len=prompt_len + steps + 8, max_chunk=512)
    counts = {}
    from repro_torch.kernels import chunked_prefill_attention as cpa
    before = dict(cpa.body_launches)
    with torch.no_grad(), launches_by_heads(counts):
        engines = [InstanceEngine(cfg, host, **kw),
                   InstanceEngine(cfg, params, devices=[device] * 2, **kw)]
        (ref, got), _ = greedy_pair(engines, prompt, steps)
    bodies = {b: n - before[b] for b, n in cpa.body_launches.items()
              if n != before[b]}
    scale = max(float(np.abs(r).max()) for r in ref)
    err = max(float(np.abs(a - b).max()) for a, b in zip(got, ref))
    same = sum(int(a.argmax() == b.argmax()) for a, b in zip(got, ref))
    half = (cfg.n_heads // 2, cfg.n_kv_heads // 2)
    want = {(KERNELS[0], *half): 2 * steps * n_layers,
            (KERNELS[1], *half): 2 * n_layers}
    card = {k: n for k, n in counts.items() if k in want}
    if card != want:
        raise AssertionError(f"tp2 card vs CPU: kernel calls {counts}, "
                             f"want {want} at the shards' heads")
    if not math.isfinite(err) or err > TP_F32_RTOL * scale:
        raise AssertionError(f"tp2 card vs CPU: logits max abs err "
                             f"{err:.3e} > {TP_F32_RTOL} x {scale:.3e}")
    log(f"[tp] card vs CPU, {cfg.name} full width, {n_layers} layers, f32: "
        f"TP=2 on two shards of the card against one device on the CPU, "
        f"prefill {prompt_len} tokens + {steps} decode steps fed the CPU's "
        f"greedy tokens: logits max abs err {err:.3e} (tol {TP_F32_RTOL} x "
        f"max |logit| {scale:.3e}), argmax equal {same}/{steps + 1}; kernel "
        f"calls {by_heads(counts)}; prefill launches by body {bodies}")
    del params, host, engines
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def pieces_equal(a, b) -> bool:
    """Two exports equal bit for bit: spans, and every page tensor."""
    import torch
    if len(a) != len(b):
        return False
    for pa, pb in zip(a, b):
        if pa["span"] != pb["span"] or len(pa["pages"]) != len(pb["pages"]):
            return False
        for la, lb in zip(pa["pages"], pb["pages"]):
            for k in la:
                x, y = la[k], lb[k]
                if x.dtype != y.dtype or x.shape != y.shape or not \
                        torch.equal(x.view(torch.int16), y.view(torch.int16)):
                    return False
    return True


def run_tp_dense(seed: int, card: str, serve_peak=None,
                 prompt_len: int = 512, steps: int = 16, cfg=None,
                 device="cuda"):
    """The whole Qwen2.5-14B in bf16 on the serve phase's weights (the
    same seed), every engine graphed: TP=2 against TP=1 on the card, a
    TP=2 -> TP=1 -> TP=2 handoff, a decode step at width 1 and 2, eager
    and graphed, and the serve phase's 8 requests through DynaServe on a
    [1, 2]-wide pool, counted.  Returns the session's launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.costmodel import BatchCostModel
    from repro_torch.engine import InstanceEngine
    from repro_torch.engine.backend import H100
    from repro_torch.models.model import init_params
    cfg = cfg or get_config("qwen2.5-14b")
    empty = torch.cuda.empty_cache if device == "cuda" else (lambda: None)
    half = (cfg.n_heads // 2, cfg.n_kv_heads // 2)
    t0 = time.monotonic()
    params = init_params(cfg, torch.Generator(device=device)
                         .manual_seed(seed), device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    log(f"[tp] {cfg.name}: {tensor_bytes(params) / 1e9:.3f} GB of bf16 "
        f"weights generated in {time.monotonic() - t0:.1f} s (the serve "
        f"phase's seed)")
    prompt = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, prompt_len).astype(np.int32)
    kw = dict(n_slots=2, max_len=1024, max_chunk=512)
    counts = {}
    with launches_by_heads(counts):
        one = InstanceEngine(cfg, params, **kw)
        two = InstanceEngine(cfg, params, devices=[device] * 2, **kw)
        if device == "cuda" and not (one.graphs and two.graphs):
            raise AssertionError("a width-1 or width-2 engine on the card "
                                 "does not graph its steps")
        (l1, l2), (s1, s2) = greedy_pair([one, two], prompt, steps)
    scale = float(np.abs(l1[0]).max())
    err = float(np.abs(l1[0] - l2[0]).max())
    if not math.isfinite(err) or err > TP_BF16_RTOL * scale:
        raise AssertionError(f"tp2 vs tp1 prefill logits: max abs err "
                             f"{err:.3e} > {TP_BF16_RTOL} x {scale:.3e}")
    differ = []
    for i, (a, b) in enumerate(zip(l1[1:], l2[1:])):
        if int(a.argmax()) != int(b.argmax()):
            top = np.sort(a)[-2:]
            differ.append(f"step {i + 1} margin {top[1] - top[0]:.4f}")
    step_err = max(float(np.abs(a - b).max()) for a, b in zip(l1, l2))
    log(f"[tp] {cfg.name} bf16 TP=2 vs TP=1 on the card, prompt "
        f"{prompt_len}: prefill logits max abs err {err:.3e} (tol "
        f"{TP_BF16_RTOL} x max |logit| {scale:.3f}); {steps} decode steps "
        f"fed TP=1's greedy tokens: argmax equal "
        f"{steps - len(differ)}/{steps}"
        + (f" (differing: {'; '.join(differ)}, TP=1's top-2 logit margin)"
           if differ else "")
        + f", max abs err over all steps {step_err:.3e}; kernel calls "
        f"{by_heads(counts)}")
    # handoff across widths: TP=2 -> TP=1 -> TP=2, each export byte-equal
    upto = prompt_len + steps
    first = two.export_state(s2, upto=upto, chunk=128)
    one.free(s1)
    b = one.alloc("b")
    one.import_state(b, first)
    again = one.export_state(b, upto=upto, chunk=128)
    c = two.alloc("c")
    two.import_state(c, again)
    third = two.export_state(c, upto=upto, chunk=128)
    if not (pieces_equal(first, again) and pieces_equal(first, third)):
        raise AssertionError("tp handoff: a re-export differs from the "
                             "first export")
    from repro_torch.engine import BatchItem
    tok = np.array([int(l2[-1].argmax())], np.int32)
    out = two.run_batch([BatchItem(s2, tok, upto, True),
                         BatchItem(c, tok, upto, True)])
    moved = sum(t.numel() * t.element_size() for p in first
                for pc in p["pages"] for t in pc.values())
    log(f"[tp] handoff TP=2 -> TP=1 -> TP=2 of {upto} tokens in "
        f"{len(first)} pieces ({moved} B), both engines "
        f"{'graphed' if two.graphs else 'eager'}: every "
        f"piece re-exports byte-equal at each width; the next decode step "
        f"from the source slot and from the twice-imported slot: logits "
        f"max abs diff {float(np.abs(out[s2] - out[c]).max()):.3e}; "
        f"captures: width 1 {one.captures}, width 2 {two.captures}")
    one.close()
    two.close()
    del one, two, out
    gc.collect()
    empty()

    # a decode step of one request at each width, eager and graphed
    # (wall, device time, idle share), beside the cost model's price
    if device == "cuda":
        for n in (1, 2):
            t = time_decode(cfg, params, card, n_slots=1, ctx=prompt_len,
                            steps=8, device=device, width=n, tag="tp")
            pred = BatchCostModel(cfg, H100, tp_degree=n) \
                .mixed_batch_latency(0, 0, 1, prompt_len) * 1e3
            log(f"[tp] decode step, one request at {prompt_len} tokens, "
                f"width {n}: the cost model (H100 data sheet, "
                f"tp_degree={n}) prices it at {pred:.3f} ms; the eager "
                f"wall is {t['eager'][0] / pred:.2f}x that, the graphed "
                f"{t['graphed'][0] / pred:.2f}x; graphed / eager wall "
                f"{t['graphed'][0] / t['eager'][0]:.3f}; card {card}")

    # the serve phase's 8 requests on a [1, 2]-wide pool
    reqs = make_requests(seed, cfg.vocab_size)
    counts = {}
    with launches_by_heads(counts):
        _, launches, peak = serve_counted(
            cfg, params, reqs, card, device,
            f"{cfg.name} [1, 2] dynaserve", n_slots=8, n_pages=4096,
            max_chunk=512, devices_per_instance=[1, 2])
    if not any(k[1:] == half for k in counts):
        raise AssertionError(f"the 2-wide instance launched nothing: "
                             f"{counts}")
    ratio = None if not serve_peak else peak / serve_peak
    log(f"[tp] [1, 2] session: kernel calls {by_heads(counts)} (H {half[0]}"
        f" / KV {half[1]}: the 2-wide instance's shards); max allocated "
        f"{peak / 1e9:.3f} "
        f"GB" + (f", {ratio:.3f}x the one-device serve phase's "
                 f"{serve_peak / 1e9:.3f} GB" if ratio else
                 " (serve phase not run: no one-device peak to compare)"))
    if ratio is not None and ratio > 1.1:
        raise AssertionError(f"the [1, 2] session peaked at {ratio:.3f}x "
                             f"the one-device serve phase's memory")
    del params
    gc.collect()
    empty()
    return launches


def run_ep_layer_check(seed: int, cfg=None, device="cuda"):
    """One Qwen3-30B-A3B MoE layer at full width in f32 on the card:
    expert-parallel over two shards against the unsharded layer, on the
    same weights and tokens (the same routing, bit for bit)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.layers import moe_fwd
    from repro_torch.models.model import init_params
    from repro_torch.models.tp import ShardGroup
    from repro_torch.utils.sharding import shard_params, tp_param_specs
    cfg = (cfg or get_config(MOE_PATH)).with_(n_layers=1, dtype="float32")
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen, device=device)
    p = params["layers"][0]["mlp"]
    specs = tp_param_specs(cfg, params)["layers"][0]["mlp"]
    x = torch.randn(1, 256, cfg.d_model, generator=gen, device=device)
    one, two = [], []
    group = ShardGroup(2)
    try:
        with torch.no_grad():
            with moe_routing(tape=one):
                y1, aux1 = moe_fwd(p, x, cfg)
            with moe_routing(tape=two):
                outs = group.run(lambda r: moe_fwd(
                    shard_params(p, specs, 2, r, device), x, cfg))
    finally:
        group.close()
    for r in two:
        for k in ("gate_idx", "pos_in_e", "keep"):
            if not torch.equal(r[k], one[0][k]):
                raise AssertionError(f"ep2 moe layer: {k} differs from "
                                     f"the unsharded layer's")
    scale = float(y1.abs().max())
    err = max(float((y - y1).abs().max()) for y, _ in outs)
    if not math.isfinite(err) or err > MOE_LAYER_RTOL * scale:
        raise AssertionError(f"ep2 moe layer: max abs err {err:.3e} > "
                             f"{MOE_LAYER_RTOL} x {scale:.3e}")
    log(f"[tp] {cfg.name} MoE layer, full width, f32, 256 tokens: EP=2 "
        f"(experts [0, {cfg.moe_experts // 2}) and [{cfg.moe_experts // 2}, "
        f"{cfg.moe_experts}) on two shards of the card) vs EP=1: routing "
        f"identical on both shards ({int((~one[0]['keep']).sum())} dropped "
        f"slots), output max abs err {err:.3e} (tol {MOE_LAYER_RTOL} x "
        f"{scale:.3e}), aux {float(outs[0][1]):.6f} vs {float(aux1):.6f}")
    del params, p, outs
    if device == "cuda":
        torch.cuda.empty_cache()


def run_ep(seed: int, card: str, cfg=None, device="cuda"):
    """(d): one MoE layer EP=2 against EP=1, then the whole model serving
    on two EP=2 instances.  Returns the session's launches."""
    from repro_torch.configs import get_config
    cfg = cfg or get_config(MOE_PATH)
    run_ep_layer_check(seed, cfg=cfg, device=device)
    half = (cfg.n_heads // 2, cfg.n_kv_heads // 2)
    counts = {}
    with launches_by_heads(counts):
        launches, *rest = run_moe_serve(seed, card, cfg=cfg, device=device,
                                        devices_per_instance=2)
    del rest
    log(f"[tp] {cfg.name} ep2 session: kernel calls {by_heads(counts)}")
    if set(counts) != {(KERNELS[0], *half), (KERNELS[1], *half)}:
        raise AssertionError(f"the ep2 instances launched {counts}")
    return launches


def shard_handoff_us(n_reduce: int = 2000) -> float:
    """Host time of one ``all_reduce`` of a one-element CPU tensor between
    two shard threads (two turn hand-offs and one add), in microseconds:
    what each of a sharded step's collectives costs the host besides the
    shards' own work."""
    import torch
    from repro_torch.models import tp
    group = tp.ShardGroup(2)
    x = torch.ones(1)

    def body(rank):
        for _ in range(n_reduce):
            tp.all_reduce(x)

    try:
        group.run(body)
        t0 = time.perf_counter()
        group.run(body)
        return (time.perf_counter() - t0) / n_reduce * 1e6
    finally:
        group.close()


def run_tp(seed: int, card: str, serve_peak=None):
    """Phase 8.  Returns (launches by path, kernel times at the shards'
    shapes by path, max abs kernel error there by kernel)."""
    import os
    import torch
    from repro_torch.utils.device import DEVICE_COUNT_ENV
    t0 = time.monotonic()
    log(f"[tp] one all_reduce between two shard threads (a one-element "
        f"CPU tensor: two turn hand-offs and an add) costs the host "
        f"{shard_handoff_us():.1f} us; a 48-layer eager step has 96, a "
        f"replayed graph none")
    kc = KernelChecks(seed)
    serving_paths(kc, SHARD_SHAPES)
    log_kernel_checks(kc, "at the shards' head counts ")
    times = {path: time_kernels(seed, path, H, KV, quant=False)
             for path, H, KV, _ in SHARD_SHAPES}
    torch.cuda.empty_cache()
    run_tp_card_vs_cpu(seed)
    prev = os.environ.get(DEVICE_COUNT_ENV)
    os.environ[DEVICE_COUNT_ENV] = "2"      # the backends' 2-wide instances
    try:
        launches = {TP_PATH: run_tp_dense(seed, card, serve_peak)}
        launches[EP_PATH] = run_ep(seed, card)
    finally:
        if prev is None:
            os.environ.pop(DEVICE_COUNT_ENV, None)
        else:
            os.environ[DEVICE_COUNT_ENV] = prev
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[tp] phase wall {time.monotonic() - t0:.1f} s; card {card}; every "
        f"TP/EP row is two shards time-sharing one card; every engine and "
        f"session of the phase replays one CUDA graph a (T, n_pp) key, "
        f"both shards and every sum in it, but the decode-step lines' "
        f"eager engines (graphs=False, at both widths)")
    errs = {name: max(e[name] for e in kc.err.values()) for name in KERNELS}
    return launches, times, errs


# ---------------------------------------------------------------------------
# phase 10: the launcher users start
# ---------------------------------------------------------------------------
#: the launcher's runs: its default smoke config (Qwen2.5-14B's family,
#: hd 32) with the open loop and overlap, then phi4-mini's smoke config,
#: whose head dim of 40 no earlier path of the card runs
LAUNCH_RUNS = (["--smoke", "--open-loop", "--overlap"],
               ["--arch", "phi4-mini-3.8b", "--smoke"])


def run_launch(device="cuda"):
    """``repro_torch.launch.serve.main`` in-process for each of
    ``LAUNCH_RUNS``: every request completes and, on the card, both
    kernels launch.  Returns the phi4-mini run's launches by kernel."""
    import io
    from contextlib import redirect_stdout
    from repro_torch.kernels import chunked_prefill_attention as cpa
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.launch import serve as launcher
    for argv in LAUNCH_RUNS:
        if device != "cuda":
            argv = argv + ["--device", device]
        before = (pda.launches, cpa.launches, dict(cpa.body_launches))
        buf = io.StringIO()
        t0 = time.monotonic()
        with redirect_stdout(buf), step_tally() as tally:
            rc = launcher.main(argv)
        lines = buf.getvalue().splitlines()
        head = dict(kv.split("=") for kv in lines[1].split()[:4])
        if rc != 0 or head["completed"] != head["offered"]:
            raise AssertionError(f"launcher: rc {rc}, {lines[1]}")
        for line in lines:
            log(f"[launch] {line}")
        launches = {"paged_decode_attention": pda.launches - before[0],
                    "chunked_prefill_attention": cpa.launches - before[1]}
        bodies = {b: n - before[2][b] for b, n in cpa.body_launches.items()}
        log(f"[launch] python -m repro_torch.launch.serve {' '.join(argv)}: "
            f"{head['completed']}/{head['offered']} requests complete in "
            f"{time.monotonic() - t0:.1f} s; kernel launches {launches}, "
            f"chunked_prefill_attention by body {bodies}; "
            f"{tally_line(tally)}")
        check_graphed(tally, " ".join(argv), device)
        if device == "cuda" and launches != tally["eager_launches"]:
            raise AssertionError(f"{' '.join(argv)}: launches {launches}, "
                                 f"the eager step's "
                                 f"{tally['eager_launches']}")
        if device == "cuda":
            for name, n in launches.items():
                if n <= 0:
                    raise AssertionError(f"{name} was not launched by "
                                         f"{' '.join(argv)}")
            # the smoke configs run in f32: every prefill on 3xTF32
            if bodies.get("tf32") != launches["chunked_prefill_attention"]:
                raise AssertionError(f"f32 prefill launches off the 3xTF32 "
                                     f"body in {' '.join(argv)}: {bodies}")
    return launches


# ---------------------------------------------------------------------------
# phase 11: the dense slot cache (recurrent, encoder-decoder and VLM models)
# ---------------------------------------------------------------------------
DENSE_PATHS = ("recurrentgemma-9b", "mamba2-780m")
# handoff past the window: beta's state is alpha's byte for byte, so the
# same bf16 decode steps give the same logits; 2e-2 (the kernels' bf16
# tolerance) bounds what a reordered reduction could change
HANDOFF_TOL = 2e-2
# card against CPU in f32 with TF32 off: the products differ only in the
# order of their f32 sums (d_model up to 8192 terms, relative errors near
# 1e-6 a layer), so logits and states agree to 1e-4 of their own largest
# magnitude; a wrong mask, ring slot or state update moves them by O(1)
F32_RTOL = 1e-4
# the cross K/V of slot 0 against the projections of a separate encoder
# run on zero frames (bf16, another batch size): bf16 steps of the
# largest values
CROSS_TOL = 2e-2


def paged_counts():
    from repro_torch.kernels import chunked_prefill_attention as cpa
    from repro_torch.kernels import paged_decode_attention as pda
    return pda.launches + cpa.launches


def dense_model(seed: int, name: str, device="cuda", **cut):
    """The full-width model ``name`` (depth cut by ``cut``), random bf16
    weights from ``seed`` generated on ``device``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg = get_config(name).with_(**cut)
    t0 = time.monotonic()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                         device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    weights = tensor_bytes(params)
    n = sum(t.numel() for t in flat(params).values())
    log(f"[dense] {cfg.name}{' (cut: ' + str(cut) + ')' if cut else ''}: "
        f"{cfg.n_layers} layers {'/'.join(cfg.layer_pattern)}, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype}: "
        f"{n / 1e9:.3f}B params, {weights / 1e9:.3f} GB, generated "
        f"in {time.monotonic() - t0:.1f} s (ModelConfig.param_count "
        f"{cfg.param_count() / 1e9:.3f}B)")
    return cfg, params


def run_dense_serve(seed: int, card: str, cfg, params, reqs=None,
                    device="cuda"):
    """The serve phases' 8 requests through DynaServe, then colocation, on
    two dense-cache instances sharing the card and the weights; neither
    paged kernel may launch."""
    import numpy as np
    import torch
    reqs = reqs or make_requests(seed, cfg.vocab_size)
    outs = {}
    for policy in ("dynaserve", "colocation"):
        before = paged_counts()
        with step_tally() as tally:
            outs[policy], m, moved, wall = serve(cfg, params, reqs, policy)
        n_paged = paged_counts() - before
        ttft, tbt = np.asarray(m.ttfts) * 1e3, np.asarray(m.tbts) * 1e3
        log(f"[dense] {cfg.name} {policy}: {m.completed}/{m.offered} "
            f"requests, {m.tokens_total} tokens in {wall:.2f} s wall "
            f"({m.tokens_total / wall:.2f} tok/s); TTFT mean "
            f"{ttft.mean():.1f} p50 {np.median(ttft):.1f} max {ttft.max():.1f} "
            f"ms; TBT mean {tbt.mean():.1f} p50 {np.median(tbt):.1f} p99 "
            f"{np.percentile(tbt, 99):.1f} ms; state moved {moved} B; paged "
            f"kernel launches {n_paged}; {tally_line(tally)}; card {card}")
        check_graphed(tally, f"{cfg.name} {policy}", device)
        if m.completed != m.offered:
            raise AssertionError(f"{cfg.name} {policy}: {m.completed} of "
                                 f"{m.offered} requests")
        if n_paged:
            raise AssertionError(f"{cfg.name}: a paged kernel launched on "
                                 f"the dense path")
        if policy == "dynaserve" and moved <= 0:
            raise AssertionError("no state handoff: DynaServe split no "
                                 "request")
        if device == "cuda":
            gc.collect()
            torch.cuda.empty_cache()
    return outs


def slot_state(eng, slot: int, upto: int):
    """Every cache tensor of ``slot`` that a handoff of ``upto`` tokens
    carries: spans of full-attention layers, whole rings, recurrent
    state, tail and cross caches."""
    out = {}
    for i, c in enumerate(eng.cache["blocks"]):
        for k, v in c.items():
            ring = "k" in c and c["k"].shape[2] < upto
            out[f"blocks[{i}].{k}"] = v[:, slot] if ring or "k" not in c \
                else v[:, slot, :upto]
    for j, tc in enumerate(eng.cache.get("tail", ())):
        for k, v in tc.items():
            out[f"tail[{j}].{k}"] = v[slot]
    for k, v in eng.cache.get("cross", {}).items():
        out[f"cross.{k}"] = v[:, slot]
    return out


def run_dense_handoff(seed: int, cfg, params, upto: int, chunk: int = 512,
                      steps: int = 8, device="cuda"):
    """Engine A prefills ``upto`` tokens in ``chunk``-token chunks and
    exports its state (``chunk``-token pieces); engine B imports it.  B's
    state must equal A's byte for byte; then both decode ``steps`` tokens
    from the same tokens and their logits must agree."""
    import numpy as np
    import torch
    from repro_torch.engine import BatchItem, InstanceEngine
    A, B = (InstanceEngine(cfg, params, n_slots=2, max_len=upto + 64,
                           max_chunk=chunk) for _ in range(2))
    prompt = np.random.default_rng(seed + 7).integers(
        0, cfg.vocab_size, upto).astype(np.int32)
    sa, sb = A.alloc("r"), B.alloc("r")
    for lo in range(0, upto, chunk):
        A.run_batch([BatchItem(sa, prompt[lo:lo + chunk], lo)])
    t0 = time.monotonic()
    pieces = A.export_state(sa, upto=upto, chunk=chunk)
    B.import_state(sb, pieces)
    if device == "cuda":
        torch.cuda.synchronize()
    moved = time.monotonic() - t0
    sa_state, sb_state = slot_state(A, sa, upto), slot_state(B, sb, upto)
    n_bytes = 0
    for key, a in sa_state.items():
        b = sb_state[key]
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(
                a.contiguous().view(torch.uint8),
                b.contiguous().view(torch.uint8)):
            raise AssertionError(f"{cfg.name} handoff: {key} differs")
        n_bytes += a.numel() * a.element_size()
    rings = sum(p is not None for p in pieces[-1].get("rings", ()))
    worst, tok = 0.0, int(prompt[-1])
    for i in range(steps):
        out_a = A.run_batch([BatchItem(sa, np.array([tok], np.int32),
                                       upto + i, True)])[sa]
        out_b = B.run_batch([BatchItem(sb, np.array([tok], np.int32),
                                       upto + i, True)])[sb]
        worst = max(worst, float(np.abs(out_a - out_b).max()))
        tok = int(out_a.argmax())
    log(f"[dense] {cfg.name} handoff at upto={upto} in {chunk}-token "
        f"chunks: {len(pieces)} pieces (the last ships {rings} ring(s) "
        f"whole), "
        f"{n_bytes} B of slot state byte-equal after the import ("
        f"state_bytes says {A.state_bytes(upto)} B), export+import "
        f"{moved * 1e3:.1f} ms; {steps} decode steps from the same tokens: "
        f"logits max abs err A vs B {worst:.3e} (tol {HANDOFF_TOL})")
    if worst > HANDOFF_TOL:
        raise AssertionError(f"{cfg.name} handoff logits differ by {worst}")


def run_whisper_frontend(seed: int, card: str, steps: int = 16,
                         device="cuda"):
    """Whisper-large-v3 at full width: ``run_frontend`` on slot 0 of a
    2-slot dense engine (1500 random frames x 0.02, 12 tokens), 16 decode
    steps, then ``run_frontend`` on slot 1 with other frames.  The
    reference's trait: slot 0's cross K/V then hold the projections of
    the encoder run on zero frames."""
    import numpy as np
    import torch
    from repro_torch.engine import InstanceEngine
    from repro_torch.models.mixers import _project_qkv
    from repro_torch.models.model import _encoder_fwd
    cfg, params = dense_model(seed, "whisper-large-v3", device=device)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    frames = [0.02 * torch.randn(cfg.encoder_len, cfg.d_model, generator=g,
                                 device=device) for _ in range(2)]
    prompt = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, 12).astype(np.int32)
    eng = InstanceEngine(cfg, params, n_slots=2, max_len=64)
    before = paged_counts()
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t0 = time.monotonic()
    logits = eng.run_frontend(0, frames=frames[0], tokens=prompt)
    t_front = time.monotonic() - t0
    toks = decode_steps(eng, 0, logits, len(prompt), steps, cfg)
    sync()
    t_dec = time.monotonic() - t0 - t_front
    xk0 = eng.cache["cross"]["xk"][:, 0].clone()
    eng.run_frontend(1, frames=frames[1], tokens=prompt[:4])
    with torch.no_grad():
        # the encoder on the batch run_frontend built: zero frames in
        # the inactive row 0, slot 1's frames in row 1
        enc = _encoder_fwd(params, cfg, torch.stack(
            [torch.zeros_like(frames[1]), frames[1]]))
        worst, scale = 0.0, 0.0
        for layer, lp in enumerate(params["layers"]):
            _, xk, xv = _project_qkv(lp["cross"], cfg, enc[:, :1], enc)
            for key, exp in (("xk", xk[0]), ("xv", xv[0])):
                got = eng.cache["cross"][key][layer, 0]
                worst = max(worst, float((got.float() - exp.float())
                                         .abs().max()))
                scale = max(scale, float(exp.float().abs().max()))
    changed = not torch.equal(xk0, eng.cache["cross"]["xk"][:, 0])
    log(f"[dense] {cfg.name} run_frontend: 1500 frames + 12 tokens on slot "
        f"0 in {t_front * 1e3:.1f} ms, {steps} decode steps in "
        f"{t_dec * 1e3:.1f} ms ({t_dec / steps * 1e3:.1f} ms a step), "
        f"tokens {toks[:6]}...; after slot 1's frontend, slot 0's cross K/V "
        f"{'were replaced' if changed else 'were NOT replaced'} by the "
        f"zero-frame encoder's projections: max abs err {worst:.3e} "
        f"(tol {CROSS_TOL} x max |value| {scale:.3f}); paged kernel "
        f"launches {paged_counts() - before}; card {card}")
    if not changed or worst > CROSS_TOL * max(1.0, scale):
        raise AssertionError("whisper cross K/V trait not reproduced")
    del eng, params


def decode_steps(eng, slot, logits, pos, steps, cfg):
    """Greedy decode ``steps`` tokens from ``logits``; checks each step's
    logits are finite and the tokens in range."""
    import numpy as np
    from repro_torch.engine import BatchItem
    toks = [int(np.asarray(logits).argmax())]
    for i in range(steps):
        out = eng.run_batch([BatchItem(slot, np.array([toks[-1]], np.int32),
                                       pos + i, True)])[slot]
        if out.shape != (cfg.vocab_size,) or not np.isfinite(out).all():
            raise AssertionError(f"{cfg.name}: bad logits at step {i}")
        toks.append(int(out.argmax()))
    if not all(0 <= t < cfg.vocab_size for t in toks):
        raise AssertionError(f"{cfg.name}: token out of range")
    return toks


def run_vlm_frontend(seed: int, card: str, n_layers: int = 8,
                     steps: int = 16, device="cuda"):
    """InternVL2-76B at full width, depth cut to ``n_layers`` of 80 (141
    GB of bf16 weights do not fit one 80 GB card): ``run_frontend`` with
    256 patch embeddings and 12 tokens, then 16 decode steps."""
    import numpy as np
    import torch
    from repro_torch.engine import InstanceEngine
    cfg, params = dense_model(seed, "internvl2-76b", device=device,
                              n_layers=n_layers)
    g = torch.Generator(device=device).manual_seed(seed + 2)
    ee = 0.02 * torch.randn(cfg.num_patches, cfg.d_model, generator=g,
                            device=device)
    prompt = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, 12).astype(np.int32)
    eng = InstanceEngine(cfg, params, n_slots=2, max_len=512)
    before = paged_counts()
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t0 = time.monotonic()
    logits = eng.run_frontend(0, extra_embeds=ee, tokens=prompt)
    sync()
    t_front = time.monotonic() - t0
    toks = decode_steps(eng, 0, logits, cfg.num_patches + len(prompt), steps,
                        cfg)
    sync()
    t_dec = time.monotonic() - t0 - t_front
    log(f"[dense] {cfg.name} run_frontend ({n_layers} of 80 layers, full "
        f"width; cut because 141 GB of bf16 weights do not fit one 80 GB "
        f"card): {cfg.num_patches} patches x {cfg.d_model} + 12 tokens in "
        f"{t_front * 1e3:.1f} ms, {steps} decode steps in "
        f"{t_dec * 1e3:.1f} ms, tokens {toks[:6]}...; paged kernel launches "
        f"{paged_counts() - before}; card {card}")
    del eng, params


def run_dense_card_vs_cpu(seed: int, name: str, n_layers: int,
                          T: int = 64, steps: int = 4, device="cuda", **cut):
    """One full-width model cut to ``n_layers`` (f32, TF32 off) on the card
    and on the CPU from the same weights and inputs: a prefill chunk on
    two rows (one padded), then ``steps`` decode steps fed the same
    tokens.  Logits and every cache tensor (recurrent state, rings and
    their positions, tails, cross K/V) agree to F32_RTOL of their own
    largest magnitude; positions exactly."""
    import numpy as np
    import torch
    from repro_torch.models.model import forward, init_cache
    cfg, gpu = dense_model(seed, name, device=device, n_layers=n_layers,
                           dtype="float32", **cut)
    cpu = to_device(gpu, "cpu")
    rng = np.random.default_rng(seed)
    B = 2
    toks = rng.integers(0, cfg.vocab_size, (B, T + steps))
    n_valid = np.array([T, T - 7])
    extra = {}
    n_pre = 0
    if cfg.arch_type == "vlm":
        n_pre = 64
        extra["extra_embeds"] = 0.02 * rng.standard_normal(
            (B, n_pre, cfg.d_model))
    if cfg.arch_type == "audio":
        extra["frames"] = 0.02 * rng.standard_normal(
            (B, cfg.encoder_len, cfg.d_model))

    def run(params, dev):
        t = {k: torch.tensor(v, dtype=torch.float32, device=dev)
             for k, v in extra.items()}
        cache = init_cache(cfg, B, n_pre + T + steps + 8, device=dev)
        nv = torch.tensor(n_valid + n_pre, device=dev)
        out = []
        with torch.no_grad():
            lg, cache, _ = forward(
                params, cfg, torch.tensor(toks[:, :T], device=dev),
                cache=cache, pos_offset=torch.zeros(B, dtype=torch.long,
                                                    device=dev),
                n_valid=nv, last_only=True, **t)
            out.append(lg)
            for i in range(steps):
                lg, cache, _ = forward(
                    params, cfg, torch.tensor(toks[:, T + i:T + i + 1],
                                              device=dev),
                    cache=cache, pos_offset=nv + i, last_only=True)
                out.append(lg)
        return [o.cpu() for o in out], to_device(cache, "cpu")

    t0 = time.monotonic()
    got, got_cache = run(gpu, device)
    exp, exp_cache = run(cpu, "cpu")
    bad = []
    worst = {}
    exp_flat = flat(exp_cache)
    for key, a, b in [("logits", torch.stack(got), torch.stack(exp))] + [
            (k, v, exp_flat[k]) for k, v in flat(got_cache).items()]:
        if not b.dtype.is_floating_point:
            if not torch.equal(a, b):
                bad.append(key)
            continue
        err = float((a - b).abs().max())
        bound = F32_RTOL * float(b.abs().max())
        worst[key] = (err, bound)
        if err > bound:
            bad.append(f"{key} {err:.3e} > {bound:.3e}")
    top = sorted(worst.items(), key=lambda kv: -kv[1][0] / max(kv[1][1],
                                                              1e-30))[:3]
    log(f"[dense] {cfg.name} card vs CPU, f32, {n_layers} layers full width, "
        f"prefill T={T} on 2 rows (one padded to {T - 7}) + {steps} decode "
        f"steps: logits max abs err {worst['logits'][0]:.3e} (bound "
        f"{worst['logits'][1]:.3e} = {F32_RTOL} x max |logit|); worst "
        f"state errors against their bounds: "
        + ", ".join(f"{k} {e:.3e}/{b:.3e}" for k, (e, b) in top)
        + f"; positions equal; {time.monotonic() - t0:.1f} s")
    if bad:
        raise AssertionError(f"{cfg.name} card vs CPU: {bad}")
    del gpu, cpu


def run_ring_past_window_check(seed: int, repeats: int = 10,
                               device="cuda"):
    """RecurrentGemma's smoke config (window 32) takes a 64-token chunk
    (one row padded to 45): every ring slot has two writers, and the last
    valid one must win on the card as on the CPU, on every repeat."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import forward, init_cache, init_params
    cfg = get_smoke_config("recurrentgemma-9b")
    cpu = init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    gpu = to_device(cpu, device)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (4, 64)))
    n_valid = torch.tensor([64, 45, 64, 33])

    def run(params, dev):
        cache = init_cache(cfg, 4, 96, device=dev)
        with torch.no_grad():
            forward(params, cfg, toks.to(dev), cache=cache,
                    pos_offset=torch.zeros(4, dtype=torch.long, device=dev),
                    n_valid=n_valid.to(dev), last_only=True)
        return flat(to_device(cache, "cpu"))

    exp = run(cpu, "cpu")
    worst = 0.0
    for _ in range(repeats):
        got = run(gpu, device)
        for key, a in got.items():
            b = exp[key]
            if not b.dtype.is_floating_point:
                if not torch.equal(a, b):
                    raise AssertionError(f"ring past the window: {key} "
                                         f"differs on the card")
            else:
                worst = max(worst, float((a - b).abs().max()))
    if worst > F32_RTOL:
        raise AssertionError(f"ring past the window: state err {worst}")
    log(f"[dense] recurrentgemma-9b smoke ring (window {cfg.window}, one "
        f"64-token chunk, rows of 64/45/64/33 valid tokens): {repeats} card "
        f"runs keep the CPU's last writer in every slot (positions equal), "
        f"state max abs err {worst:.3e} (tol {F32_RTOL})")


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, dev) for v in tree)
    return tree.to(dev)


def flat(tree, prefix=""):
    """A cache as {path: tensor}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((f"[{i}]", v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}.{k}" if not k.startswith("[")
                        else prefix + k))
    return out


def run_dense(seed: int, card: str, device="cuda"):
    """Phase 10.  RecurrentGemma-9B and Mamba2-780M serve at full width
    and hand off past the window; Whisper-large-v3 and InternVL2-76B run
    their stub frontends; the four models at full width and two layers
    (RecurrentGemma five) agree with the CPU in f32."""
    import torch
    t0 = time.monotonic()
    for name, upto in (("recurrentgemma-9b", 2560), ("mamba2-780m", 1536)):
        cfg, params = dense_model(seed, name, device=device)
        run_dense_serve(seed, card, cfg, params, device=device)
        run_dense_handoff(seed, cfg, params, upto, device=device)
        del params
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    run_whisper_frontend(seed, card, device=device)
    run_vlm_frontend(seed, card, device=device)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    for name, n_layers, cut in (("recurrentgemma-9b", 5, {}),
                                ("mamba2-780m", 2, {}),
                                ("whisper-large-v3", 2,
                                 {"encoder_layers": 2}),
                                ("internvl2-76b", 2, {})):
        run_dense_card_vs_cpu(seed, name, n_layers, device=device, **cut)
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    run_ring_past_window_check(seed, device=device)
    log(f"[dense] phase wall {time.monotonic() - t0:.1f} s; card {card}")


# ---------------------------------------------------------------------------
# phase 12: training, then serving the trained weights
# ---------------------------------------------------------------------------
#: card against CPU in f32 (TF32 off): loss, grad norm, lr and the moments
#: to F32_RTOL of their own largest magnitude; the updated params to the
#: reference's microbatch bound (tests/test_training.py), 3e-3 absolute:
#: Adam's first step turns gradient differences near eps into updates of
#: up to lr (1e-3 here)
TRAIN_PARAM_ATOL = 3e-3
#: microbatching 4 (with remat) against 1 (without), the same bound: loss
#: within 2e-3, params rtol = atol = 3e-3
MB_LOSS_TOL, MB_PARAM_TOL = 2e-3, 3e-3
#: the whole model's run: steps, batch, sequence, lr, warm-up, and how many
#: extra steps run under torch.profiler
TRAIN_STEPS, TRAIN_B, TRAIN_T, TRAIN_LR, TRAIN_WARMUP = 30, 4, 1024, 3e-4, 5
PROFILED_STEPS = 2


def short_key(path: str) -> str:
    """``['layers'][0]['mixer']['wq']`` -> ``layers.0.mixer.wq``."""
    return ".".join(part.strip("'") for part in path[1:-1].split("]["))


def leaf_errors(got, exp):
    """{short path: (max abs error, max |expected|)} of two trees."""
    from repro_torch.utils.tree import tree_items
    exp = dict(tree_items(exp))
    out = {}
    for key, a in tree_items(got):
        b = exp[key].float()
        out[short_key(key)] = (float((a.float().cpu() - b).abs().max()),
                               float(b.abs().max()))
    return out


def run_train_card_vs_cpu(seed: int, name: str, n_layers: int = 2,
                          B: int = 2, T: int = 128, device="cuda"):
    """(a) The full-width model cut to ``n_layers``, in f32 (TF32 off):
    one ``make_train_step`` (remat on) on the card and on the CPU from the
    same weights and batch, then on the card 4 microbatches with remat
    against 1 without on a batch of 4."""
    import torch
    from repro_torch.data.tokens import token_batches
    from repro_torch.training import adamw_init, make_train_step
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.utils.tree import tree_map
    cfg, gpu = dense_model(seed, name, device=device, n_layers=n_layers,
                           dtype="float32")
    cpu = tree_map(lambda t: t.to("cpu", copy=True), gpu)
    init = tree_map(torch.clone, cpu)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1)
    batch = next(token_batches(cfg, B, T, seed=seed))
    step = make_train_step(cfg, opt_cfg)
    t0 = time.monotonic()
    gpu, g_opt, g_m = step(gpu, adamw_init(gpu, opt_cfg), batch)
    float(g_m["loss"])                       # waits for the device
    t_card = time.monotonic() - t0
    t0 = time.monotonic()
    cpu, c_opt, c_m = step(cpu, adamw_init(cpu, opt_cfg), batch)
    t_cpu = time.monotonic() - t0
    bad = []
    scalars = {}
    for k in ("loss", "grad_norm", "lr"):
        a, b = float(g_m[k]), float(c_m[k])
        scalars[k] = (a, b)
        if abs(a - b) > F32_RTOL * abs(b):
            bad.append(f"{k} {a} vs {b}")
    errs = {"params": leaf_errors(gpu, cpu),
            "m": leaf_errors(g_opt["m"], c_opt["m"]),
            "v": leaf_errors(g_opt["v"], c_opt["v"])}
    for tree, e in errs.items():
        for key, (err, scale) in e.items():
            lim = TRAIN_PARAM_ATOL if tree == "params" else F32_RTOL * scale
            if err > lim:
                bad.append(f"{tree} {key} {err:.3e} > {lim:.3e}")
    log(f"[train] {cfg.name} card vs CPU, f32, {n_layers} layers full width, "
        f"one train step (remat) on B={B} T={T}: "
        + ", ".join(f"{k} {a:.7g} vs {b:.7g}" for k, (a, b) in scalars.items())
        + f" (bound {F32_RTOL} relative); card {t_card:.2f} s, CPU "
        f"{t_cpu:.2f} s")
    for tree, e in errs.items():
        bound = (f"bound {TRAIN_PARAM_ATOL} absolute" if tree == "params"
                 else f"bound {F32_RTOL} x each leaf's largest magnitude")
        log(f"[train] {cfg.name} card vs CPU, largest error of every updated "
            f"{tree} leaf ({bound}): "
            + ", ".join(f"{k} {err:.2e}" + ("" if tree == "params"
                                             else f"/{scale:.2e}")
                        for k, (err, scale) in e.items()))
    if bad:
        raise AssertionError(f"{cfg.name} train step card vs CPU: {bad}")
    del gpu, cpu, g_opt, c_opt

    batch4 = next(token_batches(cfg, 4, T, seed=seed + 1))
    runs = {}
    for n, remat in ((1, False), (4, True)):
        p = tree_map(lambda t: t.to(device, copy=True), init)
        p, _, m = make_train_step(cfg, opt_cfg, num_microbatches=n,
                                  remat=remat)(p, adamw_init(p, opt_cfg),
                                               batch4)
        runs[n] = (p, float(m["loss"]))
    (p1, l1), (p4, l4) = runs[1], runs[4]
    worst = max((float(((a - b).abs() - MB_PARAM_TOL * b.abs()).max()), k)
                for (k, a), b in zip(flat(p4).items(), flat(p1).values()))
    log(f"[train] {cfg.name} on the card, 4 microbatches with remat vs 1 "
        f"without, B=4 T={T}: loss {l4:.7g} vs {l1:.7g} (|diff| "
        f"{abs(l4 - l1):.2e}, bound {MB_LOSS_TOL}); params: largest "
        f"|a - b| - {MB_PARAM_TOL}|b| = {worst[0]:.2e} at {worst[1]} (bound "
        f"{MB_PARAM_TOL})")
    if abs(l4 - l1) > MB_LOSS_TOL or worst[0] > MB_PARAM_TOL:
        raise AssertionError(f"{cfg.name}: microbatched step differs")
    del runs, p1, p4, init


@contextlib.contextmanager
def optimizer_range():
    """Put the train step's AdamW update under a
    ``record_function("optimizer")`` range for the profiler."""
    import torch
    from repro_torch.training import train
    upd = train.adamw_update

    def ranged(*args, **kwargs):
        with torch.profiler.record_function("optimizer"):
            return upd(*args, **kwargs)

    train.adamw_update = ranged
    try:
        yield
    finally:
        train.adamw_update = upd


def run_checkpoint_roundtrip(params, opt_state, label: str, device="cuda"):
    """Save the state into a temporary directory under ``build/``, load it
    back onto the same devices, require every leaf bit-equal, delete the
    directory.  Returns (bytes on disk, save s, load s)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.training.checkpoint import (
        latest_checkpoint, load_checkpoint, save_checkpoint,
    )
    (ROOT / "build").mkdir(exist_ok=True)
    d = tempfile.mkdtemp(prefix="ckpt_", dir=ROOT / "build")
    try:
        t0 = time.monotonic()
        path = save_checkpoint(d, params, opt_state, step=TRAIN_STEPS)
        t_save = time.monotonic() - t0
        n_bytes = Path(path).stat().st_size
        assert latest_checkpoint(d) == path
        t0 = time.monotonic()
        p2, o2, step = load_checkpoint(path, params, opt_state)
        if device == "cuda":
            torch.cuda.synchronize()
        t_load = time.monotonic() - t0
        assert step == TRAIN_STEPS
        dtypes = set()
        for (k, a), b in zip(flat((params, opt_state)).items(),
                             flat((p2, o2)).values()):
            dtypes.add(str(a.dtype).removeprefix("torch."))
            if a.dtype != b.dtype or a.device != b.device or not torch.equal(
                    a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                    b.view(torch.int16) if b.dtype == torch.bfloat16 else b):
                raise AssertionError(f"checkpoint round trip: {k} differs")
        n_leaves = len(flat((params, opt_state)))
        del p2, o2
    finally:
        shutil.rmtree(d)
    log(f"[train] {label} checkpoint round trip: {n_leaves} leaves "
        f"({'/'.join(sorted(dtypes))}) bit-equal after save + load onto the "
        f"card; {n_bytes} B on disk, save {t_save:.1f} s, load {t_load:.1f} "
        f"s; directory deleted")
    return n_bytes, t_save, t_load


def run_train_whole(seed: int, card: str, device="cuda"):
    """(b) The whole Phi-4-mini-3.8B in bf16 with f32 AdamW moments and
    remat: ``TRAIN_STEPS`` steps of ``token_batches`` through
    ``train_loop``, then ``PROFILED_STEPS`` more under torch.profiler, then
    a checkpoint round trip of the state.  Returns (cfg, trained params,
    optimizer state)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.tokens import token_batches
    from repro_torch.training import make_train_step, train_loop
    from repro_torch.training.optimizer import AdamWConfig
    cfg, params = dense_model(seed, TRAIN_PATH, device=device)
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    n_params = sum(t.numel() for t in flat(params).values())
    tokens = TRAIN_B * TRAIN_T
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                          total_steps=TRAIN_STEPS)
    batches = token_batches(cfg, TRAIN_B, TRAIN_T, seed=seed)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    res = train_loop(cfg, params, batches, opt_cfg, steps=TRAIN_STEPS,
                     log_every=1)
    wall = time.monotonic() - t0
    params, opt = res["params"], res["opt_state"]
    hist = res["history"]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    prev = 0.0
    walls = []
    for h in hist:
        walls.append(h["elapsed"] - prev)
        prev = h["elapsed"]
        log(f"[train] {cfg.name} step {h['step']}: loss {h['loss']:.4f}, lr "
            f"{h['lr']:.3e}, wall {walls[-1] * 1e3:.1f} ms, "
            f"{tokens / walls[-1]:.0f} tokens/s")
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{cfg.name}: non-finite training loss {losses}")
    if not losses[-1] < losses[0] - 0.5:
        raise AssertionError(f"{cfg.name}: loss fell from {losses[0]:.4f} to "
                             f"{losses[-1]:.4f}, not by more than 0.5")
    steady = float(np.median(walls[2:]))
    flops = 8 * n_params * tokens       # forward, remat recompute, backward
    log(f"[train] {cfg.name} whole ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, tied: {n_params / 1e9:.3f}B "
        f"params), {cfg.dtype} with {opt_cfg.moment_dtype} moments and remat, "
        f"B={TRAIN_B} T={TRAIN_T}: {TRAIN_STEPS} steps in {wall:.1f} s; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (fell {losses[0] - losses[-1]:.4f}"
        f", more than 0.5 required); median step {steady * 1e3:.1f} ms from "
        f"step 2, {tokens / steady:.0f} tokens/s, 8*N*tokens = "
        f"{flops / 1e12:.1f} TFLOP a step = {flops / steady / 1e12:.1f} "
        f"TFLOP/s, {flops / steady / BF16_FLOPS_PER_S:.3f} of the bf16 "
        f"data-sheet peak; peak memory {peak / 1e9:.3f} GB "
        f"(torch.cuda.max_memory_allocated) of "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9 if cuda else 0:.3f}; "
        f"card {card}")

    step_fn = make_train_step(cfg, opt_cfg)
    for _ in range(PROFILE_TRIES):
        sync()
        with optimizer_range(), profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED_STEPS):
                params, opt, m = step_fn(params, opt, next(batches))
            sync()
            wall_us = (time.perf_counter() - t0) * 1e6
        inside = _range_kernels(prof, "optimizer")
        if inside or not cuda:
            break
    else:
        raise RuntimeError(f"the profiler tied no kernel to the optimizer "
                           f"in {PROFILE_TRIES} captures")
    dev = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and \
                ev.name != "optimizer":
            cls = _kernel_class(ev.name)
            dev[cls] = dev.get(cls, 0.0) + ev.time_range.elapsed_us()
    busy = sum(dev.values())
    opt_us = sum(k.duration for k in inside)
    dev["other"] = dev.get("other", 0.0) - opt_us
    dev["optimizer"] = opt_us
    n = PROFILED_STEPS
    log(f"[train] {cfg.name} {n} steps under torch.profiler (lr 0 past the "
        f"schedule's end, the same work): wall {wall_us / n / 1e3:.1f} ms a "
        f"step; device ms a step by class: " + ", ".join(
            f"{k} {v / n / 1e3:.3f}" for k, v in
            sorted(dev.items(), key=lambda kv: -kv[1]))
        + f"; idle share {1 - busy / wall_us:.3f}; card {card}")
    return cfg, params, opt


def run_train(seed: int, card: str, device="cuda"):
    """Phase 11.  (a) Phi-4-mini-3.8B and Mamba2-780M at full width and 2
    layers: a train step on the card against the CPU in f32, and
    microbatching against none; (b) the whole Phi-4-mini trained in bf16,
    with a checkpoint round trip; (c) its trained weights served through
    DynaServe, kernel launches counted.  Returns (c)'s launches."""
    import torch
    empty = torch.cuda.empty_cache if device == "cuda" else (lambda: None)
    t0 = time.monotonic()
    for name in (TRAIN_PATH, "mamba2-780m"):
        run_train_card_vs_cpu(seed, name, device=device)
        gc.collect()
        empty()
    cfg, params, opt = run_train_whole(seed, card, device=device)
    gc.collect()
    empty()
    run_checkpoint_roundtrip(params, opt, f"{cfg.name} whole state",
                             device=device)
    del opt
    gc.collect()
    empty()
    launches, _ = run_serve(seed, card, cfg=cfg, params=params,
                            device=device)
    log(f"[train] phase wall {time.monotonic() - t0:.1f} s; card {card}")
    return launches


# ---------------------------------------------------------------------------
# phase 13: the dryrun, and one device's real share of three steps
# ---------------------------------------------------------------------------
#: the combos of tests/test_dryrun.py, which must trace at the H100 layouts
DRYRUN_MUST = (("chatglm3-6b", "decode_32k", False),
               ("qwen3-moe-30b-a3b", "train_4k", False),
               ("mamba2-780m", "long_500k", False),
               ("recurrentgemma-9b", "decode_32k", True),
               ("whisper-large-v3", "prefill_32k", True))
#: one step of each kind on the card, at a layout with model axis 8 whose
#: predicted one-device peak lies between 20 and 70 GB where one does
#: (chatglm3-6b decode_32k peaks at 17.2 GB at data 1 x model 8, the
#: largest share a model-8 layout gives its global batch of 128)
DRYRUN_CHECKS = (("chatglm3-6b", "decode_32k", "1x8"),
                 ("qwen3-moe-30b-a3b", "prefill_32k", "8x8"),
                 ("phi4-mini-3.8b", "train_4k", "32x8"))
#: measured peak over the trace's predicted peak
PEAK_BAND = (0.85, 1.15)
#: the sequence-sharded decode against the unsharded one, in f32
SEQ_SHARD_TOL = 1e-5
#: run the two-pod sweep only when the one-pod sweep took less than this
SWEEP_SECONDS = 150.0


def run_dryrun_sweep(multi_pod: bool, jobs: int):
    """Every assigned arch x shape traced on ``meta`` at the production
    layout, ``jobs`` at a time; one line a combo.  Raises when a combo of
    ``DRYRUN_MUST`` fails; prints every failure with its error."""
    from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES
    from repro_torch.launch import dryrun
    combos = [(a, s, multi_pod) for a in ASSIGNED_ARCHS for s in INPUT_SHAPES]
    t0 = time.monotonic()
    recs = {}
    for arch, shape, mp, rec in dryrun._records(combos, jobs):
        recs[(arch, shape)] = rec
        log(f"[dryrun] {dryrun.summary_line(rec)}")
    wall = time.monotonic() - t0
    bad = [k for k, r in recs.items() if r["status"] != "ok"]
    log(f"[dryrun] {'two pods' if multi_pod else 'one pod'}: "
        f"{len(recs) - len(bad)}/{len(recs)} combos traced in {wall:.1f} s "
        f"({jobs} processes); failed: {bad or 'none'}")
    from repro_torch.configs import canonical
    for arch, shape, mp in DRYRUN_MUST:
        if mp == multi_pod and recs[(canonical(arch), shape)]["status"] != "ok":
            raise AssertionError(f"dryrun: {arch} {shape} did not trace: "
                                 f"{recs[(canonical(arch), shape)]['error']}")
    return wall


def run_dryrun_check(arch: str, shape: str, layout: str, card: str):
    """``check_on_device`` of one combo on the card: the measured peak
    within ``PEAK_BAND`` of the traced one; what the allocator holds for
    the real arguments at least the specs' bytes and at most the
    allocator's rounding above them; the FlopCounterMode count of the
    real run equal to the meta trace's (the same ops, counted by the same
    formulas: a check that the trace ran what the card ran)."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.utils.sharding import Layout
    dims = tuple(int(x) for x in layout.split("x"))
    t0 = time.monotonic()
    r = dryrun.check_on_device(arch, shape, Layout(dims, ("data", "model")),
                               "cuda")
    p, m = r["predicted"], r["measured"]
    ratio = m["peak_bytes"] / p["peak_bytes"]
    over = m["allocated_argument_bytes"] - p["argument_bytes"]
    log(f"[dryrun] {arch} {shape} at REPRO_DRYRUN_MESH={layout} (shard 0 "
        f"of model 8, {r['microbatches']} microbatch(es)): arguments "
        f"{m['allocated_argument_bytes']} B allocated / "
        f"{p['argument_bytes']} B by the specs = +{over} B (allocator "
        f"rounding bound {m['allocator_slack_bytes']} B); "
        f"peak {m['peak_bytes'] / 1e9:.3f} GB measured / "
        f"{p['peak_bytes'] / 1e9:.3f} GB traced = {ratio:.4f}; FLOPs "
        f"{m['flops']:.6e} measured / {p['flops']:.6e} traced; device "
        f"{m['device_ms']:.3f} ms ({m['timed_by']}) / roofline "
        f"{p['roofline_max']} {p['roofline_max_s'] * 1e3:.3f} ms = "
        f"{m['device_ms'] / (p['roofline_max_s'] * 1e3):.3f}; "
        f"{time.monotonic() - t0:.1f} s; {card}")
    if m["flops"] != p["flops"]:
        raise AssertionError(f"{arch} {shape}: FLOPs {m['flops']} on the "
                             f"card, {p['flops']} traced")
    if not 0 <= over <= m["allocator_slack_bytes"]:
        raise AssertionError(f"{arch} {shape}: the allocator holds "
                             f"{m['allocated_argument_bytes']} B for the "
                             f"arguments, the specs give "
                             f"{p['argument_bytes']} B (+{over} B, bound "
                             f"{m['allocator_slack_bytes']} B)")
    if not PEAK_BAND[0] <= ratio <= PEAK_BAND[1]:
        raise AssertionError(f"{arch} {shape}: measured peak {ratio:.4f}x "
                             f"the traced peak, outside {PEAK_BAND}")
    torch.cuda.empty_cache()


def run_seqshard_decode(seed: int, n_layers: int = 2, prompt: int = 3000,
                        steps: int = 4, S: int = 4096, B: int = 4, cfg=None,
                        device="cuda"):
    """chatglm3-6b at full width and ``n_layers`` layers in f32: a prefill
    and ``steps`` decode steps through a dense cache whose sequence is
    split over two shards of a real ShardGroup time-sharing the card,
    each with its shard of the weights at the dryrun's traced decode
    layout (every query head, ``wo`` split by rows), against the same
    steps on the whole cache and weights.  The second shard holds
    positions ``S / 2`` on, so the prompt's tail and every decode step
    land there."""
    import os
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import traced_shard
    from repro_torch.models import model as tmodel
    from repro_torch.models.tp import ShardGroup
    from repro_torch.utils.device import (
        DEVICE_COUNT_ENV, as_device, visible_devices)
    from repro_torch.utils.sharding import Layout
    cfg = (cfg or get_config("chatglm3-6b")).with_(n_layers=n_layers,
                                                   dtype="float32")
    gen = torch.Generator(device=device).manual_seed(seed)
    params = tmodel.init_params(cfg, gen, device=device)
    toks = torch.randint(0, cfg.vocab_size, (B, prompt + steps),
                         generator=gen, device=device)

    def run(params, cache, dev):
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        out = []
        with torch.no_grad():
            lg, _, _ = tmodel.forward(params, cfg, toks[:, :prompt],
                                      cache=cache, pos_offset=0)
            out.append(lg[:, -1])
            for i in range(steps):
                lg, _, _ = tmodel.forward(
                    params, cfg, toks[:, prompt + i:prompt + i + 1],
                    cache=cache, pos_offset=torch.full(
                        (B,), prompt + i, device=device))
                out.append(lg[:, -1])
        return torch.stack(out)

    exp = run(params, tmodel.init_cache(cfg, B, S, device=device),
              as_device(device))
    layout = Layout((1, 2), ("data", "model"))
    shards = [traced_shard(params, cfg, layout, r, seq_decode=True)
              for r in range(2)]
    if shards[0]["layers"][0]["mixer"]["wo"].shape[0] * 2 != \
            cfg.n_heads * cfg.hd:
        raise AssertionError("the traced decode layout keeps wo whole")
    prev = os.environ.get(DEVICE_COUNT_ENV)
    os.environ[DEVICE_COUNT_ENV] = "2"
    group = ShardGroup(2, seq_shard=True)
    try:
        devs = visible_devices(torch.device(device).type)[:2]
        caches = [tmodel.init_cache(cfg, B, S // 2, device=d) for d in devs]
        got = group.run(lambda r: run(shards[r], caches[r], devs[r]))
    finally:
        group.close()
        if prev is None:
            os.environ.pop(DEVICE_COUNT_ENV, None)
        else:
            os.environ[DEVICE_COUNT_ENV] = prev
    scale = exp.abs().max().item()
    err = max((g - exp).abs().max().item() for g in got)
    log(f"[dryrun] sequence-sharded decode, chatglm3-6b full width, "
        f"{n_layers} layers, f32, B {B}, a {prompt}-token prefill and "
        f"{steps} decode steps over a {S}-slot cache split over two shards "
        f"of the card: max |err| {err:.3e} = {err / scale:.3e} of the "
        f"logits' scale {scale:.3f} (bound {SEQ_SHARD_TOL})")
    if not err <= SEQ_SHARD_TOL * scale:
        raise AssertionError(f"sequence-sharded decode off by {err / scale} "
                             f"of scale")


def run_dryrun(seed: int, card: str):
    """Phase 12."""
    import os
    t0 = time.monotonic()
    jobs = max(1, min(8, (os.cpu_count() or 2) - 1))
    wall = run_dryrun_sweep(False, jobs)
    if wall < SWEEP_SECONDS:
        run_dryrun_sweep(True, jobs)
    else:
        log(f"[dryrun] the one-pod sweep took {wall:.1f} s; the two-pod "
            f"sweep is left out")
    for arch, shape, layout in DRYRUN_CHECKS:
        run_dryrun_check(arch, shape, layout, card)
    run_seqshard_decode(seed)
    log(f"[dryrun] phase wall {time.monotonic() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 14: the examples
# ---------------------------------------------------------------------------
EXAMPLE_PATHS = ("serve_cluster_torch", "multiturn_chat_torch")


def load_example(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_examples(card: str, device="cuda"):
    """Phase 13: the two engine examples in this process on the card, at
    their default smoke config (Qwen2.5-14B, paged), each with the
    kernels' launch counters zeroed just before it and read just after.
    Returns launches by example."""
    import io
    from contextlib import redirect_stdout
    from repro_torch.kernels import chunked_prefill_attention as cpa
    from repro_torch.kernels import paged_decode_attention as pda
    launches = {}
    for name in EXAMPLE_PATHS:
        mod = load_example(name)
        buf = io.StringIO()
        t0 = time.monotonic()
        pda.launches = 0
        cpa.launches = 0
        with redirect_stdout(buf), step_tally() as tally:
            out = mod.main([] if device == "cuda" else ["--device", device])
        n = {"paged_decode_attention": pda.launches,
             "chunked_prefill_attention": cpa.launches}
        for line in buf.getvalue().splitlines():
            if line.strip():
                log(f"[examples] {name}: {line}")
        log(f"[examples] {name}: {time.monotonic() - t0:.1f} s, kernel "
            f"launches {n}; {tally_line(tally)}; {card}")
        check_graphed(tally, name, device)
        for kernel, k in n.items():
            if k <= 0 and device == "cuda":
                raise AssertionError(f"{name}: {kernel} was not launched")
        if name == "multiturn_chat_torch":
            saved = [t["saved"] for t in out]
            if not all(b > a for a, b in zip(saved, saved[1:])):
                raise AssertionError(f"{name}: saved prefill {saved} does "
                                     f"not grow turn by turn")
        launches[f"examples/{name}.py"] = n
    return launches


# ---------------------------------------------------------------------------
# phase 15: the compiled step (one CUDA graph per (T, n_pp)) against eager
# ---------------------------------------------------------------------------
#: (config, layers kept, page-pool precision or None for the dense cache,
#: max_len, shards): Qwen2.5-14B at full width on every pool format;
#: RecurrentGemma-9B (its ring of 2048 and a tail block) and Mamba2-780M
#: on the dense cache, at full width and 4 layers; sharded engines whose
#: two shards time-share the card: the 14B at TP=2 on a bf16 pool and on
#: the dense cache, Qwen3-30B-A3B at EP=2 (sharded pools are bf16 only)
GRAPH_ENGINES = (("qwen2.5-14b", 2, "bf16", 1024, 1),
                 ("qwen2.5-14b", 2, "fp8", 1024, 1),
                 ("qwen2.5-14b", 2, "int8", 1024, 1),
                 ("recurrentgemma-9b", 4, None, 4096, 1),
                 ("mamba2-780m", 4, None, 1024, 1),
                 ("qwen2.5-14b", 2, "bf16", 1024, 2),
                 ("qwen2.5-14b", 2, None, 1024, 2),
                 (MOE_PATH, 2, "bf16", 1024, 2))
#: the items, each (slot, first position, tokens): prefill chunks in the
#: T buckets 512, 128 and 32, then a mixed batch (a decode step, a
#: 60-token chunk, a new 7-token prompt)
GRAPH_STEPS = ([(0, 0, 300)], [(1, 0, 100)], [(2, 0, 20), (0, 300, 30)],
               [(0, 330, 1), (1, 100, 60), (3, 0, 7)])
GRAPH_DECODE_STEPS = 8


def cache_bytes(eng):
    """Every cache tensor of every shard of an engine, as raw bytes."""
    import torch
    return {k: v.contiguous().view(torch.uint8).clone()
            for k, v in flat(eng.caches).items()}


def graph_pool_bytes(device="cuda"):
    """Bytes the allocator holds in the engines' shared graph pool on
    ``device`` (its segments in ``torch.cuda.memory_snapshot()``), or
    None where the snapshot does not name segments' pools."""
    import torch
    from repro_torch.engine.runner import graph_pool
    pid = tuple(graph_pool(torch.device(device)))
    segs = torch.cuda.memory_snapshot()
    if segs and "segment_pool_id" not in segs[0]:
        return None
    return sum(sg["total_size"] for sg in segs
               if tuple(sg["segment_pool_id"]) == pid)


def run_graphs(seed: int, card: str, device="cuda"):
    """For each of ``GRAPH_ENGINES``: an eager engine (``graphs=False``)
    and a graphed one on the same weights, fed the same items
    (``GRAPH_STEPS``, then ``GRAPH_DECODE_STEPS`` decode steps of all four
    slots).  After every step the logits must be bit-equal and every
    shard's cache tensors byte-equal; every capture's all-inactive warm-up must
    leave every cache byte as it was; the launch counters after the
    replays must equal the eager engine's; and, with every key captured,
    ``dispatch_batch`` of a prefill, a mixed and a decode step must make
    no synchronizing call on either engine under
    ``torch.cuda.set_sync_debug_mode("error")``.  Prints the captures,
    their seconds and the graph pool's bytes."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.engine import BatchItem, InstanceEngine
    from repro_torch.engine import runner
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.models.model import init_params
    t_phase = time.monotonic()
    capture = runner.InstanceEngine._capture
    warm_checks = [0]

    sync_debug = (torch.cuda.set_sync_debug_mode if device == "cuda"
                  else (lambda mode: None))

    def checked_capture(self, T, n_pp):
        before = cache_bytes(self)
        g = capture(self, T, n_pp)
        torch.cuda.synchronize()
        after = cache_bytes(self)
        bad = [k for k in before if not torch.equal(before[k], after[k])]
        if bad:
            raise AssertionError(f"the warm-up of key ({T}, {n_pp}) "
                                 f"changed cache bytes of {bad}")
        warm_checks[0] += 1
        return g

    runner.InstanceEngine._capture = checked_capture
    try:
        for name, layers, prec, max_len, width in GRAPH_ENGINES:
            cfg = get_config(name).with_(n_layers=layers)
            params = init_params(cfg, torch.Generator(device=device)
                                 .manual_seed(seed), device=device)
            kw = dict(n_slots=4, max_len=max_len, max_chunk=512,
                      devices=[device] * width)
            if prec is not None:
                kw.update(kv_mode="paged", page_size=8, kv_precision=prec)
            else:
                kw.update(kv_mode="dense")
            eager = InstanceEngine(cfg, params, graphs=False, **kw)
            graphed = InstanceEngine(cfg, params, **kw)
            if device == "cuda" and not graphed.graphs:
                raise AssertionError(f"{name} x{width}: the engine on the "
                                     f"card does not graph its steps")
            what = (f"{name} {prec or 'dense'}"
                    + (f" {'EP' if cfg.moe_experts else 'TP'}={width}"
                       if width > 1 else ""))
            for eng in (eager, graphed):
                for i in range(4):
                    eng.alloc(f"r{i}")
            toks = np.random.default_rng(seed).integers(
                0, cfg.vocab_size, (4, 1024)).astype(np.int32)
            pos = [0] * 4
            launches = {"eager": {}, "graphed": {}}
            steps = [list(st) for st in GRAPH_STEPS]

            def items_of(step):
                return [BatchItem(s, toks[s, p:p + n], p, True)
                        for s, p, n in step]

            def run(label, eng, items):
                before = launch_counts()
                out = eng.run_batch(items)
                for k, n in launch_counts().items():
                    launches[label][k] = launches[label].get(k, 0) + \
                        n - before[k]
                return out

            n_cmp = 0
            for step in steps:
                for s, p, n in step:
                    pos[s] = max(pos[s], p + n)
            for i in range(GRAPH_DECODE_STEPS):
                steps.append([(s, pos[s] + i, 1) for s in range(4)])
            for k, step in enumerate(steps):
                items = items_of(step)
                le, lg = run("eager", eager, items), run("graphed", graphed,
                                                         items)
                for s in le:
                    if not np.array_equal(le[s].view(np.uint32),
                                          lg[s].view(np.uint32)):
                        raise AssertionError(
                            f"{what} step {k} slot {s}: "
                            f"graphed logits differ from eager by "
                            f"{np.abs(le[s] - lg[s]).max():.3e}")
                ce, cg = cache_bytes(eager), cache_bytes(graphed)
                bad = [key for key in ce if not torch.equal(ce[key],
                                                            cg[key])]
                if bad:
                    raise AssertionError(f"{what} step {k}: cache bytes "
                                         f"differ in {bad}")
                n_cmp += 1
            if launches["eager"] != launches["graphed"]:
                raise AssertionError(f"{what}: launches eager "
                                     f"{launches['eager']}, graphed "
                                     f"{launches['graphed']}")
            # every key captured: the same kinds of step again, now
            # dispatched under the sync debug mode
            nxt = [p + GRAPH_DECODE_STEPS for p in pos]

            def take(slot, n):
                nxt[slot] += n
                return (slot, nxt[slot] - n, n)

            for kind in ("prefill", "mixed", "decode"):
                pair = []
                for _ in range(2):
                    pair.append([take(2, 16)] if kind == "prefill" else
                                [take(2, 16), take(0, 1)] if kind == "mixed"
                                else [take(s, 1) for s in range(4)])
                for eng in (eager, graphed):
                    eng.run_batch(items_of(pair[0]))    # captures if new
                    sync_debug("error")
                    try:
                        handle = eng.dispatch_batch(items_of(pair[1]))
                    finally:
                        sync_debug(0)
                    eng.collect_batch(handle)
            pool = graph_pool_bytes(device) if device == "cuda" else None
            log(f"[graphs] {name} ({layers} layers, full width"
                f"{'' if width == 1 else ', ' + what.split()[-1] + ', two shards time-sharing the card'}) "
                f"{'pool ' + prec if prec else 'dense cache'}: {n_cmp} "
                f"steps ({', '.join(str(len(st)) + ' items' for st in GRAPH_STEPS)}, "
                f"then {GRAPH_DECODE_STEPS} decode steps of 4 slots) graphed "
                f"vs eager: logits bit-equal, every cache tensor of every "
                f"shard byte-equal after every step; launches equal "
                f"{ {k: n for k, n in launches['graphed'].items() if n} or 'none (dense)'}; "
                f"set_sync_debug_mode('error') raised nothing in "
                f"dispatch_batch of a prefill, a mixed and a decode step on "
                f"either engine; {graphed.captures} captures in "
                f"{graphed.capture_seconds:.2f} s, the shared pool "
                f"{'not measured' if pool is None else f'{pool / 1e9:.3f} GB'}; "
                f"{card}")
            eager.close()
            graphed.close()
            del eager, graphed, params
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
    finally:
        runner.InstanceEngine._capture = capture
    log(f"[graphs] {warm_checks[0]} captures' all-inactive warm-ups left "
        f"every cache byte as it was; phase wall "
        f"{time.monotonic() - t_phase:.1f} s")


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


def _range_kernels(prof, name: str):
    """The device kernels launched inside every ``record_function(name)``
    range of a profile: each range's own kernels and those of the CPU ops
    under it."""
    import torch
    out = []

    def walk(ev):
        out.extend(k for k in ev.kernels if k.name != name)
        for child in ev.cpu_children:
            walk(child)

    for ev in prof.events():
        if ev.name == name and \
                ev.device_type == torch.autograd.DeviceType.CPU:
            walk(ev)
    return out


#: plain ops of the dense path, by the profile class they form: the dense
#: attention, and the SSD scan, the RG-LRU recurrence and the causal conv
DENSE_RANGES = {"_flash_gqa": "attention", "_gqa_scores_to_out": "attention",
                "ssd_scan": "scan", "_linear_scan": "scan",
                "_causal_conv": "scan"}


@contextlib.contextmanager
def dense_ranges():
    """Put each of the ``DENSE_RANGES`` functions of the port's mixers under
    a ``record_function`` range named by its class, for the profiler."""
    import torch
    from repro_torch.models import mixers
    saved = {name: getattr(mixers, name) for name in DENSE_RANGES}

    def ranged(fn, cls):
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(cls):
                return fn(*args, **kwargs)
        return wrapper

    for name, fn in saved.items():
        setattr(mixers, name, ranged(fn, DENSE_RANGES[name]))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(mixers, name, fn)


@contextlib.contextmanager
def moe_ranges():
    """Put every MoE layer of the port under a ``record_function("moe")``
    range for the profiler (the port itself has no ranges)."""
    import torch
    from repro_torch.models import layers
    fwd = layers.moe_fwd

    def ranged(*args, **kwargs):
        with torch.profiler.record_function("moe"):
            return fwd(*args, **kwargs)

    layers.moe_fwd = ranged
    try:
        yield
    finally:
        layers.moe_fwd = fwd


def run_profile(seed: int, card: str, cfg=None, device="cuda",
                n_slots: int = 8, ctx: int = 1024, chunk: int = 512,
                steps: int = 4, graphs: bool = False):
    """One engine (Qwen2.5-14B unless ``cfg`` names another config) at the
    serve phase's sizes: ``steps`` prefill steps (a ``chunk``-token chunk
    on every slot at position ``ctx``) and ``steps`` decode steps (every
    slot, contexts from ``ctx + chunk``), each window under
    torch.profiler.  Prints wall time per step, device time per kernel
    class, and the device's idle share (wall time with no kernel
    running).  For an MoE model the kernels inside its MoE layers other
    than matrix products (router softmax, sort, rank scan, dispatch,
    combine) form the ``moe`` class, and the share of ``matmul`` that is
    the expert products is printed beside it.  For a dense-cache model
    every kernel of the plain dense attention forms the ``attention``
    class and every kernel of the SSD scan, the RG-LRU recurrence and the
    causal convolution the ``scan`` class (their products included; the
    RG-LRU's one-token closed form stays in ``other``).  With ``graphs``
    the engine replays its captured steps: the kernels run under no
    Python range, so the ``moe``, ``attention`` and ``scan`` classes are
    not split out of ``matmul`` and ``other`` there."""
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
                         n_pages=4096, max_chunk=chunk,
                         max_len=ctx + 2 * chunk, graphs=graphs)
    mode = "graphed" if eng.graphs else "eager"
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
    prefill(ctx)                             # warm both step shapes (a
    decode(ctx + chunk)                      # graphed engine captures)
    for label, fn in (("prefill", lambda i: prefill(ctx)),
                      ("decode", lambda i: decode(ctx + chunk + 1 + i))):
        sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
        # wall time a step without the profiler, whose host-side cost
        # inflates a short (graphed) step's wall
        sync()
        t0 = time.perf_counter()
        for i in range(steps):
            fn(i)
        sync()
        bare_us = (time.perf_counter() - t0) * 1e6
        for _ in range(PROFILE_TRIES):
            sync()
            with moe_ranges(), dense_ranges(), \
                    profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for i in range(steps):
                    fn(i)
                sync()
                wall_us = (time.perf_counter() - t0) * 1e6
            if device != "cuda" or any(
                    ev.device_type == torch.autograd.DeviceType.CUDA
                    for ev in prof.events()):
                break
        dev = {}
        for ev in prof.events():
            # the ranges also show on the device timeline, as spans over
            # their kernels: they are not kernels
            if ev.device_type == torch.autograd.DeviceType.CUDA and \
                    ev.name not in ("moe", "attention", "scan"):
                cls = _kernel_class(ev.name)
                dev[cls] = dev.get(cls, 0.0) + ev.time_range.elapsed_us()
        busy = sum(dev.values())
        experts = ""
        if cfg.moe_experts and device == "cuda" and not eng.graphs:
            inside = _range_kernels(prof, "moe")
            mm = sum(k.duration for k in inside
                     if _kernel_class(k.name) == "matmul")
            moe = sum(k.duration for k in inside) - mm
            if not inside:
                raise RuntimeError("the profiler tied no kernel to the MoE "
                                   "layers' ranges")
            dev["other"] = dev.get("other", 0.0) - moe
            dev["moe"] = moe
            experts = (f"; of matmul, the expert products "
                       f"{mm / steps / 1e3:.3f}")
        if not eng.paged and device == "cuda" and not eng.graphs:
            for cls in ("attention", "scan"):
                for k in _range_kernels(prof, cls):
                    dev[_kernel_class(k.name)] -= k.duration
                    dev[cls] = dev.get(cls, 0.0) + k.duration
        parts = ", ".join(f"{k} {v / steps / 1e3:.3f}" for k, v in
                          sorted(dev.items(), key=lambda kv: -kv[1]))
        log(f"[profile] {cfg.name} {label} step, {mode} (B={n_slots}, "
            f"{'T=' + str(chunk) if label == 'prefill' else 'T=1'}, "
            f"context {ctx}): wall {bare_us / steps / 1e3:.3f} ms (under the "
            f"profiler {wall_us / steps / 1e3:.3f}); device ms by kernel "
            f"class: {parts or 'none recorded'}{experts}; idle share "
            f"{1 - busy / bare_us:.3f} of the wall without the profiler "
            f"({1 - busy / wall_us:.3f} under it); card {card}")
        host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        log(f"[profile] {cfg.name} {label} step, {mode}, host ops by self "
            f"CPU time "
            f"a step: " + ", ".join(
                f"{e.key} {e.self_cpu_time_total / steps / 1e3:.2f} ms "
                f"({e.count // steps} calls)" for e in host[:8]))
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
    t_start = time.monotonic()
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
    times, moe_times, train_times, phi4_times = {}, {}, {}, {}
    prefill_rows = {}
    if "kernels" in phases:
        errs = run_kernel_checks(args.seed)
        run_packed_checks(args.seed)
        times, moe_times, train_times, phi4_times = (
            time_kernels(args.seed, path, **layout)
            for path, layout in TIMED_PATHS.items())
        for label, H, KV, hd, dt in PREFILL_ROWS:
            prefill_rows[label] = time_kernels(
                args.seed, label, H, KV, quant=False, hd=hd, dtype=dt,
                decode=False)["chunked_prefill_attention"]
            torch.cuda.empty_cache()
        prefill_rows["hd 32, scaled bf16 pool (mma_sync)"] = \
            time_hd32_bodies(args.seed)
        torch.cuda.empty_cache()
    if "model" in phases:
        run_model_check(args.seed)
    if "graphs" in phases:
        run_graphs(args.seed, card)
    launches = {}             # serving path -> kernel -> launches
    serve_peak = None
    if "serve" in phases:
        launches["qwen2.5-14b"], serve_peak = run_serve(args.seed, card,
                                                        decode_timing=True)
        gc.collect()     # the sessions' reference cycles hold the weights
        torch.cuda.empty_cache()
    nemotron_times = {}
    if "nemotron" in phases:
        nem_errs, nemotron_times, launches[NEMOTRON_PATH] = run_nemotron(
            args.seed, card)
        errs = {k: max(errs.get(k, 0.0), e) for k, e in nem_errs.items()}
    moe = None
    if "moe" in phases:
        run_moe_layer_check(args.seed)
        run_moe_model_check(args.seed)
        launches[MOE_PATH], *moe = run_moe_serve(args.seed, card)
        gc.collect()
        torch.cuda.empty_cache()
    if "http" in phases:
        if moe is None:       # http alone: build the MoE weights for it
            from repro_torch.configs import get_config
            from repro_torch.models.model import init_params
            cfg = get_config(MOE_PATH)
            moe = [cfg, init_params(cfg, torch.Generator(device="cuda")
                                    .manual_seed(args.seed), device="cuda"),
                   4096]
        run_http(args.seed, *moe)
    moe = None
    gc.collect()
    torch.cuda.empty_cache()
    tp_times = {}
    if "tp" in phases:
        tp_launches, tp_times, tp_errs = run_tp(args.seed, card, serve_peak)
        launches.update(tp_launches)
        errs = {k: max(errs.get(k, 0.0), e) for k, e in tp_errs.items()}
    if "launch" in phases:
        launches[PHI4_SMOKE_PATH] = run_launch()
    if "dense" in phases:
        run_dense(args.seed, card)
        gc.collect()
        torch.cuda.empty_cache()
    if "train" in phases:
        launches[TRAIN_PATH] = run_train(args.seed, card)
        gc.collect()
        torch.cuda.empty_cache()
    if "dryrun" in phases:
        run_dryrun(args.seed, card)
        gc.collect()
        torch.cuda.empty_cache()
    if "examples" in phases:
        launches.update(run_examples(card))
        gc.collect()
        torch.cuda.empty_cache()
    if "tf32_one_pass" in phases:
        run_tf32_one_pass(args.seed)
    if "packed" in phases:
        run_packed(args.seed, card)
    if "profile" in phases:
        from repro_torch.configs import get_config
        for name in ("qwen2.5-14b", MOE_PATH) + DENSE_PATHS:
            for graphs in (False, True):
                run_profile(args.seed, card, cfg=get_config(name),
                            graphs=graphs)
                gc.collect()
                torch.cuda.empty_cache()

    # times at the Qwen2.5-14B shapes (the first path; PERF.md's earlier
    # rows), launches of every serving path run, max error over both
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
            "launches": {path: n[name] for path, n in launches.items()},
            "max_abs_err": errs.get(name),
            "ms": t.get("ms"), "device_ms": t.get("device_ms"),
            "timed_by": t.get("timed_by"),
            "plain_ms": t.get("plain_ms"),
            "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
            "library_ms": t.get("library_ms"),
            "library_device_ms": t.get("library_device_ms"),
            # the same times at the Qwen3-30B-A3B, Phi-4-mini,
            # Nemotron-4-340B (hd 192) and phi4-mini smoke (hd 40, f32)
            # shapes, and at the shards' shapes of the TP=2 and EP=2
            # instances
            MOE_PATH: moe_times.get(name),
            TRAIN_PATH: train_times.get(name),
            NEMOTRON_PATH: nemotron_times.get(name),
            PHI4_SMOKE_PATH: phi4_times.get(name),
            **{path: t.get(name) for path, t in tp_times.items()},
            # prefill alone at the head dims of PREFILL_ROWS
            **(prefill_rows if name == KERNELS[1] else {})})
    log(f"[total] phases {','.join(phases)} passed in "
        f"{time.monotonic() - t_start:.1f} s wall, the build included")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
