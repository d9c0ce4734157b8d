"""Analytic per-batch cost model.

Used by three consumers with one implementation:
  * the global scheduler's execution predictor (paper §4.1),
  * the local scheduler's prefill-budget computation (paper §4.2, seeding
    the profile table the way the paper's offline profiling does),
  * the discrete-event cluster simulator (repro_torch.sim) that reproduces the
    paper's figures on this GPU-less container.

Latency of a mixed batch is the roofline max of its compute and memory
terms plus a fixed launch overhead:

    t = max(flops / (peak_flops * mfu_cap), bytes / (hbm_bw * bw_eff)) + c0

which reproduces the paper's Table 1/Figure 6 behaviour: decode-only
batches are memory-bound (weights re-read per pass), prefill chunks are
compute-bound (5.7e13 FLOPs for a 2048-token chunk of a 14B model ->
~350 ms on A100, exactly the paper's colocation P99-TBT violation).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float           # dense bf16 FLOP/s per instance
    hbm_bw: float               # bytes/s
    link_bw: float              # bytes/s inter-instance (RDMA NIC / ICI)
    mfu_cap: float = 0.52       # achievable fraction of peak on prefill
    bw_eff: float = 0.80        # achievable fraction of HBM bandwidth
    batch_overhead: float = 2.0e-3   # per-iteration launch/schedule cost (s)


A100 = HardwareSpec("A100-80G", peak_flops=312e12, hbm_bw=2.039e12,
                    link_bw=100e9)       # 4x200 Gbps ConnectX-6 RoCE
TPU_V5E = HardwareSpec("TPU-v5e", peak_flops=197e12, hbm_bw=819e9,
                       link_bw=50e9)


@dataclasses.dataclass(frozen=True)
class WorkItem:
    """One request's contribution to a batch."""
    kind: str        # "prefill" | "decode"
    tokens: int      # tokens processed this pass (prefill chunk len, or 1)
    ctx: int         # context length those tokens attend to


class BatchCostModel:
    def __init__(self, cfg: ModelConfig, hw: HardwareSpec,
                 tp_degree: int = 1, dtype_bytes: int = 2):
        self.cfg = cfg
        self.hw = hw
        self.tp = tp_degree
        self.dtype_bytes = dtype_bytes
        self.n_params = cfg.param_count()
        self.n_active = cfg.active_param_count()
        self.weight_bytes = self.n_params * dtype_bytes
        # per-layer attention coefficients
        attn_layers = sum(
            1 for i in range(cfg.n_layers)
            if cfg.layer_pattern[i % cfg.pattern_len] in ("attn", "local_attn"))
        self.attn_layers = attn_layers
        qdim = cfg.n_heads * cfg.hd
        # QK^T + PV: 2 * 2 * qdim FLOPs per (token, ctx position)
        self.attn_flops_coef = 4 * qdim * attn_layers
        # KV bytes read per context token (all attention layers)
        self.kv_bytes_per_tok = 2 * cfg.n_kv_heads * cfg.hd * dtype_bytes * attn_layers
        # recurrent layers contribute constant per-token state traffic
        rec_layers = cfg.n_layers - attn_layers
        if cfg.layer_pattern and "ssd" in cfg.layer_pattern:
            self.state_bytes = rec_layers * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
        elif cfg.layer_pattern and "rglru" in cfg.layer_pattern:
            self.state_bytes = rec_layers * cfg.lru_dim * 4
        else:
            self.state_bytes = 0
        self._init_tp()

    # ------------------------------------------------------------------
    # tensor-parallel scaling (devices_per_instance > 1)
    # ------------------------------------------------------------------
    def _init_tp(self) -> None:
        """Per-component parallel speedups for a ``tp``-wide instance.

        A uniform ``/ tp`` overstates the speedup twice over: dims the
        width does not divide are *replicated* (GQA kv_heads, odd expert
        counts) and do no less work per device, and the two per-layer
        allreduces (attention-out, MLP-out) add link-bound time that
        grows with width.  ``achieved_parallelism`` supplies the real
        per-dim degrees; an Amdahl (harmonic) mean over the parameter
        shares turns them into effective flops/bytes speedups; the
        collective term is priced per batch token at ``link_bw``.

        Everything reduces to exactly the legacy arithmetic at tp=1
        (speedups 1.0, collective 0.0), keeping sim/engine decision
        streams byte-identical for single-device pools.
        """
        cfg, tp = self.cfg, self.tp
        if tp <= 1:
            self.parallelism = None
            self.coll_bytes_per_tok = 0.0
            self.coll_s_per_tok = 0.0
            self.flops_speedup = 1.0
            self.bytes_speedup = 1.0
            self.attn_tp = 1
            self.kv_tp = 1
            return
        from repro_torch.utils.sharding import achieved_parallelism
        ap = achieved_parallelism(cfg, tp)
        self.parallelism = ap
        self.attn_tp = ap.heads
        self.kv_tp = ap.kv_heads
        mlp_tp = ap.experts if ap.experts > 1 else ap.ffn
        dm, hd = cfg.d_model, cfg.hd
        # parameter-share decomposition (matmul flops track param reads,
        # so one set of shares serves both roofline sides)
        attn_q = self.attn_layers * 2 * dm * cfg.n_heads * hd    # wq + wo
        attn_kv = self.attn_layers * 2 * dm * cfg.n_kv_heads * hd

        def amdahl(total: float) -> float:
            sharded = attn_q + attn_kv
            mlp = max(0.0, float(total) - sharded
                      - cfg.vocab_size * dm)   # embed (+tied lm_head) rest
            rest = max(0.0, float(total) - sharded - mlp)
            t = (attn_q / ap.heads + attn_kv / ap.kv_heads
                 + mlp / mlp_tp + rest)
            return total / t if t > 0 else 1.0

        self.flops_speedup = amdahl(self.n_active)
        self.bytes_speedup = amdahl(self.n_params)
        # ring allreduce after every attention-out and MLP-out projection:
        # each moves 2*(tp-1)/tp * d_model activation bytes per token
        self.coll_bytes_per_tok = (cfg.n_layers * 2 * 2.0 * (tp - 1) / tp
                                   * dm * self.dtype_bytes)
        self.coll_s_per_tok = self.coll_bytes_per_tok / self.hw.link_bw

    # ------------------------------------------------------------------
    def effective_ctx(self, ctx: int) -> int:
        """Sliding-window archs cap attention context at the window."""
        w = self.cfg.window
        if w and all(k in ("local_attn", "ssd", "rglru")
                     for k in self.cfg.layer_pattern):
            return min(ctx, w)
        return ctx

    def flops(self, items: Sequence[WorkItem]) -> float:
        f = 0.0
        for it in items:
            f += 2.0 * self.n_active * it.tokens
            if it.kind == "prefill":
                # chunk attends to ctx + its own triangular half
                eff = self.effective_ctx(it.ctx)
                f += self.attn_flops_coef * (it.tokens * eff + it.tokens * it.tokens / 2.0)
            else:
                f += self.attn_flops_coef * it.tokens * self.effective_ctx(it.ctx)
        return f

    def bytes_moved(self, items: Sequence[WorkItem]) -> float:
        b = float(self.weight_bytes)
        for it in items:
            if it.kind == "decode":
                b += self.kv_bytes_per_tok * self.effective_ctx(it.ctx) + self.state_bytes
            else:
                # prefill streams its own growing KV once
                eff = self.effective_ctx(it.ctx + it.tokens)
                b += self.kv_bytes_per_tok * eff
        return b

    def _flops_split(self, items: Sequence[WorkItem]) -> Tuple[float, float]:
        """(dense matmul flops, attention-score flops) — the two scale
        by different achieved TP degrees."""
        dense = attn = 0.0
        for it in items:
            dense += 2.0 * self.n_active * it.tokens
            if it.kind == "prefill":
                eff = self.effective_ctx(it.ctx)
                attn += self.attn_flops_coef * (it.tokens * eff
                                                + it.tokens * it.tokens / 2.0)
            else:
                attn += self.attn_flops_coef * it.tokens * self.effective_ctx(it.ctx)
        return dense, attn

    def _kv_state_bytes(self, items: Sequence[WorkItem]) -> Tuple[float, float]:
        kv = st = 0.0
        for it in items:
            if it.kind == "decode":
                kv += self.kv_bytes_per_tok * self.effective_ctx(it.ctx)
                st += self.state_bytes
            else:
                kv += self.kv_bytes_per_tok * self.effective_ctx(it.ctx + it.tokens)
        return kv, st

    def collective_time(self, items: Sequence[WorkItem]) -> float:
        """Link-bound allreduce time for one forward over ``items``."""
        if self.coll_s_per_tok == 0.0:
            return 0.0
        return self.coll_s_per_tok * sum(it.tokens for it in items)

    def latency(self, items: Sequence[WorkItem]) -> float:
        if not items:
            return 0.0
        if self.tp <= 1:
            t_c = self.flops(items) / (self.hw.peak_flops * self.hw.mfu_cap * self.tp)
            t_m = self.bytes_moved(items) / (self.hw.hbm_bw * self.hw.bw_eff * self.tp)
            return max(t_c, t_m) + self.hw.batch_overhead
        dense_f, attn_f = self._flops_split(items)
        t_c = (dense_f / self.flops_speedup + attn_f / self.attn_tp) \
            / (self.hw.peak_flops * self.hw.mfu_cap)
        kv_b, st_b = self._kv_state_bytes(items)
        t_m = (self.weight_bytes / self.bytes_speedup
               + kv_b / self.kv_tp + st_b) \
            / (self.hw.hbm_bw * self.hw.bw_eff)
        return max(t_c, t_m) + self.collective_time(items) \
            + self.hw.batch_overhead

    # convenience for the schedulers ------------------------------------
    def decode_batch_latency(self, dnum: int, ctx: int) -> float:
        return self.latency([WorkItem("decode", 1, ctx)] * dnum)

    def mixed_batch_latency(self, plen: int, p_ctx: int, dnum: int,
                            d_ctx: int) -> float:
        items: List[WorkItem] = []
        if plen:
            items.append(WorkItem("prefill", plen, p_ctx))
        items.extend([WorkItem("decode", 1, d_ctx)] * dnum)
        return self.latency(items)

    def max_prefill_tokens(self, slo: float, dnum: int, d_ctx: int,
                           p_ctx: int = 0) -> int:
        """Largest prefill chunk that keeps the mixed batch under ``slo``
        (closed-form inversion of the roofline; Algorithm 2's budget M)."""
        budget = slo - self.hw.batch_overhead
        if budget <= 0:
            return 0
        if self.tp > 1:
            return self._max_prefill_tokens_tp(budget, dnum, d_ctx, p_ctx)
        # memory side barely depends on plen; if decode alone busts the
        # budget there is no room for prefill at all
        base_mem = self.bytes_moved([WorkItem("decode", 1, d_ctx)] * dnum)
        t_mem = base_mem / (self.hw.hbm_bw * self.hw.bw_eff * self.tp)
        if t_mem > budget:
            return 0
        decode_flops = self.flops([WorkItem("decode", 1, d_ctx)] * dnum)
        flops_budget = budget * self.hw.peak_flops * self.hw.mfu_cap * self.tp - decode_flops
        if flops_budget <= 0:
            return 0
        # solve attn_coef/2 * m^2 + (2*N_active + attn_coef*ctx) * m = flops_budget
        a = self.attn_flops_coef / 2.0
        bq = 2.0 * self.n_active + self.attn_flops_coef * self.effective_ctx(p_ctx)
        if a <= 0:
            m = flops_budget / bq
        else:
            m = (-bq + (bq * bq + 4 * a * flops_budget) ** 0.5) / (2 * a)
        return max(0, int(m))

    def _max_prefill_tokens_tp(self, budget: float, dnum: int, d_ctx: int,
                               p_ctx: int) -> int:
        """TP>1 budget inversion, in *time* units: the compute side scales
        per component and every batch token pays the collective tax, so
        the quadratic is solved on seconds instead of flops."""
        decs = [WorkItem("decode", 1, d_ctx)] * dnum
        F = self.hw.peak_flops * self.hw.mfu_cap
        kv_b, st_b = self._kv_state_bytes(decs)
        t_mem = (self.weight_bytes / self.bytes_speedup
                 + kv_b / self.kv_tp + st_b) \
            / (self.hw.hbm_bw * self.hw.bw_eff)
        if t_mem > budget:
            return 0
        dense_f, attn_f = self._flops_split(decs)
        t_dec = (dense_f / self.flops_speedup + attn_f / self.attn_tp) / F
        avail = budget - t_dec - self.coll_s_per_tok * dnum
        if avail <= 0:
            return 0
        # seconds(m) = a*m^2 + b*m with the collective folded into b
        a = self.attn_flops_coef / (2.0 * self.attn_tp * F)
        b = (2.0 * self.n_active / self.flops_speedup
             + self.attn_flops_coef * self.effective_ctx(p_ctx) / self.attn_tp) \
            / F + self.coll_s_per_tok
        if a <= 0:
            m = avail / b
        else:
            m = (-b + (b * b + 4 * a * avail) ** 0.5) / (2 * a)
        return max(0, int(m))

    # transfer ----------------------------------------------------------
    def kv_bytes_per_tok_at(self, precision=None) -> float:
        """Per-context-token KV bytes when the cache stores ``precision``
        (None/bf16 -> the model-dtype figure).  Quantized formats ship
        1-byte codes plus k+v per-token f32 dequant scales per attention
        layer, which is what shrinks handoff streams and page HBM."""
        from repro_torch.core.precision import get_precision
        prec = get_precision(precision)
        if not prec.quantized:
            return self.kv_bytes_per_tok
        cfg = self.cfg
        per_layer = 2 * cfg.n_kv_heads * cfg.hd * prec.itemsize + 2 * 4
        return per_layer * self.attn_layers

    def kv_transfer_bytes(self, n_tokens: int, precision=None) -> float:
        """Bytes of KV/state shipped for a handoff covering ``n_tokens``."""
        eff = self.effective_ctx(n_tokens)
        return self.kv_bytes_per_tok_at(precision) * eff + self.state_bytes

    def kv_transfer_time(self, n_tokens: int, precision=None) -> float:
        return self.kv_transfer_bytes(n_tokens, precision) / self.hw.link_bw
