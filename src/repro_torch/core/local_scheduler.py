"""Local scheduler (paper Algorithm 2): SLO-aware batch composition.

Per executed batch the scheduler RECORDs (plen, ctx, dnum, time) into a
profile table; before composing the next batch it (1) admits every decode
request (latency-critical), (2) consults the table (falling back to the
analytic cost model exactly like the paper seeds its table from offline
profiling) for the max prefill budget M that keeps predicted latency
under the TBT SLO, and (3) greedily fills M from the prefill queue in
arrival order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.costmodel import BatchCostModel
from repro_torch.core.paging import pages_for


def _bucket(x: int, base: int = 2) -> int:
    """Geometric bucketing so the table generalizes across nearby shapes."""
    if x <= 0:
        return 0
    return 1 << max(0, int(math.log2(max(1, x)) + 0.5))


class ProfileTable:
    """(plen, ctx, dnum) -> EWMA latency, refined with execution feedback."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self.table: Dict[Tuple[int, int, int], float] = {}
        self.records = 0

    def key(self, plen: int, ctx: int, dnum: int):
        return (_bucket(plen), _bucket(ctx), _bucket(dnum))

    def record(self, plen: int, ctx: int, dnum: int, time: float) -> None:
        k = self.key(plen, ctx, dnum)
        if k in self.table:
            self.table[k] = (1 - self.alpha) * self.table[k] + self.alpha * time
        else:
            self.table[k] = time
        self.records += 1

    def lookup(self, plen: int, ctx: int, dnum: int) -> Optional[float]:
        return self.table.get(self.key(plen, ctx, dnum))


@dataclasses.dataclass
class PrefillWork:
    """A queued micro-request's outstanding prefill."""
    rid: str
    remaining: int              # prefill tokens left
    ctx: int                    # tokens already cached (position of chunk)
    deadline: Optional[float] = None  # TTFT deadline (arrival + SLO ttft)
    # Leading tokens of ``remaining`` resident in the instance's
    # shared-prefix KV cache: they cost no compute (the pages are
    # spliced, not prefilled), so the scheduler grants them without
    # consuming the SLO prefill budget M or any free page.
    cached: int = 0


@dataclasses.dataclass
class DecodeWork:
    rid: str
    ctx: int                    # current context length
    tbt: Optional[float] = None  # owning request's SLO-class TBT target


@dataclasses.dataclass
class BatchPlan:
    decodes: List[DecodeWork]
    prefills: List[Tuple[PrefillWork, int]]   # (work, granted tokens)
    predicted_latency: float
    # work was deferred because the KV page pool could not hold its
    # growth — the session defers (pages free as requests finish) or
    # preempts a victim's cache instead of letting the engine overflow
    starved: bool = False
    # granted tokens served from the shared-prefix cache (no compute)
    cached_tokens: int = 0
    # decision provenance (flight recorder): the SLO-inverted prefill
    # token budget M this batch was sized under, and the effective TBT
    # window after the pipeline discount
    budget: int = 0
    slo_eff: float = 0.0

    @property
    def prefill_tokens(self) -> int:
        return sum(g for _, g in self.prefills)

    @property
    def computed_prefill_tokens(self) -> int:
        """Prefill tokens that actually run through the model."""
        return self.prefill_tokens - self.cached_tokens

    @property
    def dnum(self) -> int:
        return len(self.decodes)


class LocalScheduler:
    def __init__(self, cost: BatchCostModel, slo: float = 0.100,
                 max_batch_requests: int = 256,
                 min_chunk: int = 16, slo_aware: bool = True,
                 static_chunk: Optional[int] = None,
                 slo_margin: float = 0.88):
        """``slo_aware=False`` + ``static_chunk`` reproduces the vLLM
        chunked-prefill baseline (fixed chunk regardless of load).
        ``slo_margin`` keeps planned batches below the SLO with headroom
        so jitter/bucketing cannot push the p99 over."""
        self.cost = cost
        self.slo = slo
        self.profile = ProfileTable()
        self.max_batch_requests = max_batch_requests
        self.min_chunk = min_chunk
        self.slo_aware = slo_aware
        self.static_chunk = static_chunk
        self.slo_margin = slo_margin
        # Elastic role bias in [-1, 1] set by the pool controller:
        # +1 = prefill-heavy (2x the prefill budget — few decodes are
        # running, so TBT headroom is traded for prefill throughput),
        # -1 = decode-heavy (half the budget, protecting the TBT stream).
        self.role_bias = 0.0

    def set_role_bias(self, bias: float) -> None:
        self.role_bias = max(-1.0, min(1.0, bias))

    # ---------------- Algorithm 2 ----------------
    def record(self, plan: BatchPlan, measured: float) -> None:
        ctx = int(sum(d.ctx for d in plan.decodes) / max(1, plan.dnum))
        self.profile.record(plan.computed_prefill_tokens, ctx, plan.dnum,
                            measured)

    def effective_slo(self, decodes: Sequence[DecodeWork]) -> float:
        """TBT budget for one batch: the tightest SLO-class target among
        the co-batched decode streams (every decode in the batch pays
        the full batch latency), falling back to the instance default
        for unclassed work or prefill-only batches."""
        targets = [d.tbt if d.tbt is not None else self.slo for d in decodes]
        if not targets:
            return self.slo
        return min(targets)

    def max_prefill_allowed(self, ctx: int, dnum: int, p_ctx: int = 0,
                            slo: Optional[float] = None) -> int:
        if not self.slo_aware:
            return self._biased(self.static_chunk or 2048)
        slo = (slo if slo is not None else self.slo) * self.slo_margin
        # profile-table refinement: probe geometric plen candidates and
        # take the largest whose recorded latency fits the SLO; fall back
        # to the analytic inversion where the table is cold.
        analytic = self.cost.max_prefill_tokens(slo, dnum, ctx, p_ctx=p_ctx)
        best = None
        plen = 1
        while plen <= 1 << 20:
            t = self.profile.lookup(plen, ctx, dnum)
            if t is not None and t <= slo:
                best = plen if best is None else max(best, plen)
            plen <<= 1
        out = analytic if best is None else \
            int(min(max(best, analytic / 2), analytic * 2))
        # role bias trades TBT headroom for prefill throughput, but the
        # "never stray more than 2x from the model" bound still holds
        # in both directions
        return int(min(max(self._biased(out), analytic / 2), 2 * analytic))

    def _biased(self, budget: int) -> int:
        if not self.role_bias:
            return budget
        return max(0, int(budget * 2.0 ** self.role_bias))

    def next_batch(self, prefill_queue: Sequence[PrefillWork],
                   decode_queue: Sequence[DecodeWork],
                   free_pages: Optional[int] = None,
                   page_size: Optional[int] = None,
                   n_inflight: int = 0,
                   inflight_latency: float = 0.0,
                   free_frames: Optional[int] = None,
                   frames_of=None) -> BatchPlan:
        """Compose one unified batch.

        With ``free_pages``/``page_size`` (a paged-KV backend) the batch
        is additionally sized against the free page pool: every decode
        that would cross a page boundary reserves a page, every prefill
        grant is capped to the pages left.  Work that does not fit is
        *deferred* (it stays queued; ``plan.starved`` tells the session)
        rather than overflowing the pool mid-batch.

        Under mixed-precision KV the pool is denominated in *frames*
        (one frame = one 1-byte-itemsize page; a bf16 page costs 2, a
        quantized page 1): pass ``free_frames`` plus ``frames_of`` (rid
        -> frames one of that request's pages costs) and the same
        boundary/cap logic charges per-request frame prices, so
        quantized streams stretch the pool 2x.  Without them the page
        path is the frames path at uniform price 1 — identical plans.

        ``n_inflight``/``inflight_latency`` describe batches already
        dispatched ahead (pipelined execution): the device serializes
        them before this batch, so every decode stream's TBT spans the
        in-flight batch PLUS this one.  The SLO inversion for the
        prefill budget M therefore (a) counts the in-flight decode
        streams as co-running and (b) sizes M against the SLO window
        *left over* after the in-flight work drains — without this, a
        pipelined prefill-heavy batch behind a decode batch would pay
        two full SLO budgets per token.  Defaults (0, 0.0 — the
        synchronous loop) keep the original budget.
        """
        mem_aware = (free_frames is not None or free_pages is not None) \
            and bool(page_size)
        if frames_of is None:
            frames_of = lambda rid: 1  # noqa: E731 — uniform page price
        starved = False
        decodes: List[DecodeWork] = []
        budget_frames = (free_frames if free_frames is not None
                         else free_pages) if mem_aware else 0
        for d in decode_queue[: self.max_batch_requests]:
            if mem_aware:
                # appending this stream's next token needs a fresh page
                # exactly when its context fills the current one
                need = frames_of(d.rid) if d.ctx % page_size == 0 else 0
                if need > budget_frames:
                    starved = True
                    continue
                budget_frames -= need
            decodes.append(d)
        d_ctx = int(sum(d.ctx for d in decodes) / max(1, len(decodes)))
        p_ctx = max((w.ctx for w in prefill_queue), default=0)
        slo_eff = self.effective_slo(decodes)
        if inflight_latency > 0.0:
            # leave at least a sliver of budget so prefill cannot starve
            # forever behind a permanently-full pipeline
            slo_eff = max(slo_eff * 0.25, slo_eff - inflight_latency)
        M = self.max_prefill_allowed(d_ctx, len(decodes) + n_inflight,
                                     p_ctx=p_ctx, slo=slo_eff)
        grants: List[Tuple[PrefillWork, int]] = []
        budget = M
        # earliest-TTFT-deadline first; unclassed work keeps FCFS order
        # (stable sort, None sorts last at equal arrival position)
        if any(w.deadline is not None for w in prefill_queue):
            prefill_queue = sorted(
                prefill_queue,
                key=lambda w: w.deadline if w.deadline is not None
                else float("inf"))
        cached_total = 0
        for w in prefill_queue:
            if budget <= 0 or len(decodes) + len(grants) >= self.max_batch_requests:
                break
            # the cached head rides for free: its pages are spliced from
            # the prefix cache, so it consumes neither the SLO budget M
            # nor a free page — only the tail past it is "paid" work
            free_head = max(0, min(w.cached, w.remaining))
            paid = min(w.remaining - free_head, budget)
            g = free_head + paid
            if mem_aware:
                fw = frames_of(w.rid)
                slack = pages_for(w.ctx + free_head, page_size) * \
                    page_size - (w.ctx + free_head)
                g_mem = free_head + slack + \
                    (budget_frames // fw) * page_size
                if g > g_mem:
                    g = g_mem
                    starved = True
            if g <= 0:
                continue
            # avoid degenerate 1-token prefill slivers unless finishing
            if g - free_head < min(self.min_chunk,
                                   w.remaining - free_head):
                break
            if mem_aware:
                budget_frames -= (pages_for(w.ctx + g, page_size) -
                                  pages_for(w.ctx + free_head,
                                            page_size)) * fw
            grants.append((w, g))
            cached_total += min(free_head, g)
            budget -= max(0, g - free_head)
        plen = sum(g for _, g in grants) - cached_total
        p_ctx = grants[0][0].ctx if grants else 0
        lat = self.cost.mixed_batch_latency(plen, p_ctx, len(decodes), d_ctx)
        return BatchPlan(decodes, grants, lat, starved=starved,
                         cached_tokens=cached_total, budget=M,
                         slo_eff=slo_eff)
