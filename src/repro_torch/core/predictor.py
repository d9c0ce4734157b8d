"""Execution predictor inside the global scheduler (paper §4.1).

The paper replays each instance's queue as *virtual batches* under the
same admission rules as the runtime (FCFS, per-pass prefill token budget,
every active request advances >=1 token per pass).  We implement that
replay in closed form: between decode start/finish events the batch
composition is constant, so each "epoch" contributes

    n_passes * latency(prefill_share, dnum, avg_ctx)

without iterating pass by pass.  A probe is O(n log n) in queued
micro-requests — microseconds in practice, matching the paper's "a few
microseconds per probe" budget.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

from repro_torch.core.costmodel import BatchCostModel, WorkItem


@dataclasses.dataclass
class QueuedWork:
    """A micro-request queued on an instance, as the predictor sees it."""
    rid: str
    prefill_remaining: int
    decode_remaining: int
    ctx: int                     # context length at its first decode step
    ready: float = 0.0           # earliest start (KV handoff dependency)


class ExecutionPredictor:
    def __init__(self, cost: BatchCostModel, slo: float = 0.100):
        self.cost = cost
        self.slo = slo

    # ------------------------------------------------------------------
    def drain_time(self, queue: Sequence[QueuedWork], now: float = 0.0,
                   slo: Optional[float] = None,
                   cost: Optional[BatchCostModel] = None) -> float:
        """Predicted time until the instance finishes all queued work.

        ``slo`` overrides the per-pass TBT budget used to size virtual
        batches (the arriving request's SLO class, when it has one).
        ``cost`` overrides the cost model — probes of a sharded (TP>1)
        instance price its batches with that instance's model.
        """
        if not queue:
            return 0.0
        cost = cost if cost is not None else self.cost
        # Per-pass prefill budget under the local scheduler's SLO control.
        # dnum varies over the drain; use the average active decode count
        # to pick a representative budget (the local scheduler re-tunes it
        # every batch anyway).
        total_prefill = sum(q.prefill_remaining for q in queue)
        avg_ctx = sum(q.ctx for q in queue) / len(queue)

        # decode start pass of each request (FCFS prefill drain at M/pass)
        n = len(queue)
        budget_slo = slo if slo is not None else self.slo
        M = max(1, cost.max_prefill_tokens(budget_slo, min(n, 8),
                                           int(avg_ctx)))
        starts: List[int] = []
        cum = 0
        for q in queue:
            cum += q.prefill_remaining
            starts.append(math.ceil(cum / M) if q.prefill_remaining else 0)
        ends = [s + q.decode_remaining for s, q in zip(starts, queue)]
        prefill_passes = math.ceil(total_prefill / M) if total_prefill else 0

        # epoch sweep over event points
        events = sorted(set([0, prefill_passes] + starts + ends))
        t = 0.0
        for lo, hi in zip(events, events[1:]):
            n_pass = hi - lo
            if n_pass <= 0:
                continue
            dnum = sum(1 for s, e in zip(starts, ends) if s <= lo < e)
            mid = (lo + hi) / 2.0
            ctx = avg_ctx + mid          # decode ctx grows ~1/pass
            plen = M if lo < prefill_passes else 0
            lat = cost.mixed_batch_latency(plen, int(avg_ctx), dnum, int(ctx))
            t += n_pass * lat
        # trailing epoch: if all passes were consumed by events, done;
        # otherwise everything ended at the last event.
        return t

    def completion_time(self, queue: Sequence[QueuedWork],
                        new: Optional[QueuedWork] = None,
                        now: float = 0.0,
                        slo: Optional[float] = None,
                        cost: Optional[BatchCostModel] = None) -> float:
        q = list(queue)
        if new is not None:
            q.append(new)
        return self.drain_time(q, now, slo=slo, cost=cost)
