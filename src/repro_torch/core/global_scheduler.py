"""Global scheduler (paper Algorithm 1).

Per arriving request: bounded binary search (K probes) over the partition
ratio phi, driving the predicted completion times of the alpha and beta
instances to equality; then commit the two micro-requests.  Cold start
(idle cluster) takes the PD-disaggregation split phi = P/L directly.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.core.costmodel import BatchCostModel
from repro_torch.core.predictor import ExecutionPredictor, QueuedWork
from repro_torch.core.request import MicroRequest, Request, split_request


@dataclasses.dataclass
class InstanceView:
    """What the global scheduler knows about one unified instance.

    ``draining`` members accept no new placements (the elastic pool is
    retiring them); ``role_bias`` is the pool controller's drift in
    [-1, 1] (+ = prefill-heavy, - = decode-heavy) used to steer alpha
    micro-requests toward prefill-leaning instances and beta
    micro-requests toward decode-leaning ones.  ``cached_prefix`` is
    the arriving request's prompt prefix already resident in this
    instance's shared-prefix KV cache (tokens, page-aligned): the
    scheduler scores placements and split points on *effective*
    (post-hit) prefill work, so a long cached prefix pulls the request
    toward the instance that holds it and pushes the split point
    earlier (less real prefill to balance against the decode side).
    """
    iid: int
    queue: List[QueuedWork]
    draining: bool = False
    role_bias: float = 0.0
    cached_prefix: int = 0
    # cost model matching the instance's shard width (None = the
    # scheduler-wide model): probes of a TP=n member price its virtual
    # batches with TP=n latencies, so a wide instance correctly looks
    # faster to the binary search than a 1-device one
    cost: Optional[BatchCostModel] = None


@dataclasses.dataclass
class Placement:
    alpha: Optional[MicroRequest]
    beta: Optional[MicroRequest]
    alpha_instance: Optional[int]
    beta_instance: Optional[int]
    phi: float
    predicted_t1: float
    predicted_t2: float
    probes: int
    overhead_s: float
    # Decision provenance for the flight recorder: every (phi, t1, t2)
    # the binary search *considered* (not just the winner), and the
    # per-candidate-instance drain scores pick_pair ranked.  Costless
    # when unobserved: the lists are built during scheduling anyway.
    trials: List[Tuple[float, float, float]] = \
        dataclasses.field(default_factory=list)
    candidates: List[Tuple[int, float]] = \
        dataclasses.field(default_factory=list)


class GlobalScheduler:
    def __init__(self, cost: BatchCostModel, slo: float = 0.100,
                 max_probes: int = 6, epsilon: float = 0.015,
                 margin_tokens: int = 20,
                 split_gain_threshold: float = 0.05):
        self.cost = cost
        self.predictor = ExecutionPredictor(cost, slo)
        self.max_probes = max_probes
        self.epsilon = epsilon
        # split only when it beats whole-request placement by this margin
        self.split_gain_threshold = split_gain_threshold
        # paper §5: configurable decode-length margin against
        # underestimation (20 tokens in their setup)
        self.margin_tokens = margin_tokens
        self._rr = 0
        # (iid, biased drain score) per candidate from the last
        # pick_pair call — recorded into Placement.candidates
        self._last_candidates: List[Tuple[int, float]] = []

    # ------------------------------------------------------------------
    def _work_of(self, mr: MicroRequest, ready: float = 0.0,
                 cached: int = 0) -> QueuedWork:
        """``cached`` is the target instance's cached-prefix length for
        this request: the overlap with the micro's prompt span is
        spliced, not prefilled, so the predictor only sees the
        effective (post-hit) prefill work."""
        hit = max(0, min(cached - mr.start, mr.prefill_tokens))
        return QueuedWork(
            rid=mr.rid,
            prefill_remaining=mr.prefill_tokens - hit,
            decode_remaining=mr.decode_tokens,
            ctx=mr.start if mr.role == "beta" else 0,
            ready=ready,
        )

    def pick_pair(self, instances: Sequence[InstanceView]) -> Tuple[int, int]:
        """Round-robin over the unified pool (paper §3.1), tie-broken by
        predicted load so a hot instance is never the alpha target.

        Elastic pools add two refinements: draining instances are never
        picked (unless the whole pool is draining), and role bias steers
        the prefill-dominated alpha toward prefill-leaning instances and
        the decode-dominated beta toward decode-leaning ones.  Returns
        *indices into the sequence*, as before.
        """
        n = len(instances)
        if n == 1:
            self._last_candidates = [(instances[0].iid, 0.0)]
            return 0, 0
        cands = [i for i in range(n) if not instances[i].draining] or \
            list(range(n))
        if len(cands) == 1:
            self._last_candidates = [(instances[cands[0]].iid, 0.0)]
            return cands[0], cands[0]
        dt = {i: self.predictor.drain_time(instances[i].queue,
                                           cost=instances[i].cost)
              for i in cands}
        self._last_candidates = [(instances[i].iid, dt[i]) for i in cands]
        # bias weight relative to typical drain so it reorders only
        # near-ties; the floor keeps it meaningful on an idle pool
        w = 0.25 * (sum(dt.values()) / len(cands)) + 1e-3
        # a cached prefix is prefill work the alpha target simply skips:
        # credit it at the SLO-paced prefill rate so the hit competes
        # with (and usually beats) a slightly shorter queue elsewhere
        saved = {i: 0.0 for i in cands}
        if any(instances[i].cached_prefix for i in cands):
            M = max(1, self.cost.max_prefill_tokens(self.predictor.slo, 0, 0))
            t_tok = self.cost.mixed_batch_latency(M, 0, 0, 0) / M
            saved = {i: instances[i].cached_prefix * t_tok for i in cands}
        rr = self._rr
        self._rr = (self._rr + 1) % n
        ia = min(cands, key=lambda i: (
            dt[i] - w * instances[i].role_bias - saved[i], (i - rr) % n))
        ib = min((i for i in cands if i != ia), key=lambda i: (
            dt[i] + w * instances[i].role_bias, (i - rr) % n))
        return ia, ib

    def schedule(self, r: Request,
                 instances: Sequence[InstanceView]) -> Placement:
        t0 = time.perf_counter()
        D = r.D_pred + self.margin_tokens
        r_eff = dataclasses.replace(r, predicted_decode=D)
        # the request's SLO class (when attached) sizes the predictor's
        # virtual batches instead of the scheduler-wide default budget
        slo = r.slo.tbt if r.slo is not None else None
        ia, ib = self.pick_pair(instances)
        qa, qb = instances[ia].queue, instances[ib].queue
        # cached-prefix lengths on the chosen alpha/beta targets: every
        # probe below scores *effective* prefill (prompt minus hit)
        ca, cb = instances[ia].cached_prefix, instances[ib].cached_prefix
        cost_a, cost_b = instances[ia].cost, instances[ib].cost
        same_instance = ia == ib
        # Placement carries instance *ids*, not view indices, so callers
        # may pass a sparse/filtered view of an elastic pool.
        ia, ib = instances[ia].iid, instances[ib].iid

        # single (non-draining) instance: splitting would hand KV from
        # the instance to itself — run the request whole
        if same_instance:
            whole = MicroRequest(r_eff, "alpha", 0, r_eff.L)
            t1 = self.predictor.completion_time(
                qa, self._work_of(whole, cached=ca), slo=slo, cost=cost_a)
            return Placement(whole, None, ia, None, 1.0, t1, 0.0, 0,
                             time.perf_counter() - t0,
                             trials=[(1.0, t1, 0.0)],
                             candidates=list(self._last_candidates))

        # cold start: both instances idle -> PD-disaggregation split;
        # the completion probes still score effective (post-hit)
        # prefill, and the alpha side — chosen by pick_pair for its
        # cached prefix — is the one that claims the hit, so the split
        # point itself stays at the PD boundary (splitting *earlier*
        # would hand the cached span to the instance that missed)
        if not qa and not qb:
            phi = r_eff.P / r_eff.L
            alpha, beta = split_request(r_eff, phi)
            t1 = self.predictor.completion_time(
                qa, self._work_of(alpha, cached=ca) if alpha else None,
                slo=slo, cost=cost_a)
            t2 = self.predictor.completion_time(
                qb, self._work_of(beta, cached=cb) if beta else None,
                slo=slo, cost=cost_b)
            return Placement(alpha, beta, ia if alpha else None,
                             ib if beta else None, phi, t1, t2, 0,
                             time.perf_counter() - t0,
                             trials=[(phi, t1, t2)],
                             candidates=list(self._last_candidates))

        lo, hi = 0.0, 1.0
        phi = r_eff.P / r_eff.L          # start from PD disaggregation
        best = None
        probes = 0
        trials: List[Tuple[float, float, float]] = []
        for _ in range(self.max_probes):
            probes += 1
            alpha, beta = split_request(r_eff, phi)
            t1 = self.predictor.completion_time(
                qa, self._work_of(alpha, cached=ca) if alpha else None,
                slo=slo, cost=cost_a)
            t2 = self.predictor.completion_time(
                qb, self._work_of(beta, cached=cb) if beta else None,
                slo=slo, cost=cost_b)
            trials.append((phi, t1, t2))
            gap = abs(t1 - t2)
            if best is None or gap < best[0]:
                best = (gap, phi, alpha, beta, t1, t2)
            rel = gap / max(t1, t2, 1e-9)
            if rel <= self.epsilon:
                break
            if t1 < t2:      # alpha side under-loaded -> push split later
                lo = phi
            else:
                hi = phi
            phi = (lo + hi) / 2.0
        _, phi, alpha, beta, t1, t2 = best

        # Paper §3.1: "when the system is underutilized or the prompt is
        # short, APS may avoid partitioning altogether".  Splitting costs
        # a handoff gap in the TBT stream, so take it only when it
        # clearly beats running the request whole on the idler instance.
        whole = MicroRequest(r_eff, "alpha", 0, r_eff.L)
        t_whole = self.predictor.completion_time(
            qa, self._work_of(whole, cached=ca), slo=slo, cost=cost_a)
        trials.append((1.0, t_whole, 0.0))
        if t_whole <= max(t1, t2) * (1.0 + self.split_gain_threshold):
            return Placement(whole, None, ia, None, 1.0, t_whole, 0.0,
                             probes, time.perf_counter() - t0,
                             trials=trials,
                             candidates=list(self._last_candidates))
        return Placement(alpha, beta, ia if alpha else None,
                         ib if beta else None, phi, t1, t2, probes,
                         time.perf_counter() - t0, trials=trials,
                         candidates=list(self._last_candidates))
