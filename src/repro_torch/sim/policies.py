"""Serving policies: the paper's DynaServe plus both baselines.

All three run on the identical simulator/instance substrate; only the
placement + batching strategy differs — mirroring the paper's setup where
all systems are vLLM-based.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.core.costmodel import BatchCostModel
from repro_torch.core.elastic import (
    DrainInstance, ElasticConfig, InstanceStat, MergeInstances, MigrateWork,
    PoolController, ScaleUp, SetRoleBias, SplitInstance,
)
from repro_torch.core.global_scheduler import GlobalScheduler, InstanceView
from repro_torch.core.kv_transfer import monolithic_exposed, plan_chunked_transfer
from repro_torch.core.local_scheduler import LocalScheduler
from repro_torch.core.predictor import QueuedWork
from repro_torch.core.request import MicroRequest, Request, split_request
from repro_torch.core.session import MicroState as SimMicro, queued_view


class BasePolicy:
    last_overhead = 0.0
    # the GlobalScheduler Placement behind the most recent place() call
    # (None for policies/paths that never run Algorithm 1) — the session
    # reads it to record the considered split alternatives and probe
    # scores into the flight-recorder "place" event
    last_placement = None

    def role_of(self, iid: int, n: int) -> str:
        return "unified"

    def make_local_scheduler(self, iid: int, cost: BatchCostModel,
                             slo: float) -> LocalScheduler:
        raise NotImplementedError

    def place(self, r: Request, sim, now: float):
        raise NotImplementedError

    def on_micro_finished(self, m, sim, now: float) -> None:
        pass

    def on_cancel(self, rid: str, sim) -> None:
        """Drop pending-beta registrations of a cancelled (or
        rejected-at-placement) request so no orphaned handoff fires."""
        pending = getattr(self, "_pending_beta", None)
        if pending:
            for key in [k for k in pending if k.startswith(rid + "/")]:
                pending.pop(key, None)

    # helpers ------------------------------------------------------------
    # one QueuedWork projection shared with the session's admission path
    _queued_view = staticmethod(queued_view)


# ==========================================================================
# PD colocation (+ chunked prefill), vLLM default
# ==========================================================================
class ColocationPolicy(BasePolicy):
    def __init__(self, chunk: int = 2048, slo_aware: bool = False):
        self.chunk = chunk
        self.slo_aware = slo_aware
        self._rr = 0

    def make_local_scheduler(self, iid, cost, slo):
        return LocalScheduler(cost, slo, slo_aware=self.slo_aware,
                              static_chunk=self.chunk)

    def place(self, r: Request, sim, now: float):
        iid = self._rr % len(sim.instances)
        self._rr += 1
        mr = MicroRequest(r, "alpha", 0, r.true_L)
        return [(iid, SimMicro(mr, r.P, r.D, 0))]


# ==========================================================================
# PD disaggregation (DistServe/vLLM-disagg style)
# ==========================================================================
class DisaggregationPolicy(BasePolicy):
    """First half of the pool prefills, second half decodes; the full KV
    ships at the PD boundary (monolithic => fully exposed)."""

    def __init__(self, prefill_chunk: int = 8192):
        self.prefill_chunk = prefill_chunk
        self._rr_p = 0
        self._rr_d = 0
        self._pending_beta = {}

    def role_of(self, iid: int, n: int) -> str:
        return "prefill" if iid < n // 2 else "decode"

    def make_local_scheduler(self, iid, cost, slo):
        return LocalScheduler(cost, slo, slo_aware=False,
                              static_chunk=self.prefill_chunk)

    def place(self, r: Request, sim, now: float):
        n = len(sim.instances)
        n_p = max(1, n // 2)
        ip = self._rr_p % n_p
        idd = n_p + (self._rr_d % max(1, n - n_p))
        self._rr_p += 1
        self._rr_d += 1
        alpha, beta = split_request(r, r.P / r.true_L)
        # use TRUE decode length for execution; prediction only guides split
        a = SimMicro(alpha, alpha.prefill_tokens, 0, 0)
        b = SimMicro(beta, 0, r.D, r.P, ready=float("inf"))
        self._pending_beta[alpha.rid] = b
        return [(ip, a), (idd, b)]

    def on_micro_finished(self, m, sim, now: float) -> None:
        b = self._pending_beta.pop(m.rid, None)
        if b is not None:
            prec = sim.backend.request_precision(
                m.iid, getattr(m.mr.parent.slo, "name", None))
            exposed = monolithic_exposed(sim.cost, m.mr.end, precision=prec)
            nbytes = sim.cost.kv_transfer_bytes(m.mr.end, prec)
            sim.release_beta(b, now + exposed, exposed, nbytes, src=m)


# ==========================================================================
# DynaServe (paper)
# ==========================================================================
class DynaServePolicy(BasePolicy):
    def __init__(self, cost: BatchCostModel, slo: float = 0.100,
                 transfer_chunk: int = 512, max_probes: int = 6,
                 slo_aware_batching: bool = True,
                 split_mode: str = "dynamic"):
        """split_mode ablations: "dynamic" = Algorithm 1 binary search
        (the paper); "static" = fixed phi = P/L on unified instances
        (disaggregation-shaped split but elastic placement); "none" =
        never split (colocation-shaped placement with SLO batching)."""
        self.gs = GlobalScheduler(cost, slo, max_probes=max_probes)
        self.transfer_chunk = transfer_chunk
        self.slo_aware_batching = slo_aware_batching
        self.split_mode = split_mode
        self._rr = 0
        self._pending_beta = {}

    def make_local_scheduler(self, iid, cost, slo):
        if self.slo_aware_batching:
            return LocalScheduler(cost, slo, slo_aware=True)
        # ablation arm for Fig 11 (no SLO-aware batching)
        return LocalScheduler(cost, slo, slo_aware=False, static_chunk=2048)

    def _views(self, sim, r: Optional[Request] = None) -> List[InstanceView]:
        """Per-instance views for the global scheduler; with ``r`` they
        carry each instance's cached-prefix length for the request's
        prompt, so Algorithm 1 scores effective (post-hit) prefill."""
        return [InstanceView(i.iid, self._queued_view(i), i.draining,
                             i.role_bias,
                             cached_prefix=(sim.backend.cached_prefix(
                                 i.iid, r) if r is not None else 0),
                             cost=sim.backend.cost_for(i.iid))
                for i in sim.pool_instances()]

    def place(self, r: Request, sim, now: float):
        self.last_placement = None
        if self.split_mode == "none":
            iid = self._rr % len(sim.instances)
            self._rr += 1
            mr = MicroRequest(r, "alpha", 0, r.true_L)
            return [(iid, SimMicro(mr, r.P, r.D, 0))]
        if self.split_mode == "static":
            n = len(sim.instances)
            ia, ib = self._rr % n, (self._rr + 1) % n
            self._rr += 1
            alpha, beta = split_request(r, r.P / r.true_L)
            a = SimMicro(alpha, alpha.prefill_tokens, 0, 0)
            b = SimMicro(beta, 0, r.D, r.P, ready=float("inf"))
            self._pending_beta[alpha.rid] = b
            return [(ia, a), (ib, b)]
        pl = self.gs.schedule(r, self._views(sim, r))
        self.last_overhead = pl.overhead_s
        self.last_placement = pl
        out = []
        # clamp the *executed* token span to the true length (the predictor
        # margin only affects the split decision, not real work)
        true_L = r.true_L
        if pl.alpha is not None:
            a_end = min(pl.alpha.end, true_L)
            if pl.beta is None or pl.beta.start >= true_L:
                # the final micro absorbs decode-length under-prediction:
                # generation does not stop at the predicted end, so the
                # tail extends to the true length instead of truncating
                a_end = true_L
            if a_end > 0:
                mr = MicroRequest(r, "alpha", 0, a_end)
                sm = SimMicro(mr, mr.prefill_tokens, mr.decode_tokens, 0)
                out.append((pl.alpha_instance, sm))
        if pl.beta is not None and pl.beta.start < true_L:
            mr = MicroRequest(r, "beta", pl.beta.start, true_L)
            sm = SimMicro(mr, mr.prefill_tokens, mr.decode_tokens, mr.start)
            if out:      # depends on alpha's KV handoff
                sm.ready = float("inf")
                self._pending_beta[out[0][1].rid] = sm
            out.append((pl.beta_instance, sm))
        if not out:      # degenerate: empty request
            mr = MicroRequest(r, "alpha", 0, true_L)
            out.append((pl.alpha_instance or 0,
                        SimMicro(mr, mr.prefill_tokens, mr.decode_tokens, 0)))
        return out

    def on_micro_finished(self, m, sim, now: float) -> None:
        b = self._pending_beta.pop(m.rid, None)
        if b is not None:
            if b.iid == m.iid:
                # migration co-located the pair: the KV never crosses a
                # link, so the handoff is free (real backends still copy
                # between slots of the one engine)
                sim.release_beta(b, now, 0.0, 0.0, src=m)
                return
            # the stream ships the source pool's wire format: quantized
            # pages put ~half the bytes on the link per chunk
            kvpt = sim.cost.kv_bytes_per_tok_at(
                sim.backend.request_precision(
                    m.iid, getattr(m.mr.parent.slo, "name", None)))
            plan = plan_chunked_transfer(sim.cost, m.mr.end,
                                         self.transfer_chunk,
                                         kv_bytes_per_tok=kvpt)
            sim.release_beta(b, now + plan.exposed, plan.exposed,
                             plan.total_bytes, src=m)


# ==========================================================================
# Elastic DynaServe: DynaServe's APS + the pool controller
# ==========================================================================
class ElasticDynaServePolicy(DynaServePolicy):
    """DynaServe with an elastic instance pool.

    The simulator starts at ``SimConfig.n_instances`` (treat it as the
    initial/minimum size) and the ``PoolController`` resizes within
    ``[min_instances, max_instances]``, drifts role bias with the
    observed prefill/decode mix, and migrates queued micro-requests off
    hot or draining instances.  Placement only ever targets live,
    non-draining members.
    """

    def __init__(self, cost: BatchCostModel, slo: float = 0.100,
                 elastic: Optional[ElasticConfig] = None, **kw):
        super().__init__(cost, slo, **kw)
        if self.split_mode != "dynamic":
            raise ValueError("ElasticDynaServePolicy requires "
                             "split_mode='dynamic' (the ablation arms "
                             "round-robin over the whole pool)")
        self.controller = PoolController(elastic)

    @property
    def pool_interval(self) -> float:
        return self.controller.cfg.check_interval

    def place(self, r: Request, sim, now: float):
        self.controller.observe_arrival(r.P, r.D_pred)
        return super().place(r, sim, now)

    def _stats(self, sim) -> List[InstanceStat]:
        out = []
        for inst in sim.pool_instances():
            view = self._queued_view(inst)
            out.append(InstanceStat(
                iid=inst.iid,
                drain_time=self.gs.predictor.drain_time(
                    view, cost=sim.backend.cost_for(inst.iid)),
                queued_prefill_tokens=sum(q.prefill_remaining for q in view),
                queued_decode_tokens=sum(q.decode_remaining for q in view),
                n_queued=inst.n_queued,
                draining=inst.draining,
                role_bias=inst.role_bias,
                mem_pressure=sim.kv_pressure(inst.iid),
                devices=sim.backend.devices_for(inst.iid),
            ))
        return out

    def on_pool_check(self, sim, now: float) -> None:
        for act in self.controller.decide(self._stats(sim), now):
            if sim.decisions_enabled:
                payload = {"action": type(act).__name__,
                           "reason": getattr(act, "reason", ""),
                           "signals": dict(self.controller.last_signals)}
                for fld in ("iid", "src", "dst", "max_micros", "bias",
                            "donors", "devices"):
                    if hasattr(act, fld):
                        val = getattr(act, fld)
                        payload[fld] = list(val) if isinstance(val, tuple) \
                            else val
                if isinstance(act, ScaleUp):
                    # the newcomer joins at the pool's current role
                    # target; replay needs that value to pin the action
                    payload["target_bias"] = self.controller.target_bias
                sim.record_decision("pool_action", payload)
            if isinstance(act, ScaleUp):
                inst = sim.add_instance()
                # join at the pool's current role target so pick_pair
                # doesn't transiently steer prefill away from the
                # (idle, bias-0) newcomer
                inst.scheduler.set_role_bias(self.controller.target_bias)
            elif isinstance(act, DrainInstance):
                sim.drain_instance(act.iid)
            elif isinstance(act, MigrateWork):
                sim.migrate(act.src, act.dst, act.max_micros)
            elif isinstance(act, SetRoleBias):
                sim.instances[act.iid].scheduler.set_role_bias(act.bias)
            elif isinstance(act, MergeInstances):
                # width <-> count trade: retire the narrow donors and
                # attach one sharded instance twice as wide in their
                # place (the controller already queued evacuation
                # migrations for the donors' queued work)
                for iid in act.donors:
                    sim.drain_instance(iid)
                inst = sim.add_instance(devices=act.devices)
                inst.scheduler.set_role_bias(self.controller.target_bias)
            elif isinstance(act, SplitInstance):
                # reverse trade: retire the wide member, attach two
                # narrower instances to recover placement parallelism
                sim.drain_instance(act.iid)
                for _ in range(2):
                    inst = sim.add_instance(devices=act.devices)
                    inst.scheduler.set_role_bias(
                        self.controller.target_bias)
