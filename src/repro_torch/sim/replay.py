"""Counterfactual replay: re-execute a recorded decision log in the sim.

The flight recorder (:mod:`repro_torch.serving.flightrecorder`) captures every
*input* the scheduler acted on (arrivals, admission verdicts, placements
with split points, handoff transfer plans) as typed events.  Because the
simulator is deterministic given those inputs, re-running the trace with
a :class:`ReplayPolicy` pinned to the recorded choices reproduces the
original run bit-identically — ``verify_replay`` checks the per-request
token timelines match exactly.

On top of exact replay sit **counterfactuals**: override a single
recorded decision ("what if request r split at token k?", "what if it
placed on instance j?") and re-run; everything downstream — batch
composition, queueing, handoffs of *other* requests — re-derives
naturally, and ``counterfactual`` reports the goodput/latency delta
against the pinned baseline.

Scope: logs recorded on the sim backend replay exactly, including
elastic runs — recorded ``pool_action`` events (scale up/down, work
migration, role-bias changes) are re-applied at the same pool-check
times, so the pool evolves identically.  Engine logs replay
*approximately* (the sim models their cost); logs recorded with the
shared-prefix cache enabled cannot replay exactly (cache hits depend
on prompt token ids the log does not carry) and raise unless
``strict=False``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core.costmodel import A100, BatchCostModel
from repro_torch.core.kv_transfer import plan_chunked_transfer
from repro_torch.core.local_scheduler import LocalScheduler
from repro_torch.core.request import (MicroRequest, Request, SLO_CLASSES,
                                split_request)
from repro_torch.core.session import (MicroState, ServeSession, SessionConfig,
                                SessionMetrics)
from repro_torch.sim.simulator import InterleaveSchedule, SimBackend

__all__ = ["ReplayError", "ReplayLog", "ReplayPolicy", "ReplayResult",
           "replay", "verify_replay", "counterfactual"]


class ReplayError(ValueError):
    """The log cannot be replayed exactly (and strict mode is on)."""


@dataclasses.dataclass
class ReplayLog:
    """A decision log parsed into the lookups replay needs."""
    meta: dict
    requests: List[Request]
    verdicts: Dict[str, Optional[str]]        # rid -> shed reason (None=admit)
    placements: Dict[str, dict]               # rid -> place payload
    handoffs: Dict[str, dict]                 # beta micro rid -> handoff data
    token_times: Dict[str, List[float]]
    max_iid: int
    pool_actions: List[Tuple[float, dict]]    # (t, pool_action payload)

    @classmethod
    def parse(cls, events: Iterable[dict]) -> "ReplayLog":
        meta: dict = {}
        requests: List[Request] = []
        verdicts: Dict[str, Optional[str]] = {}
        placements: Dict[str, dict] = {}
        handoffs: Dict[str, dict] = {}
        token_times: Dict[str, List[float]] = {}
        pool_actions: List[Tuple[float, dict]] = []
        max_iid = 0
        for ev in events:
            kind, d = ev["kind"], ev["data"]
            if kind == "meta":
                meta = d
            elif kind == "request":
                slo = SLO_CLASSES.get(d["slo"]) if d["slo"] else None
                requests.append(Request(
                    d["rid"], d["arrival"], d["prefill"], d["decode"],
                    predicted_decode=d["predicted_decode"], slo=slo))
            elif kind == "admit":
                # keep the LAST verdict: a request admitted by load
                # control may still be shed at placement ("no free
                # slots"), and replay pins the final outcome
                verdicts[d["rid"]] = (d["reason"] or "rejected (recorded)"
                                      if d["verdict"] == "reject" else None)
            elif kind == "place":
                placements[d["rid"]] = d
                for mi in d["micros"]:
                    max_iid = max(max_iid, mi["iid"])
            elif kind == "handoff":
                handoffs[d["rid"]] = d
            elif kind == "token":
                token_times.setdefault(d["rid"], []).append(ev["t"])
            elif kind == "scale":
                max_iid = max(max_iid, d["iid"])
            elif kind == "pool_action":
                pool_actions.append((ev["t"], d))
        if not requests:
            raise ReplayError("log contains no request events — was the "
                              "recorder attached before the run?")
        # arrival-event order == recorded request-event order; pushing in
        # that order reproduces the original heap tie-breaking exactly
        return cls(meta, requests, verdicts, placements, handoffs,
                   token_times, max_iid, pool_actions)


class ReplayPolicy:
    """Places every request exactly where the recorded run placed it and
    releases betas on the recorded transfer plans.  ``overrides`` maps a
    request id to ``{"split_at": k, "alpha_iid": i, "beta_iid": j}``
    (all optional): that one request is re-split/re-placed live while
    everything else stays pinned."""

    last_overhead = 0.0
    last_placement = None

    def __init__(self, log: ReplayLog,
                 overrides: Optional[Dict[str, dict]] = None):
        self.log = log
        self.overrides = overrides or {}
        self.slo = log.meta.get("policy", {}).get("slo", 0.100)
        self.transfer_chunk = \
            log.meta.get("policy", {}).get("transfer_chunk") or 512
        self.slo_aware = log.meta.get("policy", {}
                                      ).get("slo_aware_batching")
        self._pending_beta: Dict[str, MicroState] = {}
        # elastic logs: re-apply recorded pool actions at the recorded
        # check cadence (pool_interval=0 keeps pool events unarmed on
        # static logs)
        self._pool_actions = list(log.pool_actions)  # already seq-ordered
        self._pa_idx = 0
        self.pool_interval = (
            log.meta.get("policy", {}).get("pool_interval") or 0.0
            if self._pool_actions else 0.0)

    def role_of(self, iid: int, n: int) -> str:
        return "unified"

    def make_local_scheduler(self, iid: int, cost: BatchCostModel,
                             slo: float) -> LocalScheduler:
        if self.slo_aware is False:
            return LocalScheduler(cost, slo, slo_aware=False,
                                  static_chunk=2048)
        return LocalScheduler(cost, slo, slo_aware=True)

    def on_pool_check(self, sim, now: float) -> None:
        """Re-apply recorded elastic actions whose check time has come
        (the replay pool evolves exactly as the recorded one did)."""
        while self._pa_idx < len(self._pool_actions):
            t, d = self._pool_actions[self._pa_idx]
            if t > now + 1e-9:
                break
            self._pa_idx += 1
            act = d["action"]
            if act == "ScaleUp":
                inst = sim.add_instance()
                inst.scheduler.set_role_bias(d.get("target_bias", 0.0))
            elif act == "DrainInstance":
                sim.drain_instance(d["iid"])
            elif act == "MigrateWork":
                sim.migrate(d["src"], d["dst"], d["max_micros"])
            elif act == "SetRoleBias":
                sim.instances[d["iid"]].scheduler.set_role_bias(d["bias"])

    def on_cancel(self, rid: str, sim) -> None:
        for key in [k for k in self._pending_beta
                    if k.startswith(rid + "/")]:
            self._pending_beta.pop(key, None)

    # -- placement ----------------------------------------------------
    def _place_override(self, r: Request, ov: dict):
        rec = self.log.placements.get(r.rid)
        rec_micros = rec["micros"] if rec else []
        rec_alpha = next((m for m in rec_micros if m["role"] == "alpha"),
                         None)
        rec_beta = next((m for m in rec_micros if m["role"] == "beta"),
                        None)
        ia = ov.get("alpha_iid",
                    rec_alpha["iid"] if rec_alpha else 0)
        ib = ov.get("beta_iid",
                    rec_beta["iid"] if rec_beta else ia)
        split = ov.get("split_at",
                       rec_beta["start"] if rec_beta else r.true_L)
        alpha, beta = split_request(r, split / max(1, r.true_L))
        out = []
        if alpha is not None:
            a_end = min(alpha.end, r.true_L) if beta is not None \
                else r.true_L
            mr = MicroRequest(r, "alpha", 0, a_end)
            out.append((ia, MicroState(mr, mr.prefill_tokens,
                                       mr.decode_tokens, 0)))
        if beta is not None and beta.start < r.true_L:
            mr = MicroRequest(r, "beta", beta.start, r.true_L)
            sm = MicroState(mr, mr.prefill_tokens, mr.decode_tokens,
                            mr.start)
            if out:
                sm.ready = float("inf")
                self._pending_beta[out[0][1].rid] = sm
            out.append((ib, sm))
        return out

    def place(self, r: Request, sim, now: float):
        ov = self.overrides.get(r.rid)
        if ov is not None:
            return self._place_override(r, ov)
        rec = self.log.placements.get(r.rid)
        if rec is None:
            raise ReplayError(f"no recorded placement for admitted "
                              f"request {r.rid!r}")
        out = []
        for mi in rec["micros"]:
            mr = MicroRequest(r, mi["role"], mi["start"], mi["end"])
            sm = MicroState(mr, mi["prefill"], mi["decode"], mi["pos"],
                            ready=float("inf") if mi["waiting"] else 0.0)
            out.append((mi["iid"], sm))
        if len(out) >= 2 and out[1][1].ready == float("inf"):
            self._pending_beta[out[0][1].rid] = out[1][1]
        return out

    # -- handoff -------------------------------------------------------
    def on_micro_finished(self, m: MicroState, sim, now: float) -> None:
        b = self._pending_beta.pop(m.rid, None)
        if b is None:
            return
        rec = self.log.handoffs.get(b.rid)
        parent = m.mr.parent.rid
        if rec is not None and parent not in self.overrides:
            # the recorded exposure is relative to its own emission time
            # (the original always had ready == now + exposed), so replay
            # re-anchors it at *this* run's emission time
            sim.release_beta(b, now + rec["exposed"], rec["exposed"],
                             rec["nbytes"], src=m)
            return
        # overridden (or unrecorded/degenerate) handoff: plan it live,
        # exactly as DynaServePolicy would
        if b.iid == m.iid:
            sim.release_beta(b, now, 0.0, 0.0, src=m)
            return
        kvpt = sim.cost.kv_bytes_per_tok_at(
            sim.backend.request_precision(
                m.iid, getattr(m.mr.parent.slo, "name", None)))
        plan = plan_chunked_transfer(sim.cost, m.mr.end,
                                     self.transfer_chunk,
                                     kv_bytes_per_tok=kvpt)
        sim.release_beta(b, now + plan.exposed, plan.exposed,
                         plan.total_bytes, src=m)


class _ReplaySession(ServeSession):
    """ServeSession with admission pinned to the recorded verdicts."""

    def __init__(self, backend, policy, cfg, verdicts):
        super().__init__(backend, policy, cfg)
        self._verdicts = verdicts

    def _admit(self, r):
        return self._verdicts.get(r.rid)


@dataclasses.dataclass
class ReplayResult:
    metrics: SessionMetrics
    token_times: Dict[str, List[float]]
    session: ServeSession


def _build_backend(meta: dict, cost: Optional[BatchCostModel],
                   strict: bool) -> SimBackend:
    be = meta.get("backend", {})
    if cost is None:
        from repro_torch.configs import get_config
        arch = be.get("arch")
        if not arch:
            raise ReplayError("log's meta event names no arch; pass "
                              "cost= explicitly")
        cost = BatchCostModel(get_config(arch), A100)
    if strict:
        if be.get("prefix_cache"):
            raise ReplayError(
                "log was recorded with the shared-prefix cache on; hit "
                "decisions depend on prompt token ids the log does not "
                "carry — pass strict=False for approximate replay")
        if be.get("kv_precision") == "mixed":
            raise ReplayError("mixed-precision pools are not replayed "
                              "exactly; pass strict=False")
    il = be.get("interleave")
    kw = {}
    if be.get("kind") == "sim":
        kw["host_overhead"] = be.get("host_overhead", 0.0)
        if be.get("page_size") and not be.get("prefix_cache"):
            kw["page_size"] = be["page_size"]
            kw["pages_per_instance"] = be["pages_per_instance"]
    kvp = be.get("kv_precision", "bf16")
    if kvp != "mixed":
        kw["kv_precision"] = kvp
    return SimBackend(
        cost,
        interleave=None if il is None else InterleaveSchedule(
            seed=il["seed"], window=il["window"], width=il["width"],
            mode=il["mode"]),
        **kw)


def replay(events: Iterable[dict],
           cost: Optional[BatchCostModel] = None,
           overrides: Optional[Dict[str, dict]] = None,
           strict: bool = True,
           recorder=None) -> ReplayResult:
    """Re-execute a recorded decision log on a fresh SimBackend pinned
    to the recorded choices.  ``overrides`` un-pins named requests (see
    :class:`ReplayPolicy`); ``recorder`` optionally attaches a new
    FlightRecorder to the replay session (to diff decision streams)."""
    log = events if isinstance(events, ReplayLog) else ReplayLog.parse(events)
    meta_cfg = log.meta.get("cfg", {})
    backend = _build_backend(log.meta, cost, strict)
    policy = ReplayPolicy(log, overrides=overrides)
    # elastic logs start at the recorded size and grow via replayed
    # pool actions; static logs cover every instance id ever placed on
    n_inst = meta_cfg.get("n_instances", 1) if log.pool_actions \
        else max(meta_cfg.get("n_instances", 1), log.max_iid + 1)
    cfg = SessionConfig(
        n_instances=n_inst,
        slo=meta_cfg.get("slo", 0.100),
        admission=bool(meta_cfg.get("admission")),
        overlap=meta_cfg.get("overlap"),
        pipeline_depth=meta_cfg.get("pipeline_depth", 2),
        stream_chunk_tokens=meta_cfg.get("stream_chunk_tokens", 512),
        max_sim_time=meta_cfg.get("max_sim_time", 10_000.0),
        open_loop=True)
    session = _ReplaySession(backend, policy, cfg, log.verdicts)
    if recorder is not None:
        recorder.attach(session)
    metrics = session.run(log.requests)
    token_times = {rid: list(st.token_times)
                   for rid, st in session.req_states.items()
                   if st.token_times}
    return ReplayResult(metrics, token_times, session)


def verify_replay(events: Iterable[dict],
                  cost: Optional[BatchCostModel] = None,
                  strict: bool = True) -> dict:
    """Replay a log and compare per-request token timelines against the
    recorded ones.  Exact replays match bit-identically (JSON float
    round-trips are exact in Python)."""
    log = events if isinstance(events, ReplayLog) else ReplayLog.parse(events)
    res = replay(log, cost=cost, strict=strict)
    mism: List[str] = []
    max_diff = 0.0
    recorded = log.token_times
    for rid in sorted(set(recorded) | set(res.token_times)):
        a, b = recorded.get(rid, []), res.token_times.get(rid, [])
        if len(a) != len(b):
            mism.append(f"{rid}: {len(a)} recorded vs {len(b)} replayed "
                        f"tokens")
            continue
        for x, y in zip(a, b):
            d = abs(x - y)
            max_diff = max(max_diff, d)
            if d != 0.0:
                mism.append(f"{rid}: token at {x} replayed at {y}")
                break
    return {"ok": not mism, "n_requests": len(recorded),
            "max_abs_diff": max_diff, "mismatched": mism,
            "result": res}


def counterfactual(events: Iterable[dict],
                   overrides: Dict[str, dict],
                   cost: Optional[BatchCostModel] = None,
                   strict: bool = True) -> dict:
    """Replay the log as recorded AND with ``overrides`` applied; report
    the goodput / p99-TBT delta of the overridden world."""
    log = events if isinstance(events, ReplayLog) else ReplayLog.parse(events)
    base = replay(log, cost=cost, strict=strict)
    var = replay(log, cost=cost, overrides=overrides, strict=strict)
    return {
        "overrides": overrides,
        "baseline": {"goodput": base.metrics.goodput,
                     "completed": base.metrics.completed,
                     "p99_tbt": base.metrics.p99_tbt()},
        "override": {"goodput": var.metrics.goodput,
                     "completed": var.metrics.completed,
                     "p99_tbt": var.metrics.p99_tbt()},
        "goodput_delta": var.metrics.goodput - base.metrics.goodput,
    }
