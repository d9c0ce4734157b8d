"""SLO-miss attribution: decompose TTFT/TBT violations into causes.

Given a flight-recorder decision log (:mod:`repro_torch.serving.flightrecorder`),
``analyze`` partitions each request's wall time — the TTFT window
``[arrival, first_token]`` and the full-latency window
``[arrival, last_token]`` — into six mutually-exclusive components that
sum *exactly* to the observed TTFT / latency:

``queueing_wait``
    No batch containing (or blocking) the request ran on its instance:
    the request sat in a scheduler queue.
``prefill_interference``
    Device time spent computing *other* requests' prefill tokens while
    this request waited or shared the batch (the paper's core
    prefill-vs-decode contention).
``handoff_stall``
    Time parked in the HANDOFF state waiting for the alpha→beta KV
    transfer to land.
``preempt_recompute``
    Device time re-computing prefix tokens this request had already
    computed before a preemption or handoff fallback evicted them.
``cache_miss``
    First-time prefill compute on a cacheable prompt while the shared
    prefix cache was enabled — work a warmer cache could have served.
``device_busy``
    Remaining device time: the request's own useful compute (fresh
    prefill on uncacheable prompts, decode steps) plus co-batched
    decode work of others.

Within a batch the interval is split by token share — granted prefill
tokens count one unit each, each decode stream one unit — so components
are exact fractions of device intervals, and the per-request sum equals
the window length to float precision (well inside the 1% acceptance
bound).

``publish`` surfaces the per-SLO-class aggregate through the Prometheus
registry; the HTTP server exposes the full report at
``/debug/attribution``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core.request import SLO_CLASSES

__all__ = ["COMPONENTS", "RequestAttribution", "ClassAttribution",
           "AttributionReport", "analyze", "publish"]

COMPONENTS = ("queueing_wait", "prefill_interference", "handoff_stall",
              "preempt_recompute", "cache_miss", "device_busy")


@dataclasses.dataclass
class RequestAttribution:
    rid: str
    slo_class: Optional[str]
    arrival: float
    ttft: float
    latency: float
    n_tokens: int
    max_tbt: float
    ttft_miss: bool
    tbt_miss: bool
    # component -> seconds, over the TTFT window / full-latency window
    ttft_components: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    total_components: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ClassAttribution:
    slo_class: str
    n: int = 0
    ttft_misses: int = 0
    tbt_misses: int = 0
    # summed over the missing requests' relevant windows (TTFT window
    # for TTFT misses, full window for TBT misses)
    components: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in COMPONENTS})

    @property
    def top_cause(self) -> Optional[str]:
        if not (self.ttft_misses or self.tbt_misses):
            return None
        return max(self.components, key=lambda c: self.components[c])

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["top_cause"] = self.top_cause
        return d


@dataclasses.dataclass
class AttributionReport:
    requests: List[RequestAttribution]
    per_class: Dict[str, ClassAttribution]

    def to_json(self, include_requests: bool = True) -> dict:
        out = {
            "components": list(COMPONENTS),
            "per_class": {k: v.to_json()
                          for k, v in sorted(self.per_class.items())},
        }
        if include_requests:
            out["requests"] = [r.to_json() for r in self.requests]
        return out

    def top_causes(self) -> Dict[str, Optional[str]]:
        return {k: v.top_cause for k, v in self.per_class.items()}


class _Exec:
    """One executed batch, pre-digested for interval classification."""
    __slots__ = ("t0", "t1", "total", "prefill_units", "decode_units",
                 "own")

    def __init__(self, ev: dict):
        d = ev["data"]
        self.t1 = ev["t"]
        self.t0 = min(d["t0"], self.t1)
        # own: parent rid -> [prefill granted, recomputed, decodes]
        self.own: Dict[str, List[float]] = {}
        pf = dec = 0.0
        for entry in d["prefill"]:
            rid, g = entry[0], entry[1]
            past = entry[2] if len(entry) > 2 else 0
            parent = rid.split("/")[0]
            o = self.own.setdefault(parent, [0.0, 0.0, 0.0])
            o[0] += g
            o[1] += past
            pf += g
        for rid in d["decode"]:
            parent = rid.split("/")[0]
            o = self.own.setdefault(parent, [0.0, 0.0, 0.0])
            o[2] += 1.0
            dec += 1.0
        self.prefill_units = pf
        self.decode_units = dec
        self.total = max(pf + dec, 1e-12)


def _window_components(rid: str, a: float, b: float,
                       phase_of, execs_by_iid: Dict[int, List[_Exec]],
                       cache_on: bool, cacheable: bool) -> Dict[str, float]:
    """Partition [a, b] into the attribution components.  ``phase_of(t)``
    returns the instance id hosting the request at time t, or "handoff"
    while it is parked mid-transfer, or None before placement."""
    comp = {c: 0.0 for c in COMPONENTS}
    if b <= a:
        return comp
    cm_key = "cache_miss" if (cache_on and cacheable) else "device_busy"
    # breakpoints: window edges, phase edges, exec edges on any
    # instance the request touches
    cuts = {a, b}
    cuts.update(t for t in phase_of.edges if a < t < b)
    iids = {p for p in phase_of.phases if isinstance(p, int)}
    for iid in iids:
        for ex in execs_by_iid.get(iid, ()):
            if ex.t1 > a and ex.t0 < b:
                if a < ex.t0 < b:
                    cuts.add(ex.t0)
                if a < ex.t1 < b:
                    cuts.add(ex.t1)
    pts = sorted(cuts)
    for lo, hi in zip(pts, pts[1:]):
        w = hi - lo
        if w <= 0:
            continue
        mid = (lo + hi) / 2.0
        where = phase_of(mid)
        if where == "handoff":
            comp["handoff_stall"] += w
            continue
        if where is None:
            comp["queueing_wait"] += w
            continue
        ex = None
        for cand in execs_by_iid.get(where, ()):
            if cand.t0 <= mid < cand.t1:
                ex = cand
                break
        if ex is None:
            comp["queueing_wait"] += w
            continue
        u = w / ex.total              # seconds per batch unit
        own = ex.own.get(rid)
        own_pf, own_past, own_dec = own if own is not None else (0., 0., 0.)
        own_past = min(own_past, own_pf)
        comp["preempt_recompute"] += u * own_past
        comp[cm_key] += u * (own_pf - own_past)
        comp["device_busy"] += u * (own_dec + (ex.decode_units - own_dec))
        comp["prefill_interference"] += u * (ex.prefill_units - own_pf)
    return comp


class _Phases:
    """Piecewise instance-residency of one request: alpha instance until
    the handoff starts, "handoff" while parked, beta instance after,
    with migrations switching the active micro's home."""

    def __init__(self):
        self.segs: List[Tuple[float, object]] = []   # (start t, where)

    def add(self, t: float, where) -> None:
        self.segs.append((t, where))

    def freeze(self) -> None:
        self.segs.sort(key=lambda s: s[0])
        self.edges = [t for t, _ in self.segs]
        self.phases = [w for _, w in self.segs]

    def __call__(self, t: float):
        where = None
        for t0, w in self.segs:
            if t0 <= t:
                where = w
            else:
                break
        return where


def analyze(events: Iterable[dict]) -> AttributionReport:
    evs = list(events)
    cache_on = False
    reqs: Dict[str, dict] = {}
    tokens: Dict[str, List[float]] = {}
    execs_by_iid: Dict[int, List[_Exec]] = {}
    place: Dict[str, dict] = {}
    handoff_at: Dict[str, float] = {}        # parent rid -> t(handoff state)
    beta_ready: Dict[str, float] = {}        # parent rid -> t(running_beta)
    migrations: Dict[str, List[Tuple[float, int]]] = {}

    for ev in evs:
        kind, d, t = ev["kind"], ev["data"], ev["t"]
        if kind == "meta":
            cache_on = bool(d.get("backend", {}).get("prefix_cache"))
        elif kind == "request":
            reqs[d["rid"]] = dict(d, t=t)
        elif kind == "token":
            tokens.setdefault(d["rid"], []).append(t)
        elif kind == "exec":
            execs_by_iid.setdefault(d["iid"], []).append(_Exec(ev))
        elif kind == "place":
            place[d["rid"]] = dict(d, t=t)
        elif kind == "transition":
            if d["new"] == "handoff":
                handoff_at.setdefault(d["rid"], t)
            elif d["new"] == "running_beta" and d["old"] == "handoff":
                beta_ready.setdefault(d["rid"], t)
        elif kind == "migrate":
            for rid in d["rids"]:
                migrations.setdefault(rid, []).append((t, d["dst"]))

    for lst in execs_by_iid.values():
        lst.sort(key=lambda e: e.t0)

    out: List[RequestAttribution] = []
    per_class: Dict[str, ClassAttribution] = {}
    for rid, rq in reqs.items():
        toks = tokens.get(rid)
        pl = place.get(rid)
        if not toks or pl is None:
            continue                      # rejected / cancelled pre-token
        arrival = rq["t"]                 # session-clock arrival
        first, last = toks[0], toks[-1]
        ttft = first - arrival
        latency = last - arrival
        gaps = [b - a for a, b in zip(toks, toks[1:])]
        max_tbt = max(gaps, default=0.0)

        micros = pl["micros"]
        alpha = next((m for m in micros if m["role"] == "alpha"),
                     micros[0])
        beta = next((m for m in micros if m["role"] == "beta"), None)
        ph = _Phases()
        ph.add(pl["t"], alpha["iid"])
        if beta is not None and rid in handoff_at:
            t_h = handoff_at[rid]
            ph.add(t_h, "handoff")
            ph.add(beta_ready.get(rid, t_h), beta["iid"])
        # migrations re-home the micro that moved; approximate by
        # switching the whole request (exact for single-micro requests)
        for full_rid, moves in migrations.items():
            if full_rid.split("/")[0] == rid:
                for t_m, dst in moves:
                    ph.add(t_m, dst)
        ph.freeze()

        cacheable = bool(rq.get("cacheable"))
        ttft_c = _window_components(rid, arrival, first, ph,
                                    execs_by_iid, cache_on, cacheable)
        total_c = _window_components(rid, arrival, last, ph,
                                     execs_by_iid, cache_on, cacheable)

        slo_name = rq.get("slo")
        slo = SLO_CLASSES.get(slo_name) if slo_name else None
        ttft_miss = bool(slo) and ttft > slo.ttft
        tbt_miss = bool(slo) and max_tbt > slo.tbt
        ra = RequestAttribution(
            rid=rid, slo_class=slo_name, arrival=arrival, ttft=ttft,
            latency=latency, n_tokens=len(toks), max_tbt=max_tbt,
            ttft_miss=ttft_miss, tbt_miss=tbt_miss,
            ttft_components=ttft_c, total_components=total_c)
        out.append(ra)

        cls = per_class.setdefault(slo_name or "default",
                                   ClassAttribution(slo_name or "default"))
        cls.n += 1
        if ttft_miss:
            cls.ttft_misses += 1
            for c in COMPONENTS:
                cls.components[c] += ttft_c[c]
        if tbt_miss:
            cls.tbt_misses += 1
            for c in COMPONENTS:
                cls.components[c] += total_c[c]
    return AttributionReport(out, per_class)


def publish(report: AttributionReport, registry) -> None:
    """Surface the per-class aggregate as Prometheus gauges (gauges, not
    counters: the report is recomputed over the recorder's ring on each
    scrape, i.e. a sliding window)."""
    g_sec = registry.gauge(
        "dynaserve_slo_miss_attribution_seconds",
        "Attributed seconds inside SLO-missing requests' latency windows",
        labels=("slo_class", "component"))
    g_n = registry.gauge(
        "dynaserve_slo_misses",
        "Requests missing their SLO bound (recorder window)",
        labels=("slo_class", "bound"))
    for name, cls in report.per_class.items():
        g_n.set(cls.ttft_misses, slo_class=name, bound="ttft")
        g_n.set(cls.tbt_misses, slo_class=name, bound="tbt")
        for c in COMPONENTS:
            g_sec.set(cls.components[c], slo_class=name, component=c)
