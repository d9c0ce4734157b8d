"""Dependency-free metrics: counters, gauges, histograms, Prometheus
text exposition, and the serving hub that meters a ``ServeSession``.

The registry is deliberately tiny (no client library — the project
depends only on numpy+jax): metric families hold per-label-set children
behind one lock, and ``render()`` emits the Prometheus text format
(``# HELP`` / ``# TYPE`` headers, cumulative ``_bucket`` counts with an
``+Inf`` bound, ``_sum`` / ``_count``) that any scraper ingests.

``ServingMetrics`` is the session-facing half: registered as a session
observer it turns lifecycle callbacks into request/token counters and
per-SLO-class TTFT/TBT histograms, and ``sample(session)`` polls the
queue/pipeline/pool gauges plus whatever the backend meters through
``Backend.gauges`` (KV page occupancy, prefix-cache size, slots).
All times come off the *session* clock, so the histograms are directly
comparable between the simulator (virtual seconds) and real engines
(wall seconds).
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "ServingMetrics",
    "DEFAULT_TTFT_BUCKETS", "DEFAULT_TBT_BUCKETS",
]

# Latency bucket ladders (seconds): wide enough for batch-class traffic,
# fine enough near the interactive SLO bounds (0.5s TTFT / 100ms TBT).
DEFAULT_TTFT_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0,
                        5.0, 10.0, 30.0, 60.0)
DEFAULT_TBT_BUCKETS = (0.002, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                       1.0, 2.5)


def _escape(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt_labels(names: Sequence[str], values: Sequence[str],
                extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = list(zip(names, values)) + list(extra)
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"'
                     for k, v in sorted(pairs))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Family:
    """One metric family: name + help + typed per-label-set children."""

    kind = "untyped"

    def __init__(self, name: str, help_: str, labels: Sequence[str],
                 lock: threading.Lock):
        self.name = name
        self.help = help_
        self.label_names = tuple(labels)
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = lock

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[k]) for k in self.label_names)

    def _child(self, labels: Dict[str, str]):
        key = self._key(labels)
        c = self._children.get(key)
        if c is None:
            c = self._new_child()
            self._children[key] = c
        return c

    def _new_child(self):
        raise NotImplementedError

    def render(self) -> List[str]:
        with self._lock:
            lines = [f"# HELP {self.name} {self.help}",
                     f"# TYPE {self.name} {self.kind}"]
            for key in sorted(self._children):
                lines.extend(self._render_child(key, self._children[key]))
            return lines

    def _render_child(self, key, child) -> List[str]:
        raise NotImplementedError


class Counter(_Family):
    kind = "counter"

    def _new_child(self):
        return [0.0]

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"{self.name}: counters only go up")
        with self._lock:
            self._child(labels)[0] += value

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._child(labels)[0])

    def _render_child(self, key, child):
        return [f"{self.name}{_fmt_labels(self.label_names, key)} "
                f"{_fmt_value(child[0])}"]


class Gauge(_Family):
    kind = "gauge"

    def _new_child(self):
        return [0.0]

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._child(labels)[0] = float(value)

    def inc(self, value: float = 1.0, **labels) -> None:
        with self._lock:
            self._child(labels)[0] += value

    def dec(self, value: float = 1.0, **labels) -> None:
        self.inc(-value, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._child(labels)[0])

    def _render_child(self, key, child):
        return [f"{self.name}{_fmt_labels(self.label_names, key)} "
                f"{_fmt_value(child[0])}"]


class _HistChild:
    __slots__ = ("counts", "total", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)   # + the +Inf bucket
        self.total = 0.0
        self.count = 0


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name, help_, labels, lock,
                 buckets: Sequence[float] = DEFAULT_TBT_BUCKETS):
        super().__init__(name, help_, labels, lock)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs or any(b <= a for a, b in zip(bs, bs[1:])):
            raise ValueError(f"{name}: buckets must be sorted and unique")
        self.buckets = bs

    def _new_child(self):
        return _HistChild(len(self.buckets))

    def observe(self, value: float, **labels) -> None:
        v = float(value)
        with self._lock:
            c = self._child(labels)
            i = 0
            while i < len(self.buckets) and v > self.buckets[i]:
                i += 1
            c.counts[i] += 1
            c.total += v
            c.count += 1

    def count_of(self, **labels) -> int:
        with self._lock:
            return self._child(labels).count

    def _render_child(self, key, c: _HistChild):
        lines = []
        cum = 0
        for bound, n in zip(self.buckets + (float("inf"),), c.counts):
            cum += n
            labels = _fmt_labels(self.label_names, key,
                                 extra=(("le", _fmt_value(bound)),))
            lines.append(f"{self.name}_bucket{labels} {cum}")
        base = _fmt_labels(self.label_names, key)
        lines.append(f"{self.name}_sum{base} {_fmt_value(c.total)}")
        lines.append(f"{self.name}_count{base} {c.count}")
        return lines


class MetricsRegistry:
    """A set of metric families rendered as one Prometheus scrape."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _add(self, fam: _Family) -> _Family:
        cur = self._families.get(fam.name)
        if cur is not None:
            if type(cur) is not type(fam):
                raise ValueError(f"metric {fam.name} re-registered with a "
                                 f"different type")
            return cur
        self._families[fam.name] = fam
        return fam

    def counter(self, name: str, help_: str,
                labels: Iterable[str] = ()) -> Counter:
        return self._add(Counter(name, help_, tuple(labels), self._lock))

    def gauge(self, name: str, help_: str,
              labels: Iterable[str] = ()) -> Gauge:
        return self._add(Gauge(name, help_, tuple(labels), self._lock))

    def histogram(self, name: str, help_: str, labels: Iterable[str] = (),
                  buckets: Sequence[float] = DEFAULT_TBT_BUCKETS
                  ) -> Histogram:
        return self._add(Histogram(name, help_, tuple(labels), self._lock,
                                   buckets=buckets))

    def render(self) -> str:
        lines: List[str] = []
        for name in sorted(self._families):
            lines.extend(self._families[name].render())
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# The serving hub: session observer + gauge sampler
# ---------------------------------------------------------------------------
def _cls(req) -> str:
    return req.slo.name if req.slo is not None else "default"


class ServingMetrics:
    """Meters one ``ServeSession`` into a ``MetricsRegistry``.

    Append to ``session.observers`` for the event-driven half (request /
    token counters, TTFT/TBT histograms keyed by SLO class, terminal
    outcomes); call ``sample(session)`` periodically — the
    ``SessionDriver`` does — for the polled half (queue depths,
    in-flight pipeline depth, pool size, backend occupancy gauges).
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 ttft_buckets: Sequence[float] = DEFAULT_TTFT_BUCKETS,
                 tbt_buckets: Sequence[float] = DEFAULT_TBT_BUCKETS):
        r = registry if registry is not None else MetricsRegistry()
        self.registry = r
        self.requests = r.counter(
            "dynaserve_requests_total",
            "Requests by SLO class and terminal outcome",
            labels=("slo_class", "outcome"))
        self.admitted = r.counter(
            "dynaserve_admitted_total",
            "Requests past admission control", labels=("slo_class",))
        self.tokens = r.counter(
            "dynaserve_tokens_total",
            "Tokens delivered to streaming handles",
            labels=("slo_class",))
        self.ttft = r.histogram(
            "dynaserve_ttft_seconds",
            "Time to first token (session clock)",
            labels=("slo_class",), buckets=ttft_buckets)
        self.tbt = r.histogram(
            "dynaserve_tbt_seconds",
            "Time between tokens (session clock)",
            labels=("slo_class",), buckets=tbt_buckets)
        self.open_requests = r.gauge(
            "dynaserve_open_requests", "Requests admitted but not terminal")
        self.pool_size = r.gauge(
            "dynaserve_pool_size", "Active (placeable) instances")
        self.queue_depth = r.gauge(
            "dynaserve_queue_depth",
            "Queued micro-requests per instance and queue",
            labels=("instance", "queue"))
        self.inflight = r.gauge(
            "dynaserve_inflight_batches",
            "Dispatched-but-uncollected batches (pipeline depth)",
            labels=("instance",))
        self.kv_streams = r.gauge(
            "dynaserve_kv_streams", "Background KV handoff streams live")
        self.backend_gauge = r.gauge(
            "dynaserve_backend", "Backend substrate gauges (see key label)",
            labels=("instance", "key"))
        self.preemptions = r.gauge(
            "dynaserve_preemptions",
            "KV recompute preemptions (session counter)")
        self.scale_events = r.counter(
            "dynaserve_scale_events_total",
            "Elastic pool scale events by direction",
            labels=("direction",))
        self.preempt_causes = r.counter(
            "dynaserve_preemptions_total",
            "Preemptions and recompute-requeues by cause",
            labels=("cause",))
        # per-request progress state (arrival + last token time), pruned
        # at terminal transitions so memory stays bounded
        self._progress: Dict[str, List[float]] = {}
        self._plock = threading.Lock()

    # ---- session observer callbacks (driver thread) ----
    def on_request(self, req, now: float) -> None:
        with self._plock:
            self._progress[req.rid] = [now, -1.0]

    def on_transition(self, req, old: str, new: str, now: float) -> None:
        if new == "admitted":
            self.admitted.inc(slo_class=_cls(req))
        elif new in ("done", "cancelled", "rejected"):
            self.requests.inc(slo_class=_cls(req), outcome=new)
            with self._plock:
                self._progress.pop(req.rid, None)

    def on_token(self, req, now: float) -> None:
        cls = _cls(req)
        self.tokens.inc(slo_class=cls)
        with self._plock:
            prog = self._progress.get(req.rid)
            if prog is None:
                prog = self._progress[req.rid] = [now, -1.0]
            arrival, last = prog
            prog[1] = now
        if last < 0:
            self.ttft.observe(max(0.0, now - arrival), slo_class=cls)
        else:
            self.tbt.observe(max(0.0, now - last), slo_class=cls)

    def on_decision(self, kind: str, payload: dict, now: float) -> None:
        if kind == "scale":
            self.scale_events.inc(
                direction=str(payload.get("direction", "up")))
        elif kind in ("preempt", "recompute"):
            self.preempt_causes.inc(
                cause=str(payload.get("cause", kind)))

    # ---- polled gauges (driver thread) ----
    def sample(self, session) -> None:
        self.open_requests.set(float(session._open_requests))
        self.pool_size.set(float(len(session.active_instances())))
        self.kv_streams.set(float(len(session._streams)))
        self.preemptions.set(float(session.preemptions))
        for inst in session.pool_instances():
            i = str(inst.iid)
            self.queue_depth.set(len(inst.prefill_q), instance=i,
                                 queue="prefill")
            self.queue_depth.set(len(inst.decode_q), instance=i,
                                 queue="decode")
            self.inflight.set(len(inst.inflight), instance=i)
            for key, val in session.backend.gauges(inst.iid).items():
                self.backend_gauge.set(val, instance=i, key=key)

    def render(self) -> str:
        return self.registry.render()
