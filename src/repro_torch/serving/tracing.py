"""Per-request trace spans, emitted as JSON lines.

The ``Tracer`` is a session observer: lifecycle transitions carve each
request's life into named spans on the session clock —

    queued     arrival         -> admitted
    scheduled  admitted        -> running_alpha (placed + dispatched)
    prefill    running_alpha   -> first token (or handoff, if earlier)
    handoff    handoff         -> running_beta (KV migration exposed)
    decode     first token     -> terminal

and at the terminal transition writes one JSON object per request to the
sink: ``{"trace_id", "rid", "slo_class", "outcome", "arrival", "end",
"n_tokens", "spans": [{"name", "start", "end", "dur"}, ...], "events":
[{"t", "kind", ...}, ...]}`` — ``events`` carries mid-flight scheduler
decisions (preemptions, recompute-requeues) that hit the request.  The
HTTP front door mints a ``trace_id`` per request (also returned in the
``x-trace-id`` response header) and registers it here, so a client can
grep the trace log for exactly the request it saw.

The sink is either a callable (dict -> None) or a file path opened in
append mode; with no sink, traces accumulate on ``tracer.finished`` (a
bounded deque) for tests and ad-hoc inspection.  Pool-level decisions
that belong to no single request (prefix-cache evictions, elastic
scale events, migrations, controller actions) land on
``tracer.pool_events``, another bounded ring.

Below the session, the engine level is ``engine`` (the module
``repro_torch.utils.trace``, which imports only the standard library so
that the engine needs nothing of this package): one process-wide switch,
spans at the dispatch, pack, stage, launch, capture, collect, wait,
copy and sample of every engine step and at the session's compose,
placement and handoffs, and one record an engine step, stamped on the
profiler's clock, with the session clock's zero on that clock.
"""
from __future__ import annotations

import collections
import json
import threading
from typing import Callable, Dict, List, Optional, Union

from repro_torch.utils import trace as engine

__all__ = ["Tracer", "engine"]

_TERMINAL = ("done", "cancelled", "rejected")


class _Trace:
    __slots__ = ("trace_id", "arrival", "marks", "first_token", "n_tokens",
                 "events")

    def __init__(self, trace_id: str, arrival: float):
        self.trace_id = trace_id
        self.arrival = arrival
        self.marks: Dict[str, float] = {}     # state -> first time entered
        self.first_token: Optional[float] = None
        self.n_tokens = 0
        # scheduler decisions that hit this request mid-flight
        # (preemptions, recompute-requeues), kept on the span record
        self.events: List[dict] = []


class Tracer:
    """Session observer that turns lifecycle edges into span timelines."""

    def __init__(self, sink: Union[None, str, Callable[[dict], None]] = None,
                 keep: int = 256):
        self._lock = threading.Lock()
        self._live: Dict[str, _Trace] = {}
        # rids pre-registered before their on_request arrived; bounded so
        # a front door that mints ids for never-submitted requests can't
        # grow _live without limit
        self._orphans: collections.deque = collections.deque()
        self._keep = keep
        self._seq = 0
        self.finished: collections.deque = collections.deque(maxlen=keep)
        # pool-level decisions (evictions, scale, migrations) that have no
        # single owning request; bounded ring like ``finished``
        self.pool_events: collections.deque = collections.deque(maxlen=keep)
        self._path: Optional[str] = None
        self._emit: Optional[Callable[[dict], None]] = None
        if callable(sink):
            self._emit = sink
        elif sink is not None:
            self._path = str(sink)

    def register(self, rid: str, trace_id: str) -> None:
        """Attach a caller-minted trace id (the HTTP layer's) to ``rid``.
        Safe before or just after submission; ids default to
        ``trace-<n>`` otherwise."""
        with self._lock:
            tr = self._live.get(rid)
            if tr is not None:
                tr.trace_id = trace_id
            else:
                tr = _Trace(trace_id, 0.0)
                tr.arrival = float("nan")
                self._live[rid] = tr
                self._orphans.append(rid)
                while len(self._orphans) > self._keep:
                    old = self._orphans.popleft()
                    cur = self._live.get(old)
                    if cur is not None and cur.arrival != cur.arrival:
                        del self._live[old]

    # ---- session observer callbacks (driver thread) ----
    def on_request(self, req, now: float) -> None:
        with self._lock:
            tr = self._live.get(req.rid)
            if tr is None:
                self._seq += 1
                tr = _Trace(f"trace-{self._seq}", now)
                self._live[req.rid] = tr
            tr.arrival = now
            tr.marks["queued"] = now

    def on_transition(self, req, old: str, new: str, now: float) -> None:
        with self._lock:
            tr = self._live.get(req.rid)
            if tr is None:
                return
            tr.marks.setdefault(new, now)
            if new not in _TERMINAL:
                return
            record = self._close(req, tr, new, now)
            del self._live[req.rid]
        self.finished.append(record)
        if self._emit is not None:
            self._emit(record)
        elif self._path is not None:
            line = json.dumps(record, sort_keys=True)
            with open(self._path, "a") as f:
                f.write(line + "\n")

    def on_token(self, req, now: float) -> None:
        with self._lock:
            tr = self._live.get(req.rid)
            if tr is None:
                return
            if tr.first_token is None:
                tr.first_token = now
            tr.n_tokens += 1

    def on_decision(self, kind: str, payload: dict, now: float) -> None:
        if kind in ("preempt", "recompute"):
            rid = payload.get("req") or payload.get("rid")
            with self._lock:
                tr = self._live.get(rid)
                if tr is not None and len(tr.events) < 64:
                    ev = {"t": now, "kind": kind}
                    for k in ("cause", "iid", "evicted_tokens", "keep"):
                        if k in payload:
                            ev[k] = payload[k]
                    tr.events.append(ev)
        elif kind in ("evict", "scale", "migrate", "pool_action"):
            self.pool_events.append({"t": now, "kind": kind, **payload})

    # ---- span assembly ----
    def _close(self, req, tr: _Trace, outcome: str, end: float) -> dict:
        m = tr.marks
        spans: List[dict] = []

        def span(name: str, start: Optional[float],
                 stop: Optional[float]) -> None:
            if start is None or stop is None or stop < start:
                return
            spans.append({"name": name, "start": start, "end": stop,
                          "dur": stop - start})

        admitted = m.get("admitted")
        alpha = m.get("running_alpha")
        handoff = m.get("handoff")
        beta = m.get("running_beta")
        first = tr.first_token
        span("queued", tr.arrival, admitted if admitted is not None else end)
        span("scheduled", admitted, alpha if alpha is not None
             else (handoff if handoff is not None else None))
        if alpha is not None:
            stop = min(x for x in (first, handoff, end) if x is not None)
            span("prefill", alpha, stop)
        span("handoff", handoff, beta if beta is not None else end)
        if first is not None:
            span("decode", first, end)
        return {
            "trace_id": tr.trace_id,
            "rid": req.rid,
            "slo_class": req.slo.name if req.slo is not None else "default",
            "outcome": outcome,
            "arrival": tr.arrival,
            "end": end,
            "n_tokens": tr.n_tokens,
            "spans": spans,
            "events": list(tr.events),
        }
