"""Scheduler flight recorder: typed, sequenced decision logs.

Every scheduler decision the :class:`~repro_torch.core.session.ServeSession`
makes — admission verdicts, GlobalScheduler split/placements (with the
probe trials and candidate scores that were *considered*), LocalScheduler
batch plans, preemption/eviction victims with causes, handoff-stream
chunk timelines, and elastic pool actions — is emitted through the
extended observer protocol ``on_decision(kind, payload, now)`` alongside
the existing ``on_request / on_transition / on_token`` callbacks.

The :class:`FlightRecorder` is an observer that records those callbacks
as a monotonically-sequenced event stream with bounded memory (a ring
buffer plus an optional JSONL sink).  On top of the stream this module
provides:

* a hand-rolled schema validator (``validate_log`` / the
  ``python -m repro_torch.serving.flightrecorder validate`` CLI) so CI can
  assert recorded logs stay well-formed without a jsonschema dependency;
* a Perfetto / ``chrome://tracing`` exporter (``to_chrome_trace``)
  rendering per-instance device busy lanes, KV-stream transfer lanes,
  and per-request spans from the same events, and with the engine's
  trace (``repro_torch.utils.trace``) one host lane per instance;
* ``token_timelines`` — the per-request token-emission times a replay
  (:mod:`repro_torch.sim.replay`) must reproduce bit-identically.

Zero overhead when unobserved: the session only builds decision payloads
when at least one attached observer defines ``on_decision`` (see
``ServeSession._dec``), so an unobserved run allocates no event objects.

Event envelope (one JSON object per line in a dumped log)::

    {"seq": 17, "t": 0.4821, "kind": "place", "data": {...}}

``seq`` is strictly increasing per recorder; ``t`` is the session clock
(virtual seconds on the sim, wall seconds on an engine).
"""
from __future__ import annotations

import json
import threading
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Union

__all__ = [
    "FlightRecorder", "EVENT_SCHEMAS", "validate_event", "validate_log",
    "load_events", "token_timelines", "to_chrome_trace",
    "export_chrome_trace",
]

_NUM = (int, float)
_OPT_STR = (str, type(None))
_OPT_NUM = (int, float, type(None))

# kind -> {required data field: allowed types}.  Extra fields are
# allowed (forward compatibility); missing or mistyped ones fail
# validation.
EVENT_SCHEMAS: Dict[str, Dict[str, tuple]] = {
    "meta": {"backend": (dict,), "policy": (dict,), "cfg": (dict,),
             "version": (int,)},
    "request": {"rid": (str,), "arrival": _NUM, "prefill": (int,),
                "decode": (int,), "predicted_decode": (int,),
                "slo": _OPT_STR, "cacheable": (bool,)},
    "transition": {"rid": (str,), "old": (str,), "new": (str,)},
    "token": {"rid": (str,)},
    "admit": {"rid": (str,), "verdict": (str,), "reason": _OPT_STR},
    "place": {"rid": (str,), "micros": (list,)},
    "batch": {"iid": (int,), "prefill": (list,), "decode": (list,),
              "predicted_latency": _NUM, "budget": (int,),
              "slo_eff": _NUM, "starved": (bool,),
              "cached_tokens": (int,)},
    "exec": {"iid": (int,), "t0": _NUM, "latency": _NUM,
             "device_time": _NUM, "prefill": (list,), "decode": (list,)},
    "preempt": {"rid": (str,), "req": (str,), "iid": (int,),
                "cause": (str,), "evicted_tokens": (int,)},
    "recompute": {"rid": (str,), "req": (str,), "iid": (int,),
                  "cause": (str,)},
    "handoff": {"rid": (str,), "req": (str,), "src": _OPT_STR,
                "src_iid": _OPT_NUM, "dst_iid": (int,), "pos": (int,),
                "ready": _NUM, "exposed": _NUM, "nbytes": _NUM},
    "handoff_chunk": {"rid": (str,), "i": (int,), "nbytes": _NUM},
    "evict": {"iid": (int,), "count": (int,)},
    "scale": {"iid": (int,), "action": (str,), "direction": (str,)},
    "migrate": {"src": (int,), "dst": (int,), "moved": (int,),
                "rids": (list,), "bytes": _NUM},
    "pool_action": {"action": (str,), "reason": (str,)},
}

_MICRO_FIELDS = {"iid": (int,), "role": (str,), "start": (int,),
                 "end": (int,), "prefill": (int,), "decode": (int,),
                 "pos": (int,), "waiting": (bool,)}


def validate_event(ev: dict, prev_seq: Optional[int] = None) -> List[str]:
    """Validate one event envelope + payload; returns a list of error
    strings (empty when valid)."""
    errs: List[str] = []
    if not isinstance(ev, dict):
        return [f"event is {type(ev).__name__}, not object"]
    for key, types in (("seq", (int,)), ("t", _NUM), ("kind", (str,)),
                       ("data", (dict,))):
        if key not in ev:
            errs.append(f"missing envelope field {key!r}")
        elif not isinstance(ev[key], types):
            errs.append(f"envelope field {key!r} has type "
                        f"{type(ev[key]).__name__}")
    if errs:
        return errs
    if prev_seq is not None and ev["seq"] <= prev_seq:
        errs.append(f"seq {ev['seq']} not > previous {prev_seq}")
    kind = ev["kind"]
    schema = EVENT_SCHEMAS.get(kind)
    if schema is None:
        errs.append(f"unknown kind {kind!r}")
        return errs
    data = ev["data"]
    for fld, types in schema.items():
        if fld not in data:
            errs.append(f"{kind}: missing data field {fld!r}")
        elif not isinstance(data[fld], types) or (
                isinstance(data[fld], bool) and bool not in types):
            errs.append(f"{kind}: field {fld!r} has type "
                        f"{type(data[fld]).__name__}")
    if kind == "place" and not errs:
        for i, mi in enumerate(data["micros"]):
            if not isinstance(mi, dict):
                errs.append(f"place: micros[{i}] not an object")
                continue
            for fld, types in _MICRO_FIELDS.items():
                if fld not in mi or not isinstance(mi[fld], types):
                    errs.append(f"place: micros[{i}].{fld} missing/bad")
    return errs


def validate_log(events: Iterable[dict]) -> List[str]:
    """Validate a whole event stream: per-event schemas plus global
    monotonic-seq ordering.  Returns all errors found."""
    errs: List[str] = []
    prev = None
    n = 0
    for i, ev in enumerate(events):
        n += 1
        for e in validate_event(ev, prev_seq=prev):
            errs.append(f"event[{i}]: {e}")
        if isinstance(ev, dict) and isinstance(ev.get("seq"), int):
            prev = ev["seq"]
    if n == 0:
        errs.append("empty log")
    return errs


def load_events(path: str) -> List[dict]:
    """Read a dumped JSONL decision log."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def token_timelines(events: Iterable[dict]) -> Dict[str, List[float]]:
    """Per-request token emission times — the ground truth a replay of
    the log must reproduce bit-identically."""
    out: Dict[str, List[float]] = {}
    for ev in events:
        if ev.get("kind") == "token":
            out.setdefault(ev["data"]["rid"], []).append(ev["t"])
    return out


# ---------------------------------------------------------------------------
# Recorder
# ---------------------------------------------------------------------------
class FlightRecorder:
    """Session observer recording lifecycle + decision events.

    Bounded memory: the newest ``capacity`` events stay in a ring
    (``dropped`` counts what fell out); an optional ``sink`` — a path or
    a callable — additionally receives every event, so a file sink keeps
    the full log while the ring serves live endpoints.
    """

    def __init__(self, capacity: int = 65536,
                 sink: Union[None, str, Callable[[dict], None]] = None,
                 record_tokens: bool = True):
        self._ring: deque = deque(maxlen=max(1, capacity))
        self._lock = threading.Lock()
        self._seq = 0
        self.dropped = 0
        self.record_tokens = record_tokens
        self._sink_fn: Optional[Callable[[dict], None]] = None
        self._sink_file = None
        if callable(sink):
            self._sink_fn = sink
        elif sink is not None:
            self._sink_file = open(sink, "w")

    # -- attachment --------------------------------------------------
    def attach(self, session) -> "FlightRecorder":
        """Register on ``session.observers`` and record the ``meta``
        event (backend/policy/config) a replay needs to rebuild the
        same world."""
        cfg = session.cfg
        policy = session.policy
        describe = getattr(session.backend, "describe", None)
        self._record("meta", {
            "version": 1,
            "backend": dict(describe()) if describe is not None else {},
            "policy": {
                "name": type(policy).__name__,
                "slo": getattr(policy, "slo", cfg.slo),
                "transfer_chunk": getattr(policy, "transfer_chunk", None),
                "slo_aware_batching": getattr(policy, "slo_aware_batching",
                                              None),
                "pool_interval": getattr(policy, "pool_interval", None),
            },
            "cfg": {
                "n_instances": cfg.n_instances,
                "slo": cfg.slo,
                "admission": cfg.admission,
                "open_loop": cfg.open_loop,
                "overlap": session._overlap,
                "pipeline_depth": cfg.pipeline_depth,
                "stream_chunk_tokens": cfg.stream_chunk_tokens,
                "max_sim_time": cfg.max_sim_time,
            },
        }, session.now)
        session.observers.append(self)
        return self

    # -- observer protocol -------------------------------------------
    def on_request(self, req, now: float) -> None:
        self._record("request", {
            "rid": req.rid, "arrival": req.arrival, "prefill": req.P,
            "decode": req.D,
            "predicted_decode": req.D_pred,
            "slo": req.slo.name if req.slo is not None else None,
            "cacheable": getattr(req, "prompt_tokens", None) is not None,
        }, now)

    def on_transition(self, req, old: str, new: str, now: float) -> None:
        self._record("transition",
                     {"rid": req.rid, "old": old, "new": new}, now)

    def on_token(self, req, now: float) -> None:
        if self.record_tokens:
            self._record("token", {"rid": req.rid}, now)

    def on_decision(self, kind: str, payload: dict, now: float) -> None:
        self._record(kind, payload, now)

    # -- recording ----------------------------------------------------
    def _record(self, kind: str, data: dict, t: float) -> None:
        with self._lock:
            self._seq += 1
            ev = {"seq": self._seq, "t": t, "kind": kind, "data": data}
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(ev)
            if self._sink_fn is not None:
                self._sink_fn(ev)
            elif self._sink_file is not None:
                self._sink_file.write(json.dumps(ev) + "\n")

    # -- access --------------------------------------------------------
    def events(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)

    def dump(self, path: str) -> int:
        evs = self.events()
        with open(path, "w") as f:
            for ev in evs:
                f.write(json.dumps(ev) + "\n")
        return len(evs)

    def close(self) -> None:
        if self._sink_file is not None:
            self._sink_file.close()
            self._sink_file = None


# ---------------------------------------------------------------------------
# Perfetto / chrome://tracing exporter
# ---------------------------------------------------------------------------
def _us(t: float) -> float:
    return t * 1e6


def to_chrome_trace(events: Iterable[dict],
                    spans: Optional[dict] = None) -> dict:
    """Render a decision log as a Chrome-trace JSON object (loads in
    Perfetto and ``chrome://tracing``): per-instance device busy lanes
    from ``exec`` events (the steps' device time where the engine was
    traced, else their host latency), KV-stream transfer lanes from
    ``handoff``/``handoff_chunk``, async per-request spans from
    lifecycle transitions, and instant markers for preemption, eviction
    and elastic scale events.  ``spans``: what
    ``repro_torch.utils.trace.take()`` handed over for the same run,
    drawn as one host lane per instance (``host-<iid>``; spans of no
    instance on ``host``), mapped onto the session clock by its
    ``zero_ns``."""
    evs = list(events)
    pid = 1
    out: List[dict] = [{"name": "process_name", "ph": "M", "pid": pid,
                        "tid": 0, "args": {"name": "dynaserve"}}]
    t0 = min((e["t"] for e in evs), default=0.0)

    def ts(t: float) -> float:
        return _us(t - t0)

    # device lanes
    for e in evs:
        d = e["data"]
        if e["kind"] == "exec":
            n_pf = sum(g for _, g, *_ in d["prefill"])
            out.append({
                "name": f"batch p{n_pf} d{len(d['decode'])}",
                "ph": "X", "pid": pid, "tid": f"instance-{d['iid']}",
                "ts": ts(d["t0"]), "dur": _us(d["device_time"]),
                "args": {"prefill_tokens": n_pf,
                         "decodes": len(d["decode"]),
                         "latency_s": d["latency"]},
            })
        elif e["kind"] in ("preempt", "recompute", "evict", "scale",
                           "migrate", "pool_action"):
            out.append({
                "name": f"{e['kind']}:{d.get('cause') or d.get('action', '')}",
                "ph": "i", "s": "g", "pid": pid, "tid": "events",
                "ts": ts(e["t"]), "args": d,
            })

    # engine host lanes: the trace's spans on the session clock
    if spans and spans.get("zero_ns") is not None:
        zero = spans["zero_ns"]
        for _, name, a, b, parent, key, iid, attrs in spans["spans"]:
            args = {"key": key, "parent": parent}
            args.update(attrs or {})
            out.append({
                "name": name, "ph": "X", "pid": pid,
                "tid": "host" if iid is None else f"host-{iid}",
                "ts": ts((a - zero) * 1e-9), "dur": (b - a) * 1e-3,
                "args": args})

    # KV-stream lanes: handoff emission -> last chunk (or +exposed)
    chunks: Dict[str, List[float]] = {}
    for e in evs:
        if e["kind"] == "handoff_chunk":
            chunks.setdefault(e["data"]["rid"], []).append(e["t"])
    for e in evs:
        if e["kind"] != "handoff":
            continue
        d = e["data"]
        end = max(chunks.get(d["rid"], [e["t"] + d["exposed"]]))
        out.append({
            "name": f"kv {d['req']}", "ph": "X", "pid": pid,
            "tid": "kv-streams", "ts": ts(e["t"]),
            "dur": max(1.0, _us(end - e["t"])),
            "args": {"nbytes": d["nbytes"], "src_iid": d["src_iid"],
                     "dst_iid": d["dst_iid"], "exposed_s": d["exposed"]},
        })

    # request spans (async b/e pairs keyed by rid)
    starts: Dict[str, float] = {}
    for e in evs:
        if e["kind"] == "request":
            starts[e["data"]["rid"]] = e["t"]
    terminal = {"done", "cancelled", "rejected"}
    for e in evs:
        if e["kind"] == "transition" and e["data"]["new"] in terminal:
            rid = e["data"]["rid"]
            if rid in starts:
                out.append({"name": rid, "cat": "request", "ph": "b",
                            "id": rid, "pid": pid, "tid": "requests",
                            "ts": ts(starts.pop(rid))})
                out.append({"name": rid, "cat": "request", "ph": "e",
                            "id": rid, "pid": pid, "tid": "requests",
                            "ts": ts(e["t"]),
                            "args": {"outcome": e["data"]["new"]}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def export_chrome_trace(events: Iterable[dict], path: str,
                        spans: Optional[dict] = None) -> int:
    trace = to_chrome_trace(events, spans)
    with open(path, "w") as f:
        json.dump(trace, f)
    return len(trace["traceEvents"])


# ---------------------------------------------------------------------------
# CLI: python -m repro_torch.serving.flightrecorder validate|perfetto LOG [OUT]
# ---------------------------------------------------------------------------
def _main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="repro_torch.serving.flightrecorder",
        description="validate or export a recorded decision log")
    sub = ap.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("validate", help="schema-validate a JSONL log")
    v.add_argument("log")
    p = sub.add_parser("perfetto",
                       help="export a Chrome-trace/Perfetto JSON timeline")
    p.add_argument("log")
    p.add_argument("out")
    args = ap.parse_args(argv)
    events = load_events(args.log)
    if args.cmd == "validate":
        errs = validate_log(events)
        if errs:
            for e in errs[:50]:
                print(f"INVALID: {e}")
            print(f"{len(errs)} error(s) in {len(events)} events")
            return 1
        kinds: Dict[str, int] = {}
        for ev in events:
            kinds[ev["kind"]] = kinds.get(ev["kind"], 0) + 1
        print(f"OK: {len(events)} events, "
              + ", ".join(f"{k}={n}" for k, n in sorted(kinds.items())))
        return 0
    n = export_chrome_trace(events, args.out)
    print(f"wrote {n} trace events to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
