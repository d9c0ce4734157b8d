"""The harness's observer on ``ServeSession.observers`` and the
arithmetic of the window's end-to-end numbers.

The observer keeps, for every request, its due time, when the session
admitted it, its lifecycle edges and the time of every token, all on the
session's clock.  Nothing is read from ``SessionMetrics``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

RUNNING = ("running_alpha", "running_beta")


@dataclasses.dataclass
class ReqLog:
    rid: str
    phase: str
    due: float
    ttft_limit: float
    tbt_limit: float
    decode_len: int
    admitted: Optional[float] = None     # on_request: when the loop took it
    running: Optional[float] = None      # first RUNNING_* edge
    handoffs: List[float] = dataclasses.field(default_factory=list)
    rejected: bool = False
    done: Optional[float] = None
    place_s: Optional[float] = None      # the policy's own decision time
    tokens: List[float] = dataclasses.field(default_factory=list)


class Recorder:
    """Session observer.  ``logs`` is filled from the trace before the run;
    ``marks`` takes a snapshot of the callables in ``probes`` the first
    time the clock passes each of ``mark_at`` (seconds); ``peak`` keeps
    the largest value each callable in ``peaks`` gave at any event."""

    def __init__(self, logs: Dict[str, ReqLog], policy=None,
                 mark_at: Sequence[float] = (), probes: Optional[dict] = None,
                 peaks: Optional[dict] = None):
        self.logs = logs
        self.policy = policy
        self._mark_at = sorted(mark_at)
        self.probes = probes or {}
        self.marks: List[Dict[str, float]] = []
        self.peaks = peaks or {}
        self.peak = {k: 0.0 for k in self.peaks}

    def _tick(self, now: float) -> None:
        for k, fn in self.peaks.items():
            self.peak[k] = max(self.peak[k], fn())
        while self._mark_at and now >= self._mark_at[0]:
            self._mark_at.pop(0)
            snap = {k: float(fn()) for k, fn in self.probes.items()}
            snap["t"] = now
            self.marks.append(snap)

    def close(self) -> None:
        """Snapshot now for every mark the clock never reached (a loop
        that ran out of work before the close)."""
        while self._mark_at:
            self._tick(self._mark_at[0])

    def on_request(self, req, now: float) -> None:
        self._tick(now)
        self.logs[req.rid].admitted = now

    def on_placed(self, req, placements, now: float) -> None:
        if self.policy is not None:
            self.logs[req.rid].place_s = float(self.policy.last_overhead)

    def on_transition(self, req, old: str, new: str, now: float) -> None:
        self._tick(now)
        log = self.logs[req.rid]
        if new in RUNNING and log.running is None:
            log.running = now
        elif new == "handoff":
            log.handoffs.append(now)
        elif new == "rejected":
            log.rejected = True
        elif new == "done":
            log.done = now

    def on_token(self, req, now: float) -> None:
        self._tick(now)
        self.logs[req.rid].tokens.append(now)


@dataclasses.dataclass
class Window:
    """What a metric's reader reads (``metrics/<name>.py``): the window
    on the session's clock, the request logs and, in a traced run, the
    engine steps and the profiler's slice."""
    w0: float
    w1: float
    logs: Dict[str, ReqLog]
    widths: dict
    page_size: int
    setup_s: float
    capture_s: float
    marks: List[Dict[str, float]]
    steps: Optional[list] = None         # probes.Step, traced run only
    trace: Optional[object] = None       # devtrace.Summary, traced run only
    kind: Optional[object] = None        # the model's reference/<kind>.py

    @property
    def seconds(self) -> float:
        return self.w1 - self.w0

    def mark(self, key: str, i: int) -> Optional[float]:
        return self.marks[i][key] if len(self.marks) > i else None


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """numpy's linear-interpolation percentile; None for no values."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, float), q))


def due_in(logs: Dict[str, ReqLog], w0: float, w1: float) -> List[ReqLog]:
    return [g for g in logs.values() if w0 <= g.due < w1]


def ttfts(logs: Dict[str, ReqLog], w0: float, w1: float) -> List[float]:
    """First-token time minus due time of every request due in the
    window; one with no first token by the close (refused ones too)
    counts with what it has waited so far."""
    out = []
    for g in due_in(logs, w0, w1):
        first = g.tokens[0] if g.tokens and g.tokens[0] < w1 else None
        out.append((first if first is not None else w1) - g.due)
    return out


def gaps(logs: Dict[str, ReqLog], w0: float, w1: float) -> List[float]:
    """Every gap between consecutive tokens of a request whose later
    token falls in the window, and each still-streaming request's open
    gap from its last token to the close."""
    out = []
    for g in logs.values():
        ts = [t for t in g.tokens if t < w1]
        out.extend(b - a for a, b in zip(ts, ts[1:]) if b >= w0)
        if ts and len(ts) < g.decode_len:
            out.append(w1 - ts[-1])
    return out


def tokens_in(logs: Dict[str, ReqLog], w0: float, w1: float):
    """(tokens emitted in the window, of them within their class's
    limits): a first token within its TTFT limit, a later one whose gap
    to the one before is within its TBT limit."""
    n = good = 0
    for g in logs.values():
        for i, t in enumerate(g.tokens):
            if not w0 <= t < w1:
                continue
            n += 1
            if i == 0:
                good += (t - g.due) <= g.ttft_limit
            else:
                good += (t - g.tokens[i - 1]) <= g.tbt_limit
    return n, good


def queue_waits(logs: Dict[str, ReqLog], w0: float, w1: float) -> List[float]:
    """Due time to the first RUNNING_* edge of every request due in the
    window (the close, for one not running by then)."""
    return [(g.running if g.running is not None and g.running < w1 else w1)
            - g.due for g in due_in(logs, w0, w1)]


def failed(logs: Dict[str, ReqLog], w0: float, w1: float,
           served: Dict[str, int]) -> List[str]:
    """Requests due in the window that were refused, or ended with
    another number of tokens than asked for.  ``served``: tokens the
    program returned, by request."""
    bad = []
    for g in due_in(logs, w0, w1):
        if g.rejected:
            bad.append(g.rid)
        elif g.done is not None and served.get(g.rid) != g.decode_len:
            bad.append(g.rid)
    return bad
