"""The program's own spans and step records in the traced run
(``--trace 1``), and the card's idle time charged to the host phase that
kept it waiting.

``repro_torch.utils.trace`` keeps spans at the engine's and the session's
layer boundaries and one record an engine step, stamped on the clock of
the profiler's host events.  ``install()`` (each reader of them calls it
when loaded) wraps two of the harness's functions, which only a traced
run calls: ``probes.installed``, to switch the program's tracing on for
the run and take what it kept after the loop, and
``devtrace.from_profiler``, to read the profiler's raw device intervals
beside its summary.  A program without ``repro_torch.utils.trace`` runs
as before, and the readers find nothing (``of`` gives ``None``).

Every idle nanosecond of the profiler's slice is charged to the innermost
program span open at that nanosecond (the latest-starting one), or to
``host.other`` where none is; the spans' names fall in three classes:
``dispatch`` (``engine.dispatch`` and its children), ``collect``
(``engine.collect`` and its children) and ``loop`` (every other span and
``host.other``), which add up to the slice's idle time.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import heapq
import importlib
import statistics
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

from cardbench import devtrace, probes

DISPATCH = ("engine.dispatch", "engine.pack", "engine.stage",
            "engine.launch", "engine.capture")
COLLECT = ("engine.collect", "engine.wait", "engine.d2h", "engine.sample")
CLASSES = ("dispatch", "collect", "loop")
#: slack at either end of a program span inside the harness's range
SLACK_NS = 50_000

Interval = Tuple[int, int]


def class_of(name: str) -> str:
    if name in DISPATCH:
        return "dispatch"
    if name in COLLECT:
        return "collect"
    return "loop"


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


@dataclasses.dataclass(eq=False)
class ProgramTrace:
    """What the program kept in one traced run, by the harness's list of
    steps of the same run (``Window.steps``); with the profiler's slice,
    its idle time by class."""
    steps_ref: list
    trace_slice: object = None
    s0_ns: Optional[int] = None          # the slice's start, epoch ns
    spans: list = dataclasses.field(default_factory=list)
    records: list = dataclasses.field(default_factory=list)
    zero_ns: Optional[int] = None        # the session clock's zero
    idle_ns: Optional[Dict[str, int]] = None   # by class
    window_ns: Optional[int] = None


_RUNS: List[ProgramTrace] = []


def _program_trace():
    """The program's tracing module, or None where it has none."""
    try:
        return importlib.import_module("repro_torch.utils.trace")
    except ImportError:
        return None


def of(run) -> Optional[ProgramTrace]:
    """The program's trace of the run that ``run`` (a ``record.Window``)
    reads, or None."""
    if run.steps is None:
        return None
    for pt in reversed(_RUNS):
        if pt.steps_ref is run.steps:
            return pt
    return None


def steps_in(run) -> list:
    """The program's step records dispatched in the window and collected
    before the profiler's slice began: the profiler slows a graph's launch
    several times over, which the steps inside the slice would take into
    their times."""
    pt = of(run)
    if pt is None:
        return []
    w1 = run.w1
    if pt.s0_ns is not None and pt.zero_ns is not None:
        w1 = min(w1, (pt.s0_ns - pt.zero_ns) * 1e-9)
    return [r for r in pt.records
            if run.w0 <= r["t"] and r["t"] + r["host_s"] < w1]


def idle_share(run, cls: str) -> Optional[float]:
    """Idle time charged to ``cls``, in percent of the slice."""
    pt = of(run)
    if pt is None or pt.idle_ns is None or not pt.window_ns:
        return None
    return pt.idle_ns[cls] / pt.window_ns * 100.0


def merge(intervals: Sequence[Interval]) -> List[Interval]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_of(busy: Sequence[Interval], s0: int, s1: int) -> List[Interval]:
    """[s0, s1) less the union of ``busy``."""
    out, t = [], s0
    for a, b in merge(busy):
        if b <= t:
            continue
        if a >= s1:
            break
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < s1:
        out.append((t, s1))
    return out


def attribute(idle: Sequence[Interval],
              spans: Sequence[Tuple[int, int, str]]) -> Dict[str, int]:
    """Nanoseconds of ``idle`` (disjoint, sorted) by the name of the
    innermost span open there (``spans``: (start, end, name); the
    latest-starting, and of two that start together the one that ends
    first), ``host.other`` where none is open.  Every idle nanosecond is
    charged once."""
    points = sorted({p for a, b in idle for p in (a, b)}
                    | {p for a, b, _ in spans for p in (a, b)})
    starts = sorted(range(len(spans)), key=lambda i: spans[i][0])
    out: Dict[str, int] = {}
    heap: list = []
    si = ii = 0
    for x, y in zip(points, points[1:]):
        while si < len(starts) and spans[starts[si]][0] <= x:
            i = starts[si]
            heapq.heappush(heap, (-spans[i][0], spans[i][1], i))
            si += 1
        while heap and heap[0][1] <= x:      # ended: no longer open
            heapq.heappop(heap)
        while ii < len(idle) and idle[ii][1] <= x:
            ii += 1
        if ii == len(idle) or idle[ii][0] > x:
            continue                          # the device was busy
        # open spans that ended before x but sit below the top stay in
        # the heap; the top is the latest-starting span still open
        name = spans[heap[0][2]][2] if heap else "host.other"
        out[name] = out.get(name, 0) + (y - x)
    return out


def by_class(charged: Dict[str, int]) -> Dict[str, int]:
    out = dict.fromkeys(CLASSES, 0)
    for name, ns in charged.items():
        out[class_of(name)] += ns
    return out


def contained(inner: Sequence[Interval], outer: Sequence[Interval],
              slack: int = SLACK_NS) -> Tuple[int, List[int]]:
    """How many of ``inner`` lie within one of ``outer`` (disjoint,
    sorted), with ``slack`` at either end; and for those, how far each
    starts after its outer one."""
    starts = [a for a, _ in outer]
    n, offsets = 0, []
    for a, b in inner:
        j = bisect.bisect_right(starts, a + slack) - 1
        if j >= 0 and outer[j][1] + slack >= b:
            n += 1
            offsets.append(a - outer[j][0])
    return n, offsets


def _read_profiler(pt: ProgramTrace, prof, window_s: float) -> None:
    """The slice's device intervals and the harness's ``engine.dispatch``
    ranges from the profiler's raw events; the idle time by class, and
    the checks that the program's spans and the profiler share a clock
    and that no program span reached the profiler."""
    from torch.autograd import DeviceType
    device, dispatch, cuda_names = [], [], set()
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        a = ev.start_ns()
        b = a + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            cuda_names.add(name)
            if name not in probes.RANGES:
                device.append((a, b))
        elif name == "engine.dispatch":
            dispatch.append((a, b))
    s0 = pt.s0_ns
    s1 = s0 + round(window_s * 1e9)
    inside = [(a, b, name) for _, name, a, b, *_ in pt.spans
              if b > s0 and a < s1]
    charged = attribute(idle_of(device, s0, s1), inside)
    pt.idle_ns, pt.window_ns = by_class(charged), s1 - s0
    idle = sum(charged.values())
    log(f"[spans] slice {pt.window_ns * 1e-9:.6f} s: idle {idle * 1e-9:.6f}"
        f" s, by class " + ", ".join(
            f"{c} {pt.idle_ns[c] * 1e-9:.6f}" for c in CLASSES)
        + "; by span " + ", ".join(
            f"{n} {ns * 1e-9:.6f}" for n, ns in sorted(
                charged.items(), key=lambda kv: -kv[1])))
    mine = [(a, b) for a, b, name in inside
            if name == "engine.dispatch" and a >= s0 and b <= s1]
    n, off = contained(mine, merge(dispatch))
    med = statistics.median(off) * 1e-3 if off else float("nan")
    log(f"[spans] same clock: {n} of {len(mine)} engine.dispatch spans in "
        f"the slice lie within the harness's range (slack "
        f"{SLACK_NS * 1e-3:g} us); median start offset {med:.3f} us")
    if pt.zero_ns is not None:
        # the steps share one stream, so their device times add up to
        # its occupancy: with and without the profiler running
        t0 = (s0 - pt.zero_ns) * 1e-9
        span = min(30.0, t0)
        before = sum(r["device_s"] for r in pt.records
                     if t0 - span <= r["t"] < t0)
        inside = sum(r["device_s"] for r in pt.records if r["t"] >= t0)
        log(f"[spans] the steps' device time: {before / span * 100:.3f}% of "
            f"the {span:g} s before the slice, {inside / window_s * 100:.3f}"
            f"% of the slice")
    names = {s[1] for s in pt.spans}
    log(f"[spans] program span names among the profiler's CUDA-side "
        f"events: {sorted(names & cuda_names)} (the harness's own ranges: "
        f"{sorted(set(probes.RANGES) & cuda_names)})")


def install() -> None:
    """Wrap ``probes.installed`` and ``devtrace.from_profiler`` (once)."""
    if getattr(probes.installed, "program_trace", False):
        return
    orig_installed, orig_read = probes.installed, devtrace.from_profiler

    @contextlib.contextmanager
    def installed(session, backend, clock, trace_slice):
        with orig_installed(session, backend, clock, trace_slice) as steps:
            program = _program_trace()
            if program is None:
                yield steps
                return
            pt = ProgramTrace(steps, trace_slice)
            if trace_slice is not None:
                tick = trace_slice.tick

                def tick_and_mark(now):
                    before = trace_slice.state
                    tick(now)
                    if before == "before" and trace_slice.state == "on":
                        pt.s0_ns = time.time_ns()
                trace_slice.tick = tick_and_mark
            program.enable()
            try:
                yield steps
            finally:
                program.disable()
                got = program.take()
                pt.spans, pt.records = got["spans"], got["steps"]
                pt.zero_ns = got["zero_ns"]
                _RUNS[:] = _RUNS[-3:] + [pt]
                log(f"[spans] {len(pt.spans)} spans and {len(pt.records)} "
                    f"step records kept; fell out: {got['dropped']}")

    def from_profiler(prof, window_s):
        summary = orig_read(prof, window_s)
        for pt in reversed(_RUNS):
            ts = pt.trace_slice
            if ts is not None and ts.prof is prof and pt.s0_ns is not None:
                _read_profiler(pt, prof, window_s)
                break
        return summary

    installed.program_trace = True
    probes.installed = installed
    devtrace.from_profiler = from_profiler
