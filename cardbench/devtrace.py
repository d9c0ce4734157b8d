"""Reading the profiler's slice: device busy time, device time by
operation name, and the idle gaps named by the host range that was open
when each began.

Device operations are the profiler's CUDA-side events (kernels, copies,
sets), those of graph replays included; host ranges are the
``record_function`` ranges of ``probes.RANGES``.  Both come on one
timeline, in microseconds from the profiler's start.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Tuple

from cardbench.probes import RANGES

TOP = 10


@dataclasses.dataclass
class Summary:
    busy_s: float
    window_s: float
    by_name: Dict[str, float]                # device seconds by op name
    gaps: List[Tuple[str, float]]            # (host range, seconds)

    def device_s(self, fragment: str) -> float:
        return sum(s for n, s in self.by_name.items() if fragment in n)

    def top_ops(self) -> List[List]:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n[:160], s] for n, s in ops]

    def top_gaps(self) -> List[List]:
        return [[n, s] for n, s in sorted(self.gaps, key=lambda g: -g[1])[:TOP]]

    def gaps_by_range(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for n, s in self.gaps:
            out[n] += s
        return dict(out)


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def label_at(ranges: List[Tuple[float, float, str]], t: float) -> str:
    """The innermost host range open at t (the latest-starting one that
    contains it); ``host.other`` when none is."""
    starts = [r[0] for r in ranges]
    i = bisect.bisect_right(starts, t)
    best = None
    for a, b, name in reversed(ranges[max(0, i - 64):i]):
        if a <= t < b and (best is None or a > best[0]):
            best = (a, b, name)
    return best[2] if best else "host.other"


def summarize(device_ops: List[Tuple[str, float, float]],
              host_ranges: List[Tuple[float, float, str]],
              window_s: float) -> Summary:
    """``device_ops``: (name, start us, end us); ``host_ranges``: (start
    us, end us, name); ``window_s``: the slice's length on the host."""
    by_name: Dict[str, float] = defaultdict(float)
    for name, a, b in device_ops:
        by_name[name] += (b - a) * 1e-6
    busy = merge([(a, b) for _, a, b in device_ops])
    ranges = sorted(host_ranges)
    gaps = [(label_at(ranges, prev_end), (a - prev_end) * 1e-6)
            for (_, prev_end), (a, _) in zip(busy, busy[1:])]
    return Summary(busy_s=sum(b - a for a, b in busy) * 1e-6,
                   window_s=window_s, by_name=dict(by_name), gaps=gaps)


def from_profiler(prof, window_s: float) -> Summary:
    """The slice of a stopped ``torch.profiler.profile``, read from the
    profiler's raw events (building its event tree would take minutes for
    a few seconds of serving)."""
    from torch.autograd import DeviceType
    ops, ranges = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        a = ev.start_ns() * 1e-3
        b = a + ev.duration_ns() * 1e-3
        if ev.device_type() == DeviceType.CUDA:
            if name not in RANGES:           # the ranges' GPU-side echoes
                ops.append((name, a, b))
        elif name in RANGES:
            ranges.append((a, b, name))
    return summarize(ops, ranges, window_s)
