"""What the traced run (``--trace 1``) adds around the program's calls,
from the benchmark's own files: host ranges at the layer boundaries, a
tally of every engine step, and the profiler's slice of the window.

The program is left as it is: each probe wraps a method for the life of
the run and puts it back after.  The untraced run installs none of them.

Host ranges (``torch.profiler.record_function``, so they sit on the
profiler's timeline beside the kernels): ``session.pump`` (one event of
the session's loop), ``policy.place`` (split point and placement),
``engine.dispatch`` (``InstanceEngine.dispatch_batch``: packing, staging,
the replay), ``engine.collect`` (``EngineBackend.collect``: the logits to
the host and ``sample``), ``handoff.pump`` (one piece of a KV stream, or a
whole synchronous handoff).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import torch

RANGES = ("session.pump", "policy.place", "engine.dispatch",
          "engine.collect", "handoff.pump")


@dataclasses.dataclass
class Step:
    t: float                               # session clock at dispatch
    T: int                                 # the engine's T bucket
    n_pp: int                              # its pages bucket
    n_slots: int
    items: List[Tuple[int, int, bool]]     # (tokens, first position, logits)
    traced: bool                           # inside the profiler's slice


class Slice:
    """The profiler from ``t0`` on the session's clock to the loop's end,
    started from the engine's dispatch (the loop's busiest call) and
    stopped once the loop has returned, each after a device
    synchronisation, so the slice holds exactly the kernels of the steps
    dispatched inside it, and reading it costs the window nothing."""

    def __init__(self, t0: float):
        self.t0 = t0
        self.prof = None
        self.state = "before"
        self.host_s = 0.0
        self._start = 0.0

    def tick(self, now: float) -> None:
        if self.state == "before" and now >= self.t0:
            torch.cuda.synchronize()
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()
            self._start = time.perf_counter()
            self.state = "on"

    def stop(self) -> None:
        if self.state != "on":
            return
        torch.cuda.synchronize()
        self.host_s = time.perf_counter() - self._start
        self.prof.stop()
        self.state = "done"

    @property
    def on(self) -> bool:
        return self.state == "on"


def warm_profiler(device) -> None:
    """One tiny profile in set-up, so the first real one does not pay
    CUPTI's start inside the window."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize()


class Patches:
    """Methods of the program wrapped for a while and put back exactly:
    a class's attribute, or an instance's own (which shadows its
    class's), in the reverse order of patching."""

    def __init__(self):
        self._saved = []

    def __call__(self, obj, name, make):
        own = vars(obj).get(name, Patches)
        self._saved.append((obj, name, own))
        setattr(obj, name, make(getattr(obj, name)))

    def restore(self):
        for obj, name, own in reversed(self._saved):
            if own is Patches:
                delattr(obj, name)
            else:
                setattr(obj, name, own)
        self._saved.clear()


@contextlib.contextmanager
def installed(session, backend, clock: Callable[[], float],
              trace_slice: Optional[Slice]):
    """Wrap the program's calls for the run; yields the list of steps."""
    from repro_torch.engine.runner import InstanceEngine, bucket_of
    steps: List[Step] = []
    patch = Patches()

    def ranged(label):
        def make(orig):
            def call(*a, **k):
                with torch.profiler.record_function(label):
                    return orig(*a, **k)
            return call
        return make

    def dispatch(orig):
        def call(self, items):
            now = clock()
            if trace_slice is not None:
                trace_slice.tick(now)
            with torch.profiler.record_function("engine.dispatch"):
                handle = orig(self, items)
            if items:
                T = bucket_of(max(len(it.tokens) for it in items),
                              self.buckets)
                n_pp = bucket_of(max(1, self.allocator.max_table_len),
                                 self.page_buckets) if self.paged else 0
                steps.append(Step(
                    now, T, n_pp, self.n_slots,
                    [(len(it.tokens), int(it.pos_offset), bool(it.want_logits))
                     for it in items],
                    trace_slice is not None and trace_slice.on))
            return handle
        return call

    patch(InstanceEngine, "dispatch_batch", dispatch)
    patch(session, "_pump", ranged("session.pump"))
    patch(session.policy, "place", ranged("policy.place"))
    patch(backend, "collect", ranged("engine.collect"))
    patch(backend, "stream_pump", ranged("handoff.pump"))
    patch(backend, "do_handoff", ranged("handoff.pump"))
    try:
        yield steps
    finally:
        patch.restore()
        if trace_slice is not None:
            trace_slice.stop()
