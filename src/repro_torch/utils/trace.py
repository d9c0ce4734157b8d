"""Spans, step records and the session's zero, below the session, on the
profiler's clock.

The engine level of ``repro_torch.serving.tracing`` (which re-exports
this module as ``engine``): the serving layer's ``Tracer`` keeps each
request's life on the session clock; this keeps what happens inside one
step and one loop turn.  It imports only the standard library, so the
engine imports it without the ``serving`` package.

One process-wide switch, ``enable()`` / ``disable()``; ``on`` says
which.  Off, a call site tests ``trace.on`` and does nothing else: no
span object, no clock read, no CUDA event.  A call site reads

    sp = trace.on and trace.begin("engine.pack", step, iid)
    ...
    if sp:
        trace.end(sp)

On, each span is one tuple in a bounded buffer, handed over by
``take()`` once the run is over (nothing is written on the hot path):

    (id, name, start_ns, end_ns, parent, key, iid, attrs)

``start_ns`` / ``end_ns`` are ``time.time_ns()``: Unix-epoch
nanoseconds, the clock on which ``torch.profiler`` stamps its host
events (``_KinetoEvent.start_ns``), so the spans share one timeline with
the profiler's kernels.  ``parent`` is the id of the span open on the
same thread when this one began (-1 for none), ``key`` the step id or
request id the span belongs to, ``iid`` the instance id (``None`` where
there is none), ``attrs`` a dict of extra fields or ``None``.  No span
enters the profiler: none is a ``record_function`` range, so none is
counted among its device operations.

Spans (name: where; what it covers):

    engine.dispatch  InstanceEngine.dispatch_batch: the whole call
    engine.pack        allocator.ensure, _apply_forks, layout.pack
    engine.stage       pin_memory and the inputs' H2D enqueue
    engine.launch      graph replay (or the eager forward) and the
                       logits clone
    engine.capture     one key's warm-up and capture (attrs T, the
                       key's bucket: a rung of a paged engine; n_pp)
    engine.collect   EngineBackend.collect: the whole call
    engine.wait        the host blocked on the step's end event
    engine.d2h         the logits copied to the host
    engine.sample      the sample loop over the step's sampled rows
    session.compose  ServeSession._compose_batch (the local scheduler)
    policy.place     ServeSession._on_arrival: split point and placement
    handoff.pump     EngineBackend.stream_pump: one KV piece (attrs bytes)
    handoff.sync     EngineBackend.do_handoff: a whole synchronous
                     handoff (attrs bytes)

Step records, one dict an engine step, opened at dispatch by the engine
and closed by ``ServeSession._on_batch_done``, where the plan and the
result meet: ``step``, ``iid``, ``t`` (session seconds at dispatch),
``T`` (the longest item's bucket in the engine's ``buckets``: 1 for a
decode-only step), ``N`` (rows computed), ``n_pp``, ``n_slots``,
``rows`` (real rows), ``prefill`` (its
tokens), ``decode`` (its rows), ``captured`` (the key was captured in
this step), ``host_s`` (dispatch to collect), ``predicted_s`` (the
plan's ``predicted_latency``) and ``device_s`` (CUDA events around the
step on the engine's stream; on the CPU, where the work runs in the
call, the ``engine.launch`` span's length).
"""
from __future__ import annotations

import collections
import itertools
import threading
import time

#: spans and step records kept; the oldest fall out past these
SPAN_CAP = 1 << 19
STEP_CAP = 1 << 17

on = False

_spans: collections.deque = collections.deque(maxlen=SPAN_CAP)
_steps: collections.deque = collections.deque(maxlen=STEP_CAP)
_ids = itertools.count()
_step_ids = itertools.count()
_local = threading.local()
_counts = {"spans": 0, "steps": 0}
_zero = {"ns": None}


def enable() -> None:
    """Empty the buffers and switch tracing on."""
    global on
    reset()
    on = True


def disable() -> None:
    global on
    on = False


def reset() -> None:
    _spans.clear()
    _steps.clear()
    _counts.update(spans=0, steps=0)
    _zero["ns"] = None
    _local.__dict__.pop("stack", None)


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def begin(name: str, key=None, iid=None) -> list:
    """Open a span on this thread; its parent is the innermost span open
    here.  Returns the open span, for ``end``."""
    stack = _stack()
    sp = [next(_ids), name, time.time_ns(), stack[-1][0] if stack else -1,
          key, iid]
    stack.append(sp)
    return sp


def end(sp: list, **attrs) -> int:
    """Close ``sp`` (and any span left open inside it by an exception);
    returns its length in nanoseconds."""
    t = time.time_ns()
    stack = _stack()
    while stack and stack.pop() is not sp:
        pass
    _spans.append((sp[0], sp[1], sp[2], t, sp[3], sp[4], sp[5],
                   attrs or None))
    _counts["spans"] += 1
    return t - sp[2]


def new_step() -> int:
    """The id of an engine step being dispatched."""
    return next(_step_ids)


def add_step(record: dict) -> None:
    """Keep one closed step record."""
    _steps.append(record)
    _counts["steps"] += 1


def set_zero(ns: int) -> None:
    """The session clock's zero on this module's clock."""
    _zero["ns"] = ns


def take() -> dict:
    """What was recorded since ``enable``: ``spans`` (tuples, in the order
    they closed), ``steps`` (records, in the order they closed),
    ``zero_ns`` (the session clock's zero, or None) and ``dropped`` (how
    many of each fell out of the buffers)."""
    return {"spans": list(_spans), "steps": list(_steps),
            "zero_ns": _zero["ns"],
            "dropped": {"spans": _counts["spans"] - len(_spans),
                        "steps": _counts["steps"] - len(_steps)}}
