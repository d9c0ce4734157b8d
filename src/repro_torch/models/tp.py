"""Tensor-parallel context for the model forward, on torch.

Mirrors ``repro.models.tp``.  The forward functions in ``layers.py`` /
``mixers.py`` are written against *local* parameter shards: a shard's
attention and MLP products see only its slice of the head / ffn / expert
dims, and the output projections must sum over the shards so that the
residual adds see replicated activations.  Whether a sum is needed is
decided where it happens: every collective site consults ``tp_axis()``
*and* compares the local parameter width with the config's global dim —
a dim that did not divide the width is replicated, computes the full
output on every shard, and must NOT be summed.

Where the reference runs one program per device inside ``shard_map`` and
``psum``s, a sharded instance of the port runs one worker thread per
shard in one process (``ShardGroup``): every step runs the unchanged step
body on each shard's thread with its own params view, cache shard and
device, and the collective sites call ``all_reduce``, which sums the
shards' partial outputs in shard order.  An engine whose shards share
one card captures a step's turns once into a CUDA graph
(``engine.runner``); its replays take no turn.  The
context is thread-local, so the shard threads of one instance and a
one-device instance on the caller's thread never see each other's.

``RecordingGroup`` is the dryrun's group: it runs one shard's body on
the caller's thread, gives each collective's input back as its result,
and records each collective's kind, bytes and axis, so a trace of one
shard shows that device's share of the work and its traffic.
"""
from __future__ import annotations

import concurrent.futures
import queue
import threading
from contextlib import contextmanager, nullcontext
from typing import Callable, ContextManager, List, Optional

import torch

_local = threading.local()


def tp_axis() -> Optional["ShardGroup"]:
    """The shard group of the step running on this thread, or None."""
    return getattr(_local, "group", None)


def tp_rank() -> int:
    """This thread's shard index within ``tp_axis()`` (0 outside one)."""
    return getattr(_local, "rank", 0)


@contextmanager
def tp_context(group: "ShardGroup", rank: int):
    """Mark the enclosed forward as shard ``rank`` of ``group``: its
    output projections sum over the group where params are sharded."""
    prev = (tp_axis(), tp_rank())
    _local.group, _local.rank = group, rank
    try:
        yield
    finally:
        _local.group, _local.rank = prev


def all_reduce(t, op: str = "sum"):
    """``op`` ("sum" or "max") of ``t`` over the shards of the active
    group, taken in shard order, on this shard's device (every shard of
    the group must call it, with the same ``op``)."""
    if op not in _REDUCE:
        raise ValueError(f"unknown reduction {op!r}")
    return _local.group.all_reduce(_local.rank, t, op)


_REDUCE = {"sum": lambda a, b: a + b, "max": torch.maximum}


def all_gather(t, dim: int):
    """The shards' ``t`` concatenated along ``dim`` in shard order, on
    this shard's device."""
    return _local.group.all_gather(_local.rank, t, dim)


class ShardGroup:
    """The ``n`` shards of one sharded instance: ``n`` persistent worker
    threads, one per shard, that take turns.

    ``run(fn)`` calls ``fn(rank)`` on worker ``rank`` inside
    ``tp_context(self, rank)`` and returns the results in shard order;
    ``run(fn, context)`` also enters ``context(rank)`` on worker ``rank``
    around it, in the shard's turn (a capture makes its stream every
    shard thread's current stream so).
    One shard runs at a time: shard 0 runs up to its first
    ``all_reduce`` and hands the turn to shard 1, and so on; the last
    shard to post its partial sums the partials once for each distinct
    device of the group (``p_0 + p_1 + ...``, always in shard order) and
    hands the turn back to shard 0, and every shard takes the sum on its
    device (shards on one device share that tensor).  The shards' host
    work (Python and kernel launches) thus never contends for the
    interpreter lock; the device runs each shard's kernels in the order
    they were launched.  If a shard raises, the group is
    broken: every shard waiting for its turn raises
    ``BrokenBarrierError``, and ``run`` waits for every shard, raises the
    first shard's own error (not the aborts it caused), and leaves the
    group ready for the next step.

    ``all_gather`` takes the same turns and concatenates the shards'
    tensors in shard order.  ``seq_shard``: each shard's dense cache
    holds a slice of the sequence, not of the KV heads; decode then
    merges flash-decoding statistics over the group
    (``mixers._flash_decode_seqsharded``)."""

    def __init__(self, n: int, name: str = "shard", seq_shard: bool = False):
        self.n = n
        self.seq_shard = seq_shard
        self._closed = False
        self._cond = threading.Condition()
        self._turn = 0
        self._broken = False
        self._parts: List = [None] * n
        self._sums: dict = {}
        self._jobs = [queue.SimpleQueue() for _ in range(n)]
        self._threads = [
            threading.Thread(target=self._work, args=(r,), daemon=True,
                             name=f"{name}-{r}") for r in range(n)]
        for t in self._threads:
            t.start()

    # ---- turns and the collective ----
    def _wait_turn(self, rank: int) -> None:
        with self._cond:
            self._cond.wait_for(lambda: self._turn == rank or self._broken)
            if self._broken:
                raise threading.BrokenBarrierError

    def _pass(self, to: int) -> None:
        with self._cond:
            self._turn = to
            self._cond.notify_all()

    def _abort(self) -> None:
        with self._cond:
            self._broken = True
            self._cond.notify_all()

    def _reduce(self, f) -> None:
        sums = {}
        for dev in dict.fromkeys(p.device for p in self._parts):
            acc = self._parts[0].to(dev)
            for p in self._parts[1:]:
                acc = f(acc, p.to(dev))
            sums[dev] = acc
        self._sums = sums

    def all_reduce(self, rank: int, t, op: str = "sum"):
        return self._collect(rank, t, _REDUCE[op])

    def all_gather(self, rank: int, t, dim: int):
        return self._collect(rank, t, lambda a, b: torch.cat([a, b], dim))

    def _collect(self, rank: int, t, f):
        """``f`` folded over the shards' ``t`` in shard order."""
        self._parts[rank] = t
        if rank == self.n - 1:
            self._reduce(f)
            self._pass(0)
        else:
            self._pass(rank + 1)
        self._wait_turn(rank)
        return self._sums[t.device]

    # ---- the workers ----
    def _work(self, rank: int) -> None:
        jobs = self._jobs[rank]
        while True:
            job = jobs.get()
            if job is None:
                return
            self._do(rank, *job)
            del job      # hold nothing of the step while idle

    def _do(self, rank: int, fn, context, fut) -> None:
        try:
            self._wait_turn(rank)
            with tp_context(self, rank), \
                    (context(rank) if context else nullcontext()):
                result = fn(rank)
            self._pass(rank + 1)         # after the last shard: turn n
            fut.set_result(result)
        except BaseException as e:       # re-raised by run() in the caller
            self._abort()
            fut.set_exception(e)

    def run(self, fn: Callable[[int], object],
            context: Optional[Callable[[int], ContextManager]] = None) \
            -> list:
        if self._closed:
            raise RuntimeError("the shard group is closed")
        with self._cond:
            self._turn, self._broken = 0, False
        futs = [concurrent.futures.Future() for _ in range(self.n)]
        for jobs, fut in zip(self._jobs, futs):
            jobs.put((fn, context, fut))
        concurrent.futures.wait(futs)
        self._parts = [None] * self.n
        self._sums = {}
        errors = [f.exception() for f in futs if f.exception() is not None]
        if errors:
            own = [e for e in errors
                   if not isinstance(e, threading.BrokenBarrierError)]
            raise (own or errors)[0]
        return [f.result() for f in futs]

    def close(self) -> None:
        """Stop the worker threads (idempotent)."""
        if self._closed:
            return
        self._closed = True
        for jobs in self._jobs:
            jobs.put(None)
        for t in self._threads:
            if t is not threading.current_thread():
                t.join()


class _Recorded(torch.autograd.Function):
    """Identity that records a collective in the forward and its
    conjugate in the backward: the gradient of a tensor-parallel sum's
    input is summed over the group again (Megatron's ``f`` and ``g``)."""

    @staticmethod
    def forward(ctx, t, group, op):
        ctx.group = group
        group.record("all-reduce", t, group.axis, op=op)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        ctx.group.record("all-reduce", g, ctx.group.axis, op="sum")
        return g, None, None


class RecordingGroup:
    """The dryrun's stand-in for the ``n`` shards of one model axis: it
    runs shard ``rank``'s body alone, on the caller's thread.  A
    collective returns its own input (one shard's unsummed partial, of
    the summed shape) and appends ``{"kind", "op", "axis", "bytes"}`` to
    ``records``; under autograd a sum records its conjugate in the
    backward too.  The shard's values are partials, but its shapes,
    operations and bytes are one device's true share.  ``seq_shard`` as
    in ``ShardGroup``."""

    def __init__(self, n: int, axis: str = "model", rank: int = 0,
                 seq_shard: bool = False):
        self.n, self.axis, self.rank = n, axis, rank
        self.seq_shard = seq_shard
        self.records: List[dict] = []

    def record(self, kind: str, t, axis, op: Optional[str] = None) -> None:
        """Count one collective of ``t`` (a tensor, or a byte count)."""
        nbytes = t if isinstance(t, int) else t.numel() * t.element_size()
        self.records.append({"kind": kind, "op": op, "axis": axis,
                             "bytes": nbytes})

    def all_reduce(self, rank: int, t, op: str = "sum"):
        if torch.is_grad_enabled() and t.requires_grad:
            return _Recorded.apply(t, self, op)
        self.record("all-reduce", t, self.axis, op=op)
        return t

    def all_gather(self, rank: int, t, dim: int):
        """``t`` repeated ``n`` times along ``dim``: the gathered shape."""
        out = torch.cat([t] * self.n, dim)
        self.record("all-gather", out, self.axis)
        return out

    def run(self, fn: Callable[[int], object]) -> list:
        """``[fn(rank)]``, run on this thread as shard ``rank``."""
        with tp_context(self, self.rank):
            return [fn(self.rank)]
