"""One serving session, two substrates (the online serving API).

``ServeSession`` owns the full request lifecycle — arrival, admission
control, placement (global scheduler via the policy), per-instance batch
composition (local scheduler), KV handoff, streaming token delivery,
cancellation, completion — as ONE event loop.  What used to be written
twice (``sim.simulator.ClusterSim`` and ``engine.cluster.ServingCluster``
each had their own arrival→place→batch→handoff→finish loop) is now a
single driver parameterised by a ``Backend``:

* ``repro_torch.sim.simulator.SimBackend`` — virtual clock, per-batch latency
  from the analytic ``BatchCostModel``; completions are *deferred*
  events, so concurrent instances overlap in simulated time.
* ``repro_torch.engine.backend.EngineBackend`` — wall clock, real JAX engines;
  batches execute synchronously and emit real sampled tokens.

Because the policies (``repro_torch.sim.policies``) only ever talk to the
session surface (``instances``, ``release_beta``, ``add_instance`` …),
the two-level scheduler, the elastic pool controller, and every policy
run byte-identically against either backend.

Online API::

    session = ServeSession(backend, policy, SessionConfig(...))
    handle = session.generate(prompt, max_new_tokens=64, slo=INTERACTIVE)
    for token in handle:          # streams as the event loop advances
        ...
    session.cancel(handle.rid)    # frees slots, aborts pending handoffs

Offline/trace API (open-loop arrival-driven, both backends)::

    metrics = session.run(trace)  # SessionMetrics incl. per-SLO-class

Overlapped execution (``SessionConfig.overlap``): the session pipelines
up to ``pipeline_depth`` batches per instance — batch N+1 is composed
and dispatched (``Backend.dispatch``) while batch N's device work is in
flight, and alpha→beta KV handoffs run as chunked background streams
interleaved with decode instead of blocking the loop.  Composition only
ever draws from micro-requests NOT in flight (a stream's next step
issues strictly after its previous step completes), so the token
streams are identical to the synchronous path — only wall-clock and
exposed-transfer time change.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import time as _time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.costmodel import BatchCostModel, WorkItem
from repro_torch.core.kv_transfer import plan_background_stream
from repro_torch.core.local_scheduler import DecodeWork, LocalScheduler, PrefillWork
from repro_torch.core.metrics_util import pctl
from repro_torch.core.paging import pages_for
from repro_torch.core.predictor import ExecutionPredictor, QueuedWork
from repro_torch.core.request import (
    MicroRequest, Request, RequestState, SLOClass,
)

# Process-wide default for ``SessionConfig.overlap=None`` — the test
# harness flips this (pytest --overlap) to rerun every existing suite
# with the pipelined loop default-on.
DEFAULT_OVERLAP = False


def queued_view(inst: "InstanceState") -> List[QueuedWork]:
    """Project an instance's queues into the predictor's ``QueuedWork``
    terms — the one view both the policies (global scheduling) and the
    session (admission control) consume."""
    out = []
    for m in inst.prefill_q:
        out.append(QueuedWork(m.rid, m.prefill_remaining,
                              m.decode_remaining, m.pos))
    for m in inst.decode_q:
        out.append(QueuedWork(m.rid, 0, m.decode_remaining, m.pos))
    return out


class SessionStallError(RuntimeError):
    """The event loop reached a state where open requests exist but no
    instance can make progress (e.g. a beta whose KV handoff will never
    arrive, or work stranded on a fully-draining pool).  Raised instead
    of busy-looping or silently returning incomplete results."""


class HandoffStreamError(RuntimeError):
    """A background KV stream could not complete its import (e.g. the
    destination page pool ran out mid-stream).  Backends raise this from
    ``stream_pump``; the session aborts the stream, drops the partial
    import, and falls back to recompute."""


# ---------------------------------------------------------------------------
# Runtime state shared by both backends
# ---------------------------------------------------------------------------
@dataclasses.dataclass(eq=False)
class MicroState:
    """Runtime state of one micro-request on an instance."""
    mr: MicroRequest
    prefill_remaining: int
    decode_remaining: int
    pos: int                       # next absolute token position
    ready: float = 0.0
    iid: int = -1
    cancelled: bool = False
    # KV pages this micro borrows from the instance's shared-prefix
    # cache (claimed, pinned): they cost no prefill compute and are
    # counted ONCE per instance in admission commitments
    shared_pages: int = 0
    # High-water mark of positions lost to preemption / handoff
    # fallback: grants below it are *recomputed* work, which the flight
    # recorder attributes separately from first-time prefill
    recompute_hi: int = 0

    @property
    def rid(self) -> str:
        return self.mr.rid


@dataclasses.dataclass(eq=False)
class ExecHandle:
    """One dispatched batch, possibly still in flight on the substrate.

    ``token`` is the backend's opaque in-flight handle (``dispatch``
    returned it instead of an ``ExecResult``); ``result`` is filled at
    collection.  ``overlapped`` marks handles issued through the
    non-blocking ``dispatch`` path so completion bookkeeping
    (``Backend.on_complete``) fires exactly once per dispatch."""
    iid: int
    grants: List[Tuple[MicroState, int]]
    decs: List[MicroState]
    plan: object
    issued_at: float
    token: object = None
    result: Optional["ExecResult"] = None
    overlapped: bool = False

    @property
    def micros(self) -> set:
        return {m for m, _ in self.grants} | set(self.decs)


@dataclasses.dataclass(eq=False)
class TransferStream:
    """One in-flight background KV handoff (alpha → beta).

    Virtual backends model the stream as chunk-landing events at
    ``times`` (totals identical to the synchronous accounting); real
    backends pump ``token`` (a backend stream object) one piece per
    "xfer" event, double-buffered against the export.  The finished
    alpha (``src``) stays pinned — its slot is only released once the
    last chunk lands, so the export always reads live pages."""
    beta: MicroState
    src: Optional[MicroState] = None
    token: object = None
    t_ready: float = 0.0          # virtual: when the last chunk lands
    exposed: float = 0.0
    nbytes: float = 0.0
    times: List[float] = dataclasses.field(default_factory=list)
    chunk_i: int = 0
    sent: float = 0.0
    release_src: bool = False     # src micro finished; release at done
    done: bool = False
    aborted: bool = False


class InstanceState:
    """One pool member: queues + the local scheduler composing its
    batches.  The *execution substrate* behind it lives in the backend."""

    def __init__(self, iid: int, scheduler: LocalScheduler,
                 role: str = "unified", spawned_at: float = 0.0):
        self.iid = iid
        self.scheduler = scheduler
        self.role = role           # unified | prefill | decode
        self.prefill_q: List[MicroState] = []
        self.decode_q: List[MicroState] = []
        self.inflight: List[ExecHandle] = []   # dispatched, not collected
        # elastic lifecycle: active segments [(start, end|None), ...]
        self.draining = False
        self.retired = False
        self.segments: List[List[Optional[float]]] = [[spawned_at, None]]
        # accounting
        self.busy_time = 0.0
        self.flops_done = 0.0
        self.bytes_done = 0.0
        self.kv_tokens_resident = 0

    @property
    def busy(self) -> bool:
        return bool(self.inflight)

    @property
    def in_flight(self) -> set:
        """Micros inside any dispatched-but-uncollected batch: excluded
        from composition (a micro's next step issues only after its
        previous completes), preemption, and migration."""
        out: set = set()
        for h in self.inflight:
            out |= h.micros
        return out

    @property
    def role_bias(self) -> float:
        return getattr(self.scheduler, "role_bias", 0.0)

    @property
    def n_queued(self) -> int:
        return len(self.prefill_q) + len(self.decode_q)

    def has_work(self, now: float) -> bool:
        return any(m.ready <= now for m in self.prefill_q) or \
            any(m.ready <= now for m in self.decode_q)

    def active_seconds(self, horizon: float) -> float:
        return sum((end if end is not None else horizon) - start
                   for start, end in self.segments)


@dataclasses.dataclass
class ReqState:
    req: Request
    # effective arrival: equals req.arrival except in closed-loop wall-
    # clock replay, where the request "arrives" when dispatched (the
    # shared trace object is never mutated)
    arrival: float = 0.0
    token_times: List[float] = dataclasses.field(default_factory=list)
    ttft: Optional[float] = None
    done_at: Optional[float] = None
    micro_done: int = 0
    n_micro: int = 1
    rejected: bool = False
    cancelled: bool = False


# ---------------------------------------------------------------------------
# Backend protocol
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ExecResult:
    """Outcome of one batch on one instance."""
    latency: float
    tokens: Dict[str, int] = dataclasses.field(default_factory=dict)
    deferred: bool = True   # True: completion fires at now+latency (sim)
    # Pure device occupancy when ``latency`` also covers pipeline wait
    # (overlapped dispatch): busy-time accounting uses this so a
    # two-deep pipeline does not double-count the queued interval.
    device_time: Optional[float] = None


class Backend:
    """Execution substrate under a ``ServeSession``.

    ``virtual_clock`` backends model time (completions are deferred
    events); real backends execute synchronously on the wall clock and
    return actual sampled tokens (``emits_tokens``).  ``max_chunk``
    caps per-pass prefill grants (e.g. the engine's padding buckets).

    Backends with a paged KV cache expose the page pool through
    ``page_size`` / ``free_pages`` / ``total_pages``: the session sizes
    batches against free pages (memory-aware local scheduling), reads
    ``1 - free/total`` as the admission / elastic pressure signal, and
    calls ``on_preempt`` to reclaim a victim's pages under pressure.
    ``page_size=None`` (the default) means an unbounded dense cache and
    disables all of it.
    """
    virtual_clock: bool = True
    emits_tokens: bool = False
    max_chunk: Optional[int] = None
    page_size: Optional[int] = None
    cost: BatchCostModel

    def spawn(self, iid: int) -> None:
        """Bring up the substrate for a (new or revived) instance."""

    def retire(self, iid: int) -> None:
        """Tear down a drained instance's substrate."""

    # ---- sharded (multi-device) instances ----
    def devices_for(self, iid: int) -> int:
        """Shard width (device count) of the instance; 1 = unsharded."""
        return 1

    def set_devices(self, iid: int, n: int) -> None:
        """Pin an instance's shard width before (re-)spawning it — the
        elastic controller's width↔count trades go through here."""
        if n > 1:
            raise NotImplementedError(
                f"{type(self).__name__} does not support sharded "
                f"instances")

    def cost_for(self, iid: int) -> BatchCostModel:
        """Cost model matching the instance's shard width (schedulers
        price a TP=n instance with TP=n latencies)."""
        return self.cost

    def register(self, req: Request, prompt=None) -> None:
        """Make the request's inputs available (prompt tokens etc.)."""

    def forget(self, rid: str) -> None:
        """Drop per-request records of a terminal request."""

    def on_place(self, iid: int, micro: MicroState) -> bool:
        """Reserve per-instance resources (a KV slot).  False => the
        instance cannot take the micro (admission rejects the request)."""
        return True

    def release(self, micro: MicroState) -> None:
        """Free the micro's resources (slot, cached state)."""

    def execute(self, inst: InstanceState,
                grants: Sequence[Tuple[MicroState, int]],
                decs: Sequence[MicroState]) -> ExecResult:
        raise NotImplementedError

    # ---- overlapped (dispatch-ahead) execution ----
    # ``interleave`` is an optional completion-delivery schedule (see
    # repro_torch.sim.simulator.InterleaveSchedule): the session permutes
    # concurrently-in-flight completion events through it, making every
    # async ordering seeded and replayable.
    interleave = None

    def dispatch(self, inst: InstanceState,
                 grants: Sequence[Tuple[MicroState, int]],
                 decs: Sequence[MicroState], now: float = 0.0):
        """Begin executing a batch without blocking on its result.

        Returns either an ``ExecResult`` (virtual/synchronous substrate
        — the completion is fully known at dispatch) or an opaque
        in-flight token to be ``poll``ed / ``collect``ed.  The default
        wraps the blocking ``execute`` so substrates that never
        override this still run under an overlapped session."""
        return self.execute(inst, grants, decs)

    def poll(self, token) -> bool:
        """True when ``collect(token)`` would not block."""
        return True

    def collect(self, token) -> ExecResult:
        """Block until the dispatched batch finishes; return its result."""
        raise NotImplementedError

    def on_complete(self, inst: InstanceState,
                    grants: Sequence[Tuple[MicroState, int]],
                    decs: Sequence[MicroState]) -> None:
        """Completion bookkeeping for a batch issued via ``dispatch``
        (e.g. the simulator returns the batch's in-flight page growth
        to the free pool).  Called exactly once per dispatched batch,
        before the session advances any micro's position."""

    def do_handoff(self, src: MicroState, dst: MicroState) -> float:
        """Move KV/state for a real backend; returns bytes moved."""
        return 0.0

    # ---- background KV streams (overlapped handoff) ----
    def handoff_stream(self, src: MicroState, dst: MicroState):
        """Open a chunked background KV stream src → dst; returns an
        opaque stream token, or None when the substrate cannot stream
        (the session falls back to the blocking ``do_handoff``)."""
        return None

    def stream_pump(self, stream) -> Optional[float]:
        """Move the stream's next chunk; returns bytes moved, or None
        once the stream is complete.  Raises ``HandoffStreamError``
        when the import cannot proceed (destination out of pages)."""
        raise NotImplementedError

    def stream_abort(self, stream) -> None:
        """Tear down an in-flight stream (cancel / fallback); the
        partially-imported destination pages are dropped by the
        session through ``on_preempt``/``release``."""

    def on_migrate(self, micro: MicroState, src_iid: int,
                   dst_iid: int) -> bool:
        """Re-home a queued micro's resources.  False => cannot move."""
        return True

    def free_pages(self, iid: int) -> Optional[int]:
        """Free KV pages on the instance (None = unbounded / dense)."""
        return None

    def total_pages(self, iid: int) -> Optional[int]:
        """Page-pool capacity of the instance (None = unbounded)."""
        return None

    # ---- per-page KV precision (quantized page pools) ----
    # The pool is denominated in *frames*: one frame = one page of a
    # 1-byte-itemsize format, so a bf16 page costs 2 frames and a
    # quantized (fp8/int8) page 1.  Under a uniform precision every
    # frame inequality is the page inequality scaled by a constant, so
    # backends without quantization see identical decisions; mixed
    # precision lets quantized requests stretch the same HBM 2x.
    def pool_precision(self, iid: int):
        """Storage format of the instance's page pool."""
        from repro_torch.core.precision import BF16
        return BF16

    def request_precision(self, iid: int, slo_name: Optional[str]):
        """Format pages of a request in SLO class ``slo_name`` get on
        the instance (policy-aware backends map BATCH -> quantized)."""
        return self.pool_precision(iid)

    def free_frames(self, iid: int) -> Optional[int]:
        free = self.free_pages(iid)
        if free is None:
            return None
        return free * self.pool_precision(iid).frames

    def total_frames(self, iid: int) -> Optional[int]:
        total = self.total_pages(iid)
        if total is None:
            return None
        return total * self.pool_precision(iid).frames

    def on_preempt(self, micro: MicroState) -> None:
        """Drop the micro's resident KV (pages); the session re-queues
        the work as a recompute prefill."""

    # ---- shared-prefix KV cache (repro_torch.engine.prefix_cache) ----
    # capability flag: True only when the backend actually runs a
    # prefix cache — gates claims and the hit/lookup metrics so a
    # cache-less (but page-pooled) run reports no cache activity
    has_prefix_cache: bool = False

    def cached_prefix(self, iid: int, req) -> int:
        """Non-mutating probe: tokens of ``req``'s prompt cached on the
        instance (page-aligned).  The global scheduler scores
        placements and split points on *effective* prefill — prompt
        minus this — and admission predicts TTFT with it."""
        return 0

    def claim_prefix(self, micro: MicroState, limit: int) -> int:
        """Pin + splice the longest cached prefix of the micro's prompt
        (capped to ``limit`` tokens, rounded down to pages) into its
        slot.  Returns tokens claimed; the session advances ``pos``
        past them so their prefill is skipped entirely."""
        return 0

    def pinned_prefix_pages(self, iid: int) -> int:
        """Distinct cache pages pinned by live claims on the instance
        (for counting shared pages once in admission commitments)."""
        return 0

    def on_handoff_import(self, beta: MicroState) -> None:
        """The beta's KV import is about to allocate pages on its
        destination.  Virtual backends mirror the cache eviction a real
        import triggers (the engine's allocator reclaims LRU cached
        pages inside ``import_state`` itself, so it needs no hook)."""

    @property
    def prefix_evictions(self) -> int:
        """Cache pages reclaimed under memory pressure so far."""
        return 0

    def check_invariants(self) -> None:
        """Debug hook: assert KV refcount/occupancy coherence."""

    def gauges(self, iid: int) -> Dict[str, float]:
        """Substrate-level gauge sample for the observability layer
        (``repro_torch.serving.metrics``): slot/page occupancy, prefix-cache
        size — whatever the substrate meters.  Keys become Prometheus
        gauge names (``dynaserve_backend_<key>``), values are current
        readings.  Empty by default; sampling must not mutate state."""
        return {}

    def describe(self) -> Dict[str, object]:
        """Static substrate configuration for the flight recorder's
        ``meta`` event — enough for ``repro_torch.sim.replay`` to rebuild an
        equivalent backend from a recorded decision log."""
        return {}


# ---------------------------------------------------------------------------
# Config + metrics
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SessionConfig:
    n_instances: int = 2
    slo: float = 0.100             # default TBT target (unclassed work)
    max_sim_time: float = 10_000.0
    warmup: float = 5.0
    hbm_bytes: float = 80e9        # A100-80G, for utilization accounting
    record_util: bool = False
    # --- online serving ---
    admission: bool = False        # load-shed when predicted TTFT busts SLO
    open_loop: bool = True         # honor arrival timestamps (wall-clock
    #                                backends sleep until each arrival)
    default_slo: Optional[SLOClass] = None   # attached to unclassed requests
    # Long-lived sessions: drop per-request state (req_states entry,
    # handle registration, backend prompt/token records) as soon as a
    # request turns terminal, so memory stays bounded at open-request
    # count.  Leave True for run()/metrics(), which aggregate over the
    # retained states at the end.
    retain_finished: bool = True
    # Debug: assert KV page refcount / prefix-cache coherence on every
    # pool-control tick (the stall guard) — catches double-frees of
    # shared pages the moment they happen instead of as bad tokens.
    debug_kv_invariants: bool = False
    # --- overlapped execution ---
    # None defers to the module-level DEFAULT_OVERLAP (the pytest
    # --overlap switch); True pipelines dispatch-ahead batches and runs
    # KV handoffs as background streams, False is the synchronous loop.
    overlap: Optional[bool] = None
    pipeline_depth: int = 2        # dispatched-but-uncollected batches
    stream_chunk_tokens: int = 512  # background-stream chunk sizing


@dataclasses.dataclass
class ClassReport:
    """Per-SLO-class serving quality (goodput measured at the API)."""
    name: str
    offered: int = 0
    completed: int = 0
    rejected: int = 0
    cancelled: int = 0
    tokens: int = 0
    tokens_in_slo: int = 0
    goodput: float = 0.0           # SLO-attaining tokens / second
    ttft_p50: float = 0.0
    ttft_p99: float = 0.0
    tbt_p99: float = 0.0

    @property
    def attainment(self) -> float:
        return self.tokens_in_slo / max(1, self.tokens)


@dataclasses.dataclass
class SessionMetrics:
    duration: float
    completed: int
    offered: int
    tokens_total: int
    tokens_in_slo: int
    tbts: np.ndarray
    ttfts: np.ndarray
    req_attained: float           # fraction of requests with max TBT <= SLO
    scheduling_overheads: np.ndarray
    per_instance_busy: List[float]
    per_instance_mfu: List[float]
    per_instance_hbm: List[float]
    transfer_exposed_total: float
    transfer_bytes_total: float
    goodput_window: Optional[List[Tuple[float, float]]] = None
    # elastic-pool accounting
    instance_seconds: float = 0.0       # sum of per-instance active time
    n_instances_peak: int = 0
    n_instances_final: int = 0
    migrations: int = 0
    migration_bytes: float = 0.0
    preemptions: int = 0           # KV evictions under memory pressure
    pool_events: List[Tuple[float, str]] = dataclasses.field(
        default_factory=list)
    # online serving
    rejected: int = 0
    cancelled: int = 0
    per_class: Dict[str, ClassReport] = dataclasses.field(
        default_factory=dict)
    # shared-prefix KV cache
    prefix_lookups: int = 0        # placement-time cache probes
    prefix_hits: int = 0           # probes that claimed >= 1 page
    prefix_saved_tokens: int = 0   # prefill tokens skipped via claims
    prefix_handoff_saved_tokens: int = 0   # handoff tokens not shipped
    prefix_evictions: int = 0      # cache pages reclaimed under pressure
    prefill_tokens_computed: int = 0       # prefill tokens actually run

    @property
    def prefix_hit_rate(self) -> float:
        return self.prefix_hits / max(1, self.prefix_lookups)

    @property
    def goodput(self) -> float:
        return self.tokens_in_slo / self.duration

    @property
    def throughput_tokens(self) -> float:
        return self.tokens_total / self.duration

    @property
    def throughput_rps(self) -> float:
        return self.completed / self.duration

    @property
    def token_attainment(self) -> float:
        return self.tokens_in_slo / max(1, self.tokens_total)

    @property
    def goodput_per_instance_second(self) -> float:
        """SLO-attaining tokens per instance-second — the elastic pool's
        efficiency metric (fixed-N pays for idle valleys)."""
        return self.tokens_in_slo / max(1e-9, self.instance_seconds)

    def p99_tbt(self) -> float:
        return pctl(self.tbts, 99)

    def p50_tbt(self) -> float:
        return pctl(self.tbts, 50)


# ---------------------------------------------------------------------------
# Streaming handle
# ---------------------------------------------------------------------------
class ServeHandle:
    """Client-side view of one in-flight request.

    Iterating yields tokens incrementally, pumping the session's event
    loop as needed (real backends yield sampled token ids; the simulator
    yields output positions).  ``state`` tracks the request lifecycle.
    """

    def __init__(self, session: "ServeSession", req: Request):
        self._session = session
        self.req = req
        self.tokens: List[int] = []

    @property
    def rid(self) -> str:
        return self.req.rid

    @property
    def state(self) -> str:
        return self.req.state

    @property
    def done(self) -> bool:
        return self.req.terminal

    # compat alias: the old engine ``LiveRequest.generated``
    @property
    def generated(self) -> List[int]:
        return self.tokens

    def cancel(self) -> bool:
        return self._session.cancel(self.rid)

    def result(self) -> List[int]:
        """Block until terminal; returns the full token list."""
        for _ in self:
            pass
        return self.tokens

    def __iter__(self):
        sent = 0
        while True:
            while sent < len(self.tokens):
                yield self.tokens[sent]
                sent += 1
            if self.req.terminal:
                return
            if not self._session._pump():
                if self.req.terminal:
                    continue
                if self._session._truncated:
                    return          # time horizon reached, not a deadlock
                raise SessionStallError(
                    f"request {self.rid} stalled in state {self.req.state} "
                    f"with no pending events")


# ---------------------------------------------------------------------------
# The shared driver
# ---------------------------------------------------------------------------
class ServeSession:
    """The one arrival→admit→place→batch→handoff→finish event loop.

    Exposes the pool surface the policies drive (``instances``,
    ``active_instances``, ``add_instance``, ``drain_instance``,
    ``migrate``, ``release_beta``) so ``repro_torch.sim.policies`` run
    unmodified on either backend.
    """

    def __init__(self, backend: Backend, policy,
                 cfg: Optional[SessionConfig] = None):
        self.backend = backend
        self.policy = policy
        self.cfg = cfg or SessionConfig()
        # Observability hooks (repro_torch.serving): objects appended here get
        # lifecycle callbacks — ``on_request(req, now)`` at arrival,
        # ``on_transition(req, old, new, now)`` on each state change,
        # ``on_placed(req, placements, now)`` after the global scheduler
        # splits/places, ``on_token(req, now)`` per delivered token.
        # Observers must treat the session as read-only.  Observers that
        # additionally define ``on_decision(kind, payload, now)`` receive
        # the typed scheduler-decision stream (the flight recorder);
        # payloads are only built when such an observer is attached.
        self.observers: List[object] = []
        self._dec_n = -1                     # observer count at last scan
        self._dec_fns: Tuple = ()            # cached on_decision callables
        self._last_prefix_evictions = 0
        self._overlap = (DEFAULT_OVERLAP if self.cfg.overlap is None
                         else bool(self.cfg.overlap))
        self._streams: Dict[str, TransferStream] = {}   # beta rid -> stream
        self._pinned_src: Dict[str, TransferStream] = {}  # src rid -> stream
        self.cost = backend.cost
        self.predictor = ExecutionPredictor(self.cost, self.cfg.slo)
        self.instances: List[InstanceState] = []
        for i in range(self.cfg.n_instances):
            backend.spawn(i)
            self.instances.append(InstanceState(
                i, policy.make_local_scheduler(i, backend.cost_for(i),
                                               self.cfg.slo),
                policy.role_of(i, self.cfg.n_instances)))
        self.req_states: Dict[str, ReqState] = {}
        self.handles: Dict[str, ServeHandle] = {}
        self._rid_seq = itertools.count()
        self._events: List[Tuple[float, int, str, object]] = []
        self._seq = 0
        self._arrivals_left = 0
        self._open_requests = 0
        self._pool_armed = False
        self._truncated = False
        self._batches_done = 0
        self._pool_progress = -1
        self._pool_idle = 0
        self.now = 0.0
        self._t0: Optional[float] = None   # wall-clock epoch (real backends)
        self.transfer_exposed = 0.0
        self.transfer_bytes = 0.0
        self.migrations = 0
        self.migration_bytes = 0.0
        self.preemptions = 0
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_saved_tokens = 0
        self.prefix_handoff_saved_tokens = 0
        self.prefill_tokens_computed = 0
        self.n_instances_peak = self.cfg.n_instances
        self.pool_events: List[Tuple[float, str]] = []
        self.sched_overheads: List[float] = []

    # ---------------- observability plumbing ----------------
    def _notify(self, event: str, *args) -> None:
        for ob in self.observers:
            fn = getattr(ob, event, None)
            if fn is not None:
                fn(*args)

    def _to(self, req: Request, state: str) -> None:
        """Transition a request's lifecycle, notifying observers on an
        actual change (terminal states are sticky, and batch re-issues
        re-assert RUNNING_* every pass — observers see each edge once)."""
        old = req.state
        req.to(state, self.now)
        if req.state != old:
            self._notify("on_transition", req, old, req.state, self.now)

    @property
    def _dec(self) -> Tuple:
        """Cached ``on_decision`` callables of the attached observers.

        Zero-overhead when unobserved: emission sites guard payload
        construction with ``if self._dec:`` — with no decision observer
        attached no event dict is ever allocated.  The scan re-runs only
        when the observer count changes."""
        obs = self.observers
        if len(obs) != self._dec_n:
            self._dec_n = len(obs)
            self._dec_fns = tuple(
                fn for fn in (getattr(o, "on_decision", None) for o in obs)
                if fn is not None)
        return self._dec_fns

    @property
    def decisions_enabled(self) -> bool:
        """True when at least one observer records scheduler decisions
        (policies use this to guard their own payload construction)."""
        return bool(self._dec)

    def record_decision(self, kind: str, payload: dict) -> None:
        """Emit one typed scheduler-decision event to every decision
        observer.  Public so policies (e.g. the elastic pool applier)
        can record decisions the session core does not see."""
        for fn in self._dec:
            fn(kind, payload, self.now)

    # ---------------- event plumbing ----------------
    def _push(self, t: float, kind: str, payload) -> None:
        self._seq += 1
        heapq.heappush(self._events, (t, self._seq, kind, payload))

    def _wall(self) -> float:
        if self._t0 is None:
            self._t0 = _time.monotonic()
        return _time.monotonic() - self._t0

    def _advance(self, t: float) -> None:
        if self.backend.virtual_clock:
            self.now = t
            return
        wall = self._wall()
        if self.cfg.open_loop and t > wall:
            _time.sleep(t - wall)
            wall = self._wall()
        self.now = max(self.now, wall)

    def _pop_event(self) -> Tuple[float, int, str, object]:
        """Pop the next event; with an interleaving schedule attached
        to the backend, completion deliveries ("batch_done"/"xfer")
        that are concurrently in flight within the schedule's window
        are permuted by its seeded choice — the same seed replays the
        same ordering bit-identically, a different seed explores an
        ordering the real engine would only hit under load.  The
        chosen event is delivered at the group's earliest time, so the
        virtual clock stays monotone."""
        first = heapq.heappop(self._events)
        sched = getattr(self.backend, "interleave", None)
        if (sched is None or not self._overlap
                or first[2] not in sched.PERMUTABLE):
            return first
        group = [first]
        while self._events and len(group) < sched.width:
            t, _, kind, _ = self._events[0]
            if kind not in sched.PERMUTABLE or t > first[0] + sched.window:
                break
            group.append(heapq.heappop(self._events))
        pick = group.pop(sched.choose(len(group)))
        for ev in group:
            heapq.heappush(self._events, ev)
        return (first[0], pick[1], pick[2], pick[3])

    def _pump(self) -> bool:
        """Dispatch one event; False when the queue is empty (or the
        time horizon is exceeded)."""
        if not self._events:
            return False
        t, _, kind, payload = self._pop_event()
        if t > self.cfg.max_sim_time:
            # past the configured horizon: leave the event queue intact
            # so truncation stays distinguishable from a genuine stall
            self._seq += 1
            heapq.heappush(self._events, (t, self._seq, kind, payload))
            self._truncated = True
            return False
        self._advance(t)
        if kind == "arrival":
            self._on_arrival(payload)
        elif kind == "batch_done":
            self._on_batch_done(payload)
        elif kind == "collect":
            h: ExecHandle = payload
            if (h.result is None and not self.backend.poll(h.token)
                    and any(k == "xfer" for _, _, k, _ in self._events)):
                # device still busy and a KV stream has chunks pending:
                # pump the transfer first — this is exactly the overlap
                # (streams are finite, so this always terminates)
                self._push(self.now, "collect", h)
            else:
                self._on_batch_done(h)
        elif kind == "xfer":
            self._on_xfer(payload)
        elif kind == "kick":
            if payload < len(self.instances):
                self._maybe_start_batch(self.instances[payload])
        elif kind == "pool":
            if self.cfg.debug_kv_invariants:
                self.backend.check_invariants()
            self.policy.on_pool_check(self, self.now)
            if self._arrivals_left > 0 or self._open_requests > 0:
                # The recurring pool event keeps the queue non-empty, so
                # a session that can make no progress (e.g. a request
                # whose KV footprint no pool member can ever hold) would
                # spin on pool checks forever.  Give the controller a few
                # ticks to unblock things (scale up / migrate / its kicks
                # land as non-pool events), then raise instead.
                busy = any(i.busy for i in self.instances)
                others = any(k != "pool" for _, _, k, _ in self._events)
                if busy or others or self._batches_done != self._pool_progress:
                    self._pool_idle = 0
                    self._pool_progress = self._batches_done
                elif self._arrivals_left == 0:
                    self._pool_idle += 1
                    if self._pool_idle >= 5:
                        raise SessionStallError(
                            f"pool control loop spinning with "
                            f"{self._open_requests} open request(s) and no "
                            f"instance able to progress (work stuck beyond "
                            f"preemption — footprint exceeds every pool "
                            f"member?)")
                self._push(self.now + payload, "pool", payload)
            else:
                self._pool_armed = False
        return True

    def _arm_pool(self) -> None:
        interval = getattr(self.policy, "pool_interval", 0.0)
        if (interval and hasattr(self.policy, "on_pool_check")
                and not self._pool_armed):
            self._pool_armed = True
            self._push(self.now + interval, "pool", interval)

    # ---------------- public API: trace replay ----------------
    def run(self, requests: Sequence[Request]) -> SessionMetrics:
        """Open-loop, arrival-driven replay of a request trace; returns
        end-of-run metrics.  Identical semantics on both backends (a
        wall-clock backend sleeps until each arrival when
        ``cfg.open_loop``)."""
        if not self.backend.virtual_clock:
            self._wall()                     # start the clock
        for r in requests:
            self._push(r.arrival, "arrival", r)
        self._arrivals_left += len(requests)
        self._arm_pool()
        while self._pump():
            pass
        if self._open_requests > 0 and not self._truncated:
            stuck = [rid for rid, st in self.req_states.items()
                     if st.done_at is None and not st.rejected
                     and not st.cancelled]
            raise SessionStallError(
                f"no instance can make progress; {self._open_requests} open "
                f"request(s) remain: {stuck[:8]}")
        return self._metrics(requests)

    # ---------------- public API: online serving ----------------
    def generate(self, prompt=None, max_new_tokens: Optional[int] = None, *,
                 prompt_len: Optional[int] = None,
                 decode_len: Optional[int] = None,
                 predicted_decode: Optional[int] = None,
                 slo: Optional[SLOClass] = None,
                 rid: Optional[str] = None) -> ServeHandle:
        """Submit one request at the current time; returns a streaming
        handle.  Real backends take ``prompt`` (token array) +
        ``max_new_tokens``; the simulator takes ``prompt_len`` +
        ``decode_len`` (lengths only)."""
        if prompt is not None and prompt_len is None:
            prompt_len = len(prompt)
        if max_new_tokens is not None and decode_len is None:
            decode_len = max_new_tokens
        if prompt_len is None or decode_len is None:
            raise ValueError("generate() needs prompt/prompt_len and "
                             "max_new_tokens/decode_len")
        rid = rid or f"req{next(self._rid_seq)}"
        if not self.backend.virtual_clock:
            self._advance(self._wall())
        r = Request(rid, self.now, int(prompt_len), int(decode_len),
                    predicted_decode=predicted_decode, slo=slo)
        if prompt is not None:
            r.prompt_tokens = prompt     # prefix-cache matching key
        self.backend.register(r, prompt)
        handle = ServeHandle(self, r)
        self.handles[rid] = handle
        self._arrivals_left += 1
        self._arm_pool()
        self._on_arrival(r)
        return handle

    def cancel(self, rid: str) -> bool:
        """Abort an in-flight request: frees its slots/queued micros and
        drops any pending beta handoff.  Returns False if the request is
        unknown or already terminal."""
        st = self.req_states.get(rid)
        if st is None or st.req.terminal:
            return False
        self._to(st.req, RequestState.CANCELLED)
        st.cancelled = True
        # abort in-flight background handoffs first: the src pin is
        # released here, the beta's partial import is freed by the
        # queue sweep below (its slot release drops the dst pages)
        for stream in [s for s in self._streams.values()
                       if s.beta.mr.parent.rid == rid]:
            self._abort_stream(stream)
        for inst in self.instances:
            for q in (inst.prefill_q, inst.decode_q):
                for m in [m for m in q if m.mr.parent.rid == rid]:
                    if m in inst.in_flight:
                        m.cancelled = True    # reaped at batch completion
                    else:
                        q.remove(m)
                        self.backend.release(m)
            self._maybe_retire(inst)
        if hasattr(self.policy, "on_cancel"):
            self.policy.on_cancel(rid, self)
        if st.done_at is None:
            self._open_requests -= 1
        self._finalize(st)
        return True

    def metrics(self) -> SessionMetrics:
        return self._metrics([st.req for st in self.req_states.values()])

    # ---------------- elastic pool lifecycle ----------------
    def active_instances(self) -> List[InstanceState]:
        return [i for i in self.instances if not i.draining and not i.retired]

    def pool_instances(self) -> List[InstanceState]:
        """Members still holding or receiving work (not yet retired)."""
        return [i for i in self.instances if not i.retired]

    def add_instance(self, devices: Optional[int] = None) -> InstanceState:
        """Scale up: cancel an in-flight drain (warmest), revive a
        retired member (profile table stays warm), or append a fresh
        one — in that order, so the pool never exceeds its cap while a
        drain is still completing.

        ``devices`` asks for a *sharded* member of that width: undrain
        only considers members already at the width (their engine is
        live), while a retired member's substrate is gone and may be
        revived at a new width (the elastic width↔count trade); its
        local scheduler is rebuilt over the width's cost model."""
        inst = next((i for i in self.instances
                     if i.draining and not i.retired
                     and (devices is None
                          or self.backend.devices_for(i.iid) == devices)),
                    None)
        if inst is not None:
            inst.draining = False
            label = "undrain"
        else:
            inst = next((i for i in self.instances if i.retired), None)
            if inst is not None:
                inst.retired = False
                inst.draining = False
                inst.segments.append([self.now, None])
                if devices is not None and \
                        devices != self.backend.devices_for(inst.iid):
                    self.backend.set_devices(inst.iid, devices)
                    inst.scheduler = self.policy.make_local_scheduler(
                        inst.iid, self.backend.cost_for(inst.iid),
                        self.cfg.slo)
                self.backend.spawn(inst.iid)
                label = "revive"
            else:
                iid = len(self.instances)
                if devices is not None:
                    self.backend.set_devices(iid, devices)
                self.backend.spawn(iid)
                inst = InstanceState(
                    iid,
                    self.policy.make_local_scheduler(
                        iid, self.backend.cost_for(iid), self.cfg.slo),
                    self.policy.role_of(iid, iid + 1), spawned_at=self.now)
                self.instances.append(inst)
                label = "attach"
        self.pool_events.append((self.now, f"{label} {inst.iid}"))
        if self._dec:
            self.record_decision("scale", {
                "iid": inst.iid, "action": label, "direction": "up",
                "devices": self.backend.devices_for(inst.iid)})
        self.n_instances_peak = max(self.n_instances_peak,
                                    len(self.active_instances()))
        return inst

    def drain_instance(self, iid: int) -> None:
        """Scale down: stop placing work on ``iid``; it retires once its
        queues empty (no request is ever dropped)."""
        inst = self.instances[iid]
        if inst.retired or inst.draining:
            return
        inst.draining = True
        self.pool_events.append((self.now, f"drain {iid}"))
        if self._dec:
            self.record_decision("scale", {"iid": iid, "action": "drain",
                                           "direction": "down"})
        self._maybe_retire(inst)

    def _stream_touches(self, iid: int) -> bool:
        """An active background stream reads pages on its src instance
        and writes pages on its dst — neither substrate may be torn
        down mid-stream."""
        return any(s.beta.iid == iid
                   or (s.src is not None and s.src.iid == iid)
                   for s in self._streams.values())

    def _maybe_retire(self, inst: InstanceState) -> None:
        if not (inst.draining and not inst.busy and inst.n_queued == 0):
            return
        if self._stream_touches(inst.iid):
            return       # re-checked when the stream finishes/aborts
        # never retire the last live member: a pool with zero active
        # instances can place no work and the session would stall — the
        # drain is cancelled instead (the old engine loop had this guard;
        # the shared driver applies it to both backends)
        others = [i for i in self.instances
                  if i is not inst and not i.retired and not i.draining]
        if not others:
            inst.draining = False
            self.pool_events.append((self.now, f"undrain {inst.iid}"))
            if self._dec:
                self.record_decision("scale", {
                    "iid": inst.iid, "action": "undrain",
                    "direction": "up"})
            return
        inst.draining = False
        inst.retired = True
        inst.segments[-1][1] = self.now
        self.backend.retire(inst.iid)
        self.pool_events.append((self.now, f"retire {inst.iid}"))
        if self._dec:
            self.record_decision("scale", {"iid": inst.iid,
                                           "action": "retire",
                                           "direction": "down"})

    def migrate(self, src_iid: int, dst_iid: int, max_micros: int) -> int:
        """Move up to ``max_micros`` queued (not in-flight) micro-requests
        from a hot instance to a cold one.  A micro that already computed
        KV on the source pays the KV move on the inter-instance link (the
        simulator models the delay; a real backend physically re-homes
        the slot state) before it becomes runnable on the destination."""
        src, dst = self.instances[src_iid], self.instances[dst_iid]
        moved = 0
        moved_rids: List[str] = []
        moved_bytes = 0.0

        # a waiting beta has no KV yet (its handoff redirects to the new
        # home); anything started owns KV for every position < pos
        def resident_kv(m: MicroState) -> int:
            return 0 if m.ready == float("inf") else m.pos

        # cheapest moves first: least resident KV on the source (a beta
        # with a background stream in flight is not movable — its
        # destination slot is receiving pages right now)
        flying = src.in_flight
        candidates = sorted(
            (m for m in src.prefill_q + src.decode_q
             if m not in flying and m.rid not in self._streams),
            key=resident_kv)
        for m in candidates:
            if moved >= max_micros:
                break
            if not self.backend.on_migrate(m, src_iid, dst_iid):
                continue
            q_src = src.prefill_q if m in src.prefill_q else src.decode_q
            q_dst = dst.prefill_q if q_src is src.prefill_q else dst.decode_q
            q_src.remove(m)
            # the source's prefix-cache claim does not travel: resident
            # KV (shared pages included) ships as private pages
            m.shared_pages = 0
            resident = resident_kv(m)
            if resident > 0:
                mprec = self.backend.request_precision(
                    src_iid, getattr(m.mr.parent.slo, "name", None))
                nbytes = self.cost.kv_transfer_bytes(resident, mprec)
                self.migration_bytes += nbytes
                self.transfer_bytes += nbytes
                moved_bytes += nbytes
                if self.backend.virtual_clock:
                    delay = self.cost.kv_transfer_time(resident, mprec)
                    m.ready = max(m.ready, self.now + delay)
                    self.transfer_exposed += delay
            m.iid = dst_iid
            q_dst.append(m)
            moved += 1
            moved_rids.append(m.rid)
            # wake the destination when the micro actually becomes
            # runnable (a waiting beta is woken by release_beta instead)
            if m.ready != float("inf"):
                self._push(max(self.now, m.ready), "kick", dst_iid)
        if moved:
            self.migrations += moved
            if self._dec:
                self.record_decision("migrate", {
                    "src": src_iid, "dst": dst_iid, "moved": moved,
                    "rids": moved_rids, "bytes": moved_bytes})
            self._maybe_retire(src)
        return moved

    # ---------------- shared-prefix cache ----------------
    def _claim_prefix(self, m: MicroState, limit: Optional[int] = None,
                      count: bool = True) -> int:
        """Try to serve the head of the micro's prefill from the
        instance's prefix cache: claimed pages splice into its slot and
        ``pos`` jumps past them — the local scheduler never sees the
        cached tokens, so they consume neither the SLO prefill budget
        nor free pages.  ``count=False`` keeps re-probes (the same
        micro retried each batch) out of the hit-rate denominator —
        each micro contributes one placement-time lookup and at most
        one eventual hit, so ``hits <= lookups`` stays true."""
        if not self.backend.has_prefix_cache \
                or self.backend.page_size is None or m.pos != 0 \
                or m.prefill_remaining <= 0:
            return 0
        if count:
            self.prefix_lookups += 1
        # always compute >= 1 prefill token: the pass consuming the
        # span's last position is the one that emits its next token
        lim = m.prefill_remaining if limit is None else limit
        lim = min(lim, m.prefill_remaining - 1)
        h = self.backend.claim_prefix(m, lim)
        if h <= 0:
            return 0
        m.shared_pages = h // self.backend.page_size
        m.pos = h
        m.prefill_remaining -= h
        self.prefix_hits += 1
        self.prefix_saved_tokens += h
        return h

    def _claim_handoff_prefix(self, beta: MicroState) -> int:
        """A beta about to receive its KV handoff first claims whatever
        prefix its *destination* instance has cached — those pages never
        cross the link."""
        if not self.backend.has_prefix_cache \
                or self.backend.page_size is None or beta.pos <= 0 \
                or beta.shared_pages:
            return 0
        self.prefix_lookups += 1
        h = self.backend.claim_prefix(beta, beta.pos)
        if h <= 0:
            return 0
        beta.shared_pages = h // self.backend.page_size
        self.prefix_hits += 1
        self.prefix_handoff_saved_tokens += h
        return h

    # ---------------- admission control ----------------
    _queued_view = staticmethod(queued_view)

    def predicted_ttft(self, r: Request) -> float:
        """Best-case first-token time on the least-loaded instance.

        Decodes co-run with the newcomer's prefill in mixed batches, so
        the wait is NOT the full queue drain — it is the SLO-paced
        drain of the prefill tokens ahead of it plus its own: with a
        per-pass budget ``M`` (Algorithm 2's inversion under the
        request's TBT class), first token lands after
        ``ceil((queued_prefill + P) / M)`` passes."""
        act = self.active_instances() or self.pool_instances()
        if not act:
            return float("inf")
        slo = r.slo.tbt if r.slo is not None else self.cfg.slo
        best = float("inf")
        for inst in act:
            cost = self.backend.cost_for(inst.iid)
            queued_pf = sum(m.prefill_remaining for m in inst.prefill_q)
            dnum = len(inst.decode_q)
            avg_ctx = int(sum(m.pos for m in inst.decode_q) / dnum) \
                if dnum else 0
            M = max(1, cost.max_prefill_tokens(slo, min(dnum, 8),
                                               avg_ctx))
            per_pass = cost.mixed_batch_latency(M, 0, dnum, avg_ctx)
            # a cached prefix collapses the newcomer's effective prefill
            p_eff = max(0, r.P - self.backend.cached_prefix(inst.iid, r))
            n_pass = math.ceil((queued_pf + p_eff) / M)
            best = min(best, n_pass * per_pass)
        return best

    def kv_pressure(self, iid: int) -> float:
        """Fraction of the instance's KV pool in use, denominated in
        frames so quantized pages weigh their true HBM share — the
        memory signal admission control and the elastic controller
        consume (0.0 for dense/unbounded backends).  With a uniform
        pool precision this is exactly the page ratio."""
        total = self.backend.total_frames(iid)
        if not total:
            return 0.0
        free = self.backend.free_frames(iid)
        if free is None:
            return 0.0
        return 1.0 - free / total

    def _page_frames(self, iid: int, slo) -> int:
        """Frames one page of a request in SLO class ``slo`` costs on
        the instance (the backend's precision policy sets the format)."""
        name = slo.name if slo is not None else None
        return self.backend.request_precision(iid, name).frames

    def _kv_committed_frames(self, inst: InstanceState) -> int:
        """Frames the instance's placed micro-requests will eventually
        occupy (each micro grows to its span end), each priced at its
        request's page precision.  Pages borrowed from the shared-prefix
        cache are counted ONCE — each micro's commitment excludes its
        claimed pages and the distinct pinned set is added back (at the
        pool's precision; engine pools are uniform so this is exact).
        Computed from the session's own queues + the backend's trie
        (identical on both substrates), so every admission decision
        built on it is byte-identical on the simulator and on real
        engines regardless of clock semantics."""
        psize = self.backend.page_size
        base = sum((pages_for(m.mr.end, psize) - m.shared_pages)
                   * self._page_frames(inst.iid, m.mr.parent.slo)
                   for m in inst.prefill_q + inst.decode_q)
        return base + self.backend.pinned_prefix_pages(inst.iid) \
            * self.backend.pool_precision(inst.iid).frames

    def _kv_admit(self, r: Request) -> bool:
        """Frame-pool admission: shed the request when no instance can
        commit enough frames for its predicted footprint (prompt +
        predicted decode, rounded up to pages and priced at the
        request's page precision; pages the instance already caches for
        this prompt's prefix don't count — they would be claimed, not
        allocated)."""
        psize = self.backend.page_size
        if not psize:
            return True
        need = pages_for(r.P + r.D_pred, psize)
        for inst in (self.active_instances() or self.pool_instances()):
            total = self.backend.total_frames(inst.iid)
            hit = self.backend.cached_prefix(inst.iid, r) // psize
            fp = self._page_frames(inst.iid, r.slo)
            if total is None or \
                    total - self._kv_committed_frames(inst) >= \
                    (need - hit) * fp:
                return True
        return False

    def _admit(self, r: Request) -> Optional[str]:
        """None to admit, else the shed reason."""
        if not self.cfg.admission or r.slo is None or r.slo.admits_always:
            return None
        if self.predicted_ttft(r) > r.slo.ttft:
            return "predicted TTFT over SLO"
        if not self._kv_admit(r):
            return "KV page commitments exhausted"
        return None

    def _reject(self, r: Request, reason: str,
                arrival: Optional[float] = None) -> None:
        self._to(r, RequestState.REJECTED)
        st = self.req_states.setdefault(
            r.rid, ReqState(r, arrival=r.arrival if arrival is None
                            else arrival))
        st.rejected = True
        self.pool_events.append((self.now, f"reject {r.rid}: {reason}"))
        self._finalize(st)

    # ---------------- arrival ----------------
    def _on_arrival(self, r: Request) -> None:
        self._arrivals_left -= 1
        if r.state != RequestState.QUEUED:
            # a reused trace object carries the previous run's terminal
            # state; arrival starts a fresh lifecycle
            r.reset_lifecycle()
        # as-fast-as-possible wall-clock replay: the request "arrives"
        # when dispatched (kept off the shared Request object so a trace
        # can be replayed through several arms)
        arrival = self.now \
            if (not self.backend.virtual_clock and not self.cfg.open_loop) \
            else r.arrival
        if r.slo is None and self.cfg.default_slo is not None:
            r.slo = self.cfg.default_slo
        self._notify("on_request", r, self.now)
        self.backend.register(r)
        shed_reason = self._admit(r)
        if self._dec:
            self.record_decision("admit", {
                "rid": r.rid,
                "verdict": "reject" if shed_reason is not None else "admit",
                "reason": shed_reason})
        if shed_reason is not None:
            self._reject(r, shed_reason, arrival=arrival)
            return
        self._to(r, RequestState.ADMITTED)
        placements = self.policy.place(r, self, self.now)
        if hasattr(self.policy, "last_overhead"):
            self.sched_overheads.append(self.policy.last_overhead)
        # reserve backend resources; on exhaustion, shed the request
        # instead of stalling (satellite: the old loop spun forever)
        placed: List[MicroState] = []
        for inst_id, sm in placements:
            sm.iid = inst_id
            if not self.backend.on_place(inst_id, sm):
                for p in placed:
                    self.backend.release(p)
                if hasattr(self.policy, "on_cancel"):
                    self.policy.on_cancel(r.rid, self)
                if self._dec:
                    self.record_decision("admit", {
                        "rid": r.rid, "verdict": "reject",
                        "reason": "no free slots"})
                self._reject(r, "no free slots", arrival=arrival)
                return
            placed.append(sm)
        st = ReqState(r, arrival=arrival, n_micro=len(placements))
        self.req_states[r.rid] = st
        self._open_requests += 1
        self._notify("on_placed", r, placements, self.now)
        if self._dec:
            self.record_decision("place", self._placement_payload(r,
                                                                  placements))
        for inst_id, sm in placements:
            inst = self.instances[inst_id]
            # real backends: the final forward pass is not needed for the
            # last token (it is emitted by the pass before), so the micro
            # covering the request's tail runs one fewer decode step
            if (self.backend.emits_tokens and sm.decode_remaining > 0
                    and sm.mr.end >= r.true_L):
                sm.decode_remaining -= 1
            # shared-prefix hit: splice cached pages, skip their prefill
            # (betas waiting on a handoff claim later, in release_beta)
            if sm.ready != float("inf"):
                self._claim_prefix(sm)
            if sm.prefill_remaining > 0:
                inst.prefill_q.append(sm)
            elif sm.decode_remaining > 0:
                inst.decode_q.append(sm)
            else:
                # degenerate span (e.g. 1-token tail absorbed above)
                self._micro_finished(sm)
                continue
            self._maybe_start_batch(inst)

    def _placement_payload(self, r: Request, placements) -> dict:
        """Decision payload for a just-placed request: the spans chosen
        plus (when the policy exposes them) the split alternatives and
        candidate-instance scores the global scheduler *considered*."""
        out = {
            "rid": r.rid,
            "micros": [{"iid": iid, "role": sm.mr.role,
                        "start": sm.mr.start, "end": sm.mr.end,
                        "prefill": sm.prefill_remaining,
                        "decode": sm.decode_remaining, "pos": sm.pos,
                        "waiting": sm.ready == float("inf")}
                       for iid, sm in placements],
        }
        pl = getattr(self.policy, "last_placement", None)
        if pl is not None:
            out.update(phi=pl.phi, predicted_t1=pl.predicted_t1,
                       predicted_t2=pl.predicted_t2, probes=pl.probes,
                       trials=list(pl.trials),
                       candidates=list(pl.candidates),
                       overhead_s=pl.overhead_s)
        return out

    # ---------------- batching ----------------
    def _work_meta(self, m: MicroState):
        slo = m.mr.parent.slo
        tbt = slo.tbt if slo is not None else None
        deadline = None
        if slo is not None and math.isfinite(slo.ttft):
            st = self.req_states.get(m.mr.parent.rid)
            arrival = st.arrival if st is not None else m.mr.parent.arrival
            deadline = arrival + slo.ttft
        return tbt, deadline

    def _late_cached(self, inst: InstanceState, m: MicroState) -> int:
        """Late prefix-cache probe for a still-unstarted queued micro: a
        request that queued behind a sibling sharing its prefix hits
        pages inserted AFTER it arrived.  Returns the cached head the
        local scheduler may grant budget-free; the claim itself is
        applied at batch issue (``_maybe_start_batch``)."""
        psize = self.backend.page_size
        if not self.backend.has_prefix_cache or not psize \
                or m.pos != 0 or m.shared_pages or m.prefill_remaining <= 1:
            return 0
        c = self.backend.cached_prefix(inst.iid, m.mr.parent)
        # mirror _claim_prefix's clamp: >= 1 prefill token always runs
        return min(c, ((m.prefill_remaining - 1) // psize) * psize)

    def _compose_batch(self, inst: InstanceState):
        # conservative hazard rule: a micro inside a dispatched batch
        # is not re-batched until that batch collects (its next decode
        # needs the sampled token; its next prefill chunk needs pos to
        # advance) — this is what keeps pipelined token streams
        # identical to the synchronous ones
        flying = inst.in_flight
        pf = [m for m in inst.prefill_q
              if m.ready <= self.now and m not in flying]
        dc = [m for m in inst.decode_q
              if m.ready <= self.now and m not in flying]
        if inst.role == "prefill":
            dc = []
        if inst.role == "decode":
            pf = []
        cap = self.backend.max_chunk
        pworks, dworks = [], []
        for m in pf:
            tbt, deadline = self._work_meta(m)
            rem = m.prefill_remaining if cap is None else \
                min(m.prefill_remaining, cap)
            cached = min(self._late_cached(inst, m), rem)
            pworks.append(PrefillWork(m.rid, rem, m.pos, deadline=deadline,
                                      cached=cached))
        for m in dc:
            tbt, _ = self._work_meta(m)
            dworks.append(DecodeWork(m.rid, m.pos, tbt=tbt))
        # page budgeting runs in frames: each micro's pages are priced
        # at its request's precision, so quantized streams stretch the
        # pool (uniform precision degenerates to plain page counting)
        slos = {m.rid: m.mr.parent.slo for m in pf + dc}
        plan = inst.scheduler.next_batch(
            pworks, dworks, free_pages=self.backend.free_pages(inst.iid),
            page_size=self.backend.page_size,
            n_inflight=sum(len(h.decs) for h in inst.inflight),
            inflight_latency=sum(
                getattr(h.plan, "predicted_latency", 0.0)
                for h in inst.inflight),
            free_frames=self.backend.free_frames(inst.iid),
            frames_of=lambda rid: self._page_frames(inst.iid,
                                                    slos.get(rid)))
        return plan, pf, dc

    def _seniority(self, m: MicroState):
        st = self.req_states.get(m.mr.parent.rid)
        arrival = st.arrival if st is not None else m.mr.parent.arrival
        return (arrival, m.mr.parent.rid)

    def _preempt_for_memory(self, inst: InstanceState,
                            junior_to=None,
                            cause: str = "memory") -> bool:
        """Free pages by evicting one micro-request's KV (vLLM-style
        recompute preemption): the *youngest* resident request loses its
        cache and re-queues as prefill from position 0.  Preemption only
        fires in favour of strictly older work — the oldest request is
        never evicted, so it monotonically progresses and the preemption
        loop terminates (no two requests can seesaw).  ``junior_to``
        restricts victims to requests younger than the given seniority
        (the handoff path protects the arriving beta's elders)."""
        if inst.role == "decode":
            # a decode-only instance (disaggregation baseline) can never
            # run the victim's recompute prefill — eviction would strand it
            return False
        psize = self.backend.page_size or 1
        candidates = [m for q in (inst.decode_q, inst.prefill_q) for m in q
                      if m not in inst.in_flight and not m.cancelled
                      and m.ready != float("inf")
                      # only victims holding *private* pages: evicting a
                      # micro that lives entirely on shared prefix pages
                      # frees nothing (and would seesaw forever)
                      and m.pos > m.shared_pages * psize]
        if junior_to is not None:
            candidates = [m for m in candidates
                          if self._seniority(m) > junior_to]
        if not candidates:
            return False
        victim = max(candidates, key=self._seniority)
        if junior_to is None:
            older = [m for m in inst.prefill_q + inst.decode_q
                     if m is not victim and not m.cancelled
                     and self._seniority(m) < self._seniority(victim)]
            if not older:
                return False
        evicted = victim.pos
        self.backend.on_preempt(victim)
        victim.shared_pages = 0      # preemption dropped its claim too
        self._requeue_for_recompute(inst, victim)
        self.preemptions += 1
        self.pool_events.append((self.now, f"preempt {victim.rid}"))
        if self._dec:
            self.record_decision("preempt", {
                "rid": victim.rid, "req": victim.mr.parent.rid,
                "iid": inst.iid, "cause": cause,
                "evicted_tokens": evicted})
        return True

    def _requeue_for_recompute(self, inst: InstanceState,
                               m: MicroState) -> None:
        """Turn a micro's resident prefix into prefill work again: it
        rebuilds KV under the normal page budget.  Pages still claimed
        from the prefix cache survive (they were never dropped), and a
        fresh claim is probed — a preempted request whose prefix stayed
        cached (pinned by a sibling, say) recomputes only the tail."""
        keep = m.shared_pages * (self.backend.page_size or 0)
        m.recompute_hi = max(m.recompute_hi, m.pos)
        if m in inst.decode_q:
            inst.decode_q.remove(m)
            inst.prefill_q.append(m)
        m.prefill_remaining += m.pos - keep      # recompute [keep, pos)
        m.pos = keep
        if m.pos == 0:
            self._claim_prefix(m)
        if m.prefill_remaining <= 0 and m.decode_remaining > 0 \
                and m in inst.prefill_q:
            inst.prefill_q.remove(m)
            inst.decode_q.append(m)

    def _maybe_start_batch(self, inst: InstanceState) -> None:
        """Fill the instance's dispatch pipeline: one batch in the
        synchronous loop, up to ``pipeline_depth`` dispatched-ahead
        batches when overlap is on (batch N+1 is composed from the
        micros NOT in flight while batch N runs on the device)."""
        if inst.retired:
            return
        depth = max(1, self.cfg.pipeline_depth) if self._overlap else 1
        while len(inst.inflight) < depth:
            if self._dispatch_one(inst) is not True:
                # False: no dispatchable work.  "inline": the batch ran
                # synchronously to completion — its kick event resumes
                # the loop, exactly like the pre-pipeline driver.
                break

    def _dispatch_one(self, inst: InstanceState):
        if not inst.has_work(self.now):
            return False
        plan, pf, dc = self._compose_batch(inst)
        # Dispatch-ahead gate: pipelining pays off only for prefill
        # chunk streams (pure compute, no cross-batch data hazard).
        # Decode passes are memory-bound — their latency is nearly flat
        # in batch width — so letting a dispatched-ahead batch carry
        # decodes splits the decode population into alternating cohorts
        # and doubles the number of weight-read passes, which costs far
        # more than the host overhead pipelining hides.  Likewise,
        # peeling prefill into its own pass behind a decode batch pays
        # an extra weight read versus folding it into the next mixed
        # batch.  So dispatch ahead only when BOTH the new batch and
        # everything in flight are decode-free; decode cadence stays
        # identical to the synchronous loop.
        if inst.inflight and (plan.decodes or
                              any(h.plan.dnum for h in inst.inflight)):
            return False
        # memory-starved with runnable work: preempt (possibly several
        # victims — deep overcommit needs more than one) and retry;
        # otherwise defer — pages free as other requests finish
        guard = len(inst.prefill_q) + len(inst.decode_q)
        while (not plan.decodes and not plan.prefills and plan.starved
               and guard > 0 and self._preempt_for_memory(inst)):
            guard -= 1
            plan, pf, dc = self._compose_batch(inst)
        if not plan.decodes and not plan.prefills:
            return False
        # map back to MicroState; apply late prefix-cache claims now —
        # the scheduler granted the cached head budget-free, the claim
        # splices the pages and advances pos, and only the computed
        # tail enters the executed grant
        by_rid = {m.rid: m for m in pf + dc}
        grants = []
        for w, g in plan.prefills:
            m = by_rid[w.rid]
            if w.cached > 0 and m.pos == 0 and not m.shared_pages:
                g -= self._claim_prefix(m, limit=w.cached, count=False)
            if g > 0:
                grants.append((m, g))
        decs = [by_rid[w.rid] for w in plan.decodes]
        if not grants and not decs:
            return False
        if self._dec:
            self.record_decision("batch", {
                "iid": inst.iid,
                "prefill": [[m.rid, g] for m, g in grants],
                "decode": [m.rid for m in decs],
                "predicted_latency": plan.predicted_latency,
                "budget": getattr(plan, "budget", 0),
                "slo_eff": getattr(plan, "slo_eff", 0.0),
                "starved": plan.starved,
                "cached_tokens": plan.cached_tokens})
        h = ExecHandle(inst.iid, grants, decs, plan, self.now)
        for m in h.micros:
            self._to(m.mr.parent,
                     RequestState.RUNNING_BETA if m.mr.role == "beta"
                     else RequestState.RUNNING_ALPHA)
        items = ([WorkItem("prefill", g, m.pos) for m, g in grants] +
                 [WorkItem("decode", 1, m.pos) for m in decs])
        inst.flops_done += self.cost.flops(items)
        inst.bytes_done += self.cost.bytes_moved(items)
        inst.inflight.append(h)
        if self._overlap:
            h.overlapped = True
            out = self.backend.dispatch(inst, grants, decs, now=self.now)
            if isinstance(out, ExecResult):
                # virtual (or degenerate-synchronous) substrate: the
                # completion time is already known
                h.result = out
                self._push(self.now + (out.latency if out.deferred
                                       else 0.0), "batch_done", h)
            else:
                h.token = out
                self._push(self.now, "collect", h)
            return True
        res = self.backend.execute(inst, grants, decs)
        h.result = res
        if res.deferred:
            self._push(self.now + res.latency, "batch_done", h)
            return True
        # synchronous substrate: the wall clock already advanced
        self._advance(self._wall())
        self._on_batch_done(h)
        return "inline"

    def _on_batch_done(self, h: ExecHandle) -> None:
        iid = h.iid
        inst = self.instances[iid]
        if h.result is None:
            h.result = self.backend.collect(h.token)
            self._advance(self._wall())
        grants, decs, plan, res = h.grants, h.decs, h.plan, h.result
        self._batches_done += 1
        if h in inst.inflight:
            inst.inflight.remove(h)
        if h.overlapped:
            self.backend.on_complete(inst, grants, decs)
        inst.busy_time += (res.device_time if res.device_time is not None
                           else res.latency)
        inst.scheduler.record(plan, res.latency)
        if self._dec:
            dev = (res.device_time if res.device_time is not None
                   else res.latency)
            # prefill entries carry [rid, granted, recomputed]: the
            # recomputed slice (positions below the preemption/fallback
            # high-water mark) lets the attribution analyzer charge it
            # to preempt_recompute instead of useful prefill
            self.record_decision("exec", {
                "iid": iid, "t0": self.now - dev, "latency": res.latency,
                "device_time": dev,
                "prefill": [[m.rid, g,
                             max(0, min(m.pos + g, m.recompute_hi) - m.pos)]
                            for m, g in grants],
                "decode": [m.rid for m in decs]})
        # prefill progress
        for m, g in grants:
            if m.cancelled:
                self._reap_cancelled(inst, m)
                continue
            self.prefill_tokens_computed += g
            m.prefill_remaining -= g
            m.pos += g
            if m.prefill_remaining <= 0:
                inst.prefill_q.remove(m)
                st = self.req_states[m.mr.parent.rid]
                # the forward pass that consumed the last prompt token
                # emitted the first output token
                if m.pos >= m.mr.parent.P and st.ttft is None:
                    st.ttft = self.now - st.arrival
                    tok = res.tokens.get(m.rid)
                    if tok is not None:
                        self._emit(st, m, tok)
                if m.decode_remaining > 0:
                    inst.decode_q.append(m)
                else:
                    self._micro_finished(m)
        # decode progress: every decode in the batch emitted one token
        for m in decs:
            if m.cancelled:
                self._reap_cancelled(inst, m)
                continue
            m.decode_remaining -= 1
            m.pos += 1
            st = self.req_states[m.mr.parent.rid]
            if self.backend.emits_tokens:
                self._emit(st, m, res.tokens.get(m.rid))
            else:
                st.token_times.append(self.now)
                self._notify("on_token", m.mr.parent, self.now)
                h = self.handles.get(m.mr.parent.rid)
                if h is not None:
                    h.tokens.append(m.pos - 1)   # synthetic: position
            if m.decode_remaining <= 0:
                inst.decode_q.remove(m)
                self._micro_finished(m)
        if self._dec:
            ev = self.backend.prefix_evictions
            if ev > self._last_prefix_evictions:
                self.record_decision("evict", {
                    "iid": iid,
                    "count": ev - self._last_prefix_evictions})
                self._last_prefix_evictions = ev
        if self.backend.virtual_clock:
            self._maybe_start_batch(inst)
        else:
            self._push(self.now, "kick", iid)
        self._maybe_retire(inst)

    def _emit(self, st: ReqState, m: MicroState, tok: Optional[int]) -> None:
        st.token_times.append(self.now)
        if st.ttft is None:
            st.ttft = self.now - st.arrival
        self._notify("on_token", m.mr.parent, self.now)
        h = self.handles.get(m.mr.parent.rid)
        if h is not None and tok is not None:
            h.tokens.append(tok)

    def _reap_cancelled(self, inst: InstanceState, m: MicroState) -> None:
        for q in (inst.prefill_q, inst.decode_q):
            if m in q:
                q.remove(m)
        self.backend.release(m)

    # ---------------- micro-request lifecycle ----------------
    def _micro_finished(self, m: MicroState) -> None:
        st = self.req_states[m.mr.parent.rid]
        st.micro_done += 1
        self.policy.on_micro_finished(m, self, self.now)
        pin = self._pinned_src.get(m.rid)
        if pin is not None:
            # the policy opened a background stream sourcing this
            # micro's pages: keep the slot alive until the last chunk
            # is exported (the stream releases it)
            pin.release_src = True
        else:
            self.backend.release(m)
        if st.micro_done >= st.n_micro and st.done_at is None:
            st.done_at = self.now
            self._to(st.req, RequestState.DONE)
            self._open_requests -= 1
            self._finalize(st)

    def _finalize(self, st: ReqState) -> None:
        """Bound long-lived sessions: with ``retain_finished=False``,
        terminal requests release every per-request record."""
        if self.cfg.retain_finished:
            return
        rid = st.req.rid
        self.req_states.pop(rid, None)
        self.handles.pop(rid, None)
        self.backend.forget(rid)

    def release_beta(self, beta: MicroState, ready: float,
                     exposed: float, nbytes: float,
                     src: Optional[MicroState] = None) -> None:
        """Called by the policy when alpha completes: beta becomes
        runnable after the KV handoff.  The simulator models the
        (possibly chunk-overlapped) transfer delay the policy computed;
        a real backend physically moves the state now and the measured
        wall time *is* the delay."""
        if beta.prefill_remaining <= 0 and beta.decode_remaining <= 0:
            # degenerate tail micro (its only token was emitted by the
            # alpha's final pass): nothing to hand off or run
            return
        self._to(beta.mr.parent, RequestState.HANDOFF)
        if self._dec:
            # recorded BEFORE destination-cache scaling: this is the
            # policy's decision as made; replay feeds the same raw
            # (ready-now, exposed, nbytes) back through this method
            self.record_decision("handoff", {
                "rid": beta.rid, "req": beta.mr.parent.rid,
                "src": src.rid if src is not None else None,
                "src_iid": src.iid if src is not None else None,
                "dst_iid": beta.iid, "pos": beta.pos,
                "ready": ready, "exposed": exposed, "nbytes": nbytes})
        # ---- prefix-cache hit on the DESTINATION ----
        # pages the beta's instance already caches for this prompt are
        # claimed into its slot and never cross the link; the modeled
        # (virtual-clock) transfer shrinks pro rata, a real backend
        # simply exports fewer pages below.
        psize = self.backend.page_size
        skipped = self._claim_handoff_prefix(beta)
        if skipped > 0 and self.backend.virtual_clock and beta.pos > 0:
            scale = max(0.0, (beta.pos - skipped) / beta.pos)
            exposed *= scale
            nbytes *= scale
            ready = min(ready, self.now + exposed)
        # ---- page-budget the transfer ----
        # Importing the prefix makes ceil(pos/page) pages resident at
        # once; an unbudgeted import would overflow the destination pool
        # (the engine's allocator raises OutOfPages).  Evict younger
        # residents to make room; when even that is not enough, fall
        # back to *recompute*: the beta rebuilds its prefix from
        # position 0 under the scheduler's normal page budget and no
        # state ships at all.
        if psize and beta.pos > 0:
            inst = self.instances[beta.iid]
            need = (pages_for(beta.pos, psize) - beta.shared_pages) \
                * self._page_frames(beta.iid, beta.mr.parent.slo)
            guard = self._seniority(beta)
            free = self.backend.free_frames(beta.iid)
            while (free is not None and free < need
                   and self._preempt_for_memory(inst, junior_to=guard,
                                                cause="handoff_import")):
                free = self.backend.free_frames(beta.iid)
            if free is not None and free < need and inst.role != "decode":
                # (a decode-only instance cannot recompute a prefix; its
                # import proceeds and may raise the typed OutOfPages)
                self._requeue_for_recompute(inst, beta)
                beta.ready = self.now
                self.pool_events.append(
                    (self.now, f"handoff-recompute {beta.rid}"))
                if self._dec:
                    self.record_decision("recompute", {
                        "rid": beta.rid, "req": beta.mr.parent.rid,
                        "iid": beta.iid, "cause": "handoff_budget"})
                self._push(self.now, "kick", beta.iid)
                return
        if self.backend.virtual_clock and beta.pos > 0:
            self.backend.on_handoff_import(beta)
        # ---- overlapped handoff: chunked background stream ----
        # The beta stays parked (ready = inf) while chunks land between
        # decode batches; its destination keeps emitting tokens for
        # everyone else, and the double-buffered export never stalls
        # the source.  Totals (bytes, exposed) match the synchronous
        # accounting exactly — only when they land differs.
        if self._overlap:
            if self.backend.virtual_clock and beta.pos > 0 and ready > self.now:
                # chunk sizing follows the *source* pool's wire format:
                # quantized pages ship ~half the bytes per chunk token
                src_iid = src.iid if src is not None else beta.iid
                chunk_bytes = (self.cost.kv_bytes_per_tok_at(
                    self.backend.request_precision(
                        src_iid, getattr(beta.mr.parent.slo, "name", None)))
                    * max(1, self.cfg.stream_chunk_tokens))
                stream = TransferStream(
                    beta=beta, t_ready=ready, exposed=exposed,
                    nbytes=nbytes,
                    times=plan_background_stream(self.now, ready, nbytes,
                                                 chunk_bytes))
                self._streams[beta.rid] = stream
                self._push(stream.times[0], "xfer", stream)
                return
            if src is not None and not self.backend.virtual_clock:
                token = self.backend.handoff_stream(src, beta)
                if token is not None:
                    stream = TransferStream(beta=beta, src=src, token=token)
                    self._streams[beta.rid] = stream
                    self._pinned_src[src.rid] = stream
                    self._push(self.now, "xfer", stream)
                    return
        if src is not None and not self.backend.virtual_clock:
            t0 = _time.monotonic()
            nbytes = self.backend.do_handoff(src, beta)
            exposed = _time.monotonic() - t0
            self._advance(self._wall())
            ready = self.now
        self.transfer_exposed += exposed
        self.transfer_bytes += nbytes
        beta.ready = ready
        self._push(max(self.now, ready), "kick", beta.iid)

    # ---------------- background KV streams ----------------
    def _on_xfer(self, stream: TransferStream) -> None:
        if stream.aborted or stream.done:
            return
        if stream.token is None:
            # virtual stream: chunk stream.chunk_i lands now
            stream.chunk_i += 1
            if stream.chunk_i < len(stream.times):
                add = stream.nbytes / len(stream.times)
                stream.sent += add
                self.transfer_bytes += add
                if self._dec:
                    self.record_decision("handoff_chunk", {
                        "rid": stream.beta.rid,
                        "i": stream.chunk_i - 1, "nbytes": add})
                self._push(stream.times[stream.chunk_i], "xfer", stream)
                return
            # final chunk: account the exact remainder so overlap-on
            # totals are bit-identical to the synchronous path
            self.transfer_bytes += stream.nbytes - stream.sent
            self.transfer_exposed += stream.exposed
            if self._dec:
                self.record_decision("handoff_chunk", {
                    "rid": stream.beta.rid, "i": stream.chunk_i - 1,
                    "nbytes": stream.nbytes - stream.sent})
            self._finish_stream(stream, ready=stream.t_ready)
            return
        # real backend: pump one piece (import chunk k while the
        # backend's stream exports chunk k+1 — double buffered)
        t0 = _time.monotonic()
        try:
            nb = self.backend.stream_pump(stream.token)
        except HandoffStreamError:
            self._stream_fallback(stream)
            return
        self._advance(self._wall())
        if nb is None:
            self._finish_stream(stream, ready=self.now)
            return
        self.transfer_bytes += nb
        if self._dec:
            stream.chunk_i += 1
            self.record_decision("handoff_chunk", {
                "rid": stream.beta.rid, "i": stream.chunk_i - 1,
                "nbytes": nb})
        # a chunk imported while the destination had no batch in
        # flight is exposed wait; one hidden behind compute is not
        if not self.instances[stream.beta.iid].inflight:
            self.transfer_exposed += _time.monotonic() - t0
        self._push(self.now, "xfer", stream)

    def _finish_stream(self, stream: TransferStream,
                       ready: float) -> None:
        stream.done = True
        self._streams.pop(stream.beta.rid, None)
        self._release_stream_src(stream)
        beta = stream.beta
        beta.ready = ready
        self._push(max(self.now, ready), "kick", beta.iid)
        self._maybe_retire(self.instances[beta.iid])

    def _release_stream_src(self, stream: TransferStream) -> None:
        if stream.src is None:
            return
        self._pinned_src.pop(stream.src.rid, None)
        if stream.release_src:
            self.backend.release(stream.src)
        if stream.src.iid < len(self.instances):
            self._maybe_retire(self.instances[stream.src.iid])

    def _abort_stream(self, stream: TransferStream) -> None:
        stream.aborted = True
        self._streams.pop(stream.beta.rid, None)
        if stream.token is not None:
            self.backend.stream_abort(stream.token)
        self._release_stream_src(stream)

    def _stream_fallback(self, stream: TransferStream) -> None:
        """Mid-stream ``OutOfPages`` on the destination: drop the
        partial import (no leaked pages) and recompute the beta's
        prefix from scratch under the normal page budget."""
        beta = stream.beta
        self._abort_stream(stream)
        inst = self.instances[beta.iid]
        self.backend.on_preempt(beta)    # trim partially-imported pages
        beta.shared_pages = 0
        if inst.role == "decode":
            raise HandoffStreamError(
                f"beta {beta.rid}: destination out of pages mid-stream "
                f"and a decode-only instance cannot recompute")
        self._requeue_for_recompute(inst, beta)
        beta.ready = self.now
        self.pool_events.append((self.now, f"handoff-recompute {beta.rid}"))
        if self._dec:
            self.record_decision("recompute", {
                "rid": beta.rid, "req": beta.mr.parent.rid,
                "iid": beta.iid, "cause": "stream_oom"})
        self._push(self.now, "kick", beta.iid)

    # ---------------- metrics ----------------
    def _metrics(self, requests: Sequence[Request]) -> SessionMetrics:
        slo = self.cfg.slo
        tbts: List[float] = []
        ttfts: List[float] = []
        tok_total = 0
        tok_in = 0
        req_ok = 0
        completed = 0
        n_rej = sum(1 for st in self.req_states.values() if st.rejected)
        n_can = sum(1 for st in self.req_states.values() if st.cancelled)
        t_end = max((st.done_at or self.now) for st in self.req_states.values()) \
            if self.req_states else self.now
        duration = max(t_end, 1e-9)
        per_class: Dict[str, ClassReport] = {}

        def class_of(st: ReqState) -> ClassReport:
            name = st.req.slo.name if st.req.slo is not None else "default"
            if name not in per_class:
                per_class[name] = ClassReport(name)
            return per_class[name]

        cls_ttfts: Dict[str, List[float]] = {}
        cls_tbts: Dict[str, List[float]] = {}
        for st in self.req_states.values():
            cr = class_of(st)
            cr.offered += 1
            if st.rejected:
                cr.rejected += 1
                continue
            if st.cancelled:
                cr.cancelled += 1
                continue
            if st.done_at is None:
                continue
            completed += 1
            cr.completed += 1
            cls_slo = st.req.slo.tbt if st.req.slo is not None else slo
            if st.ttft is not None:
                ttfts.append(st.ttft)
                cls_ttfts.setdefault(cr.name, []).append(st.ttft)
            ts = st.token_times
            gaps = [b - a for a, b in zip(ts, ts[1:])]
            tbts.extend(gaps)
            cls_tbts.setdefault(cr.name, []).extend(gaps)
            tok_total += len(ts)
            cr.tokens += len(ts)
            ok = sum(1 for g in gaps if g <= slo) + (1 if ts else 0)
            tok_in += ok
            cr.tokens_in_slo += \
                sum(1 for g in gaps if g <= cls_slo) + (1 if ts else 0)
            if all(g <= slo for g in gaps):
                req_ok += 1
        for name, cr in per_class.items():
            cr.goodput = cr.tokens_in_slo / duration
            tf = cls_ttfts.get(name, [])
            tb = cls_tbts.get(name, [])
            cr.ttft_p50 = pctl(tf, 50)
            cr.ttft_p99 = pctl(tf, 99)
            cr.tbt_p99 = pctl(tb, 99)
        mfu, hbm, busy = [], [], []
        inst_seconds = 0.0
        for inst in self.instances:
            mfu.append(inst.flops_done / max(duration, 1e-9) / self.cost.hw.peak_flops)
            hbm.append(min(1.0, (self.cost.weight_bytes +
                                 inst.kv_tokens_resident *
                                 self.cost.kv_bytes_per_tok_at(
                                     self.backend.pool_precision(inst.iid)))
                           / self.cfg.hbm_bytes))
            busy.append(inst.busy_time / max(duration, 1e-9))
            inst_seconds += inst.active_seconds(duration)
        return SessionMetrics(
            duration=duration,
            completed=completed,
            offered=len(requests),
            tokens_total=tok_total,
            tokens_in_slo=tok_in,
            tbts=np.asarray(tbts),
            ttfts=np.asarray(ttfts),
            req_attained=req_ok / max(1, completed),
            scheduling_overheads=np.asarray(self.sched_overheads),
            per_instance_busy=busy,
            per_instance_mfu=mfu,
            per_instance_hbm=hbm,
            transfer_exposed_total=self.transfer_exposed,
            transfer_bytes_total=self.transfer_bytes,
            instance_seconds=inst_seconds,
            n_instances_peak=self.n_instances_peak,
            n_instances_final=len(self.active_instances()),
            migrations=self.migrations,
            migration_bytes=self.migration_bytes,
            preemptions=self.preemptions,
            pool_events=list(self.pool_events),
            rejected=n_rej,
            cancelled=n_can,
            per_class=per_class,
            prefix_lookups=self.prefix_lookups,
            prefix_hits=self.prefix_hits,
            prefix_saved_tokens=self.prefix_saved_tokens,
            prefix_handoff_saved_tokens=self.prefix_handoff_saved_tokens,
            prefix_evictions=self.backend.prefix_evictions,
            prefill_tokens_computed=self.prefill_tokens_computed,
        )
