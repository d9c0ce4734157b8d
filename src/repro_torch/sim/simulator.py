"""Discrete-event cluster simulation backend.

The arrival→place→batch→handoff→finish loop lives in
``repro_torch.core.session.ServeSession`` — shared verbatim with the real JAX
engine backend (``repro_torch.engine.backend.EngineBackend``).  This module
supplies only the simulated *substrate*: a virtual clock and per-batch
latency from the analytic ``BatchCostModel`` — the same model the global
scheduler's predictor uses, so the paper's two-level scheduling runs
unmodified on top.  Reproduces the paper's evaluation (goodput vs QPS,
serving capacity, SLO attainment, replay) without GPUs.

``ClusterSim`` is the simulator-flavoured session: construct with
``(cost, policy, SimConfig)`` and ``run(trace)`` — exactly the seed API,
now including online-serving features (SLO classes, admission control,
streaming handles, ``cancel``) because the driver is shared.

The instance pool is dynamic: policies with an ``on_pool_check`` hook get
a periodic pool-control event and may ``add_instance`` / ``drain_instance``
/ ``migrate`` between batches, so elastic policies (repro_torch.core.elastic)
resize and rebalance the pool mid-trace.  Fixed-N policies see exactly
the old behaviour.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.costmodel import BatchCostModel, WorkItem
from repro_torch.core.paging import pages_for
from repro_torch.core.precision import PrecisionPolicy, get_precision
from repro_torch.core.request import Request
from repro_torch.core.session import (
    Backend, ExecResult, InstanceState, MicroState, ReqState, ServeHandle,
    ServeSession, SessionConfig, SessionMetrics, SessionStallError,
)
from repro_torch.engine.prefix_cache import PrefixCache

# Seed-era names: the runtime state classes moved into the shared driver.
SimConfig = SessionConfig
SimMetrics = SessionMetrics
SimMicro = MicroState
SimInstance = InstanceState

__all__ = [
    "ClusterSim", "InterleaveSchedule", "SimBackend", "SimConfig",
    "SimMetrics", "SimMicro", "SimInstance", "SessionStallError",
    "ServeHandle", "ReqState",
]


class InterleaveSchedule:
    """Seeded delivery order for concurrently-in-flight completions.

    With overlapped execution, several batch completions and KV-stream
    chunks can be in flight at once; on real hardware their delivery
    order depends on load.  Attached to a ``SimBackend``, this schedule
    makes that order a *controlled input*: whenever the session is
    about to deliver a completion event ("batch_done"/"xfer") and
    others are pending within ``window`` simulated seconds, the
    schedule's seeded RNG picks which one lands first.  The same seed
    replays the same ordering bit-identically; sweeping seeds explores
    orderings the real engine only hits under load.  ``mode="fifo"``
    degenerates to plain earliest-first delivery."""

    PERMUTABLE = ("batch_done", "xfer")

    def __init__(self, seed: int = 0, window: float = 1e-3,
                 width: int = 8, mode: str = "random"):
        if mode not in ("random", "fifo"):
            raise ValueError(f"unknown interleave mode {mode!r}")
        self.seed = seed
        self.window = window
        self.width = max(1, width)
        self.mode = mode
        self.rng = np.random.default_rng(seed)
        self.choices = 0       # permutation points encountered (tests)

    def choose(self, n: int) -> int:
        if n > 1:
            self.choices += 1
        if n <= 1 or self.mode == "fifo":
            return 0
        return int(self.rng.integers(n))


class SimBackend(Backend):
    """Virtual-clock substrate: batches take ``BatchCostModel.latency``
    simulated seconds and complete as deferred events, so concurrent
    instances overlap in simulated time.  No real tokens are produced
    (streaming handles receive output positions).

    With ``page_size`` + ``pages_per_instance`` the backend models the
    engine's paged KV pool: a placed micro-request occupies
    ``ceil(pos / page_size)`` pages once its KV is resident (a beta
    waiting on its handoff holds nothing, exactly like the engine's
    ``BlockAllocator``), so the memory-aware scheduler, admission
    control, and the elastic pressure signal load-shed identically on
    the simulator and on real engines."""

    virtual_clock = True
    emits_tokens = False
    max_chunk = None

    def __init__(self, cost: BatchCostModel, page_size: Optional[int] = None,
                 pages_per_instance: Optional[int] = None,
                 prefix_cache: bool = False,
                 host_overhead: float = 0.0,
                 interleave: Optional[InterleaveSchedule] = None,
                 kv_precision="bf16",
                 precision_policy: Optional[PrecisionPolicy] = None,
                 devices_per_instance=1):
        if bool(page_size) != bool(pages_per_instance):
            raise ValueError(
                "page_size and pages_per_instance must be set together "
                f"(got page_size={page_size}, "
                f"pages_per_instance={pages_per_instance}); a half-"
                "configured pool would silently disable the occupancy "
                "model the engine enforces")
        if prefix_cache and not page_size:
            raise ValueError("prefix_cache models page reuse; it needs "
                             "page_size + pages_per_instance")
        self.cost = cost
        self.page_size = page_size
        self.pages_per_instance = pages_per_instance
        self.prefix_cache = prefix_cache
        self.has_prefix_cache = prefix_cache
        # Per-batch host-side overhead (scheduling, sampling, Python):
        # the cost the dispatch-ahead pipeline hides.  0.0 keeps the
        # seed's pure-device clock, in which overlap-on and overlap-off
        # produce identical wall-clock timelines (the parity tests rely
        # on this); benchmarks set a realistic value to measure the
        # pipelining win.
        self.host_overhead = host_overhead
        # Optional seeded permutation of completion-event delivery; see
        # InterleaveSchedule.  None = deterministic earliest-first.
        self.interleave = interleave
        # per-page KV precision: ``kv_precision`` denominates each
        # instance's pool (str, or dict/sequence per-instance like the
        # engine backend's heterogeneous pools); ``precision_policy``
        # additionally maps SLO classes to per-request page formats
        # (mixed-precision pools — quantized requests commit half the
        # frames of the same pages_per_instance HBM budget)
        self.kv_precision = kv_precision
        if isinstance(precision_policy, str):
            precision_policy = PrecisionPolicy.parse(precision_policy)
        self.precision_policy = precision_policy
        # per-instance shard width (int | dict | sequence, exactly the
        # engine backend's spec): a TP=n member's batches are priced by
        # a tp_degree=n cost model, so placement/admission/split
        # decisions stay byte-identical across the two substrates
        self.devices_per_instance = devices_per_instance
        self._costs: Dict[int, BatchCostModel] = {1: cost}
        # modeled wire savings of quantized handoffs, per destination
        # instance (the engine backend meters the same quantity)
        self.handoff_bytes_saved = 0
        self.handoff_saved_by_iid: Dict[int, int] = {}
        # device-serialization state for overlapped dispatch: per
        # instance, the virtual time its device frees up
        self._device_free: Dict[int, float] = {}
        # capacity reserved by batches dispatched but not yet completed,
        # denominated in FRAMES (pool_precision.frames per page, so the
        # uniform-precision case is the old page count scaled exactly)
        self._inflight_pages: Dict[int, int] = {}
        self._placed: Dict[int, Dict[str, MicroState]] = {}
        # shared-prefix model: the engine's trie, per instance, over the
        # trace's prompt token ids with *virtual* page ids — identical
        # insert/match/evict sequences give identical hit decisions
        self._tries: Dict[int, PrefixCache] = {}
        self._claims: Dict[str, object] = {}

    def describe(self) -> Dict[str, object]:
        """Static substrate config for the flight recorder's ``meta``
        event; ``repro_torch.sim.replay`` rebuilds a SimBackend from it."""
        il = self.interleave
        return {
            "kind": "sim",
            "arch": getattr(self.cost.cfg, "name", None),
            "page_size": self.page_size,
            "pages_per_instance": self.pages_per_instance,
            "prefix_cache": self.prefix_cache,
            "host_overhead": self.host_overhead,
            "kv_precision": (self.kv_precision
                             if isinstance(self.kv_precision, str)
                             else "mixed"),
            "interleave": None if il is None else {
                "seed": il.seed, "window": il.window,
                "width": il.width, "mode": il.mode},
            "devices_per_instance": (self.devices_per_instance
                                     if isinstance(self.devices_per_instance,
                                                   int)
                                     else "mixed"),
        }

    # ---------------- sharded instances ----------------
    def devices_for(self, iid: int) -> int:
        spec = self.devices_per_instance
        if isinstance(spec, dict):
            spec = spec.get(iid, spec.get("default", 1))
        elif isinstance(spec, (list, tuple)):
            spec = spec[iid % len(spec)]
        return max(1, int(spec))

    def set_devices(self, iid: int, n: int) -> None:
        spec = self.devices_per_instance
        if not isinstance(spec, dict):
            if isinstance(spec, (list, tuple)):
                spec = {i: spec[i % len(spec)] for i in range(len(spec))}
            else:
                spec = {"default": int(spec)}
            self.devices_per_instance = spec
        spec[iid] = max(1, int(n))

    def cost_for(self, iid: int) -> BatchCostModel:
        n = self.devices_for(iid)
        if n not in self._costs:
            base = self.cost
            self._costs[n] = BatchCostModel(
                base.cfg, base.hw, tp_degree=n,
                dtype_bytes=base.dtype_bytes)
        return self._costs[n]

    # ---------------- pool lifecycle ----------------
    def spawn(self, iid: int) -> None:
        if self.prefix_cache and iid not in self._tries:
            self._tries[iid] = PrefixCache(self.page_size)

    def retire(self, iid: int) -> None:
        # the engine's cache dies with the engine; model the same
        self._tries.pop(iid, None)
        self._device_free.pop(iid, None)
        self._inflight_pages.pop(iid, None)

    # ---------------- per-page KV precision ----------------
    def pool_precision(self, iid: int):
        spec = self.kv_precision
        if isinstance(spec, dict):
            spec = spec.get(iid, spec.get("default", "bf16"))
        elif isinstance(spec, (list, tuple)):
            spec = spec[iid % len(spec)]
        return get_precision(spec)

    def request_precision(self, iid: int, slo_name):
        if self.precision_policy is not None:
            return self.precision_policy.for_slo(slo_name)
        return self.pool_precision(iid)

    def _micro_frames(self, micro: MicroState) -> int:
        """Frames one of the micro's pages costs (its request's SLO
        class sets the format under a precision policy)."""
        slo = micro.mr.parent.slo
        return self.request_precision(
            micro.iid, slo.name if slo is not None else None).frames

    # ---------------- shared-prefix model ----------------
    @staticmethod
    def _prompt_of(req: Request):
        return req.prompt_tokens

    def _req_precision_name(self, iid: int, req: Request) -> str:
        return self.request_precision(
            iid, req.slo.name if req.slo is not None else None).name

    def cached_prefix(self, iid: int, req: Request) -> int:
        trie = self._tries.get(iid)
        toks = self._prompt_of(req)
        if trie is None or toks is None:
            return 0
        return trie.match_len(
            toks, precision=self._req_precision_name(iid, req))

    def claim_prefix(self, micro: MicroState, limit: int) -> int:
        trie = self._tries.get(micro.iid)
        toks = self._prompt_of(micro.mr.parent)
        if trie is None or toks is None:
            return 0
        claim = trie.claim(toks, max_tokens=limit,
                           precision=self._req_precision_name(
                               micro.iid, micro.mr.parent))
        if not claim.nodes:
            return 0
        self._claims[micro.rid] = claim
        return claim.tokens

    def _drop_claim(self, micro: MicroState) -> None:
        claim = self._claims.pop(micro.rid, None)
        if claim is not None:
            trie = self._tries.get(micro.iid)
            if trie is not None:
                trie.release(claim)

    def pinned_prefix_pages(self, iid: int) -> int:
        trie = self._tries.get(iid)
        return trie.pinned_pages if trie is not None else 0

    @property
    def prefix_evictions(self) -> int:
        return sum(t.evictions for t in self._tries.values())

    def check_invariants(self) -> None:
        for iid, trie in self._tries.items():
            assert trie.pinned_pages <= trie.n_pages
            assert trie.pinned_pages >= 0

    # ---------------- page-occupancy model ----------------
    def on_place(self, iid: int, micro: MicroState) -> bool:
        if self.page_size:
            self._placed.setdefault(iid, {})[micro.rid] = micro
        return True

    def release(self, micro: MicroState) -> None:
        if self.page_size:
            trie = self._tries.get(micro.iid)
            toks = self._prompt_of(micro.mr.parent)
            if trie is not None and toks is not None \
                    and micro.ready != float("inf"):
                # index the resident prompt prefix, exactly like the
                # engine does before freeing the slot (virtual page ids;
                # the trie *shape* is the cross-substrate contract; a
                # beta still waiting on its handoff holds no KV)
                n = min(micro.pos, len(toks))
                trie.insert(np.asarray(toks)[:n - n % self.page_size],
                            precision=self._req_precision_name(
                                micro.iid, micro.mr.parent))
            self._drop_claim(micro)
            self._placed.get(micro.iid, {}).pop(micro.rid, None)

    def on_preempt(self, micro: MicroState) -> None:
        if self.page_size:
            self._drop_claim(micro)

    def _evict_to_fit(self, iid: int, need_frames: int) -> None:
        """Shrink the instance's trie until ``need_frames`` new frames
        fit the physical pool — the sim-side mirror of the engine
        allocator's ``_reclaim`` running inside an import's ``ensure``,
        so both tries shed LRU leaves at the same logical events."""
        trie = self._tries.get(iid)
        if trie is None:
            return
        pf = self.pool_precision(iid).frames
        phys_free = self.total_frames(iid) \
            - self._private_frames(iid) - trie.n_pages * pf
        while phys_free < need_frames:
            if trie.evict_one() is None:
                break
            phys_free += pf

    def on_handoff_import(self, beta: MicroState) -> None:
        """The beta's KV import is about to allocate its non-cached
        pages on the destination; evict cold cache entries first,
        exactly like the engine's ``_import_paged`` would.  A quantized
        stream also books its modeled wire savings vs bf16 here (the
        engine backend meters the same gauge from real exports)."""
        if self.page_size:
            self._evict_to_fit(
                beta.iid,
                (pages_for(beta.pos, self.page_size) - beta.shared_pages)
                * self._micro_frames(beta))
            slo = beta.mr.parent.slo
            prec = self.request_precision(
                beta.iid, slo.name if slo is not None else None)
            if prec.quantized and beta.pos > 0:
                saved = int(self.cost.kv_transfer_bytes(beta.pos) -
                            self.cost.kv_transfer_bytes(beta.pos, prec))
                if saved > 0:
                    self.handoff_bytes_saved += saved
                    self.handoff_saved_by_iid[beta.iid] = \
                        self.handoff_saved_by_iid.get(beta.iid, 0) + saved

    def on_migrate(self, micro: MicroState, src_iid: int,
                   dst_iid: int) -> bool:
        if self.page_size:
            if micro.pos > 0 and micro.ready != float("inf"):
                # resident KV must fit the destination pool (the engine
                # backend declines the move the same way)
                slo = micro.mr.parent.slo
                need = pages_for(micro.pos, self.page_size) \
                    * self.request_precision(
                        dst_iid,
                        slo.name if slo is not None else None).frames
                free = self.free_frames(dst_iid)
                if free is not None and free < need:
                    return False
                # the engine's import would reclaim cache pages on the
                # destination; shrink the modeled trie the same way
                self._evict_to_fit(dst_iid, need)
            # the claim stays behind (engine: the source slot is freed)
            self._drop_claim(micro)
            self._placed.get(src_iid, {}).pop(micro.rid, None)
            self._placed.setdefault(dst_iid, {})[micro.rid] = micro
        return True

    def _private_frames(self, iid: int) -> int:
        p = self.page_size
        return sum(max(0, pages_for(m.pos, p) - m.shared_pages)
                   * self._micro_frames(m)
                   for m in self._placed.get(iid, {}).values()
                   if m.ready != float("inf") and m.pos > 0)

    def _used_frames(self, iid: int) -> int:
        """Frames unavailable to new work: privately-held pages (each
        priced at its request's precision) plus the *pinned* part of
        the prefix cache — unpinned cached pages count as free because
        the engine evicts them on demand, strictly before preempting
        any request."""
        used = self._private_frames(iid)
        used += self._inflight_pages.get(iid, 0)
        trie = self._tries.get(iid)
        if trie is not None:
            used += trie.pinned_pages * self.pool_precision(iid).frames
        return used

    def free_frames(self, iid: int) -> Optional[int]:
        if not self.page_size:
            return None
        return max(0, self.total_frames(iid) - self._used_frames(iid))

    def total_frames(self, iid: int) -> Optional[int]:
        if not self.page_size:
            return None
        return self.pages_per_instance * self.pool_precision(iid).frames

    def free_pages(self, iid: int) -> Optional[int]:
        if not self.page_size:
            return None
        return self.free_frames(iid) // self.pool_precision(iid).frames

    def total_pages(self, iid: int) -> Optional[int]:
        return self.pages_per_instance if self.page_size else None

    def gauges(self, iid: int) -> Dict[str, float]:
        """Modeled occupancy sample for /metrics — the same keys the
        engine backend reports, so dashboards read identically over
        either substrate."""
        out: Dict[str, float] = {"devices": float(self.devices_for(iid))}
        if self.page_size:
            pf = self.pool_precision(iid).frames
            out["kv_pages_free"] = float(self.free_pages(iid))
            out["kv_pages_total"] = float(self.pages_per_instance)
            out["kv_frames_free"] = float(self.free_frames(iid))
            out["kv_frames_total"] = float(self.total_frames(iid))
            out["kv_pages_inflight"] = float(
                self._inflight_pages.get(iid, 0) // pf)
            used: Dict[str, int] = {}
            for m in self._placed.get(iid, {}).values():
                if m.ready == float("inf") or m.pos <= 0:
                    continue
                slo = m.mr.parent.slo
                name = self.request_precision(
                    iid, slo.name if slo is not None else None).name
                used[name] = used.get(name, 0) + max(
                    0, pages_for(m.pos, self.page_size) - m.shared_pages)
            for name, n in used.items():
                out[f"kv_pages_used_{name}"] = float(n)
            out["handoff_bytes_saved"] = \
                float(self.handoff_saved_by_iid.get(iid, 0))
        trie = self._tries.get(iid)
        if trie is not None:
            out["prefix_cache_pages"] = float(trie.n_pages)
            out["prefix_pinned_pages"] = float(trie.pinned_pages)
        return out

    # ---------------- execution ----------------
    def _batch_growth(self, grants: Sequence[Tuple[MicroState, int]],
                      decs: Sequence[MicroState]) -> int:
        """KV frames this batch will newly occupy (0 without paging) —
        each micro's new pages priced at its request's precision."""
        p = self.page_size
        if not p:
            return 0
        growth = sum((pages_for(m.pos + g, p) - pages_for(m.pos, p))
                     * self._micro_frames(m)
                     for m, g in grants)
        growth += sum(self._micro_frames(m) for m in decs
                      if m.pos % p == 0)
        return growth

    def _account_batch_growth(self, inst: InstanceState,
                              grants: Sequence[Tuple[MicroState, int]],
                              decs: Sequence[MicroState]) -> int:
        growth = self._batch_growth(grants, decs)
        trie = self._tries.get(inst.iid)
        if trie is not None:
            # the engine allocates this batch's pages inside run_batch,
            # evicting LRU cached prefixes when the free list runs dry;
            # mirror that here so both tries shrink at the same points
            pf = self.pool_precision(inst.iid).frames
            phys_free = self.total_frames(inst.iid) \
                - self._private_frames(inst.iid) - trie.n_pages * pf
            while phys_free < growth:
                if trie.evict_one() is None:
                    break
                phys_free += pf
        return growth

    def execute(self, inst: InstanceState,
                grants: Sequence[Tuple[MicroState, int]],
                decs: Sequence[MicroState]) -> ExecResult:
        self._account_batch_growth(inst, grants, decs)
        items: List[WorkItem] = \
            [WorkItem("prefill", g, m.pos) for m, g in grants] + \
            [WorkItem("decode", 1, m.pos) for m in decs]
        # the synchronous loop pays the host-side dispatch cost serially
        # before every batch — exactly what dispatch-ahead hides
        return ExecResult(latency=self.host_overhead +
                          self.cost_for(inst.iid).latency(items),
                          deferred=True)

    def dispatch(self, inst: InstanceState,
                 grants: Sequence[Tuple[MicroState, int]],
                 decs: Sequence[MicroState], now: float = 0.0):
        """Overlapped submission: the batch queues behind whatever the
        instance's device is already running (devices execute one batch
        at a time — pipelining hides *host* overhead, it does not make
        the device twice as fast) and its completion event fires when
        the device-serialized work drains.  Pages the batch will grow
        into are reserved immediately so the memory-aware scheduler and
        admission control see in-flight growth exactly like the engine's
        allocator, which allocates inside ``dispatch_batch``."""
        growth = self._account_batch_growth(inst, grants, decs)
        if growth:
            self._inflight_pages[inst.iid] = \
                self._inflight_pages.get(inst.iid, 0) + growth
        items: List[WorkItem] = \
            [WorkItem("prefill", g, m.pos) for m, g in grants] + \
            [WorkItem("decode", 1, m.pos) for m in decs]
        device = self.cost_for(inst.iid).latency(items)
        start = max(now + self.host_overhead, self._device_free.get(inst.iid, 0.0))
        done = start + device
        self._device_free[inst.iid] = done
        return ExecResult(latency=done - now, deferred=True,
                          device_time=device)

    def on_complete(self, inst: InstanceState,
                    grants: Sequence[Tuple[MicroState, int]],
                    decs: Sequence[MicroState]) -> None:
        # positions have not advanced yet, so this recomputes exactly
        # the growth reserved at dispatch; the pages flip from the
        # in-flight reservation to the micros' resident footprint
        growth = self._batch_growth(grants, decs)
        if growth:
            left = self._inflight_pages.get(inst.iid, 0) - growth
            self._inflight_pages[inst.iid] = max(0, left)


class ClusterSim(ServeSession):
    """The simulator entry point: a ``ServeSession`` over ``SimBackend``."""

    def __init__(self, cost: BatchCostModel, policy, sim_cfg: SimConfig):
        super().__init__(SimBackend(cost), policy, sim_cfg)
