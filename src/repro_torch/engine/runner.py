"""Per-instance execution engine on torch: one device, or a sharded
instance over several.

One ``InstanceEngine`` is the runtime of one *unified instance* in
DynaServe terms: it owns a slot-pooled KV/state cache and executes the
batches the local scheduler composes.  A batch is a set of (slot, token
span) items — prefill chunks of any length and decode steps (length 1)
run together in ONE forward call, the paper's unified mixed batch, laid
out by the engine's layout (``engine.layout``): packed rows, or (slots,
the longest item's bucket).

This mirrors ``repro.engine.runner.InstanceEngine`` with its page pool
and its dense slot cache.  The engine lives on the device of its
parameters; its cache is updated in place.  Exported handoff pieces keep
the reference's dict shape, with their arrays left as tensors on the
engine's device (the handoff between two instances on one card never
leaves it).

A sharded instance (``devices=[...]``, n of them) runs every step on n
shard threads (``models.tp.ShardGroup``), each with its own params view,
cache shard and device: tensor-parallel attention and MLP (heads / ffn
sharded, summed at the output projections) and expert-parallel MoE (each
shard owns a contiguous expert slice).  KV shards over kv_heads, each
shard's pool allocated at ``KV / n`` heads; the shards share one page
allocator, one set of block tables and one prefix cache.
``export_state`` gathers the shards into the portable single-device piece
format and ``import_state`` scatters it, so handoffs cross widths.
Repeated devices (``["cpu", "cpu"]``, two shards of one card) behave as
the reference's virtual devices do: the shards time-share the device.

An engine whose shards all lie on one card (a one-device engine, or a
sharded one on a repeated device) runs its step as the reference's
``jax.jit`` of the step (of ``shard_map`` over it, for a sharded one)
does: compiled once per key of its layout, ``(rung, n_pp)`` or ``(T,
n_pp)``, and dispatched without waiting.  At a key's first use the
engine captures the step into a CUDA graph (``_capture``: after an
eager warm-up that changes no cache byte, into one memory pool a
device); each later step of that key copies its inputs into the graph's
static buffer and replays it, on the caller's thread with no shard
turn.  ``graphs=False`` runs the eager step instead, as a CPU engine
and one over distinct cards always do (``can_graph``).  ``dispatch_batch``
waits on the device in neither mode: inputs go through pinned host
buffers with non-blocking copies, and the write plans have static
shapes.  A graph holds the addresses of the params and caches it read,
which the engine only ever writes in place; a caller that rebinds one
calls ``drop_graphs``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.convert import to_torch
from repro_torch.core.precision import get_precision
from repro_torch.engine.block_allocator import (
    BlockAllocator, CapacityError, OutOfPages, pages_for,
)
from repro_torch.engine.layout import (  # noqa: F401 (row_ladder, rung_chunk)
    PaddedLayout, RowLayout, bucket_ladder, bucket_of, row_ladder,
    rung_chunk,
)
from repro_torch.engine.prefix_cache import PrefixCache
from repro_torch.kernels.ops import (
    add_launch_counts, launch_counts, quantize_kv,
)
from repro_torch.kernels.ref import as_indexable
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (
    forward, init_cache, init_paged_cache, supports_paged_kv,
)
from repro_torch.models.tp import ShardGroup
from repro_torch.utils import trace
from repro_torch.utils.device import as_device, torch_dtype
from repro_torch.utils.sharding import (
    shard_params, tp_cache_specs, tp_param_specs,
)

DEFAULT_MAX_CHUNK = 512


@dataclasses.dataclass
class BatchItem:
    slot: int
    tokens: np.ndarray          # (t,) int32 token ids to feed
    pos_offset: int             # absolute position of tokens[0]
    want_logits: bool = False   # final chunk of prefill / decode step


@dataclasses.dataclass(eq=False)
class StepHandle:
    """An in-flight forward step: its kernels (or its graph's replay) are
    queued on the device but its logits have not been copied to the
    host.  ``logits`` is the step's own tensor (a graphed step's is a
    clone of the graph's static output), so two handles never alias.
    ``ready()`` probes completion without blocking through a CUDA event
    recorded after the step; a CPU step is always ready.  With tracing on
    (``utils.trace``), ``record`` is the step's record and ``start`` a
    timing event recorded just before the inputs' copy, which with
    ``event`` times the step on the device."""
    items: Sequence[BatchItem]
    logits: torch.Tensor
    event: Optional[object] = None
    record: Optional[dict] = None
    start: Optional[object] = None

    def ready(self) -> bool:
        return self.event is None or self.event.query()


def _cols(t: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``t[:, ids]`` for any dtype, fp8 included."""
    return as_indexable(t)[:, ids].view(t.dtype)


def _on(device: torch.device):
    """Make ``device`` the current CUDA device of the calling thread (the
    kernels launch on its current stream); nothing for the CPU."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


@dataclasses.dataclass(eq=False)
class _Graph:
    """One captured step: the CUDA graph of the forward at one (bucket,
    n_pp) key, its static packed inputs and logits (both allocated
    outside the graph pool), and the kernel launches its capture counted,
    which every replay adds to the wrappers' counters."""
    graph: object
    inputs: torch.Tensor
    logits: torch.Tensor
    launches: Dict[str, int]


_GRAPH_POOLS: Dict[int, object] = {}     # device index -> memory pool
_CAPTURE_STREAMS: Dict[int, object] = {}
_capturing = threading.Lock()            # one capture at a time


def graph_pool(device: torch.device):
    """The memory pool that every engine's graphs on ``device`` share.
    Graphs that share it never run at once (one stream), and nothing a
    graph allocates outlives its capture (its inputs and logits live
    outside the pool), so every capture may reuse all of the pool and it
    holds about one step's temporaries, however many keys there are."""
    index = torch.device(device).index or 0
    if index not in _GRAPH_POOLS:
        _GRAPH_POOLS[index] = torch.cuda.graph_pool_handle()
    return _GRAPH_POOLS[index]


def _capture_stream(device: torch.device):
    index = device.index or 0
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(device=device)
    return _CAPTURE_STREAMS[index]


def can_graph(devices: Sequence) -> bool:
    """Whether an engine whose shards lie on ``devices`` captures its
    steps: they are one CUDA device.  A graph of shards on distinct cards
    would need a capture across devices and peer copies for the sums."""
    distinct = {as_device(d) for d in devices}
    return len(distinct) == 1 and distinct.pop().type == "cuda"


class InstanceEngine:
    """One unified instance.

    ``kv_mode`` selects the cache substrate:

    * ``"paged"`` — block-table page pool (``init_paged_cache`` +
      ``BlockAllocator``); attention runs through the paged-decode /
      chunked-prefill kernels: the hand-written CUDA kernels on a card,
      their plain versions on the CPU.  Requests grow by appending pages,
      so a sequence is bounded by the *pool*, not a per-slot ``max_len``.
    * ``"dense"`` — the (n_slots, max_len) slot cache (``init_cache``);
      required for ring-buffer / recurrent / enc-dec / frontend
      architectures, whose mixers are plain PyTorch ops.
    * ``"auto"`` (default) — paged when the architecture supports it.

    ``devices`` (n > 1 of them, of one kind) makes the instance *sharded*
    (see the module docstring); ``self.tp`` is n.  Each shard's weights
    are views of ``params`` where the shard's device is the weights' own
    (a column slice is a strided view that ``matmul`` takes without a
    copy; row and expert slices are contiguous), so shards on the
    weights' device add no weight memory; only another device gets a
    copy.  Without ``devices`` (or with one) the engine runs on the
    device of its parameters.

    ``layout`` (``engine.layout``) lays the steps out, chosen here once:
    a paged engine packs them into rows (``packed``) unless its mixture
    of experts can drop a token (capacity factor under E / K); another
    pads them to (n_slots, T).  ``buckets`` is the layout's ladder, the
    first half of the step's keys: a packed engine's rungs (each with
    its chunk, ``rung_chunks``), another's T ladder (``chunk_buckets``).
    ``graphs`` (on by default) captures the step once per (bucket, n_pp)
    key where ``can_graph(self.shard_devices)``: every shard on one
    card.  ``self.graphs`` says whether this engine does.

    ``iid`` names the instance in the engine's trace spans and step
    records (``utils.trace``).  A step's record holds ``T``, the longest
    item's bucket in ``buckets`` (1 exactly for a decode-only step), and
    ``N``, the rows it computed (``layout.rows``).  Counters, always
    kept: ``iterations`` (steps), ``rows_computed`` (the steps' N),
    ``rows_real`` (the steps' tokens), ``replays`` (graph replays),
    ``captures`` and ``capture_seconds``.
    """

    def __init__(self, cfg: ModelConfig, params, n_slots: int = 8,
                 max_len: int = 512, window_override: Optional[int] = None,
                 kv_mode: str = "auto", page_size: int = 8,
                 n_pages: Optional[int] = None,
                 max_chunk: int = DEFAULT_MAX_CHUNK,
                 prefix_cache: bool = False,
                 kv_precision: str = "bf16",
                 devices: Optional[Sequence] = None, graphs: bool = True,
                 iid: Optional[int] = None):
        if kv_mode not in ("auto", "paged", "dense"):
            raise ValueError(f"unknown kv_mode {kv_mode!r}")
        if kv_mode == "paged" and not supports_paged_kv(cfg):
            raise ValueError(f"{cfg.name} cannot run a paged KV cache")
        if kv_mode == "paged" and window_override is not None:
            raise ValueError("paged KV has no sliding-window support; "
                             "window_override requires kv_mode='dense'")
        self.cfg = cfg
        self.params = params
        self.iid = iid
        self.n_slots = n_slots
        self.max_len = max_len
        self.window_override = window_override
        self.max_chunk = max_chunk
        self.chunk_buckets = bucket_ladder(max_chunk)
        self.kv_precision = get_precision(kv_precision)
        self.devices = ([as_device(d) for d in devices]
                        if devices is not None and len(devices) > 1
                        else None)
        self.tp = len(self.devices) if self.devices else 1
        if self.tp > 1:
            self._validate_tp()
        self.shard_devices = self.devices or [params["embed"].device]
        self.device = self.shard_devices[0]
        self.paged = (kv_mode == "paged" or
                      (kv_mode == "auto" and supports_paged_kv(cfg)
                       and window_override is None))
        if self.kv_precision.quantized and not self.paged:
            raise ValueError("quantized KV formats live on the page pool; "
                             f"kv_precision={self.kv_precision.name!r} "
                             f"requires a paged KV mode")
        kv = cfg.n_kv_heads // self.tp
        if self.paged:
            self.page_size = page_size
            self.n_pages = (n_pages if n_pages is not None
                            else n_slots * pages_for(max_len, page_size))
            self.caches = [init_paged_cache(cfg, self.n_pages, page_size,
                                            kv_precision=self.kv_precision,
                                            device=d, n_kv_heads=kv)
                           for d in self.shard_devices]
            self.allocator = BlockAllocator(self.n_pages, page_size,
                                            n_slots,
                                            precision=self.kv_precision)
            self.page_buckets = bucket_ladder(self.n_pages)
        else:
            if prefix_cache:
                raise ValueError("the shared-prefix cache lives on the "
                                 "page pool; it requires a paged KV mode")
            self.page_size = None
            self.n_pages = None
            self.allocator = None
            self.caches = [init_cache(cfg, n_slots, max_len,
                                      window_override=window_override,
                                      device=d, n_kv_heads=kv)
                           for d in self.shard_devices]
        # the step's layout: a paged engine packs its tokens into rows,
        # unless its mixture can drop a token (capacity under E / K),
        # where the pads compete for capacity as in the reference
        self.packed = self.paged and not (
            cfg.moe_experts
            and cfg.moe_capacity_factor * cfg.moe_top_k < cfg.moe_experts)
        self.layout = (RowLayout if self.packed else PaddedLayout)(
            n_slots, max_chunk)
        self.buckets = self.layout.buckets
        self.rung_chunks = getattr(self.layout, "rung_chunks", None)
        # shared-prefix KV cache: trie over the page pool + per-slot
        # claims; the allocator evicts through it under pressure
        self.prefix: Optional[PrefixCache] = None
        self._claims: Dict[int, object] = {}
        if prefix_cache:
            self.prefix = PrefixCache(self.page_size)
            self.allocator.evictor = self._evict_cached_page
        # sharded instance: each shard's params and its worker thread
        self._cache_specs = tp_cache_specs(self.caches[0])
        self.shard_params = [params]
        self._group: Optional[ShardGroup] = None
        if self.tp > 1:
            self._shard_instance()
        # the compiled step: one CUDA graph per (bucket, n_pp) key, where
        # every shard lies on one card
        self.graphs = graphs and can_graph(self.shard_devices)
        self._graphs: Dict[Tuple[int, int], _Graph] = {}
        self.captures = 0
        self.capture_seconds = 0.0
        self.replays = 0
        self.free_slots = list(range(n_slots))
        self.slot_owner: Dict[int, str] = {}
        self.iterations = 0
        self.rows_computed = 0
        self.rows_real = 0
        self.prefix_hit_tokens = 0

    @property
    def cache(self) -> dict:
        """The KV/state cache (shard 0's of a sharded instance, whose
        shards' caches are ``caches``)."""
        return self.caches[0]

    # ---------------- tensor/expert parallelism ----------------
    def _validate_tp(self) -> None:
        """A sharded instance requires every shardable dim to divide the
        width: a q-sharded / kv-replicated GQA split would break the
        contiguous-group attention reshape, and partially-sharded MLPs
        buy nothing.  Archs with recurrent / cross / frontend state keep
        per-slot scatter paths that are not shard-aware."""
        cfg, tp = self.cfg, self.tp
        bad: List[str] = []
        if not all(k in ("attn", "local_attn") for k in cfg.layer_pattern):
            bad.append(f"layer pattern {cfg.layer_pattern!r} "
                       f"(attention-only archs shard)")
        if cfg.tail_kinds or cfg.cross_attention or \
                cfg.arch_type in ("vlm", "audio"):
            bad.append("tail/cross/frontend blocks do not shard")
        if cfg.n_heads % tp:
            bad.append(f"n_heads={cfg.n_heads} % {tp} != 0")
        if cfg.n_kv_heads % tp:
            bad.append(f"n_kv_heads={cfg.n_kv_heads} % {tp} != 0")
        if cfg.moe_experts:
            if cfg.moe_experts % tp:
                bad.append(f"moe_experts={cfg.moe_experts} % {tp} != 0")
        elif cfg.mlp != "none" and cfg.d_ff % tp:
            bad.append(f"d_ff={cfg.d_ff} % {tp} != 0")
        if self.kv_precision.quantized:
            bad.append(f"kv_precision={self.kv_precision.name!r} "
                       f"(quantized scale planes have no head dim to "
                       f"shard)")
        if len({d.type for d in self.devices}) > 1:
            bad.append(f"devices {[str(d) for d in self.devices]} mix "
                       f"kinds (one instance runs on one kind)")
        if bad:
            raise ValueError(
                f"{cfg.name} cannot run as a {tp}-device sharded "
                f"instance: " + "; ".join(bad))

    def _shard_instance(self) -> None:
        """Cut each shard's params out of the weights by the Megatron
        specs (views on the weights' device) and start the shard
        threads, stopped by ``close`` or when the engine is collected."""
        specs = tp_param_specs(self.cfg, self.params)
        self.shard_params = [shard_params(self.params, specs, self.tp, r, d)
                             for r, d in enumerate(self.shard_devices)]
        self._group = ShardGroup(self.tp, name=f"{self.cfg.name}-shard")
        self._closer = weakref.finalize(self, self._group.close)

    def close(self) -> None:
        """Stop a sharded instance's shard threads (a one-device instance
        has none; also done when the engine is collected) and drop the
        engine's graphs."""
        self.drop_graphs()
        if self._group is not None:
            self._closer()

    def drop_graphs(self) -> None:
        """Forget every captured step, so the next step of each key
        captures anew: a caller that rebinds a parameter or cache tensor
        calls this (in-place writes need nothing)."""
        self._graphs.clear()

    # ---------------- slot management ----------------
    def alloc(self, req_id: str) -> int:
        if not self.free_slots:
            raise CapacityError(
                f"no free KV slot for {req_id}: all {self.n_slots} in use")
        slot = self.free_slots.pop(0)
        self.slot_owner[slot] = req_id
        if not self.paged:
            self._clear_slot(slot)
        return slot

    def _clear_slot(self, slot: int) -> None:
        """Empty a dense slot for its new request: attention positions to
        -1 (empty), K/V, recurrent state, conv tails and cross K/V to 0.
        The reference leaves the previous request's state in a freed
        slot, so a request that reuses it starts its recurrence from that
        state and sees its ring entries (ROADMAP.md queue C); a page pool
        needs nothing, since a new request gets fresh pages."""
        for cache in self.caches:
            for c in cache["blocks"]:
                for k, v in c.items():
                    v[:, slot] = -1 if k == "pos" else 0
            for tc in cache.get("tail", ()):
                for k, v in tc.items():
                    v[slot] = -1 if k == "pos" else 0
            for v in cache.get("cross", {}).values():
                v[:, slot] = 0

    def free(self, slot: int) -> None:
        self.slot_owner.pop(slot, None)
        if self.allocator is not None:
            self._drop_claim(slot)
            self.allocator.free_slot(slot)
        self.free_slots.append(slot)

    def preempt(self, slot: int) -> None:
        """Release the slot's KV pages but keep the slot: the scheduler
        re-queues the request for recompute under memory pressure."""
        if self.allocator is not None:
            self._drop_claim(slot)
            self.allocator.trim(slot)

    @property
    def n_free(self) -> int:
        return len(self.free_slots)

    @property
    def free_pages(self) -> Optional[int]:
        """Free pages *including* what the prefix cache would give back
        under pressure (unpinned cached prefixes are evicted before any
        request is preempted); None for a dense cache."""
        if self.allocator is None:
            return None
        extra = self.prefix.evictable_pages if self.prefix else 0
        return self.allocator.free_pages + extra

    @property
    def mem_pressure(self) -> float:
        if self.allocator is None:
            return 0.0
        return 1.0 - self.free_pages / self.n_pages

    # ---------------- shared-prefix cache ----------------
    def _evict_cached_page(self) -> Optional[int]:
        return self.prefix.evict_one() if self.prefix else None

    def _drop_claim(self, slot: int) -> None:
        claim = self._claims.pop(slot, None)
        if claim is not None:
            self.prefix.release(claim)

    def register(self, slot: int, tokens,
                 max_tokens: Optional[int] = None) -> int:
        """Match the longest cached prefix of ``tokens`` (page-aligned,
        capped to ``max_tokens``) and splice its pages into the slot's
        block table, pinning them for the slot's lifetime.  Returns the
        number of prefix tokens whose prefill is thereby skipped."""
        if self.prefix is None or self.allocator.len_of(slot) > 0:
            return 0
        claim = self.prefix.claim(tokens, max_tokens=max_tokens,
                                  precision=self.kv_precision.name)
        if not claim.nodes:
            return 0
        self.allocator.splice(slot, claim.pages, claim.tokens)
        self._claims[slot] = claim
        self.prefix_hit_tokens += claim.tokens
        return claim.tokens

    def lookup_prefix(self, tokens) -> int:
        """Non-mutating probe: cached prefix length in tokens."""
        if self.prefix is None:
            return 0
        return self.prefix.match_len(tokens,
                                     precision=self.kv_precision.name)

    def remember(self, slot: int, tokens) -> int:
        """Index the slot's resident full pages under their token ids so
        later requests sharing the prefix can splice them (called as the
        slot's request leaves the engine, *before* ``free``).  Returns
        pages adopted."""
        if self.prefix is None:
            return 0
        page = self.page_size
        n = (min(len(tokens), self.allocator.len_of(slot)) // page) * page
        if n <= 0:
            return 0
        adopted = self.prefix.insert(tokens[:n],
                                     self.allocator.pages_of(slot),
                                     precision=self.kv_precision.name)
        self.allocator.retain(adopted)
        return len(adopted)

    def check_invariants(self) -> None:
        """Refcount coherence (debug): allocator refs == table refs +
        prefix-cache refs for every page."""
        if self.allocator is not None:
            refs = self.prefix.page_refcounts() if self.prefix else {}
            self.allocator.check(cache_refs=refs)

    # ---------------- execution ----------------
    def run_batch(self, items: Sequence[BatchItem]) -> Dict[int, np.ndarray]:
        """Execute one unified mixed batch; returns {slot: last-token logits}
        for items with want_logits."""
        return self.collect_batch(self.dispatch_batch(items))

    def _stage(self, a: np.ndarray, into: Optional[torch.Tensor] = None,
               sp=False):
        """``a`` on the engine's devices without waiting on a card:
        copied from a fresh pinned host buffer (which the host allocator
        keeps until the copy has run) with ``non_blocking=True`` on the
        current stream, into ``into`` (a graph's static input) where
        given, else to each shard's device (a CPU shard takes the host
        array).  Returns ({device: tensor}, start): with ``sp``, the open
        ``engine.dispatch`` span, an ``engine.stage`` span and, on a card,
        a timing event recorded just before the copy; else None."""
        st = sp and trace.begin("engine.stage", sp[4], self.iid)
        host = torch.from_numpy(np.ascontiguousarray(a))
        cuda = self.device.type == "cuda"
        pinned = host.pin_memory() if cuda else host
        start = None
        with _on(self.device):
            if st and cuda:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            if into is not None:
                into.copy_(pinned, non_blocking=True)
                out = {self.device: into}
            else:
                out = {d: pinned.to(d, non_blocking=True)
                       for d in dict.fromkeys(self.shard_devices)}
        if st:
            trace.end(st)
        return out, start

    def _forward(self, rank: int, buf: torch.Tensor, key: int,
                 n_pp: int) -> torch.Tensor:
        """Shard ``rank``'s step on its packed inputs: (B, vocab) f32
        last-token logits; the cache is written in place.  The layout
        reads the buffer; the cache substrate adds its page size (a
        paged engine's) or its window (a dense one's)."""
        with torch.no_grad(), _on(self.shard_devices[rank]):
            tokens, kw = self.layout.inputs(buf, key, n_pp)
            logits, _, _ = forward(
                self.shard_params[rank], self.cfg, tokens,
                cache=self.caches[rank], last_only=True,
                page_size=self.page_size,
                window_override=self.window_override, **kw)
        return logits[:, 0]

    def dispatch_batch(self, items: Sequence[BatchItem]) \
            -> Optional[StepHandle]:
        """Issue one unified mixed batch without waiting for the device.

        All host-side work happens here — laying the batch out in its
        ``layout`` (rows on the row ladder, or (n_slots, T) on the T
        ladder), the block tables padded to the page ladder, block table
        growth, staging the inputs, and the step: a replay of the key's
        graph, or the eager forward (on every shard of a sharded
        instance; this returns once each shard has enqueued its step) —
        and the kernels run on while the caller schedules the next batch
        and pumps KV streams.  A key's first use captures its graph,
        which waits on the device once.  Returns ``None`` for an empty
        batch."""
        if not items:
            return None
        sp = trace.on and trace.begin("engine.dispatch", trace.new_step(),
                                      self.iid)
        pk = sp and trace.begin("engine.pack", sp[4], self.iid)
        longest = max(len(it.tokens) for it in items)
        rows = sum(len(it.tokens) for it in items)
        key, T = self.layout.key(longest, rows)     # or raises
        n_pp, tables = 0, None
        if self.paged:
            # grow block tables to cover every item's span before the
            # write; OutOfPages here means the scheduler overcommitted.
            # Growing may copy-on-write-fork shared prefix pages the write
            # region touches — apply the KV copies first.
            forks: List[Tuple[int, int]] = []
            for it in items:
                forks.extend(self.allocator.ensure(
                    it.slot, it.pos_offset + len(it.tokens)))
            if forks:
                self._apply_forks(forks)
            n_pp = bucket_of(max(1, self.allocator.max_table_len),
                             self.page_buckets)
            tables = self.allocator.table_array(n_pp)
        N = self.layout.rows(key)
        packed = self.layout.pack(items, key, tables)
        if pk:
            trace.end(pk)
        captured = (bool(sp) and self.graphs
                    and (key, n_pp) not in self._graphs)
        logits, start, launch_ns = self._launch(key, n_pp, packed, sp)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event(enable_timing=bool(sp))
            event.record(torch.cuda.current_stream(self.device))
        self.iterations += 1
        self.rows_computed += N
        self.rows_real += rows
        handle = StepHandle(items=items, logits=logits, event=event)
        if sp:
            handle.start = start
            handle.record = {"step": sp[4], "iid": self.iid, "T": T, "N": N,
                             "n_pp": n_pp, "n_slots": self.n_slots,
                             "rows": rows, "captured": captured,
                             "device_s": launch_ns * 1e-9}
            trace.end(sp)
        return handle

    def _step(self, bufs: Dict[torch.device, torch.Tensor], key: int,
              n_pp: int, stream=None) -> torch.Tensor:
        """Every shard's step on its device's packed inputs ``bufs``;
        shard 0's logits.  One device: on the caller's thread.  Sharded:
        on the shard threads, where autograd mode and the current device
        are their own, each with ``stream`` (when given) as its current
        stream."""
        def step(rank):
            return self._forward(rank, bufs[self.shard_devices[rank]], key,
                                 n_pp)

        if self._group is None:
            return step(0)
        on = None if stream is None else (lambda r: torch.cuda.stream(stream))
        return self._group.run(step, on)[0]

    def _launch(self, key: int, n_pp: int, packed: np.ndarray, sp=False):
        """The step on ``packed``: on a graphed engine a replay of the
        key's graph (captured at first use), its inputs staged into the
        graph's static buffer and its logits cloned out, all on the
        current stream; else the eager forward.  Returns (logits, the
        start event or None, the ``engine.launch`` span's nanoseconds or
        False); ``sp``, the open ``engine.dispatch`` span, or False with
        tracing off."""
        g = self.graphs and (self._graphs.get((key, n_pp))
                             or self._capture(key, n_pp))
        bufs, start = self._stage(packed, g.inputs if g else None, sp)
        la = sp and trace.begin("engine.launch", sp[4], self.iid)
        if g:
            with _on(self.device):
                g.graph.replay()
                logits = g.logits.clone()
            add_launch_counts(g.launches)
            self.replays += 1
        else:
            logits = self._step(bufs, key, n_pp)
        return logits, start, la and trace.end(la)

    def _capture(self, key: int, n_pp: int) -> _Graph:
        """Capture the step of key (``key``, n_pp) into a CUDA graph, as
        ``jax.jit`` compiles at first use.  One eager step first, on the
        static inputs with every slot inactive, on the capture stream:
        it writes only the caches' scratch rows and keeps the recurrent
        states, builds the kernels, loads their modules and sets up the
        stream's library state (on each thread that will launch into the
        capture) outside the capture.  Then the capture, in
        ``thread_local`` mode (other threads may use the card meanwhile),
        into the device's shared pool; a sharded engine's shard threads
        launch into it in their turns, and the caching allocator gives
        every block requested on the capturing stream from the graph's
        pool, whichever thread asks.  The launches of both are taken off
        the wrappers' counters; the capture's (every shard's) are added
        back at every replay.  A failed capture raises: there is no eager
        fallback.  It leaves the pool it recorded to marked as recording
        (the allocator's end of the capture never ran) and the capture
        stream current, so the device's later captures take a fresh pool
        and the caller's stream is put back."""
        dev = self.device
        cp = trace.on and trace.begin("engine.capture", None, self.iid)
        t0 = time.perf_counter()
        with _capturing, _on(dev):
            before = launch_counts()
            caller = torch.cuda.current_stream(dev)
            try:
                inputs = torch.zeros(self.layout.buffer_len(key, n_pp),
                                     dtype=torch.int32, device=dev)
                bufs = {dev: inputs}
                stream = _capture_stream(dev)
                stream.wait_stream(caller)
                with torch.cuda.stream(stream):
                    shape = self._step(bufs, key, n_pp, stream).shape
                caller.wait_stream(stream)
                warm = launch_counts()
                logits = torch.empty(shape, dtype=torch.float32, device=dev)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=graph_pool(dev),
                                      stream=stream,
                                      capture_error_mode="thread_local"):
                    logits.copy_(self._step(bufs, key, n_pp, stream))
            except BaseException:
                _GRAPH_POOLS.pop(dev.index or 0, None)
                torch.cuda.set_stream(caller)
                raise
            finally:
                after = launch_counts()
                add_launch_counts({k: before[k] - n
                                   for k, n in after.items()})
            torch.cuda.empty_cache()        # the warm-up's cached blocks
        g = _Graph(graph, inputs, logits,
                   {k: n - warm[k] for k, n in after.items()})
        self._graphs[(key, n_pp)] = g
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        if cp:
            trace.end(cp, T=key, n_pp=n_pp)
        return g

    def collect_batch(self, handle: Optional[StepHandle]) \
            -> Dict[int, np.ndarray]:
        """Block on an in-flight step and return {slot: last-token
        logits} for its want_logits items.  A traced step waits on its
        event first, apart from the copy, and takes its device time."""
        if handle is None:
            return {}
        rec = handle.record
        if rec is not None and handle.event is not None:
            w = trace.begin("engine.wait", rec["step"], self.iid)
            handle.event.synchronize()
            trace.end(w)
            if handle.start is not None:
                rec["device_s"] = handle.start.elapsed_time(handle.event) \
                    * 1e-3
        d2h = rec is not None and trace.begin("engine.d2h", rec["step"],
                                              self.iid)
        logits = handle.logits.cpu().numpy()
        if d2h:
            trace.end(d2h)
        return {it.slot: logits[it.slot]
                for it in handle.items if it.want_logits}

    def _apply_forks(self, forks: Sequence[Tuple[int, int]]) -> None:
        """Copy KV contents of copy-on-write-forked pages (old -> new)
        in place, one indexed copy per pool tensor, so the forking slot
        may write its private copy without touching the shared
        original.  The page ids are staged like a step's inputs."""
        n = len(forks)
        ids, _ = self._stage(np.asarray([o for o, _ in forks]
                                        + [w for _, w in forks], np.int64))
        for cache, dev in zip(self.caches, self.shard_devices):
            old_ids, new_ids = ids[dev][:n], ids[dev][n:]
            for blk in cache["blocks"]:
                for t in blk.values():   # k/v pages + dequant scales
                    raw = as_indexable(t)
                    raw[:, new_ids] = raw[:, old_ids]

    def run_frontend(self, slot: int, *, extra_embeds=None, frames=None,
                     tokens: Optional[np.ndarray] = None, pos_offset: int = 0):
        """Stub-frontend prefill for VLM/audio requests: embeds the patch /
        frame embeddings (plus any leading text tokens) into the cache for
        one slot.  Runs as a dedicated call because embeddings enter below
        the token embedding layer.  Embeddings and frames may be numpy
        arrays or tensors.  Returns the slot's last-position logits.

        As in the reference, ``frames`` re-encode every row (inactive rows
        get zero frames) and the cross K/V of *every* slot is replaced;
        ``active`` gates only the self-attention and recurrent writes."""
        if self.paged:
            raise ValueError("stub-frontend prefill requires a dense "
                             "cache (paged engines serve text-only "
                             "architectures)")
        B = self.n_slots
        dev = self.device
        n_extra = (extra_embeds.shape[0] if extra_embeds is not None else 0)
        tok = None
        tvalid = 0
        if tokens is not None and len(tokens):
            tok = torch.zeros((B, len(tokens)), dtype=torch.long, device=dev)
            tok[slot] = to_torch(np.asarray(tokens), dev).long()
            tvalid = len(tokens)
        kw = {}
        if extra_embeds is not None:
            ee = torch.zeros((B,) + tuple(extra_embeds.shape),
                             dtype=torch.float32, device=dev)
            ee[slot] = to_torch(extra_embeds, dev).float()
            kw["extra_embeds"] = ee
        if frames is not None:
            fr = torch.zeros((B,) + tuple(frames.shape), dtype=torch.float32,
                             device=dev)
            fr[slot] = to_torch(frames, dev).float()
            kw["frames"] = fr
        active = torch.zeros((B,), dtype=torch.bool, device=dev)
        active[slot] = True
        total = n_extra + tvalid
        with torch.no_grad():
            logits, _, _ = forward(
                self.params, self.cfg, tok, cache=self.cache,
                pos_offset=torch.full((B,), pos_offset, dtype=torch.long,
                                      device=dev),
                active=active,
                n_valid=torch.full((B,), total, dtype=torch.long, device=dev),
                last_only=True, window_override=self.window_override, **kw)
        self.iterations += 1
        self.rows_computed += B * total
        self.rows_real += total
        return logits[slot, 0].cpu().numpy()

    # ---------------- micro-request state handoff ----------------
    def export_state(self, slot: int, upto: int, chunk: int = 0,
                     start: int = 0) -> List[dict]:
        """Extract the KV/state needed to resume this request elsewhere.

        Attention KV for positions [start, upto) is split into
        ``chunk``-sized pieces (chunk-based KV transfer, §4.3); recurrent
        state is O(1) and ships as a single piece.  Paged engines ship
        whole pages, so the chunk boundaries of the transfer align with
        page boundaries.  A non-zero ``start`` (page-aligned) skips the
        leading prefix the destination already holds — the
        prefix-cache-aware handoff ships only the pages the destination's
        cache missed.  Dense pieces are copies (the cache is written in
        place afterwards), with the reference's keys and ``None``
        entries."""
        if self.paged:
            return list(self._export_paged_iter(slot, upto, chunk,
                                                start=start))
        if start:
            raise ValueError("prefix-skipping export requires a paged "
                             "cache")
        pieces: List[dict] = []
        spans = ([(0, upto)] if not chunk else
                 [(s, min(s + chunk, upto)) for s in range(0, upto, chunk)])
        for lo, hi in spans:
            piece = {"span": (lo, hi), "blocks": []}
            for i, c in enumerate(self.cache["blocks"]):
                if "k" in c and c["k"].shape[2] >= upto:
                    piece["blocks"].append(
                        {k: self._gather(i, k, (slice(None), slot,
                                                slice(lo, hi)))
                         for k in ("k", "v", "pos")})
                else:
                    # ring buffer (sliding window): bounded — ship whole
                    # buffer with the final piece instead of spans
                    piece["blocks"].append(None)
            pieces.append(piece)
        final = pieces[-1]
        final["rings"] = [
            {k: self._gather(i, k, (slice(None), slot)) for k in c}
            if "k" in c and c["k"].shape[2] < upto else None
            for i, c in enumerate(self.cache["blocks"])]
        # recurrent / tail / cross state rides with the final piece
        final["recurrent"] = [
            {k: v[:, slot].clone() for k, v in c.items()}
            if "k" not in c else None for c in self.cache["blocks"]]
        if "tail" in self.cache:
            final["tail"] = [{k: v[slot].clone() for k, v in tc.items()}
                             for tc in self.cache["tail"]]
        if "cross" in self.cache:
            final["cross"] = {k: v[:, slot].clone()
                              for k, v in self.cache["cross"].items()}
        return pieces

    def export_state_iter(self, slot: int, upto: int, chunk: int = 0,
                          start: int = 0):
        """Lazy chunk-at-a-time export for background KV streams: each
        ``next()`` copies out exactly one piece, so the caller can
        interleave decode batches between pieces.  Dense caches fall back
        to the eager export (their final piece carries recurrent/ring
        state that must be captured together)."""
        if self.paged:
            return self._export_paged_iter(slot, upto, chunk, start=start)
        return iter(self.export_state(slot, upto, chunk, start=start))

    def _export_paged_iter(self, slot: int, upto: int, chunk: int = 0,
                           start: int = 0):
        """Page-granular export: whole physical pages, grouped into
        pieces of ``ceil(chunk / page_size)`` pages each (the transfer
        chunk is rounded *up* to page boundaries).  ``start`` (a page
        boundary) drops the leading pages from the export.  The page-id
        table is snapshotted up front (append-only KV: already-exported
        spans are immutable), then pieces are copied out lazily."""
        page = self.page_size
        if start % page:
            raise ValueError(f"export start {start} is not page-aligned")
        table = list(self.allocator.pages_of(slot))
        n_need = pages_for(upto, page)
        if n_need > len(table):
            raise OutOfPages(
                f"slot {slot}: export of {upto} tokens needs {n_need} "
                f"pages, table holds {len(table)}")
        if start >= upto:
            return
        per_piece = pages_for(chunk, page) if chunk else max(1, n_need)
        for p0 in range(start // page, max(1, n_need), per_piece):
            p1 = min(p0 + per_piece, n_need)
            ids, _ = self._stage(np.asarray(table[p0:p1], np.int64))
            piece = {"span": (p0 * page, min(p1 * page, upto)),
                     "page_size": page, "pages": [],
                     "precision": self.kv_precision.name}
            for i, c in enumerate(self.cache["blocks"]):
                shards = [cache["blocks"][i] for cache in self.caches]
                pc = {k: self._join([_cols(b[name], ids[b[name].device])
                                     for b in shards])
                      for k, name in (("k", "k_pages"), ("v", "v_pages"))}
                if "k_scales" in c:
                    # quantized pool: the per-token-row dequant scales
                    # ride with their code pages
                    pc["k_scales"] = c["k_scales"][:, ids[self.device]]
                    pc["v_scales"] = c["v_scales"][:, ids[self.device]]
                piece["pages"].append(pc)
            yield piece
            if p1 >= n_need:
                break

    def _join(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The shards' slices of one K/V leaf joined over the KV heads
        (dim -2) in shard order, on this engine's device; a single part
        as it is."""
        if len(parts) == 1:
            return parts[0]
        return torch.cat([p.to(self.device) for p in parts], dim=-2)

    def _gather(self, i: int, key: str, index) -> torch.Tensor:
        """Block ``i``'s ``key`` leaf at ``index`` as one fresh tensor:
        joined over the shards for a K/V leaf, shard 0's otherwise."""
        parts = [c["blocks"][i][key][index] for c in self.caches]
        if len(parts) == 1 or self._cache_specs["blocks"][i][key] is None:
            return parts[0].clone()
        return self._join(parts)

    def _scatter(self, i: int, key: str, src) -> List[torch.Tensor]:
        """A whole-width ``src`` (tensor or numpy) for block ``i``'s
        ``key`` leaf as each shard's part on the shard's device: split
        over the KV heads for a K/V leaf, whole otherwise."""
        src = to_torch(src, self.device)
        if self.tp == 1:
            return [src]
        parts = ([src] * self.tp
                 if self._cache_specs["blocks"][i][key] is None
                 else src.chunk(self.tp, dim=-2))
        return [p.to(d) for p, d in zip(parts, self.shard_devices)]

    def _to_pool_format(self, codes, scales):
        """Convert one exported page stack (codes (G,n,page,KV,hd) plus
        optional scales (G,n,page)) into THIS pool's storage format —
        the cross-precision handoff path: a bf16 alpha importing into a
        quantized beta pool quantizes on import, and vice versa."""
        dst = self.kv_precision
        x = to_torch(codes, self.device)
        if scales is not None:
            x = x.float() * to_torch(scales, self.device)[..., None, None]
        if not dst.quantized:
            return x.to(self.cache["blocks"][0]["k_pages"].dtype), None
        return quantize_kv(x, dst.name)

    def import_state(self, slot: int, pieces: Sequence[dict]) -> None:
        """Write exported pieces into ``slot``.  Piece arrays may be
        tensors or numpy arrays (e.g. pieces the JAX engine exported)."""
        if self.paged:
            if any("blocks" in p for p in pieces):
                raise ValueError("dense-cache pieces cannot be imported "
                                 "into a paged engine")
            self._import_paged(slot, pieces)
            return
        if any("pages" in p for p in pieces):
            raise ValueError("paged pieces cannot be imported into a "
                             "dense engine")
        cache = self.cache

        def put(dst, src):
            dst.copy_(to_torch(src, self.device))

        def put_block(i, key, index, src):
            for c, part in zip(self.caches, self._scatter(i, key, src)):
                c["blocks"][i][key][index].copy_(part)

        for piece in pieces:
            lo, hi = piece["span"]
            for i, bc in enumerate(piece["blocks"]):
                if bc is not None:
                    for k in ("k", "v", "pos"):
                        put_block(i, k, (slice(None), slot, slice(lo, hi)),
                                  bc[k])
            # ring buffers and recurrent state: whole slot, final piece
            for part in ("rings", "recurrent"):
                for i, rc in enumerate(piece.get(part) or ()):
                    if rc is not None:
                        for k, v in rc.items():
                            put_block(i, k, (slice(None), slot), v)
            for tc, new in zip(cache.get("tail", ()), piece.get("tail") or ()):
                for k, v in new.items():
                    put(tc[k][slot], v)
            if piece.get("cross"):
                for k, v in piece["cross"].items():
                    put(cache["cross"][k][:, slot], v)

    def _import_paged(self, slot: int, pieces: Sequence[dict]) -> None:
        """Allocate destination pages for every piece, then write each
        pool tensor in place with ONE indexed copy over the concatenated
        page ids.  Pieces exported from a pool of a different precision
        are converted (dequantized / requantized) page-wise on import."""
        page = self.page_size
        quantized = self.kv_precision.quantized
        nl = len(self.cfg.layer_pattern)
        keys = ["k_pages", "v_pages"] + (["k_scales", "v_scales"]
                                         if quantized else [])
        parts: List[Dict[str, list]] = [{k: [] for k in keys}
                                        for _ in range(nl)]
        all_ids: List[np.ndarray] = []
        for piece in pieces:
            if piece.get("page_size") != page:
                raise ValueError(
                    f"page_size mismatch: piece ships "
                    f"{piece.get('page_size')}-token pages, engine uses "
                    f"{page}")
            lo, hi = piece["span"]
            if hi <= lo:
                continue
            self.allocator.ensure(slot, hi)
            table = self.allocator.pages_of(slot)
            all_ids.append(np.asarray(
                table[lo // page: pages_for(hi, page)], np.int64))
            src_name = piece.get("precision", "bf16")
            for i, pc in enumerate(piece["pages"]):
                k, v = pc["k"], pc["v"]
                ks, vs = pc.get("k_scales"), pc.get("v_scales")
                if src_name != self.kv_precision.name:
                    k, ks = self._to_pool_format(k, ks)
                    v, vs = self._to_pool_format(v, vs)
                for key, a in zip(keys, (k, v, ks, vs)):
                    parts[i][key].append(to_torch(a, self.device))
        if not all_ids:
            return
        ids, _ = self._stage(np.concatenate(all_ids))
        for i, part in enumerate(parts):
            for key in keys:
                src = torch.cat([as_indexable(a) for a in part[key]], dim=1)
                for cache, shard in zip(self.caches,
                                        self._scatter(i, key, src)):
                    dst = cache["blocks"][i][key]
                    as_indexable(dst)[:, ids[dst.device]] = shard

    def _kv_itemsize(self) -> int:
        """Itemsize of the dtype the KV cache actually stores — NOT
        ``cfg.dtype``: a quantized page pool holds 1-byte codes."""
        if self.paged:
            return self.cache["blocks"][0]["k_pages"].element_size()
        for c in self.cache["blocks"]:
            if "k" in c:
                return c["k"].element_size()
        return torch_dtype(self.cfg.dtype).itemsize

    def state_bytes(self, upto: int, start: int = 0,
                    as_precision=None) -> int:
        """Bytes a handoff of tokens ``[start, upto)`` moves (for
        transfer modeling; ``start > 0`` is the prefix the destination's
        cache already holds).  Paged engines ship whole pages, so the
        attention term is rounded up to the page size; a local-attention
        layer ships at most its window; recurrent layers ship their O(1)
        f32 state.  ``as_precision`` prices the same span as if the pool
        stored that format (for savings accounting)."""
        cfg = self.cfg
        total = 0
        if as_precision is not None:
            prec = get_precision(as_precision)
            # unquantized formats store the compute dtype (f32 on the CPU
            # smoke configs), not literal 2-byte bf16
            item = prec.itemsize if prec.quantized \
                else torch_dtype(cfg.dtype).itemsize
            per_tok = 2 * cfg.n_kv_heads * cfg.hd * item
            quantized = self.paged and prec.quantized
        else:
            per_tok = 2 * cfg.n_kv_heads * cfg.hd * self._kv_itemsize()
            quantized = self.paged and self.kv_precision.quantized
        if quantized:
            # k + v per-token f32 dequant scales travel with the codes
            per_tok += 2 * 4
        if self.paged:
            upto_attn = (pages_for(upto, self.page_size)
                         - start // self.page_size) * self.page_size
        else:
            upto_attn = upto - start
        for kind in (list(cfg.layer_pattern) * cfg.n_groups)[: cfg.n_layers]:
            if kind == "attn":
                total += upto_attn * per_tok
            elif kind == "local_attn":
                total += min(upto, cfg.window or upto) * per_tok
            elif kind == "ssd":
                total += cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
            elif kind == "rglru":
                total += cfg.lru_dim * 4
        return total
