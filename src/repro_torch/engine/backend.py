"""Real-engine substrate for the shared ``ServeSession`` driver, on torch.

``EngineBackend`` is the wall-clock counterpart of the simulator's
``SimBackend``: batches the session's local schedulers compose execute
on torch ``InstanceEngine``s (the hand-written CUDA attention kernels
on a card, their plain versions on the CPU), sampled tokens stream back
through the session's handles, and KV handoffs physically move page
tensors between engines via ``export_state`` / ``import_state``.

This mirrors ``repro.engine.backend``; only the device plumbing
differs.  All instances share ONE set of weight tensors and each owns
its page pool, so two instances can time-share one card.  Because all
scheduling lives in the session/policies (verbatim copies of the
reference), scheduler decisions are the same function of the same
inputs as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.costmodel import BatchCostModel, HardwareSpec
from repro_torch.core.precision import get_precision
from repro_torch.core.request import Request
from repro_torch.core.session import (
    Backend, ExecResult, HandoffStreamError, InstanceState, MicroState,
)
from repro_torch.engine.block_allocator import OutOfPages, pages_for
from repro_torch.engine.runner import (
    DEFAULT_MAX_CHUNK, BatchItem, InstanceEngine, StepHandle,
)
from repro_torch.engine.sampling import sample
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import supports_paged_kv

#: One NVIDIA H100 SXM 80 GB: NVIDIA data-sheet peaks (dense bf16
#: tensor-core FLOP/s, HBM3 bandwidth, NVLink bandwidth each way), not
#: measurements.  The default hardware the port's cost model prices.
H100 = HardwareSpec("H100-SXM-80G", peak_flops=989e12, hbm_bw=3.35e12,
                    link_bw=450e9)


@dataclasses.dataclass
class _ReqRecord:
    """Per-request engine-side state shared by its micro-requests."""
    prompt: np.ndarray             # (P,) int32
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)

    @property
    def full_seq(self) -> np.ndarray:
        """Prompt + generated tokens — the source for prefill grants,
        including KV-recompute of preempted requests (whose 'prefill'
        extends past the prompt into already-generated positions)."""
        if not self.generated:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int32)])

    @property
    def sampled_upto(self) -> int:
        """First position whose token has NOT been sampled yet."""
        return len(self.prompt) + len(self.generated)


@dataclasses.dataclass(eq=False)
class _EngineToken:
    """An in-flight dispatched batch: the device work is running; the
    sampling plan waits for ``collect``."""
    eng: InstanceEngine
    step: Optional[StepHandle]
    sampled: List[Tuple[MicroState, int]]
    t0: float


class _KVStream:
    """A background alpha→beta KV transfer, pumped piece-by-piece by the
    session between batches.  Double-buffered: piece k+1 is exported
    (device→host) before piece k is imported, so the export of the next
    chunk overlaps the import of the current one and the source engine
    is never idle-blocked on the destination."""

    def __init__(self, backend: "EngineBackend", src_eng: InstanceEngine,
                 dst_eng: InstanceEngine, src_slot: int, dst_slot: int,
                 src: MicroState, dst: MicroState, start: int,
                 dst_iid: int):
        self.backend = backend
        self.src_eng = src_eng
        self.dst_eng = dst_eng
        self.src_slot = src_slot
        self.dst_slot = dst_slot
        self.dst_iid = dst_iid
        self.src = src
        self.dst = dst
        self.upto = src.pos
        self.total_bytes = backend._transfer_bytes(src_eng, src.pos,
                                                   start=start)
        self.saved_bytes = backend._transfer_saved(src_eng, src.pos,
                                                   start=start)
        self.sent = 0.0
        self._gen = src_eng.export_state_iter(
            src_slot, upto=src.pos, chunk=backend.transfer_chunk,
            start=start)
        # export-ahead: the first piece is snapshotted at stream start
        self._next_piece = next(self._gen, None)

    def pump(self) -> Optional[float]:
        """Import one piece; export the next one ahead.  Returns bytes
        moved, or None when the stream is complete (the beta's position
        then covers the full handoff).  ``OutOfPages`` on the import
        propagates to the caller."""
        piece = self._next_piece
        if piece is None:
            self.dst.pos = max(self.dst.pos, self.upto)
            return None
        # double-buffer: snapshot piece k+1 before importing piece k
        self._next_piece = next(self._gen, None)
        self.dst_eng.import_state(self.dst_slot, [piece])
        if self._next_piece is None:
            nb = self.total_bytes - self.sent
            # stream complete: credit the quantization wire savings
            self.backend._credit_saved(self.dst_iid, self.saved_bytes)
        else:
            lo, hi = piece["span"]
            nb = min(self.total_bytes - self.sent,
                     (hi - lo) * self.backend.cost.kv_bytes_per_tok_at(
                         self.src_eng.kv_precision))
        self.sent += nb
        self.backend.kv_bytes_moved += int(nb)
        return float(nb)

    def abort(self) -> None:
        self._next_piece = None
        close = getattr(self._gen, "close", None)
        if close is not None:
            close()


class EngineBackend(Backend):
    virtual_clock = False
    emits_tokens = True

    def __init__(self, cfg: ModelConfig, params, n_slots: int = 8,
                 max_len: int = 512, hw: HardwareSpec = H100,
                 transfer_chunk: int = 32, seed: int = 0,
                 kv_mode: str = "auto", page_size: int = 8,
                 n_pages: Optional[int] = None,
                 max_chunk: int = DEFAULT_MAX_CHUNK,
                 prefix_cache: bool = False,
                 kv_precision="bf16",
                 devices_per_instance=1):
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.transfer_chunk = transfer_chunk
        self.max_chunk = max_chunk       # engine padding-bucket ceiling
        self.kv_mode = kv_mode
        self.paged = (kv_mode == "paged" or
                      (kv_mode == "auto" and supports_paged_kv(cfg)))
        if prefix_cache and not self.paged:
            raise ValueError("prefix_cache requires a paged KV mode")
        self.prefix_cache = prefix_cache
        self.has_prefix_cache = prefix_cache
        self.page_size = page_size if self.paged else None
        self.n_pages = (n_pages if n_pages is not None
                        else n_slots * pages_for(max_len, page_size)) \
            if self.paged else None
        self.cost = BatchCostModel(cfg, hw)
        self.engines: Dict[int, InstanceEngine] = {}
        self.records: Dict[str, _ReqRecord] = {}
        self._slots: Dict[str, Tuple[int, int]] = {}   # micro rid -> (iid, slot)
        self.kv_bytes_moved = 0
        # per-page KV precision: a single spec for every instance, or a
        # dict/sequence mapping instance id -> format for heterogeneous
        # pools (e.g. a bf16 interactive pool next to an fp8 batch pool)
        self.kv_precision = kv_precision
        # per-instance shard width: a single int for a homogeneous pool,
        # or a dict/sequence mapping instance id -> device count for a
        # mixed pool (e.g. a wide TP=4 instance next to 1-device ones)
        self.devices_per_instance = devices_per_instance
        self.hw = hw
        self._costs: Dict[int, BatchCostModel] = {1: self.cost}
        self.handoff_bytes_saved = 0
        self.handoff_saved_by_iid: Dict[int, int] = {}
        self._rng = np.random.default_rng(seed)

    def _precision_for(self, iid: int):
        spec = self.kv_precision
        if isinstance(spec, dict):
            spec = spec.get(iid, spec.get("default", "bf16"))
        elif isinstance(spec, (list, tuple)):
            spec = spec[iid % len(spec)]
        return get_precision(spec)

    # ---------------- sharded instances ----------------
    def devices_for(self, iid: int) -> int:
        """Shard width (device count) of instance ``iid`` under the
        configured spec (int | dict | sequence, like kv_precision)."""
        spec = self.devices_per_instance
        if isinstance(spec, dict):
            spec = spec.get(iid, spec.get("default", 1))
        elif isinstance(spec, (list, tuple)):
            spec = spec[iid % len(spec)]
        return max(1, int(spec))

    def set_devices(self, iid: int, n: int) -> None:
        """Pin instance ``iid``'s shard width (the elastic controller's
        width↔count trades call this before re-spawning)."""
        spec = self.devices_per_instance
        if not isinstance(spec, dict):
            if isinstance(spec, (list, tuple)):
                spec = {i: spec[i % len(spec)] for i in range(len(spec))}
            else:
                spec = {"default": int(spec)}
            self.devices_per_instance = spec
        spec[iid] = max(1, int(n))

    def cost_for(self, iid: int) -> BatchCostModel:
        """Cost model matching instance ``iid``'s shard width — the
        schedulers' probes and budgets price a TP=2 instance with TP=2
        latencies (one model per width, cached)."""
        n = self.devices_for(iid)
        if n not in self._costs:
            self._costs[n] = BatchCostModel(self.cfg, self.hw, tp_degree=n)
        return self._costs[n]

    def _instance_devices(self, iid: int):
        """Device list of instance ``iid``: ``None`` (the engine runs on
        the device of the shared weights).  Sharded instances are a later
        slice of the port (ROADMAP.md queue A item 10)."""
        n = self.devices_for(iid)
        if n > 1:
            raise NotImplementedError(
                f"instance {iid} wants {n} devices; sharded instances are "
                f"not ported yet (ROADMAP.md queue A item 10)")
        return None

    def _credit_saved(self, iid: int, nbytes: int) -> None:
        if nbytes <= 0:
            return
        self.handoff_bytes_saved += int(nbytes)
        self.handoff_saved_by_iid[iid] = \
            self.handoff_saved_by_iid.get(iid, 0) + int(nbytes)

    # ---------------- pool lifecycle ----------------
    def spawn(self, iid: int) -> None:
        if iid not in self.engines:
            eng = InstanceEngine(
                self.cfg, self.params, self.n_slots, self.max_len,
                kv_mode=self.kv_mode,
                page_size=self.page_size or 8, n_pages=self.n_pages,
                max_chunk=self.max_chunk, prefix_cache=self.prefix_cache,
                kv_precision=self._precision_for(iid).name,
                devices=self._instance_devices(iid))
            # the engine owns the auto-mode rule; the backend's page
            # bookkeeping (register/admission/total_pages) must agree
            assert eng.paged == self.paged, \
                (f"kv_mode resolution diverged: backend={self.paged}, "
                 f"engine={eng.paged}")
            self.engines[iid] = eng

    def retire(self, iid: int) -> None:
        self.engines.pop(iid, None)

    # ---------------- KV occupancy (memory-pressure surface) ----------
    def free_pages(self, iid: int) -> Optional[int]:
        eng = self.engines.get(iid)
        return eng.free_pages if eng is not None else None

    def total_pages(self, iid: int) -> Optional[int]:
        return self.n_pages

    def pool_precision(self, iid: int):
        eng = self.engines.get(iid)
        if eng is not None:
            return eng.kv_precision
        return self._precision_for(iid)

    def describe(self) -> Dict[str, object]:
        """Static substrate config for the flight recorder's ``meta``
        event (a replay of an engine log runs on a SimBackend built
        over the same cost model)."""
        return {
            "kind": "engine",
            "arch": self.cfg.name,
            "n_slots": self.n_slots,
            "max_len": self.max_len,
            "paged": self.paged,
            "page_size": self.page_size,
            "n_pages": self.n_pages,
            "prefix_cache": self.prefix_cache,
            "transfer_chunk": self.transfer_chunk,
            "max_chunk": self.max_chunk,
            "kv_precision": (self.kv_precision
                             if isinstance(self.kv_precision, str)
                             else "mixed"),
            "devices_per_instance": (self.devices_per_instance
                                     if isinstance(self.devices_per_instance,
                                                   int)
                                     else "mixed"),
        }

    def gauges(self, iid: int) -> Dict[str, float]:
        """Engine-side occupancy sample for /metrics: slot and KV-page
        utilisation, per-precision page occupancy, quantized-handoff
        savings, plus prefix-cache size, per instance."""
        eng = self.engines.get(iid)
        if eng is None:
            return {}
        out: Dict[str, float] = {
            "slots_free": float(eng.n_free),
            "slots_total": float(self.n_slots),
            "kv_bytes_moved": float(self.kv_bytes_moved),
            "devices": float(eng.tp),
        }
        if self.paged:
            out["kv_pages_free"] = float(eng.free_pages)
            out["kv_pages_total"] = float(self.n_pages)
            prec = eng.kv_precision
            out["kv_frames_free"] = float(eng.free_pages * prec.frames)
            out["kv_frames_total"] = float(self.n_pages * prec.frames)
            if eng.allocator is not None:
                for name, n in eng.allocator.used_by_precision().items():
                    out[f"kv_pages_used_{name}"] = float(n)
            out["handoff_bytes_saved"] = \
                float(self.handoff_saved_by_iid.get(iid, 0))
        if eng.prefix is not None:
            out["prefix_cache_pages"] = float(eng.prefix.n_pages)
            out["prefix_pinned_pages"] = float(eng.prefix.pinned_pages)
        return out

    # ---------------- request plumbing ----------------
    def register(self, req: Request, prompt=None) -> None:
        if req.rid in self.records:
            return
        if prompt is None and req.prompt_tokens is not None:
            # shared-prefix traces carry real token ids (folded into the
            # model's vocab id-stably, so shared prefixes stay shared)
            prompt = np.asarray(req.prompt_tokens) % self.cfg.vocab_size
        if prompt is None:
            # trace replay supplies lengths only: synthesize the prompt
            prompt = self._rng.integers(0, self.cfg.vocab_size, req.P)
        prompt = np.asarray(prompt, np.int32)
        total = len(prompt) + req.decode_len
        if self.paged:
            # paged engines bound sequences by the page pool, not a
            # per-slot max_len — a request may grow past max_len by
            # appending pages, it just cannot exceed the whole pool
            if pages_for(total, self.page_size) > self.n_pages:
                raise ValueError(
                    f"request {req.rid}: P+D = {total} needs "
                    f"{pages_for(total, self.page_size)} pages, pool has "
                    f"{self.n_pages}")
        elif total > self.max_len:
            raise ValueError(
                f"request {req.rid}: P+D = {total} "
                f"exceeds engine max_len {self.max_len}")
        self.records[req.rid] = _ReqRecord(prompt, req.decode_len)

    def forget(self, rid: str) -> None:
        self.records.pop(rid, None)

    def on_place(self, iid: int, micro: MicroState) -> bool:
        eng = self.engines.get(iid)
        if eng is None or eng.n_free == 0:
            return False
        self._slots[micro.rid] = (iid, eng.alloc(micro.rid))
        return True

    def release(self, micro: MicroState) -> None:
        loc = self._slots.pop(micro.rid, None)
        if loc is not None:
            eng = self.engines.get(loc[0])
            if eng is not None:
                rec = self.records.get(micro.mr.parent.rid)
                if rec is not None:
                    # index the resident *prompt* pages before the slot
                    # frees them — the shared-prefix cache keys on
                    # client-sent tokens only, so the simulator (which
                    # never sees sampled tokens) indexes identically
                    eng.remember(loc[1], rec.prompt)
                eng.free(loc[1])

    # ---------------- shared-prefix cache ----------------
    def cached_prefix(self, iid: int, req: Request) -> int:
        eng = self.engines.get(iid)
        rec = self.records.get(req.rid)
        if eng is None or rec is None:
            return 0
        return eng.lookup_prefix(rec.prompt)

    def claim_prefix(self, micro: MicroState, limit: int) -> int:
        loc = self._slots.get(micro.rid)
        if loc is None:
            return 0
        eng = self.engines.get(loc[0])
        rec = self.records.get(micro.mr.parent.rid)
        if eng is None or rec is None:
            return 0
        return eng.register(loc[1], rec.prompt, max_tokens=limit)

    def pinned_prefix_pages(self, iid: int) -> int:
        eng = self.engines.get(iid)
        return eng.prefix.pinned_pages if eng is not None and eng.prefix \
            else 0

    @property
    def prefix_evictions(self) -> int:
        return sum(e.prefix.evictions for e in self.engines.values()
                   if e.prefix is not None)

    def check_invariants(self) -> None:
        for eng in self.engines.values():
            eng.check_invariants()

    def on_preempt(self, micro: MicroState) -> None:
        """Memory-pressure preemption: drop the micro's KV pages (the
        slot stays reserved); the session re-queues it for recompute."""
        loc = self._slots.get(micro.rid)
        if loc is not None:
            eng = self.engines.get(loc[0])
            if eng is not None:
                eng.preempt(loc[1])

    # ---------------- execution ----------------
    def _build(self, grants: Sequence[Tuple[MicroState, int]],
               decs: Sequence[MicroState]) \
            -> Tuple[List[BatchItem], List[Tuple[MicroState, int]]]:
        items: List[BatchItem] = []
        sampled: List[Tuple[MicroState, int]] = []
        for m, g in grants:
            rec = self.records[m.mr.parent.rid]
            slot = self._slots[m.rid][1]
            # source is prompt + generated: KV recompute of a preempted
            # request "prefills" through already-generated positions
            toks = rec.full_seq[m.pos:m.pos + g]
            # the pass consuming the last *unsampled* position emits the
            # next token (for a fresh prefill that is the last prompt
            # token -> first output token; recompute passes re-sample
            # nothing)
            want = (m.pos + g) >= rec.sampled_upto
            items.append(BatchItem(slot, toks, m.pos, want_logits=want))
            if want:
                sampled.append((m, slot))
        for m in decs:
            rec = self.records[m.mr.parent.rid]
            slot = self._slots[m.rid][1]
            tok = rec.generated[-1] if rec.generated else int(rec.prompt[-1])
            items.append(BatchItem(slot, np.array([tok], np.int32), m.pos,
                                   want_logits=True))
            sampled.append((m, slot))
        return items, sampled

    def dispatch(self, inst: InstanceState,
                 grants: Sequence[Tuple[MicroState, int]],
                 decs: Sequence[MicroState], now: float = 0.0):
        """Non-blocking submission: build the batch, issue the step
        (torch launches asynchronously), return a token.  The
        session polls it and calls ``collect`` when the device logits
        are (nearly) ready — host-side scheduling and KV streaming
        happen in between."""
        eng = self.engines[inst.iid]
        items, sampled = self._build(grants, decs)
        t0 = time.monotonic()
        step = eng.dispatch_batch(items)
        return _EngineToken(eng=eng, step=step, sampled=sampled, t0=t0)

    def poll(self, token) -> bool:
        return token.step is None or token.step.ready()

    def collect(self, token) -> ExecResult:
        """Block on the token's step, sample, and return the result."""
        out = token.eng.collect_batch(token.step)
        latency = time.monotonic() - token.t0
        tokens: Dict[str, int] = {}
        for m, slot in token.sampled:
            if slot in out:
                tok = sample(out[slot])
                self.records[m.mr.parent.rid].generated.append(tok)
                tokens[m.rid] = tok
        return ExecResult(latency=latency, tokens=tokens, deferred=False)

    def execute(self, inst: InstanceState,
                grants: Sequence[Tuple[MicroState, int]],
                decs: Sequence[MicroState]) -> ExecResult:
        return self.collect(self.dispatch(inst, grants, decs))

    # ---------------- KV/state movement ----------------
    def _transfer_bytes(self, eng: InstanceEngine, upto: int,
                        start: int = 0) -> int:
        """Bytes a handoff of tokens ``[start, upto)`` actually puts on
        the wire: paged engines ship whole pages (state_bytes counts the
        padding), dense engines move exactly the analytic amount."""
        if eng.paged:
            return int(eng.state_bytes(upto, start=start))
        return int(self.cost.kv_transfer_bytes(upto))

    def _transfer_saved(self, eng: InstanceEngine, upto: int,
                        start: int = 0) -> int:
        """Wire bytes a quantized pool's handoff avoided relative to
        shipping the same span at bf16 (0 for unquantized pools)."""
        if not eng.paged or not eng.kv_precision.quantized:
            return 0
        return int(eng.state_bytes(upto, start=start, as_precision="bf16")
                   - eng.state_bytes(upto, start=start))

    def do_handoff(self, src: MicroState, dst: MicroState) -> float:
        """Chunk-wise KV/state handoff from the finished alpha to its
        beta (paper §4.3), on actual page tensors.  When the session
        claimed a cached prefix on the destination (the beta's block
        table already covers it), only the missed tail ships."""
        si, ss = self._slots[src.rid]
        di, ds = self._slots[dst.rid]
        src_eng = self.engines[si]
        dst_eng = self.engines[di]
        start = 0
        if src_eng.paged and dst_eng.allocator is not None:
            start = min(dst_eng.allocator.len_of(ds), src.pos)
            start -= start % src_eng.page_size
        pieces = src_eng.export_state(ss, upto=src.pos,
                                      chunk=self.transfer_chunk,
                                      start=start)
        dst_eng.import_state(ds, pieces)
        dst.pos = src.pos
        nbytes = self._transfer_bytes(src_eng, src.pos, start=start)
        self.kv_bytes_moved += nbytes
        self._credit_saved(di, self._transfer_saved(src_eng, src.pos,
                                                    start=start))
        return float(nbytes)

    def handoff_stream(self, src: MicroState,
                       dst: MicroState) -> Optional[_KVStream]:
        """Open a background alpha→beta KV stream (the overlapped form
        of ``do_handoff``): same page-aligned prefix-skip, but pieces
        move one ``stream_pump`` at a time, interleaved with batches.
        Returns None when there is nothing to move (the session then
        completes the handoff synchronously for free)."""
        si, ss = self._slots[src.rid]
        di, ds = self._slots[dst.rid]
        src_eng = self.engines[si]
        dst_eng = self.engines[di]
        start = 0
        if src_eng.paged and dst_eng.allocator is not None:
            start = min(dst_eng.allocator.len_of(ds), src.pos)
            start -= start % src_eng.page_size
        if start >= src.pos:
            dst.pos = max(dst.pos, src.pos)
            return None
        return _KVStream(self, src_eng, dst_eng, ss, ds, src, dst, start,
                         dst_iid=di)

    def stream_pump(self, stream: _KVStream) -> Optional[float]:
        try:
            return stream.pump()
        except OutOfPages as e:
            raise HandoffStreamError(str(e)) from e

    def stream_abort(self, stream: _KVStream) -> None:
        stream.abort()

    def on_migrate(self, micro: MicroState, src_iid: int,
                   dst_iid: int) -> bool:
        dst = self.engines.get(dst_iid)
        if dst is None or dst.n_free == 0:
            return False
        old_iid, old_slot = self._slots[micro.rid]
        new_slot = dst.alloc(micro.rid)
        if micro.pos > 0 and micro.ready != float("inf"):
            pieces = self.engines[old_iid].export_state(
                old_slot, upto=micro.pos, chunk=self.transfer_chunk)
            try:
                dst.import_state(new_slot, pieces)
            except OutOfPages:
                # destination pool cannot hold the resident KV: decline
                # the migration instead of crashing the session
                dst.free(new_slot)
                return False
            self.kv_bytes_moved += self._transfer_bytes(
                self.engines[old_iid], micro.pos)
            self._credit_saved(dst_iid, self._transfer_saved(
                self.engines[old_iid], micro.pos))
        self.engines[old_iid].free(old_slot)
        self._slots[micro.rid] = (dst_iid, new_slot)
        return True
