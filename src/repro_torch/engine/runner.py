"""Per-instance execution engine on torch, paged KV mode, one device.

One ``InstanceEngine`` is the runtime of one *unified instance* in
DynaServe terms: it owns a page-pooled KV cache and executes the batches
the local scheduler composes.  A batch is a set of (slot, token span)
items — prefill chunks of any length and decode steps (length 1) run
together in ONE padded forward call, the paper's unified mixed batch.

This mirrors ``repro.engine.runner.InstanceEngine`` in paged mode.  The
engine lives on the device of its parameters; its page pool is updated
in place.  Exported handoff pieces keep the reference's dict shape, with
their arrays left as tensors on the engine's device (the handoff between
two instances on one card never leaves it).  The dense slot cache, the
stub frontends and sharded instances are later slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.convert import to_torch
from repro_torch.core.precision import get_precision
from repro_torch.engine.block_allocator import (
    BlockAllocator, CapacityError, OutOfPages, pages_for,
)
from repro_torch.engine.prefix_cache import PrefixCache
from repro_torch.kernels.ops import quantize_kv
from repro_torch.kernels.ref import as_indexable
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (
    forward, init_paged_cache, supports_paged_kv,
)
from repro_torch.utils.device import torch_dtype

DEFAULT_MAX_CHUNK = 512


def bucket_ladder(max_chunk: int) -> Tuple[int, ...]:
    """Power-of-two padding buckets up to (at least) ``max_chunk``."""
    out, b = [], 1
    while b < max_chunk:
        out.append(b)
        b <<= 1
    out.append(b)
    return tuple(out)


BUCKETS = bucket_ladder(DEFAULT_MAX_CHUNK)


def bucket_of(n: int, buckets: Sequence[int] = BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(
        f"chunk of {n} tokens exceeds max bucket {buckets[-1]}; "
        f"construct the engine with max_chunk >= {n}")


@dataclasses.dataclass
class BatchItem:
    slot: int
    tokens: np.ndarray          # (t,) int32 token ids to feed
    pos_offset: int             # absolute position of tokens[0]
    want_logits: bool = False   # final chunk of prefill / decode step


@dataclasses.dataclass(eq=False)
class StepHandle:
    """An in-flight forward step: its kernels are queued on the device
    (torch launches asynchronously) but its logits have not been copied
    to the host.  ``ready()`` probes completion without blocking through
    a CUDA event recorded after the step; a CPU step is always ready."""
    items: Sequence[BatchItem]
    logits: torch.Tensor
    event: Optional[object] = None

    def ready(self) -> bool:
        return self.event is None or self.event.query()


def _cols(t: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``t[:, ids]`` for any dtype, fp8 included."""
    return as_indexable(t)[:, ids].view(t.dtype)


class InstanceEngine:
    """One unified instance with a block-table page pool.

    Attention runs through the paged-decode / chunked-prefill kernels:
    the hand-written CUDA kernels on a card, their plain versions on the
    CPU.  Requests grow by appending pages, so a sequence is bounded by
    the *pool*, not a per-slot ``max_len``.
    """

    def __init__(self, cfg: ModelConfig, params, n_slots: int = 8,
                 max_len: int = 512, window_override: Optional[int] = None,
                 kv_mode: str = "auto", page_size: int = 8,
                 n_pages: Optional[int] = None,
                 max_chunk: int = DEFAULT_MAX_CHUNK,
                 prefix_cache: bool = False,
                 kv_precision: str = "bf16",
                 devices: Optional[Sequence] = None):
        if kv_mode not in ("auto", "paged", "dense"):
            raise ValueError(f"unknown kv_mode {kv_mode!r}")
        if kv_mode == "dense" or window_override is not None:
            raise NotImplementedError(
                "the dense slot cache (kv_mode='dense', window_override) "
                "is not ported yet: ROADMAP.md queue A item 7")
        if not supports_paged_kv(cfg):
            raise NotImplementedError(
                f"{cfg.name} needs the dense slot cache, which is not "
                f"ported yet: ROADMAP.md queue A items 7 and 9")
        if devices is not None and len(devices) > 1:
            raise NotImplementedError(
                "sharded (multi-device) instances are not ported yet: "
                "ROADMAP.md queue A item 10")
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.n_slots = n_slots
        self.max_len = max_len
        self.max_chunk = max_chunk
        self.buckets = bucket_ladder(max_chunk)
        self.kv_precision = get_precision(kv_precision)
        self.tp = 1
        self.paged = True
        self.page_size = page_size
        self.n_pages = (n_pages if n_pages is not None
                        else n_slots * pages_for(max_len, page_size))
        self.cache = init_paged_cache(cfg, self.n_pages, page_size,
                                      kv_precision=self.kv_precision,
                                      device=self.device)
        self.allocator = BlockAllocator(self.n_pages, page_size, n_slots,
                                        precision=self.kv_precision)
        self.page_buckets = bucket_ladder(self.n_pages)
        # shared-prefix KV cache: trie over the page pool + per-slot
        # claims; the allocator evicts through it under pressure
        self.prefix: Optional[PrefixCache] = None
        self._claims: Dict[int, object] = {}
        if prefix_cache:
            self.prefix = PrefixCache(self.page_size)
            self.allocator.evictor = self._evict_cached_page
        self.free_slots = list(range(n_slots))
        self.slot_owner: Dict[int, str] = {}
        # counters for tests/benchmarks
        self.iterations = 0
        self.tokens_processed = 0
        self.prefix_hit_tokens = 0

    # ---------------- slot management ----------------
    def alloc(self, req_id: str) -> int:
        if not self.free_slots:
            raise CapacityError(
                f"no free KV slot for {req_id}: all {self.n_slots} in use")
        slot = self.free_slots.pop(0)
        self.slot_owner[slot] = req_id
        return slot

    def free(self, slot: int) -> None:
        self.slot_owner.pop(slot, None)
        self._drop_claim(slot)
        self.allocator.free_slot(slot)
        self.free_slots.append(slot)

    def preempt(self, slot: int) -> None:
        """Release the slot's KV pages but keep the slot: the scheduler
        re-queues the request for recompute under memory pressure."""
        self._drop_claim(slot)
        self.allocator.trim(slot)

    @property
    def n_free(self) -> int:
        return len(self.free_slots)

    @property
    def free_pages(self) -> int:
        """Free pages *including* what the prefix cache would give back
        under pressure (unpinned cached prefixes are evicted before any
        request is preempted)."""
        extra = self.prefix.evictable_pages if self.prefix else 0
        return self.allocator.free_pages + extra

    @property
    def mem_pressure(self) -> float:
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
        refs = self.prefix.page_refcounts() if self.prefix else {}
        self.allocator.check(cache_refs=refs)

    # ---------------- execution ----------------
    def run_batch(self, items: Sequence[BatchItem]) -> Dict[int, np.ndarray]:
        """Execute one unified mixed batch; returns {slot: last-token logits}
        for items with want_logits."""
        return self.collect_batch(self.dispatch_batch(items))

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(a, device=self.device)

    def dispatch_batch(self, items: Sequence[BatchItem]) \
            -> Optional[StepHandle]:
        """Issue one unified mixed batch without waiting for the device.

        All host-side work happens here — padding B to ``n_slots``, T to
        the bucket ladder and the block tables to the page ladder, block
        table growth, the forward call — and the kernels run on while
        the caller schedules the next batch and pumps KV streams.
        Returns ``None`` for an empty batch."""
        if not items:
            return None
        T = bucket_of(max(len(it.tokens) for it in items), self.buckets)
        B = self.n_slots
        tokens = np.zeros((B, T), np.int32)
        pos_off = np.zeros((B,), np.int32)
        n_valid = np.zeros((B,), np.int32)
        active = np.zeros((B,), bool)
        for it in items:
            t = len(it.tokens)
            tokens[it.slot, :t] = it.tokens
            pos_off[it.slot] = it.pos_offset
            n_valid[it.slot] = t
            active[it.slot] = True
        # grow block tables to cover every item's span before the write;
        # OutOfPages here means the scheduler overcommitted.  Growing may
        # copy-on-write-fork shared prefix pages the write region touches
        # — apply the KV copies first.
        forks: List[Tuple[int, int]] = []
        for it in items:
            forks.extend(self.allocator.ensure(
                it.slot, it.pos_offset + len(it.tokens)))
        if forks:
            self._apply_forks(forks)
        n_pp = bucket_of(max(1, self.allocator.max_table_len),
                         self.page_buckets)
        tables = self._tensor(self.allocator.table_array(n_pp))
        with torch.no_grad():
            logits, self.cache, _ = forward(
                self.params, self.cfg, self._tensor(tokens),
                cache=self.cache, pos_offset=self._tensor(pos_off),
                active=self._tensor(active), n_valid=self._tensor(n_valid),
                last_only=True, block_tables=tables,
                page_size=self.page_size)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self.iterations += 1
        self.tokens_processed += int(sum(len(it.tokens) for it in items))
        return StepHandle(items=items, logits=logits[:, 0], event=event)

    def collect_batch(self, handle: Optional[StepHandle]) \
            -> Dict[int, np.ndarray]:
        """Block on an in-flight step and return {slot: last-token
        logits} for its want_logits items."""
        if handle is None:
            return {}
        logits = handle.logits.cpu().numpy()
        return {it.slot: logits[it.slot]
                for it in handle.items if it.want_logits}

    def _apply_forks(self, forks: Sequence[Tuple[int, int]]) -> None:
        """Copy KV contents of copy-on-write-forked pages (old -> new)
        in place, one indexed copy per pool tensor, so the forking slot
        may write its private copy without touching the shared
        original."""
        old_ids = self._tensor(np.asarray([o for o, _ in forks], np.int64))
        new_ids = self._tensor(np.asarray([n for _, n in forks], np.int64))
        for blk in self.cache["blocks"]:
            for t in blk.values():       # k/v pages + dequant scales
                raw = as_indexable(t)
                raw[:, new_ids] = raw[:, old_ids]

    def run_frontend(self, slot: int, **_):
        raise NotImplementedError(
            "stub-frontend prefill (VLM/audio) is not ported yet: "
            "ROADMAP.md queue A item 9")

    # ---------------- micro-request state handoff ----------------
    def export_state(self, slot: int, upto: int, chunk: int = 0,
                     start: int = 0) -> List[dict]:
        """Extract the KV needed to resume this request elsewhere: whole
        pages covering positions [start, upto), grouped into pieces of
        ``ceil(chunk / page_size)`` pages (chunk-based KV transfer,
        §4.3).  A non-zero ``start`` (page-aligned) skips the leading
        prefix the destination already holds."""
        return list(self._export_paged_iter(slot, upto, chunk, start=start))

    def export_state_iter(self, slot: int, upto: int, chunk: int = 0,
                          start: int = 0):
        """Lazy chunk-at-a-time export for background KV streams: each
        ``next()`` copies out exactly one piece, so the caller can
        interleave decode batches between pieces."""
        return self._export_paged_iter(slot, upto, chunk, start=start)

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
            ids = self._tensor(np.asarray(table[p0:p1], np.int64))
            piece = {"span": (p0 * page, min(p1 * page, upto)),
                     "page_size": page, "pages": [],
                     "precision": self.kv_precision.name}
            for c in self.cache["blocks"]:
                pc = {"k": _cols(c["k_pages"], ids),
                      "v": _cols(c["v_pages"], ids)}
                if "k_scales" in c:
                    # quantized pool: the per-token-row dequant scales
                    # ride with their code pages
                    pc["k_scales"] = c["k_scales"][:, ids]
                    pc["v_scales"] = c["v_scales"][:, ids]
                piece["pages"].append(pc)
            yield piece
            if p1 >= n_need:
                break

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
        """Allocate destination pages for every piece, then write each
        pool tensor in place with ONE indexed copy over the concatenated
        page ids.  Pieces exported from a pool of a different precision
        are converted (dequantized / requantized) page-wise on import.
        Piece arrays may be tensors or numpy arrays (e.g. pieces the JAX
        engine exported)."""
        if any("blocks" in p for p in pieces):
            raise ValueError("dense-cache pieces cannot be imported "
                             "into a paged engine")
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
        ids = self._tensor(np.concatenate(all_ids))
        for blk, part in zip(self.cache["blocks"], parts):
            for key in keys:
                src = torch.cat([as_indexable(a) for a in part[key]], dim=1)
                as_indexable(blk[key])[:, ids] = src

    def _kv_itemsize(self) -> int:
        """Itemsize of the dtype the page pool actually stores — NOT
        ``cfg.dtype``: a quantized pool holds 1-byte codes."""
        return self.cache["blocks"][0]["k_pages"].element_size()

    def state_bytes(self, upto: int, start: int = 0,
                    as_precision=None) -> int:
        """Bytes a handoff of tokens ``[start, upto)`` moves (for
        transfer modeling; ``start > 0`` is the prefix the destination's
        cache already holds).  Whole pages ship, so the count is rounded
        up to the page size.  ``as_precision`` prices the same span as if
        the pool stored that format (for savings accounting)."""
        cfg = self.cfg
        if as_precision is not None:
            prec = get_precision(as_precision)
            # unquantized formats store the compute dtype (f32 on the CPU
            # smoke configs), not literal 2-byte bf16
            item = prec.itemsize if prec.quantized \
                else torch_dtype(cfg.dtype).itemsize
            per_tok = 2 * cfg.n_kv_heads * cfg.hd * item
            quantized = prec.quantized
        else:
            per_tok = 2 * cfg.n_kv_heads * cfg.hd * self._kv_itemsize()
            quantized = self.kv_precision.quantized
        if quantized:
            # k + v per-token f32 dequant scales travel with the codes
            per_tok += 2 * 4
        upto_attn = (pages_for(upto, self.page_size)
                     - start // self.page_size) * self.page_size
        return cfg.n_layers * upto_attn * per_tok
