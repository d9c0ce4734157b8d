"""Block-table page allocator for the paged KV subsystem.

One ``BlockAllocator`` manages the physical page pool of one
``InstanceEngine``: every serving slot owns an append-only *block
table* — the ordered list of physical page ids whose concatenation is
the slot's logical KV sequence (position ``t`` lives at offset
``t % page_size`` of physical page ``table[t // page_size]``).

Pages are the unit of everything downstream:

  * the Pallas paged-decode kernel streams pages chosen from the block
    table (``repro_torch.kernels.paged_decode_attention``);
  * micro-request KV handoff ships whole pages so chunk boundaries and
    page boundaries coincide (``InstanceEngine.export_state``);
  * the schedulers budget batches in free pages and the elastic
    controller reads ``1 - free/total`` as the memory-pressure signal.

**Pages are reference-counted and shared** (the prefix-cache subsystem,
``repro_torch.engine.prefix_cache``): a page may appear in several slots'
block tables at once — a shared prompt prefix is prefilled once and
spliced everywhere else — plus hold one reference from the prefix
trie that keeps it alive between requests.  The rules:

  * shared pages (``ref > 1``) are **read-only**; ``ensure`` detects a
    write that would land in one and *forks* it copy-on-write, handing
    the (old, new) pairs back so the engine copies the KV contents;
  * ``trim`` / ``free_slot`` *decref* — a page returns to the free list
    only when its last reference drops, so releasing a slot that holds
    shared pages can never double-free them;
  * when the free list cannot cover a request, ``ensure`` first asks
    the registered ``evictor`` (the prefix cache's LRU walk) to give
    pages back — cold cached prefixes are reclaimed *before* any live
    request is preempted.

Running out of resources raises *typed* errors so the serving session's
load-shedding path can catch them precisely instead of eating a raw
``IndexError`` from a ``list.pop``:

  * ``CapacityError`` — any engine capacity exhaustion (also raised by
    ``InstanceEngine.alloc`` when the slot pool is empty);
  * ``OutOfPages`` — the page pool specifically cannot cover a
    requested sequence extension.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.paging import pages_for  # noqa: F401  (re-exported)
from repro_torch.core.precision import (
    CODE_PRECISIONS, PRECISION_CODES, get_precision,
)


class CapacityError(RuntimeError):
    """An engine resource pool (slots or KV pages) is exhausted."""


class OutOfPages(CapacityError):
    """The page pool cannot grow a slot to the requested length."""


class BlockAllocator:
    """Refcounted free-list page allocator + per-slot block tables."""

    def __init__(self, n_pages: int, page_size: int, n_slots: int,
                 precision: str = "bf16"):
        if n_pages <= 0 or page_size <= 0:
            raise ValueError(f"need positive pool: {n_pages=} {page_size=}")
        self.n_pages = n_pages
        self.page_size = page_size
        self.n_slots = n_slots
        # Per-page precision tags (int8 codes of repro_torch.core.precision):
        # this engine's physical pool stores one uniform format, so
        # every live page carries the pool tag; tags travel with COW
        # forks and reset on the page's last release so a stale tag can
        # never describe a recycled page.
        self.precision = get_precision(precision)
        self._pool_code = PRECISION_CODES[self.precision.name]
        self._tags = np.full(n_pages, self._pool_code, np.int8)
        self._free: List[int] = list(range(n_pages))
        self._ref: List[int] = [0] * n_pages
        self._tables: List[List[int]] = [[] for _ in range(n_slots)]
        self._lens: List[int] = [0] * n_slots
        # Dense (n_slots, width) block-table matrix kept current
        # incrementally on every mutation (``table_array`` used to
        # rebuild it from the python lists every batch) — widened
        # geometrically, sliced per call.
        self._arr = np.zeros((n_slots, 8), np.int32)
        # Optional page reclaimer consulted before raising OutOfPages:
        # returns one reclaimable page id per call (the prefix cache's
        # LRU eviction), or None when nothing is left to give back.
        self.evictor: Optional[Callable[[], Optional[int]]] = None

    # ---------------- introspection ----------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    @property
    def pressure(self) -> float:
        """Fraction of the pool in use — the signal the elastic
        controller and admission control consume."""
        return self.used_pages / self.n_pages

    @property
    def max_table_len(self) -> int:
        """Longest block table across slots (sizes the kernel grid)."""
        return max((len(t) for t in self._tables), default=0)

    def pages_of(self, slot: int) -> List[int]:
        return list(self._tables[slot])

    def len_of(self, slot: int) -> int:
        """Logical tokens the slot's pages currently cover."""
        return self._lens[slot]

    def ref_of(self, page: int) -> int:
        return self._ref[page]

    def precision_of(self, page: int) -> str:
        """Precision tag of one page (pool format for live pages)."""
        return CODE_PRECISIONS[int(self._tags[page])]

    def used_by_precision(self) -> Dict[str, int]:
        """Live page counts per precision tag (metrics gauges)."""
        out: Dict[str, int] = {}
        for p, r in enumerate(self._ref):
            if r > 0:
                name = CODE_PRECISIONS[int(self._tags[p])]
                out[name] = out.get(name, 0) + 1
        return out

    def can_fit(self, slot: int, new_len: int) -> bool:
        need = pages_for(new_len, self.page_size) - len(self._tables[slot])
        return need <= len(self._free)

    # ---------------- internals ----------------
    def _alloc_page(self) -> int:
        p = self._free.pop()
        self._ref[p] = 1
        self._tags[p] = self._pool_code
        return p

    def _reclaim(self, need: int) -> None:
        """Pull pages back from the evictor (prefix-cache LRU) until the
        free list covers ``need`` — eviction strictly precedes any
        OutOfPages the caller would turn into a preemption."""
        while len(self._free) < need and self.evictor is not None:
            pid = self.evictor()
            if pid is None:
                break
            self.release_page(pid)

    def _set(self, slot: int, idx: int, page: int) -> None:
        if idx >= self._arr.shape[1]:
            width = self._arr.shape[1]
            while width <= idx:
                width *= 2
            arr = np.zeros((self.n_slots, width), np.int32)
            arr[:, : self._arr.shape[1]] = self._arr
            self._arr = arr
        self._arr[slot, idx] = page

    # ---------------- mutation ----------------
    def ensure(self, slot: int, new_len: int) -> List[Tuple[int, int]]:
        """Grow the slot's block table to cover ``new_len`` tokens.

        Appends pages from the free list AND copy-on-write-forks any
        *shared* page (``ref > 1``) the write region ``[len, new_len)``
        would touch — shared prefix pages are read-only.  Returns the
        ``(old_page, new_page)`` fork pairs; the caller must copy the
        KV contents old -> new before writing.  Atomic: on
        ``OutOfPages`` (after the evictor is exhausted) nothing is
        allocated and no table changes.
        """
        table = self._tables[slot]
        page = self.page_size
        cur = self._lens[slot]
        grow = pages_for(new_len, page) - len(table)
        fork_idx: List[int] = []
        if new_len > cur:
            first = cur // page
            last = min(len(table), pages_for(new_len, page))
            fork_idx = [i for i in range(first, last)
                        if self._ref[table[i]] > 1]
        need = max(0, grow) + len(fork_idx)
        if need > len(self._free):
            self._reclaim(need)
        if need > len(self._free):
            raise OutOfPages(
                f"slot {slot}: need {need} page(s) to reach len {new_len} "
                f"({len(fork_idx)} copy-on-write fork(s)), only "
                f"{len(self._free)} of {self.n_pages} free")
        forks: List[Tuple[int, int]] = []
        for i in fork_idx:
            old = table[i]
            new = self._alloc_page()
            self._tags[new] = self._tags[old]   # forks keep the precision
            self._ref[old] -= 1          # shared => never reaches 0 here
            table[i] = new
            self._set(slot, i, new)
            forks.append((old, new))
        for _ in range(max(0, grow)):
            p = self._alloc_page()
            self._set(slot, len(table), p)
            table.append(p)
        self._lens[slot] = max(cur, new_len)
        return forks

    def splice(self, slot: int, pages: Sequence[int], n_tokens: int) -> None:
        """Adopt shared pages as the slot's prefix: the block table must
        be empty (a fresh or trimmed slot), the pages stay owned by
        whoever already references them (each gains one reference), and
        the slot's logical length becomes ``n_tokens`` — the prefix-hit
        path that replaces recomputing those tokens."""
        if self._tables[slot]:
            raise ValueError(
                f"slot {slot} already holds {len(self._tables[slot])} "
                f"page(s); prefixes splice only into empty tables")
        if n_tokens > len(pages) * self.page_size:
            raise ValueError(
                f"slot {slot}: {n_tokens} tokens exceed the "
                f"{len(pages)} spliced page(s)")
        for i, p in enumerate(pages):
            if self._ref[p] <= 0:
                raise ValueError(f"cannot splice free page {p}")
            self._ref[p] += 1
            self._set(slot, i, p)
        self._tables[slot] = list(pages)
        self._lens[slot] = n_tokens

    def retain(self, pages: Sequence[int]) -> None:
        """Add one reference per page (the prefix cache adopting a
        releasing slot's pages so they outlive the slot)."""
        for p in pages:
            if self._ref[p] <= 0:
                raise ValueError(f"cannot retain free page {p}")
            self._ref[p] += 1

    def release_page(self, page: int) -> bool:
        """Drop one reference; returns True when the page actually went
        back to the free list (it was the last reference)."""
        if self._ref[page] <= 0:
            raise ValueError(f"page {page} released more times than "
                             f"retained")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free.append(page)
            self._tags[page] = self._pool_code
            return True
        return False

    def trim(self, slot: int) -> int:
        """Drop the slot's references (preemption: the KV is recomputed
        later) but keep the slot itself.  Shared pages are *decreffed*,
        never freed out from under their other owners; returns the
        number of pages physically returned to the free list."""
        table = self._tables[slot]
        freed = sum(1 for p in table if self.release_page(p))
        self._tables[slot] = []
        self._lens[slot] = 0
        self._arr[slot, :] = 0
        return freed

    def free_slot(self, slot: int) -> int:
        """Release the slot's pages when its request leaves the engine."""
        return self.trim(slot)

    def table_array(self, width: int) -> np.ndarray:
        """Dense ``(n_slots, width)`` int32 block-table matrix for the
        kernels — a *view* into the incrementally maintained array
        (valid until the next allocator mutation; callers ship it to
        device immediately).  Unallocated entries hold 0 — safe because
        every read past a slot's length is masked (causally in the
        prefill kernel, by ``lengths`` in the decode kernel)."""
        if self.max_table_len > width:
            raise OutOfPages(
                f"a slot holds {self.max_table_len} pages > table width "
                f"{width}")
        if width > self._arr.shape[1]:
            self._set(0, width - 1, 0)      # widen, value unchanged
        return self._arr[:, :width]

    # ---------------- invariants ----------------
    def check(self, cache_refs: Optional[Mapping[int, int]] = None) -> None:
        """Assert the refcount bookkeeping is coherent:

        * ``used_pages`` equals the number of uniquely-referenced pages
          (every page is counted once no matter how many tables share
          it);
        * the free list holds exactly the zero-ref pages;
        * with ``cache_refs`` (``PrefixCache.page_refcounts``), every
          page's refcount equals its table references + cache
          references;
        * every page (live or free) carries this pool's precision tag —
          a mixed-precision cluster stores each format in its own
          physical pool, so a foreign tag means cross-pool corruption.
        Raises ``AssertionError`` — wire it behind a debug flag.
        """
        live = sum(1 for r in self._ref if r > 0)
        assert self.used_pages == live, \
            f"used_pages {self.used_pages} != {live} uniquely-referenced"
        bad_tags = [p for p in range(self.n_pages)
                    if int(self._tags[p]) != self._pool_code]
        assert not bad_tags, \
            f"pages {bad_tags[:8]} tagged foreign precision in a " \
            f"{self.precision.name} pool"
        assert sorted(self._free) == \
            [p for p, r in enumerate(self._ref) if r == 0], \
            "free list out of sync with refcounts"
        table_refs = [0] * self.n_pages
        for s, table in enumerate(self._tables):
            assert len(table) >= pages_for(self._lens[s], self.page_size), \
                f"slot {s}: table shorter than its logical length"
            for i, p in enumerate(table):
                table_refs[p] += 1
                assert self._arr[s, i] == p, \
                    f"dense table stale at slot {s} idx {i}"
        for p in range(self.n_pages):
            if cache_refs is not None:
                want = table_refs[p] + cache_refs.get(p, 0)
                assert self._ref[p] == want, \
                    f"page {p}: ref {self._ref[p]} != {table_refs[p]} " \
                    f"table + {cache_refs.get(p, 0)} cache refs"
            else:
                assert self._ref[p] >= table_refs[p], \
                    f"page {p}: ref {self._ref[p]} < " \
                    f"{table_refs[p]} table refs"
