"""Shared-prefix KV cache: a radix trie over page-aligned token chunks.

Real traffic re-sends long common prefixes — multi-turn chat grows one
conversation's history turn over turn, fleets of requests share a system
prompt, agent loops re-prompt with an accumulating scratchpad.  The KV
of a shared prefix depends only on the token ids and positions, so once
one request has prefilled it, every later request with the same prefix
can *reuse the physical pages* instead of recomputing them.

``PrefixCache`` is the index that makes the pages findable: a trie whose
edges are **whole pages of token ids** (``page_size`` tokens hashed to
one key), so a root-to-node path spells a page-aligned token prefix and
the node stores the physical page holding that chunk's KV.  Matching is
longest-prefix by construction; granularity is exactly the unit the
``BlockAllocator`` and the Pallas paged kernels already speak.

Ownership rules (the allocator's refcounts enforce them, see
``repro_torch.engine.block_allocator``):

  * ``insert`` adopts a *released* request's full pages — each newly
    created node holds one cache reference on its page.
  * ``claim`` pins the matched path: pinned nodes are never evicted
    (a live slot's block table splices their pages).  ``release``
    unpins.
  * ``evict_one`` removes the least-recently-touched unpinned **leaf**
    (evicting an inner node would orphan its children) and returns its
    page for the caller to release — cache pages are reclaimed *before*
    any request is preempted.

Recency is a logical access counter, not wall time, so the simulator
and the real engine evolve byte-identical tries from the same event
sequence — the foundation of the "sim and engine make the same
decisions" contract.

The module is dependency-light on purpose (numpy only): the simulator
imports it without pulling JAX.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


def _chunks(tokens, page_size: int) -> Iterator[bytes]:
    """Yield the full ``page_size``-token chunks of ``tokens`` as hashable
    keys.  Token ids are normalized to int32 so the engine (int32 arrays)
    and trace generators (python ints / int64) produce identical keys."""
    arr = np.ascontiguousarray(np.asarray(tokens, dtype=np.int32))
    for lo in range(0, (len(arr) // page_size) * page_size, page_size):
        yield arr[lo:lo + page_size].tobytes()


class _Node:
    __slots__ = ("key", "page", "parent", "children", "pins", "last_access",
                 "precision")

    def __init__(self, key: Optional[bytes], page: Optional[int],
                 parent: Optional["_Node"],
                 precision: Optional[str] = None):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: Dict[bytes, "_Node"] = {}
        self.pins = 0
        self.last_access = 0
        # storage format of the indexed page ("bf16"/"fp8"/"int8");
        # None = untagged (uniform-precision pools never filter on it).
        # A shared page keeps ONE precision for its whole cache life —
        # claimants of another format miss instead of dequantizing.
        self.precision = precision


@dataclasses.dataclass
class Claim:
    """A pinned longest-prefix match: ``tokens`` cached tokens backed by
    ``pages`` (one physical page per trie node on the matched path)."""
    nodes: List[_Node]

    @property
    def tokens(self) -> int:
        return 0 if not self.nodes else \
            len(self.nodes) * len(self.nodes[0].key) // 4   # int32 = 4 B

    @property
    def pages(self) -> List[int]:
        return [n.page for n in self.nodes]

    @property
    def n_pages(self) -> int:
        return len(self.nodes)


class PrefixCache:
    """Radix trie of page-aligned token chunks -> physical page ids."""

    def __init__(self, page_size: int):
        if page_size <= 0:
            raise ValueError(f"page_size must be positive, got {page_size}")
        self.page_size = page_size
        self.root = _Node(None, None, None)
        self._clock = itertools.count(1)
        self._virtual = itertools.count(1 << 40)   # sim-side page ids
        self._n_nodes = 0
        self._n_pinned = 0
        self.evictions = 0

    # ---------------- introspection ----------------
    @property
    def n_pages(self) -> int:
        """Pages the cache currently indexes (one per node)."""
        return self._n_nodes

    @property
    def pinned_pages(self) -> int:
        """Pages pinned by live claims.  A claim pins its whole
        root-to-node path, so this also counts every non-evictable
        node: ``evictable_pages == n_pages - pinned_pages``."""
        return self._n_pinned

    @property
    def evictable_pages(self) -> int:
        return self._n_nodes - self._n_pinned

    # ---------------- matching ----------------
    def _walk(self, tokens, max_pages: Optional[int] = None,
              touch: bool = False,
              precision: Optional[str] = None) -> List[_Node]:
        out: List[_Node] = []
        node = self.root
        for key in _chunks(tokens, self.page_size):
            if max_pages is not None and len(out) >= max_pages:
                break
            child = node.children.get(key)
            if child is None:
                break
            # precision filter: a claimant can only splice pages stored
            # in ITS format — the walk stops at the first mismatch
            # (None on either side is a wildcard: untagged nodes and
            # precision-blind probes keep the pre-quantization paths)
            if precision is not None and child.precision is not None \
                    and child.precision != precision:
                break
            out.append(child)
            node = child
        if touch and out:
            t = next(self._clock)
            for n in out:
                n.last_access = t
        return out

    def match_len(self, tokens, precision: Optional[str] = None) -> int:
        """Longest cached prefix of ``tokens`` in tokens (page-aligned).
        A pure probe: does not touch recency, so schedulers may score
        every instance without perturbing eviction order."""
        return len(self._walk(tokens, precision=precision)) \
            * self.page_size

    def claim(self, tokens, max_tokens: Optional[int] = None,
              precision: Optional[str] = None) -> Claim:
        """Match-and-pin the longest cached prefix (optionally capped to
        ``max_tokens``, rounded *down* to whole pages; restricted to
        pages stored at ``precision`` when given).  The claimed pages
        must be spliced into the claimant's block table; call
        ``release`` when the claimant frees its slot."""
        max_pages = None if max_tokens is None else \
            max(0, int(max_tokens)) // self.page_size
        nodes = self._walk(tokens, max_pages=max_pages, touch=True,
                           precision=precision)
        for n in nodes:
            n.pins += 1
            if n.pins == 1:
                self._n_pinned += 1
        return Claim(nodes)

    def release(self, claim: Claim) -> None:
        for n in claim.nodes:
            n.pins -= 1
            if n.pins == 0:
                self._n_pinned -= 1
            assert n.pins >= 0, "prefix claim released twice"
        claim.nodes = []

    # ---------------- insertion ----------------
    def insert(self, tokens,
               pages: Optional[Sequence[int]] = None,
               precision: Optional[str] = None) -> List[int]:
        """Index the full pages of ``tokens``: ``pages[i]`` is the
        physical page holding chunk ``i``'s KV.  Existing nodes are kept
        (their page already holds identical KV — the duplicate stays
        with the releasing slot and is freed normally); returns the page
        ids of *newly created* nodes, which the caller must retain
        (``BlockAllocator.retain``) so they outlive the inserting slot.

        ``precision`` tags newly created nodes with the storage format
        of the indexed pages; an existing node KEEPS its original tag
        (one precision per shared page for its whole cache life).  An
        insert at a different precision stops at the first such node —
        chaining a bf16 child under a quantized parent would let a
        claim walk across formats.

        ``pages=None`` (the simulator) auto-assigns virtual ids — the
        trie *shape* is what must match the engine, not the id values.
        """
        node = self.root
        adopted: List[int] = []
        t = next(self._clock)
        for i, key in enumerate(_chunks(tokens, self.page_size)):
            child = node.children.get(key)
            if child is None:
                page = next(self._virtual) if pages is None else int(pages[i])
                child = _Node(key, page, node, precision=precision)
                node.children[key] = child
                self._n_nodes += 1
                adopted.append(page)
            elif precision is not None and child.precision is not None \
                    and child.precision != precision:
                break
            child.last_access = t
            node = child
        return adopted

    # ---------------- eviction ----------------
    def _evictable_leaves(self) -> List[_Node]:
        out = []
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif n.pins == 0:
                out.append(n)
        return out

    def evict_one(self) -> Optional[int]:
        """Drop the LRU unpinned leaf; returns its page id (the caller
        releases the cache's reference) or None when nothing is
        evictable.  Evicting leaves first keeps every surviving node's
        path intact, and removing a leaf may expose its parent as the
        next candidate — deep cold branches unwind back-to-front."""
        leaves = self._evictable_leaves()
        if not leaves:
            return None
        victim = min(leaves, key=lambda n: n.last_access)
        del victim.parent.children[victim.key]
        self._n_nodes -= 1
        self.evictions += 1
        return victim.page

    def evict(self, n_pages: int) -> List[int]:
        out: List[int] = []
        while len(out) < n_pages:
            pid = self.evict_one()
            if pid is None:
                break
            out.append(pid)
        return out

    # ---------------- debugging ----------------
    def page_refcounts(self) -> Dict[int, int]:
        """{page id: cache references} over the whole trie (always 1 per
        node — pages are never indexed twice) for invariant checks."""
        out: Dict[int, int] = {}
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            out[n.page] = out.get(n.page, 0) + 1
            stack.extend(n.children.values())
        return out
