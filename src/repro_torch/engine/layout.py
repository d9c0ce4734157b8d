"""The two layouts of an engine's step.

An ``InstanceEngine`` stages a step's inputs as one int32 buffer (the
static input of the step's CUDA graph) and runs ``models.model.forward``
on it.  Its layout, chosen once when the engine is built, owns all that
depends on how the tokens lie in that buffer: the ladder of graph keys,
a batch's key and record T, the rows a key computes, the buffer's
length, packing the items and block tables, and reading the buffer back
as ``forward``'s arguments.  The engine keeps the cache substrate, the
graphs, staging, counters and records.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.mixers import packed_rows


def bucket_ladder(max_chunk: int) -> Tuple[int, ...]:
    """Power-of-two padding buckets up to (at least) ``max_chunk``."""
    out, b = [], 1
    while b < max_chunk:
        out.append(b)
        b <<= 1
    out.append(b)
    return tuple(out)


def row_ladder(n_slots: int, max_chunk: int) -> Tuple[int, ...]:
    """The rungs of a paged engine's packed steps, each a graph key's
    first half: 1, the decode-only step (one token a slot, ``n_slots``
    rows), then row counts that a step's tokens round up to.  With C the
    top of ``bucket_ladder(max_chunk)``: c + ``n_slots`` for each power
    of two c from 16 to C (a chunk of c tokens beside a decode row of
    every other slot), 2 C + ``n_slots`` (two whole chunks and the
    decodes), and ``n_slots`` x C, the largest step the scheduler can
    compose (a whole chunk a slot), which every smaller rung lies
    below."""
    C = bucket_ladder(max_chunk)[-1]
    top = n_slots * C
    if C == 1:
        return (1,)                 # every step is a decode-only step
    mid = {c + n_slots for c in bucket_ladder(C) if c >= 16}
    if C >= 16:
        mid.add(2 * C + n_slots)
    return (1,) + tuple(sorted(r for r in mid if r < top)) + (top,)


def rung_chunk(rung: int, n_slots: int, max_chunk: int) -> int:
    """The query rows a slot takes in the attention of a packed step of
    rung ``rung`` (``row_ladder``), which is also the longest item the
    rung takes: 1 on the decode-only rung, c on rung c + ``n_slots``,
    and the chunk ladder's top C on 2 C + ``n_slots`` and on the top
    rung.  A chunk of c tokens beside decode rows thus attends as it
    does alone in a (``n_slots``, c) step."""
    if rung == 1:
        return 1
    C = bucket_ladder(max_chunk)[-1]
    if rung == n_slots * C:
        return C
    return max(c for c in bucket_ladder(C) if c <= rung - n_slots)


def bucket_of(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(
        f"chunk of {n} tokens exceeds max bucket {buckets[-1]}; "
        f"construct the engine with max_chunk >= {n}")


class PaddedLayout:
    """The (n_slots, T) step, T the longest item's bucket.  A dense-cache
    engine lays its steps out so (its scans and ring writes need each
    slot's sequence), and so does a paged mixture of experts whose
    capacity can drop a token, whose pads compete for capacity as in the
    reference.  The buffer holds tokens (B, T), then pos_offset, n_valid
    and active (B,) each, then a paged step's block tables (B, n_pp); B
    is ``n_slots`` and a slot with no item is inactive.  ``buckets``: the
    T ladder, the first half of the keys."""

    def __init__(self, n_slots: int, max_chunk: int):
        self.n_slots = n_slots
        self.buckets = bucket_ladder(max_chunk)

    def key(self, longest: int, rows: int) -> Tuple[int, int]:
        """A batch's graph key and its record's T: both the longest
        item's bucket.  Raises for an item over the ladder's top."""
        T = bucket_of(longest, self.buckets)
        return T, T

    def rows(self, key: int) -> int:
        """The rows a step of key ``key`` computes."""
        return self.n_slots * key

    def buffer_len(self, key: int, n_pp: int) -> int:
        return self.n_slots * (key + 3 + n_pp)

    def pack(self, items, key: int,
             tables: Optional[np.ndarray]) -> np.ndarray:
        """The items, and the (B, n_pp) block ``tables`` of a paged
        step, in one buffer of ``buffer_len``."""
        B = self.n_slots
        n_pp = 0 if tables is None else tables.shape[1]
        buf = np.zeros(self.buffer_len(key, n_pp), np.int32)
        tokens = buf[:B * key].reshape(B, key)
        pos_off, n_valid, active = buf[B * key:B * (key + 3)].reshape(3, B)
        for it in items:
            t = len(it.tokens)
            tokens[it.slot, :t] = it.tokens
            pos_off[it.slot] = it.pos_offset
            n_valid[it.slot] = t
            active[it.slot] = 1
        if n_pp:
            buf[B * (key + 3):] = tables.reshape(-1)
        return buf

    def inputs(self, buf: torch.Tensor, key: int, n_pp: int):
        """``forward``'s tokens and the keyword arguments of the step's
        layout, read from ``buf`` in place."""
        B = self.n_slots
        pos_offset, n_valid, active = buf[B * key:B * (key + 3)].view(3, B)
        return buf[:B * key].view(B, key), {
            "pos_offset": pos_offset, "n_valid": n_valid,
            "active": active != 0,
            "block_tables": buf[B * (key + 3):].view(B, n_pp) if n_pp
            else None}


class RowLayout:
    """A paged engine's packed step: its tokens in one stream of rows
    rounded up to a rung, so every token-wise op computes the real tokens
    and few pads.  The buffer holds each of the rung's N rows' token,
    slot and absolute position (N,), slot by slot from row 0, then each
    slot's pos_offset, n_valid, active and the row of its last token as
    one (4, B) block (``mixers.PackedRows.slots``), then the block tables
    (B, n_pp).  The decode-only rung puts slot b's token at row b.  Pad
    rows are zeros, which ``mixers.packed_rows`` tells apart by the
    slots' rows.  ``buckets``: the row ladder (``row_ladder``), the first
    half of the keys; ``rung_chunks``: each rung's chunk
    (``rung_chunk``)."""

    def __init__(self, n_slots: int, max_chunk: int):
        self.n_slots = n_slots
        self.chunks = bucket_ladder(max_chunk)
        self.buckets = row_ladder(n_slots, max_chunk)
        self.rung_chunks = {r: rung_chunk(r, n_slots, max_chunk)
                            for r in self.buckets}

    def key(self, longest: int, rows: int) -> Tuple[int, int]:
        """A batch's graph key, the least rung that holds its ``rows``
        and whose chunk holds its ``longest`` item, and its record's T,
        the longest item's rung: 1 exactly for a decode-only step.
        Raises for an item over the chunk ladder's top."""
        bucket_of(longest, self.chunks)          # or raises
        T = bucket_of(longest, self.buckets)
        if T == 1:
            return 1, 1
        return min(r for r in self.buckets[1:]
                   if r >= rows and self.rung_chunks[r] >= longest), T

    def rows(self, key: int) -> int:
        """The rows a step of key ``key`` computes."""
        return self.n_slots if key == 1 else key

    def buffer_len(self, key: int, n_pp: int) -> int:
        return 3 * self.rows(key) + self.n_slots * (4 + n_pp)

    def pack(self, items, key: int, tables: np.ndarray) -> np.ndarray:
        """The items and the (B, n_pp) block ``tables`` in one buffer of
        ``buffer_len``."""
        B, N = self.n_slots, self.rows(key)
        buf = np.zeros(self.buffer_len(key, tables.shape[1]), np.int32)
        tokens, slot, pos = buf[:3 * N].reshape(3, N)
        pos_off, n_valid, active, last = buf[3 * N:3 * N + 4 * B].reshape(
            4, B)
        r = 0
        for it in sorted(items, key=lambda it: it.slot):
            t = len(it.tokens)
            r0 = it.slot if key == 1 else r
            tokens[r0:r0 + t] = it.tokens
            slot[r0:r0 + t] = it.slot
            pos[r0:r0 + t] = np.arange(it.pos_offset, it.pos_offset + t)
            pos_off[it.slot] = it.pos_offset
            n_valid[it.slot] = t
            active[it.slot] = 1
            last[it.slot] = r0 + t - 1
            r += t
        buf[3 * N + 4 * B:] = tables.reshape(-1)
        return buf

    def inputs(self, buf: torch.Tensor, key: int, n_pp: int):
        """``forward``'s N row tokens and its ``rows`` and
        ``block_tables``, read from ``buf`` in place; the attention takes
        the rows as a (B, T) chunk of the rung's chunk, one token a slot
        on the decode rung."""
        B, N = self.n_slots, self.rows(key)
        tokens, slot, pos = buf[:3 * N].view(3, N)
        slots = buf[3 * N:3 * N + 4 * B].view(4, B)
        return tokens, {
            "rows": packed_rows(slot, pos, slots, self.rung_chunks[key]),
            "block_tables": buf[3 * N + 4 * B:].view(B, n_pp)}
