"""Chunk-based KV transfer (paper §4.3).

Server1 processes r_alpha in equal-sized chunks; once chunk k completes
its KV block is pushed immediately while chunk k+1 computes (append-only
KV => immutable chunks, no coherence concerns).  ``plan_chunked_transfer``
computes the timeline: per-chunk ready times, link occupancy, and the
*exposed* (non-overlapped) transfer time the beta instance actually waits
— the quantity the paper reports shrinking by ~94%.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

from repro_torch.core.costmodel import BatchCostModel, WorkItem


@dataclasses.dataclass
class ChunkTransferPlan:
    chunk_tokens: int
    n_chunks: int
    compute_done: float          # alpha finishes producing the last chunk
    transfer_done: float         # last chunk lands on the beta instance
    exposed: float               # transfer_done - compute_done (stall)
    total_bytes: float
    timeline: List[Tuple[float, float]]   # per chunk (send_start, send_end)


def plan_chunked_transfer(cost: BatchCostModel, n_tokens: int,
                          chunk_tokens: int = 512,
                          t0: float = 0.0,
                          kv_bytes_per_tok: float = None) -> ChunkTransferPlan:
    """Alpha computes ``n_tokens`` of prefill in chunks; each finished
    chunk is DMA-pushed while the next chunk computes.

    ``kv_bytes_per_tok`` overrides the cost model's bf16 per-token KV
    figure — quantized page pools ship ~half the bytes per chunk
    (``cost.kv_bytes_per_tok_at(precision)``), shrinking both link
    occupancy and the exposed stall."""
    if kv_bytes_per_tok is None:
        kv_bytes_per_tok = cost.kv_bytes_per_tok
    if n_tokens <= 0:
        return ChunkTransferPlan(chunk_tokens, 0, t0, t0, 0.0, 0.0, [])
    chunks: List[int] = []
    left = n_tokens
    while left > 0:
        c = min(chunk_tokens, left)
        chunks.append(c)
        left -= c
    ctx = 0
    ready = t0
    link_free = t0
    timeline: List[Tuple[float, float]] = []
    total_bytes = 0.0
    for c in chunks:
        # compute time of this chunk on alpha
        ready += cost.latency([WorkItem("prefill", c, ctx)])
        ctx += c
        b = kv_bytes_per_tok * c
        total_bytes += b
        start = max(ready, link_free)
        end = start + b / cost.hw.link_bw
        link_free = end
        timeline.append((start, end))
    # constant-size recurrent state (SSM/RG-LRU) rides with the last chunk
    if cost.state_bytes:
        total_bytes += cost.state_bytes
        link_free += cost.state_bytes / cost.hw.link_bw
        timeline[-1] = (timeline[-1][0], link_free)
    compute_done = ready
    transfer_done = link_free
    return ChunkTransferPlan(
        chunk_tokens=chunk_tokens,
        n_chunks=len(chunks),
        compute_done=compute_done,
        transfer_done=transfer_done,
        exposed=max(0.0, transfer_done - compute_done),
        total_bytes=total_bytes,
        timeline=timeline,
    )


def plan_background_stream(t0: float, ready: float, nbytes: float,
                           chunk_bytes: float,
                           max_chunks: int = 8) -> List[float]:
    """Chunk-landing times for an overlapped in-flight handoff.

    The policy already computed the transfer's end-to-end window
    ``[t0, ready]`` (via ``plan_chunked_transfer`` /
    ``monolithic_exposed``); the session's background stream splits it
    into per-chunk delivery events so decode batches interleave with
    the landing chunks instead of waiting for the whole transfer.  The
    chunk count follows the same sizing rule as the timeline planner
    (``ceil(bytes / chunk_bytes)``), capped so a huge monolithic
    handoff does not flood the event queue."""
    n = 1
    if chunk_bytes > 0 and nbytes > 0:
        n = max(1, min(max_chunks, math.ceil(nbytes / chunk_bytes)))
    span = max(0.0, ready - t0)
    times = [t0 + span * (i + 1) / n for i in range(n)]
    times[-1] = ready      # the stream completes exactly on schedule
    return times


def monolithic_exposed(cost: BatchCostModel, n_tokens: int,
                       t0: float = 0.0, precision=None) -> float:
    """Baseline: ship the whole KV after prefill completes (what vanilla
    PD disaggregation does) — the entire transfer is exposed."""
    return cost.kv_transfer_bytes(n_tokens, precision) / cost.hw.link_bw
