"""Shared page arithmetic for the paged KV subsystem.

The scheduler's batch budgeting, the session's admission commitments and
handoff budgeting, the simulator's occupancy model, and the engine's
``BlockAllocator`` must all round tokens to pages *identically* — the
"sim and engine load-shed identically" contract rests on this one
function being their single source of truth.
"""
from __future__ import annotations


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` (ceil division)."""
    return -(-max(0, n_tokens) // page_size)
