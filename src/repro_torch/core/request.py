"""The micro-request abstraction (paper §3.1).

A request r = (P prompt tokens, D decode tokens, L = P + D) is split at
token boundary s = ceil(phi * L) into r_alpha = tokens [0, s) and
r_beta = tokens [s, L).  A micro-request is a contiguous token span that
may cover prefill work, decode work, or both:

    alpha prefill  = [0, min(s, P))
    alpha decode   = [P, s)            (non-empty iff s > P)
    beta  prefill  = [s, P)            (non-empty iff s < P)
    beta  decode   = [max(s, P), L)

phi = P/L reproduces PD disaggregation; phi in {0, 1} reproduces
colocation (one side empty).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """Per-request latency targets the schedulers read.

    ``ttft`` bounds time-to-first-token (admission control rejects a
    request whose predicted queue wait already exceeds it); ``tbt``
    bounds time-between-tokens (the local scheduler sizes mixed batches
    so every co-batched decode stream stays under the *tightest* target
    in the batch, and the global scheduler probes split points against
    it).  ``float("inf")`` disables the corresponding bound.
    """
    name: str
    ttft: float
    tbt: float

    @property
    def admits_always(self) -> bool:
        return math.isinf(self.ttft)


INTERACTIVE = SLOClass("interactive", ttft=0.5, tbt=0.100)
STANDARD = SLOClass("standard", ttft=2.0, tbt=0.250)
BATCH = SLOClass("batch", ttft=float("inf"), tbt=1.0)

SLO_CLASSES: Dict[str, SLOClass] = {
    c.name: c for c in (INTERACTIVE, STANDARD, BATCH)
}


class RequestState:
    """Lifecycle of an online request (values order-comparable by phase).

    QUEUED -> ADMITTED -> RUNNING_ALPHA -> HANDOFF -> RUNNING_BETA -> DONE
    with REJECTED (admission control) and CANCELLED (client abort) as
    terminal exits from any non-terminal state.
    """
    QUEUED = "queued"
    ADMITTED = "admitted"
    RUNNING_ALPHA = "running_alpha"
    HANDOFF = "handoff"
    RUNNING_BETA = "running_beta"
    DONE = "done"
    CANCELLED = "cancelled"
    REJECTED = "rejected"

    TERMINAL = frozenset({DONE, CANCELLED, REJECTED})


@dataclasses.dataclass
class Request:
    rid: str
    arrival: float
    prompt_len: int                 # P
    decode_len: int                 # D (ground truth; scheduler sees predicted)
    predicted_decode: Optional[int] = None
    slo: Optional[SLOClass] = None
    state: str = RequestState.QUEUED
    state_times: Dict[str, float] = dataclasses.field(default_factory=dict)
    # Prompt token ids (int array), when the trace carries them — the
    # shared-prefix KV cache matches on these; length-only traces leave
    # None and never hit.
    prompt_tokens: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False)

    def to(self, state: str, now: float) -> None:
        """Transition the lifecycle; terminal states are sticky."""
        if self.state in RequestState.TERMINAL:
            return
        self.state = state
        self.state_times.setdefault(state, now)

    def reset_lifecycle(self) -> None:
        """Back to QUEUED with no history — a session resubmitting this
        request (e.g. the same trace replayed through several arms)
        starts a fresh life instead of inheriting a terminal state."""
        self.state = RequestState.QUEUED
        self.state_times = {}

    @property
    def terminal(self) -> bool:
        return self.state in RequestState.TERMINAL

    @property
    def P(self) -> int:
        return self.prompt_len

    @property
    def D(self) -> int:
        return self.decode_len

    @property
    def D_pred(self) -> int:
        return self.predicted_decode if self.predicted_decode is not None else self.decode_len

    @property
    def L(self) -> int:
        return self.P + self.D_pred

    @property
    def true_L(self) -> int:
        return self.P + self.D


@dataclasses.dataclass
class MicroRequest:
    parent: Request
    role: str                       # "alpha" | "beta"
    start: int                      # token span [start, end)
    end: int

    @property
    def rid(self) -> str:
        return f"{self.parent.rid}/{self.role}"

    @property
    def n_tokens(self) -> int:
        return self.end - self.start

    @property
    def prefill_tokens(self) -> int:
        """Prompt tokens this micro-request must prefill."""
        return max(0, min(self.end, self.parent.P) - min(self.start, self.parent.P))

    @property
    def decode_tokens(self) -> int:
        """Output tokens this micro-request must decode."""
        return max(0, self.end - max(self.start, self.parent.P))

    @property
    def needs_kv_handoff(self) -> bool:
        """beta needs KV/state of tokens [0, start) produced by alpha."""
        return self.role == "beta" and self.start > 0

    @property
    def handoff_tokens(self) -> int:
        return self.start if self.role == "beta" else 0


def split_request(r: Request, phi: float):
    """Split at s = ceil(phi*L).  Returns (alpha|None, beta|None)."""
    L = r.L
    s = min(L, max(0, math.ceil(phi * L)))
    alpha = MicroRequest(r, "alpha", 0, s) if s > 0 else None
    beta = MicroRequest(r, "beta", s, L) if s < L else None
    return alpha, beta
