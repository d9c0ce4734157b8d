"""Shared statistics helpers for serving metrics and benchmarks.

Percentile computation used to be hand-rolled in four places
(``SessionMetrics.p99_tbt``, the per-class ``ClassReport`` fills,
``benchmarks/common.py``'s capacity search, and assorted benchmark
tables), each with its own empty-input guard.  ``pctl`` is the one
shared form: empty input returns ``default`` instead of raising, so
callers never need the ``if len(xs)`` dance again.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Union

import numpy as np

__all__ = ["pctl"]


def pctl(xs: Union[Sequence, np.ndarray, Iterable], q: float,
         default: float = 0.0) -> float:
    """``q``-th percentile of ``xs`` as a float; ``default`` when empty.

    Accepts anything ``np.asarray`` does (lists, tuples, generators are
    materialised, ndarrays pass through).  NaNs are not filtered — the
    serving stack never produces them and silently dropping data would
    hide bugs.
    """
    arr = np.asarray(xs if hasattr(xs, "__len__") else list(xs),
                     dtype=float)
    if arr.size == 0:
        return float(default)
    return float(np.percentile(arr, q))
