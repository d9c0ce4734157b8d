"""Token sampling."""
from __future__ import annotations

import numpy as np


def sample(logits: np.ndarray, temperature: float = 0.0,
           rng: np.random.Generator | None = None) -> int:
    if temperature <= 0:
        return int(np.argmax(logits))
    rng = rng or np.random.default_rng()
    z = (logits - logits.max()) / temperature
    p = np.exp(z)
    p /= p.sum()
    return int(rng.choice(len(p), p=p))
