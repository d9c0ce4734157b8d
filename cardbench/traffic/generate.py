"""The one traffic generator: a mix's data file in, a seeded request list
out.

A mix file (``traffic/<mix>.json``) gives the shape: lognormal prompt
and output lengths (median, sigma, clip), the largest context a request
may reach, the SLO-class mix and the decode-length predictor's error.  A
rate file (``traffic/rates/<cell>.json``) gives what depends on the
model serving it: the arrival rate in the window, the pre-roll's length
and rate, and how many requests start the run part-way through their
outputs.

Every seed gets the same sizes, classes and gaps between arrivals, in
the same order.  The lengths are the lognormal's quantiles at
``(i + 0.5) / n`` and the gaps the exponential's (a Poisson process's
gaps, at the mix's rate), one set for each phase, put in an order drawn
once from the mix's ``layout_seed``, as is the decode-length predictor's
error.  The run's seed draws the prompt tokens (and with them, through
the weights it also draws, every served token).  With some tens of
requests in a window, which size comes when decides how much work the
window holds (output tokens a second moved by a third between seeds that
permuted the order, and by 1% between two runs of one seed), and the
predictor's error moves the split points (5% between seeds that drew
it), so the order and the error are the traffic's and not the seed's.  The shapes and the
predictor rule are those of ``repro_torch.data.workloads``
(``WORKLOADS``, ``_lengths``, ``_req``), copied so that the yardstick
stays put when the program changes.

Phases, on the session's clock (0 when ``ServeSession.run`` starts):

* ``warm``: requests due at 0 that would already have made a share
  ``f`` of their output (``f`` at the quantiles of a uniform): their
  prompt is the prompt plus those tokens, and only the rest is decoded;
* ``pre``: arrivals over ``[0, preroll_s)``;
* ``window``: arrivals over ``[preroll_s, preroll_s + seconds)``, the
  measured window.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from statistics import NormalDist
from typing import Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Planned:
    """One request of the trace, before the session sees it."""
    rid: str
    phase: str              # warm | pre | window
    due: float              # seconds on the session's clock
    prompt: np.ndarray      # (P,) int32 token ids
    decode_len: int         # tokens the session decodes
    predicted: int          # what the schedulers are told
    slo: str                # SLO class name


def load_mix(name: str, root: Path = HERE) -> dict:
    with open(root / f"{name}.json") as f:
        return json.load(f)


def load_rate(cell: str, root: Path = HERE) -> dict:
    with open(root / "rates" / f"{cell}.json") as f:
        return json.load(f)


def lognormal_quantiles(median: float, sigma: float, n: int, lo: int,
                        hi: int) -> np.ndarray:
    """n lengths at the lognormal's quantiles (i + 0.5) / n, clipped to
    [lo, hi] and truncated to ints as ``workloads._lengths`` does."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(median * np.exp(sigma * z), lo, hi).astype(int)


def exponential_gaps(n: int, span: float) -> np.ndarray:
    """n + 1 gaps at the exponential's quantiles, scaled to sum to
    ``span``: n arrivals fall inside it, the last gap past the n-th."""
    q = np.array([-math.log(1.0 - (i + 0.5) / (n + 1)) for i in range(n + 1)])
    return q * (span / q.sum())


def class_counts(mix: Dict[str, float], n: int) -> List[str]:
    """n class names in the mix's proportions (largest remainders)."""
    names = sorted(mix)
    w = np.array([mix[k] for k in names], float)
    exact = w / w.sum() * n
    counts = np.floor(exact).astype(int)
    for i in np.argsort(-(exact - counts))[: n - counts.sum()]:
        counts[i] += 1
    return [k for k, c in zip(names, counts) for _ in range(c)]


def generate(mix: dict, rate: dict, seed: int, seconds: float,
             vocab: int) -> List[Planned]:
    """The request list of one run of a cell."""
    rng = np.random.default_rng([seed, 0x7261])
    order = np.random.default_rng(mix["layout_seed"])
    pre_s = float(rate["preroll_s"])
    phases = [
        ("warm", int(rate["warm_requests"]), None),
        ("pre", int(round(rate["preroll_rate_per_s"] * pre_s)), (0.0, pre_s)),
        ("window", int(round(rate["rate_per_s"] * seconds)),
         (pre_s, pre_s + seconds)),
    ]
    p_spec, d_spec = mix["prompt"], mix["output"]
    out: List[Planned] = []
    for phase, n, span in phases:
        if n <= 0:
            continue
        P = order.permutation(lognormal_quantiles(
            p_spec["median"], p_spec["sigma"], n, p_spec["min"],
            p_spec["max"]))
        D = order.permutation(lognormal_quantiles(
            d_spec["median"], d_spec["sigma"], n, d_spec["min"],
            d_spec["max"]))
        slo = order.permutation(class_counts(mix["slo_mix"], n))
        if span is None:
            due = np.zeros(n)
            done = order.permutation((np.arange(n) + 0.5) / n)
        else:
            gaps = order.permutation(exponential_gaps(n, span[1] - span[0]))
            due = span[0] + np.cumsum(gaps)[:n]
            done = np.zeros(n)
        for i in range(n):
            p, d = int(P[i]), int(D[i])
            # a request never outgrows the slot context the mix states
            p = min(p, mix["max_context"] - d)
            made = int(done[i] * d)
            prompt = rng.integers(0, vocab, p + made).astype(np.int32)
            left = d - made
            out.append(Planned(
                rid=f"{phase}-{i}", phase=phase, due=float(due[i]),
                prompt=prompt, decode_len=left,
                predicted=predicted_decode(order, left,
                                           mix["predict_sigma"]),
                slo=str(slo[i])))
    return out


def predicted_decode(rng: np.random.Generator, d: int,
                     sigma: Optional[float]) -> int:
    """``workloads._req``'s predictor: the true length plus N(0, sigma)
    tokens of error, at least 1 (the paper's proxy model, section 5)."""
    if not sigma:
        return int(d)
    return max(1, int(round(d + rng.normal(0, sigma))))
