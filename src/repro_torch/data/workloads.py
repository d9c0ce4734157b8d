"""Workload generators shaped after the paper's four traces (§6.1).

Request prompt/output lengths follow the paper's reported request shapes
(Table 1: AzureCode P=8192/D=32, BurstGPT P=2048/D=512, MiniReasoning
P=219/D=1467; arXiv Summarization is long-prompt/short-output), with
lognormal spread around those modes.  Arrivals are Poisson (§6.1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.request import Request, SLO_CLASSES, SLOClass

# Decode-length predictor error applied when a generator is not given an
# explicit ``predict_sigma``: the paper's proxy-model predictor (§5) puts
# >95% of predictions within +-100 tokens, i.e. sigma ~= 50.  The seed
# silently fell back to the ORACLE decode length (predicted == true), so
# split-point error was never exercised; pass ``predict_sigma=0`` to get
# the oracle back explicitly.
DEFAULT_PREDICT_SIGMA = 50.0


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    name: str
    p_mode: int          # modal prompt length
    d_mode: int          # modal output length
    p_sigma: float = 0.3
    d_sigma: float = 0.4
    max_len: int = 16384


WORKLOADS: Dict[str, WorkloadSpec] = {
    # long prompt, tiny output (paper: P-8192, D-32)
    "azure_code": WorkloadSpec("azure_code", 8192, 32, 0.35, 0.5),
    # balanced (paper: P-2048, D-512), bursty in time
    "burstgpt": WorkloadSpec("burstgpt", 2048, 512, 0.45, 0.5),
    # long-document summarization: long prompt, short output
    "arxiv_summarization": WorkloadSpec("arxiv_summarization", 6144, 256, 0.3, 0.4),
    # reasoning: short prompt, long output (paper: P-219, D-1467)
    "mini_reasoning": WorkloadSpec("mini_reasoning", 219, 1467, 0.3, 0.35),
}


def _lengths(rng: np.random.Generator, spec: WorkloadSpec, n: int):
    p = rng.lognormal(np.log(spec.p_mode), spec.p_sigma, n)
    d = rng.lognormal(np.log(spec.d_mode), spec.d_sigma, n)
    p = np.clip(p, 8, spec.max_len).astype(int)
    d = np.clip(d, 4, spec.max_len).astype(int)
    return p, d


def generate_trace(workload: str, qps: float, duration: float,
                   seed: int = 0,
                   predict_sigma: Optional[float] = None,
                   slo_mix: Optional[Dict[str, float]] = None
                   ) -> List[Request]:
    """Poisson arrivals at ``qps`` for ``duration`` seconds.

    ``predict_sigma``: std-dev of the decode-length predictor's error in
    tokens (paper §5: >95% of predictions within +-100 tokens); defaults
    to ``DEFAULT_PREDICT_SIGMA`` so schedulers see *predicted* lengths,
    not the oracle.  ``slo_mix`` attaches SLO classes by weight, e.g.
    ``{"interactive": 0.5, "standard": 0.3, "batch": 0.2}`` (names from
    ``repro_torch.core.request.SLO_CLASSES``).
    """
    spec = WORKLOADS[workload]
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / qps, int(qps * duration * 2) + 16)
    arrivals = np.cumsum(gaps)
    arrivals = arrivals[arrivals < duration]
    n = len(arrivals)
    p, d = _lengths(rng, spec, n)
    return [_req(f"{workload}-{i}", arrivals[i], p[i], d[i], rng,
                 predict_sigma, slo_mix) for i in range(n)]


def hybrid_trace(qps: float, duration: float, seed: int = 0,
                 mix=("burstgpt", "azure_code")) -> List[Request]:
    """Paper §6.4: uniform 50/50 mix of BurstGPT and Azure Code."""
    half = qps / len(mix)
    reqs: List[Request] = []
    for j, w in enumerate(mix):
        reqs.extend(generate_trace(w, half, duration, seed + j))
    reqs.sort(key=lambda r: r.arrival)
    for i, r in enumerate(reqs):
        r.rid = f"hybrid-{i}"
    return reqs


# ---------------------------------------------------------------------------
# Shifting traces (elastic-pool scenarios)
#
# Three families of non-stationary traffic the fixed-N seed could not
# express, used by the elastic instance pool (repro_torch.core.elastic) and
# benchmarks/elastic_shift.py:
#   * diurnal  — sinusoidal QPS ramp (nonhomogeneous Poisson, thinning)
#   * phases   — hard switches between the four paper workloads
#   * burst    — baseline traffic with injected burst windows
# ---------------------------------------------------------------------------
def _thinned_arrivals(rng: np.random.Generator, rate_fn, rate_max: float,
                      duration: float) -> np.ndarray:
    """Nonhomogeneous Poisson arrivals via Lewis-Shedler thinning."""
    t = 0.0
    out = []
    while True:
        t += rng.exponential(1.0 / rate_max)
        if t >= duration:
            break
        if rng.random() < rate_fn(t) / rate_max:
            out.append(t)
    return np.asarray(out)


def diurnal_trace(qps_peak: float, duration: float, seed: int = 0,
                  workload: str = "burstgpt", floor: float = 0.15,
                  period: Optional[float] = None,
                  predict_sigma: Optional[float] = None,
                  slo_mix: Optional[Dict[str, float]] = None
                  ) -> List[Request]:
    """Sinusoidal QPS between ``floor * qps_peak`` and ``qps_peak`` —
    one full valley->peak->valley cycle per ``period`` (default: the
    whole window), starting at the valley."""
    spec = WORKLOADS[workload]
    rng = np.random.default_rng(seed)
    period = period or duration

    def rate(t: float) -> float:
        s = 0.5 * (1.0 - np.cos(2 * np.pi * t / period))
        return qps_peak * (floor + (1.0 - floor) * s)

    arrivals = _thinned_arrivals(rng, rate, qps_peak, duration)
    p, d = _lengths(rng, spec, len(arrivals))
    return [_req(f"diurnal-{i}", arrivals[i], p[i], d[i], rng,
                 predict_sigma, slo_mix) for i in range(len(arrivals))]


def phase_shift_trace(qps: float, duration: float, seed: int = 0,
                      phases=("mini_reasoning", "azure_code",
                              "burstgpt", "arxiv_summarization"),
                      predict_sigma: Optional[float] = None,
                      slo_mix: Optional[Dict[str, float]] = None
                      ) -> List[Request]:
    """Hard workload-mix switches: the window is split evenly across
    ``phases`` and each segment draws request shapes from a different
    paper workload (decode-heavy -> prefill-heavy -> balanced -> ...),
    stressing role-bias drift."""
    rng = np.random.default_rng(seed)
    seg = duration / len(phases)
    reqs: List[Request] = []
    t = 0.0
    i = 0
    while True:
        t += rng.exponential(1.0 / qps)
        if t >= duration:
            break
        spec = WORKLOADS[phases[min(int(t // seg), len(phases) - 1)]]
        p, d = _lengths(rng, spec, 1)
        reqs.append(_req(f"phase-{i}", t, p[0], d[0], rng, predict_sigma,
                         slo_mix))
        i += 1
    return reqs


def burst_trace(qps_base: float, duration: float, seed: int = 0,
                workload: str = "burstgpt",
                bursts=((0.35, 0.15, 5.0),),
                predict_sigma: Optional[float] = None,
                slo_mix: Optional[Dict[str, float]] = None
                ) -> List[Request]:
    """Baseline Poisson traffic with injected bursts.  Each burst is
    ``(start_frac, len_frac, multiplier)``: within the window
    ``[start_frac, start_frac + len_frac] * duration`` the arrival rate
    is multiplied — the scale-up trigger scenario."""
    spec = WORKLOADS[workload]
    rng = np.random.default_rng(seed)
    mult_max = max((m for _, _, m in bursts), default=1.0)

    def rate(t: float) -> float:
        f = t / duration
        m = 1.0
        for start, length, mult in bursts:
            if start <= f < start + length:
                m = max(m, mult)
        return qps_base * m

    arrivals = _thinned_arrivals(rng, rate, qps_base * max(1.0, mult_max),
                                 duration)
    p, d = _lengths(rng, spec, len(arrivals))
    return [_req(f"burst-{i}", arrivals[i], p[i], d[i], rng,
                 predict_sigma, slo_mix) for i in range(len(arrivals))]


SHIFTING_TRACES = {
    "diurnal": diurnal_trace,
    "phases": phase_shift_trace,
    "burst": burst_trace,
}


# ---------------------------------------------------------------------------
# Shared-prefix traces (prefix-cache scenarios)
#
# These generators attach REAL prompt token ids (``Request.prompt_tokens``)
# because prefix reuse is a property of token *content*, not lengths:
#   * multiturn — conversations re-sending the growing history each turn
#   * system_prompt — a few long system prompts shared across requests
#   * agentic — agent loops re-prompting with an accumulating scratchpad
# Token ids are synthetic (uniform over ``vocab``) but *stable*: the same
# history bytes recur verbatim, which is all the radix trie keys on.
# ---------------------------------------------------------------------------
def _toks(rng: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    return rng.integers(0, vocab, int(max(1, n))).astype(np.int32)


def multiturn_trace(qps: float, duration: float, seed: int = 0,
                    turns: int = 4, user_len: int = 48,
                    response_len: int = 64, think_time: float = 2.0,
                    vocab: int = 32000,
                    predict_sigma: Optional[float] = None,
                    slo_mix: Optional[Dict[str, float]] = None
                    ) -> List[Request]:
    """Multi-turn conversations with growing histories.

    Conversations *start* as a Poisson process at ``qps``; each turn's
    prompt is the full scripted history (all previous prompts and
    responses) plus a fresh user message, and the next turn arrives an
    exponential ``think_time`` after the previous response would have
    finished streaming.  Turn ``k`` therefore shares turn ``k-1``'s
    whole prompt as a prefix — the canonical chat-serving reuse
    pattern.
    """
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / qps, int(qps * duration * 2) + 16)
    starts = np.cumsum(gaps)
    starts = starts[starts < duration]
    reqs: List[Request] = []
    for c, t0 in enumerate(starts):
        history = _toks(rng, user_len, vocab)
        t = float(t0)
        for k in range(turns):
            d = int(max(4, rng.lognormal(np.log(response_len), 0.3)))
            reqs.append(_tok_req(f"conv{seed}-{c}-t{k}", t, history, d,
                                 rng, predict_sigma, slo_mix))
            if k + 1 == turns:
                break
            response = _toks(rng, d, vocab)
            user = _toks(rng, user_len, vocab)
            history = np.concatenate([history, response, user])
            t += rng.exponential(think_time)
            if t >= duration * 2:       # runaway tail guard
                break
    reqs.sort(key=lambda r: r.arrival)
    return reqs


def system_prompt_trace(qps: float, duration: float, seed: int = 0,
                        n_system: int = 4, system_len: int = 512,
                        user_len: int = 96, d_mode: int = 96,
                        vocab: int = 32000,
                        predict_sigma: Optional[float] = None,
                        slo_mix: Optional[Dict[str, float]] = None
                        ) -> List[Request]:
    """A mixture over ``n_system`` long shared system prompts: every
    request is one of the system prompts plus a unique user suffix, so
    the cacheable prefix is exactly the system prompt (skewed toward
    the first prompts, Zipf-ish, like a real deployment's default
    assistant)."""
    rng = np.random.default_rng(seed)
    systems = [_toks(rng, system_len, vocab) for _ in range(n_system)]
    weights = 1.0 / np.arange(1, n_system + 1)
    weights /= weights.sum()
    gaps = rng.exponential(1.0 / qps, int(qps * duration * 2) + 16)
    arrivals = np.cumsum(gaps)
    arrivals = arrivals[arrivals < duration]
    reqs: List[Request] = []
    for i, t in enumerate(arrivals):
        s = int(rng.choice(n_system, p=weights))
        prompt = np.concatenate([systems[s], _toks(rng, user_len, vocab)])
        d = int(max(4, rng.lognormal(np.log(d_mode), 0.4)))
        reqs.append(_tok_req(f"sys{seed}-{i}", float(t), prompt, d, rng,
                             predict_sigma, slo_mix))
    return reqs


def agentic_trace(qps: float, duration: float, seed: int = 0,
                  loops: int = 5, base_len: int = 256,
                  tool_len: int = 80, action_len: int = 32,
                  gap_time: float = 0.5, vocab: int = 32000,
                  predict_sigma: Optional[float] = None,
                  slo_mix: Optional[Dict[str, float]] = None
                  ) -> List[Request]:
    """Agent re-prompt loops: each agent starts from a base prompt and
    re-sends it with an accumulating scratchpad (tool outputs appended
    between iterations), so every iteration's prompt extends the
    previous one — short decode, near-total prefix overlap."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / qps, int(qps * duration * 2) + 16)
    starts = np.cumsum(gaps)
    starts = starts[starts < duration]
    reqs: List[Request] = []
    for a, t0 in enumerate(starts):
        pad = _toks(rng, base_len, vocab)
        t = float(t0)
        for k in range(loops):
            d = int(max(4, rng.lognormal(np.log(action_len), 0.3)))
            reqs.append(_tok_req(f"agent{seed}-{a}-i{k}", t, pad, d, rng,
                                 predict_sigma, slo_mix))
            if k + 1 == loops:
                break
            pad = np.concatenate([pad, _toks(rng, tool_len, vocab)])
            t += rng.exponential(gap_time)
    reqs.sort(key=lambda r: r.arrival)
    return reqs


SHARED_PREFIX_TRACES = {
    "multiturn": multiturn_trace,
    "system_prompt": system_prompt_trace,
    "agentic": agentic_trace,
}


def shared_prefix_trace(kind: str, qps: float, duration: float,
                        seed: int = 0, **kw) -> List[Request]:
    """Dispatch into the shared-prefix family (``SHARED_PREFIX_TRACES``)."""
    if kind not in SHARED_PREFIX_TRACES:
        raise ValueError(f"unknown shared-prefix trace {kind!r}; "
                         f"one of {sorted(SHARED_PREFIX_TRACES)}")
    return SHARED_PREFIX_TRACES[kind](qps, duration, seed, **kw)


def _tok_req(rid: str, t: float, prompt: np.ndarray, d: int,
             rng: np.random.Generator, predict_sigma: Optional[float],
             slo_mix: Optional[Dict[str, float]]) -> Request:
    r = _req(rid, t, len(prompt), d, rng, predict_sigma, slo_mix)
    r.prompt_tokens = prompt
    return r


def shifting_trace(kind: str, qps: float, duration: float, seed: int = 0,
                   **kw) -> List[Request]:
    """Dispatch into the shifting-trace family (see ``SHIFTING_TRACES``)."""
    if kind not in SHIFTING_TRACES:
        raise ValueError(f"unknown shifting trace {kind!r}; "
                         f"one of {sorted(SHIFTING_TRACES)}")
    return SHIFTING_TRACES[kind](qps, duration, seed, **kw)


def _req(rid: str, t: float, p: int, d: int, rng: np.random.Generator,
         predict_sigma: Optional[float],
         slo_mix: Optional[Dict[str, float]] = None) -> Request:
    if predict_sigma is None:
        predict_sigma = DEFAULT_PREDICT_SIGMA
    pred = int(d)
    if predict_sigma > 0:
        pred = max(1, int(round(d + rng.normal(0, predict_sigma))))
    slo = pick_slo(rng, slo_mix)
    return Request(rid, float(t), int(p), int(d), predicted_decode=pred,
                   slo=slo)


def pick_slo(rng: np.random.Generator,
              slo_mix: Optional[Dict[str, float]]) -> Optional[SLOClass]:
    """Draw an SLO class from a {name: weight} mix (None => unclassed)."""
    if not slo_mix:
        return None
    names = sorted(slo_mix)
    w = np.array([slo_mix[n] for n in names], float)
    name = names[int(rng.choice(len(names), p=w / w.sum()))]
    return SLO_CLASSES[name]


def replay_trace(qps: float, duration: float, seed: int = 0) -> List[Request]:
    """Paper §6.5: a continuous BurstGPT-like stream with temporal swings —
    the first ~1/7th of the window is decode-heavy (short prompts, long
    outputs), then prefill-heavy phases alternate in."""
    rng = np.random.default_rng(seed)
    reqs: List[Request] = []
    t = 0.0
    i = 0
    while t < duration:
        t += rng.exponential(1.0 / qps)
        if t >= duration:
            break
        phase = t / duration
        # decode-heavy opening, then oscillating prefill dominance
        w = np.sin(2 * np.pi * (phase * 3.0 + 0.25))
        p_mode = int(2048 * (1.0 + 1.2 * max(0.0, w)))
        d_mode = int(512 * (1.0 + 1.5 * max(0.0, -w)))
        if phase < 0.15:
            p_mode, d_mode = 300, 1200
        p = int(np.clip(rng.lognormal(np.log(p_mode), 0.4), 8, 16384))
        d = int(np.clip(rng.lognormal(np.log(d_mode), 0.4), 4, 16384))
        reqs.append(_req(f"replay-{i}", t, p, d, rng, None))
        i += 1
    return reqs
