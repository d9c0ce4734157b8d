"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, two things
that the timed path produced are held against the float32 reference of
the configuration's kind (``reference/<kind>.py``):

- Served tokens.  A sample, drawn from the seed, of the requests the
  program finished, the one with the most served tokens always in it and
  one that was handed off between instances where there is one, up to
  ``SAMPLE_TOKENS`` served tokens.  The reference runs once over each
  prompt with its served tokens and reads, for every served token, the
  gap by which its logit of that token lies below its best there.
- The KV cache.  Every request still resident at the close (a handed-off
  one on the instance it moved to), as the pages of its instance's pool
  hold it: the first layer's keys and values at each of its positions,
  read back (and dequantized, from a quantized pool) before the state was
  freed.  The reference works out the same keys and values from the same
  tokens; each position's row reads ``|program - reference| /
  |reference|`` over its heads and head dims, keys and values apart.

The cell's ``limits/<cell>.json`` names the statistics compared and their
limits (``verdict``); every finished request must also have returned as
many tokens as it asked for.  The control, in the program's place: the
reference on float8-rounded operands and the token it puts first, and
the reference's keys and values rounded to float8 as a quantized pool
rounds them (one scale a row).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from cardbench.reference import plain

#: served tokens the sample reaches before it stops adding requests
SAMPLE_TOKENS = 1200
SAMPLE_MAX = 6


def choose(finished: Dict[str, Tuple[np.ndarray, List[int]]],
           handed_off: Sequence[str], seed: int) -> List[str]:
    """The rids to compare: the longest output, one handoff, then others
    in a seeded order until ``SAMPLE_TOKENS`` or ``SAMPLE_MAX``."""
    if not finished:
        return []
    rng = np.random.default_rng([seed, 0x636b])
    order = sorted(finished)
    longest = max(order, key=lambda r: (len(finished[r][1]), r))
    pick = [longest]
    moved = [r for r in order if r in set(handed_off) and r != longest]
    if moved:
        pick.append(moved[int(rng.integers(len(moved)))])
    for r in rng.permutation(order):
        served = sum(len(finished[p][1]) for p in pick)
        if served >= SAMPLE_TOKENS or len(pick) >= SAMPLE_MAX:
            break
        if r not in pick:
            pick.append(str(r))
    return pick


def gaps(kind, params: dict, w: dict,
         seqs: Sequence[Tuple[np.ndarray, List[int]]], device,
         control: bool = False, stats=None) -> List[np.ndarray]:
    """Per sequence and served position, the reference's best logit less
    its logit of the token judged: the program's served token or, with
    ``control``, the token the float8 reference puts first."""
    toks, rows = [], []
    for prompt, served in seqs:
        full = np.concatenate([prompt, np.asarray(served[:-1], np.int32)])
        toks.append(torch.as_tensor(full, dtype=torch.long, device=device))
        rows.append(torch.arange(len(prompt) - 1, len(full), device=device))
    ref = kind.logits_at(params, w, toks, rows, "f32", stats=stats)
    ctrl = kind.logits_at(params, w, toks, rows, "fp8") if control else None
    out = []
    for i, ((prompt, served), r) in enumerate(zip(seqs, ref)):
        idx = ctrl[i].argmax(dim=-1) if control else \
            torch.as_tensor(np.asarray(served), device=device).long()
        got = r.gather(1, idx[:, None])[:, 0]
        out.append((r.max(dim=-1).values - got).cpu().numpy())
    return out


def fp8_rows(t: torch.Tensor) -> torch.Tensor:
    """(N, KV, hd) rounded to float8 e4m3 with one scale a row, as a
    quantized pool stores a position."""
    return plain._fp8(t.reshape(t.shape[0], -1), -1).reshape(t.shape)


def kv_errors(kind, params: dict, w: dict,
              resident: Sequence[Tuple[np.ndarray, torch.Tensor,
                                       torch.Tensor]],
              device, control: bool = False) -> List[np.ndarray]:
    """Per resident sequence and position, the relative error of the
    first layer's key row and of its value row, the larger of the two:
    the program's as its pool held them or, with ``control``, the
    reference's own rounded to float8 (``fp8_rows``)."""
    ref = kind.kv_at(params, w, [torch.as_tensor(t, dtype=torch.long,
                                                 device=device)
                                 for t, _, _ in resident])
    out = []
    for (_, k, v), (rk, rv) in zip(resident, ref):
        errs = []
        for got, want in ((k, rk), (v, rv)):
            got = fp8_rows(want) if control else got.to(device).float()
            num = (got - want).flatten(1).norm(dim=1)
            errs.append(num / want.flatten(1).norm(dim=1).clamp_min(1e-30))
        out.append(torch.maximum(*errs).cpu().numpy())
    return out


def summary(gap: Sequence[np.ndarray],
            kv: Sequence[np.ndarray]) -> Dict[str, float]:
    """The numbers a run can compare: the widest and the mean gap over
    every judged token, the share of them not the reference's first
    choice; the widest and the mean relative error of a cached row."""
    out: Dict[str, float] = {}
    if gap:
        g = np.concatenate(gap)
        out.update(gap_widest=float(g.max()), gap_mean=float(g.mean()),
                   off_first=float((g > 0).mean()), tokens=int(g.size))
    if kv:
        e = np.concatenate(kv)
        out.update(kv_rel_widest=float(e.max()), kv_rel_mean=float(e.mean()),
                   kv_rows=int(e.size), kv_requests=len(kv))
    return out


def verdict(got: Dict[str, float], limits: dict,
            wrong_counts: int) -> Tuple[bool, Dict[str, dict]]:
    """``correct`` and every number compared beside its limit: each
    statistic the cell's limits name (a missing one fails), and the
    finished requests with the wrong number of tokens (limit 0)."""
    checks = {c["statistic"]: {"value": got.get(c["statistic"]),
                               "limit": c["limit"]}
              for c in limits["compare"]}
    checks["wrong_token_counts"] = {"value": wrong_counts, "limit": 0}
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in checks.values()), checks
