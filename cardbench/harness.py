"""Set-up, one served window, and the check, for ``run.py`` and the tools
beside it.

``Harness`` holds what a run sets up once: the kernels, the weights drawn
from the seed, the two instances' pools on one ``EngineBackend`` and
their captured graphs.  ``serve`` runs one open-loop trace through a fresh
``ServeSession`` with ``DynaServePolicy`` and the harness's observer;
``reset`` frees every slot after it, so a tool can serve several traces
(or refill another seed's weights in place) on the same graphs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cardbench import check, devtrace, probes, reference, spec, weights
from cardbench.record import Recorder, ReqLog, due_in, percentile


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Served:
    """One served trace: the observer's logs and marks, the traced run's
    steps and slice, what the program returned for each request, the
    cache of each request still resident at the close, the device's peak
    and the pool's, and the session's clock."""
    w0: float
    w1: float
    logs: Dict[str, ReqLog]
    marks: List[Dict[str, float]]
    outputs: Dict[str, Tuple[object, List[int]]]   # rid -> (prompt, served)
    resident: Dict[str, tuple]    # micro rid -> (tokens, k, v), first layer
    peak_bytes: int               # the device's peak allocation
    pages_peak: int               # most pool pages in use at once
    t0: float                     # the session clock's zero (monotonic)
    t_close: float
    loop_end: float               # session clock when the loop returned
    steps: Optional[list] = None
    summary: Optional[devtrace.Summary] = None

    def finished(self) -> Dict[str, Tuple[object, List[int]]]:
        return {r: o for r, o in self.outputs.items()
                if self.logs[r].done is not None}


class Harness:
    def __init__(self, conf: dict, seed: int, device="cuda", n_pages=None):
        from repro_torch.engine.backend import EngineBackend
        self.conf, self.a = conf, conf["assumed"]
        self.kind = reference.of(conf)
        self.w = self.kind.widths(conf)
        self.layout = self.kind.layout(self.w)
        self.cfg = spec.model_config(conf)
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"
        t0 = time.monotonic()
        if self.cuda:
            from repro_torch.kernels import _build
            _build.build_all()
        t1 = time.monotonic()
        self.params, self.stacks = weights.make(
            self.layout, self.kind.tree, seed, self.dev,
            dtype=getattr(torch, self.w["dtype"]))
        self.sync()
        log(f"[setup] kernels built or loaded in {t1 - t0:.3f} s; weights "
            f"{weights.nbytes(self.stacks) / 1e9:.3f} GB drawn in "
            f"{time.monotonic() - t1:.3f} s")
        self.n_pages = n_pages or self.pool_pages()
        a = self.a
        self.backend = EngineBackend(
            self.cfg, self.params, n_slots=a["n_slots"],
            page_size=a["page_size"], n_pages=self.n_pages,
            max_len=self.n_pages * a["page_size"] // a["n_slots"],
            max_chunk=a["max_chunk"],
            transfer_chunk=a["transfer_chunk"],
            kv_precision=a["kv_precision"], seed=seed)
        for i in range(a["n_instances"]):
            self.backend.spawn(i)
        self.captured = 0
        self.capture_s = 0.0
        self.warm_keys = set()

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def pool_pages(self) -> int:
        """Pages an instance: an equal share of what the weights leave on
        the card, less the configuration's headroom for the largest
        graph key's temporaries and its eager warm-up."""
        a = self.a
        page_bytes = self.kind.page_bytes(self.w, a["page_size"])
        free, _ = torch.cuda.mem_get_info(self.dev)
        room = free - a["pool_headroom_gib"] * (1 << 30)
        return int(room // (a["n_instances"] * page_bytes))

    def capture(self, pages) -> None:
        """Capture every (T, n_pp) key of each instance whose pages
        bucket lies in ``pages`` = [lo, hi], the widest T first, over the
        whole T ladder up to the chunk."""
        t0 = time.monotonic()
        lo, hi = pages
        for eng in self.backend.engines.values():
            if not eng.graphs:
                continue
            for n_pp in eng.page_buckets:
                if lo <= n_pp <= hi:
                    for T in reversed(eng.buckets):
                        if (T, n_pp) not in eng._graphs:
                            eng._capture(T, n_pp)
        self.sync()
        engs = self.backend.engines.values()
        self.warm_keys = {k for e in engs for k in e._graphs}
        self.captured = sum(e.captures for e in engs)
        self.capture_s = sum(e.capture_seconds for e in engs)
        mem = ""
        if self.cuda:
            mem = (f"; allocated {torch.cuda.memory_allocated(self.dev) / 1e9:.3f}"
                   f" GB, reserved {torch.cuda.memory_reserved(self.dev) / 1e9:.3f}"
                   f" GB, peak allocated "
                   f"{torch.cuda.max_memory_allocated(self.dev) / 1e9:.3f} GB")
        log(f"[setup] {self.captured} graph keys captured in "
            f"{self.capture_s:.3f} s ({time.monotonic() - t0:.3f} s wall); "
            f"pools {len(self.backend.engines)} x {self.n_pages} pages{mem}")

    def refill(self, seed: int) -> None:
        """Another seed's weights into the same tensors (graphs stay)."""
        weights.fill(self.stacks, self.layout, seed)
        self.sync()

    def serve(self, planned, w0: float, w1: float,
              trace: bool = False) -> Served:
        """One open-loop trace through a fresh session, cut at ``w1``."""
        from repro_torch.core.request import SLO_CLASSES, Request
        from repro_torch.core.session import ServeSession, SessionConfig
        from repro_torch.sim.policies import DynaServePolicy
        a, backend = self.a, self.backend
        policy = DynaServePolicy(backend.cost, a["policy_slo_s"],
                                 transfer_chunk=a["transfer_chunk"])
        session = ServeSession(backend, policy, SessionConfig(
            n_instances=a["n_instances"], slo=a["policy_slo_s"],
            max_sim_time=w1, open_loop=True, overlap=a["overlap"]))
        logs, reqs = {}, []
        for p in planned:
            cls = SLO_CLASSES[p.slo]
            logs[p.rid] = ReqLog(p.rid, p.phase, p.due, cls.ttft, cls.tbt,
                                 p.decode_len)
            r = Request(p.rid, p.due, len(p.prompt), p.decode_len,
                        predicted_decode=p.predicted, slo=cls)
            r.prompt_tokens = p.prompt
            reqs.append(r)
        engs = backend.engines.values()
        rec = Recorder(logs, policy, mark_at=(w0, w1), probes={
            "transfer_exposed": lambda: session.transfer_exposed,
            "captures": lambda: sum(e.captures for e in engs)}, peaks={
            "pages": lambda: sum(e.allocator.used_pages for e in engs
                                 if e.allocator is not None)})
        session.observers.append(rec)
        trace_slice = None
        if trace and self.cuda:
            probes.warm_profiler(self.dev)
            trace_slice = probes.Slice(w1 - min(8.0, (w1 - w0) / 2))
        with (probes.installed(session, backend, session._wall, trace_slice)
              if trace else contextlib.nullcontext()) as steps:
            session.run(reqs)
            loop_end = session._wall()
            if trace_slice is not None:
                trace_slice.stop()
            self.sync()
        t_close = time.monotonic()
        peak = torch.cuda.max_memory_allocated(self.dev) if self.cuda else 0
        resident = resident_kv(session, backend)
        rec.close()
        summary = None
        if trace_slice is not None and trace_slice.prof is not None:
            summary = devtrace.from_profiler(trace_slice.prof,
                                             trace_slice.host_s)
        outputs = {rid: (rec_.prompt.copy(), list(rec_.generated))
                   for rid, rec_ in backend.records.items() if rid in logs}
        session.observers.clear()
        return Served(w0, w1, logs, rec.marks, outputs, resident, int(peak),
                      int(rec.peak["pages"]), session._t0, t_close, loop_end,
                      steps if trace else None, summary)

    def report(self, s: Served, t_process: Optional[float] = None) -> None:
        """The earlier lines: captures in the pre-roll and in the window,
        how late the loop admitted the window's arrivals, the steps' graph
        keys, the traced slice."""
        caps = [m["captures"] for m in s.marks]
        late = [g.admitted - g.due for g in due_in(s.logs, s.w0, s.w1)
                if g.admitted is not None]
        setup = "" if t_process is None else \
            f"setup {s.t0 + s.w0 - t_process:.3f} s; "
        log(f"[window] {s.w1 - s.w0:g} s from {s.w0:g} s on the session's "
            f"clock; {setup}graph captures in the pre-roll "
            f"{caps[0] - self.captured:g}, inside the window "
            f"{caps[1] - caps[0]:g}; arrivals admitted late by p50 "
            f"{(percentile(late, 50) or 0) * 1e3:.3f} ms, max "
            f"{max(late, default=0) * 1e3:.3f} ms over {len(late)}; the loop "
            f"returned {s.loop_end - s.w1:.3f} s past the close")
        page_gb = self.kind.page_bytes(self.w, self.a["page_size"]) / 1e9
        pages = len(self.backend.engines) * self.n_pages
        log(f"[window] KV pool pages in use at most {s.pages_peak} of "
            f"{pages} ({s.pages_peak * page_gb:.3f} of {pages * page_gb:.3f}"
            f" GB); device peak allocated {s.peak_bytes / 1e9:.3f} GB")
        extra = sorted(k for e in self.backend.engines.values()
                       for k in e._graphs if k not in self.warm_keys)
        if extra:
            log(f"[window] keys captured after set-up's warm range: {extra}")
        if s.steps is not None:
            keys: Dict[tuple, int] = {}
            for st in s.steps:
                if s.w0 <= st.t < s.w1:
                    keys[(st.T, st.n_pp)] = keys.get((st.T, st.n_pp), 0) + 1
            log("[window] steps by (T, n_pp): " + ", ".join(
                f"{k}: {n}" for k, n in sorted(keys.items())))
        if s.summary is not None:
            log(f"[trace] slice {s.summary.window_s:.3f} s, device busy "
                f"{s.summary.busy_s:.6f} s; idle by host range: " + ", ".join(
                    f"{k} {v:.6f} s" for k, v in sorted(
                        s.summary.gaps_by_range().items(),
                        key=lambda kv: -kv[1])))

    def reset(self) -> None:
        """Free every slot and record a served trace left behind."""
        self.sync()
        b = self.backend
        for iid, slot in list(b._slots.values()):
            b.engines[iid].free(slot)
        b._slots.clear()
        b.records.clear()

    def release(self) -> None:
        """Drop the program's state (engines, pools, graphs); the weights,
        which are the benchmark's, stay for the reference."""
        for eng in self.backend.engines.values():
            eng.close()
        self.backend.engines.clear()
        self.backend = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


def sample(s: Served, seed: int) -> List[str]:
    """The requests the check compares (``check.choose``): finished ones,
    and a handed-off one still streaming where none finished."""
    fin = s.finished()
    moved = [r for r, g in s.logs.items() if g.handoffs and s.outputs.get(r)
             and s.outputs[r][1]]
    pool = dict(fin)
    if moved and not any(r in fin for r in moved):
        pool.update({r: s.outputs[r] for r in moved})
    return check.choose(pool, moved, seed)


def compare(h: Harness, s: Served, pick: List[str],
            control: bool = False) -> dict:
    """``check.summary`` of the sampled requests' served tokens and of the
    resident requests' caches against the float32 reference: the
    program's, or (``control``) the reference's own in float8 in its
    place; with the routing near-ties the reference met where the model
    has experts."""
    stats: dict = {}
    g = check.gaps(h.kind, h.params, h.w, [s.outputs[r] for r in pick],
                   h.dev, control, stats=stats) if pick else []
    kv = check.kv_errors(h.kind, h.params, h.w, list(s.resident.values()),
                         h.dev, control) if s.resident else []
    out = check.summary(g, kv)
    if stats:
        out["near_tie_share"] = stats["near_ties"] / stats["decisions"]
    return out


def resident_kv(session, backend) -> Dict[str, tuple]:
    """For each micro-request still holding a slot when the loop returned
    (queued or running, or the source of a KV stream still open), the
    tokens at its positions [0, pos) and the first layer's keys and values
    that its instance's pool holds there, dequantized to float32, on the
    host.  A beta whose KV has not all arrived (its stream still open, or
    not yet ready) is left out: its pages are not yet its own."""
    out: Dict[str, tuple] = {}
    streams = session._streams
    micros = [m for inst in session.instances
              for m in inst.prefill_q + inst.decode_q]
    micros += [st.src for st in streams.values() if st.src is not None]
    for m in micros:
        loc = backend._slots.get(m.rid)
        if (loc is None or m.rid in out or m.cancelled or m.pos <= 0
                or not math.isfinite(m.ready) or m.ready > session.now
                or m.rid in streams):
            continue
        eng = backend.engines[loc[0]]
        if not eng.paged:
            continue
        full = backend.records[m.mr.parent.rid].full_seq
        n = min(m.pos, len(full))
        ids = eng.allocator.pages_of(loc[1])[:-(-n // eng.page_size)]
        blk = eng.cache["blocks"][0]
        kv = []
        for name in ("k", "v"):
            t = blk[f"{name}_pages"][0, ids].float()
            if f"{name}_scales" in blk:
                t = t * blk[f"{name}_scales"][0, ids][..., None, None]
            kv.append(t.reshape(-1, *t.shape[2:])[:n].cpu())
        out[m.rid] = (np.asarray(full[:n]), *kv)
    return out
