#!/usr/bin/env python3
"""One run of one cell of the card benchmark of ``repro_torch``.

    python3 cardbench/run.py --workload qwen2.5-14b.burstgpt --seed 7 \
        --seconds 40 --trace 0

From the root of a checkout on a machine with the cell's CUDA cards.  The
timed path is ``repro_torch.core.session.ServeSession.run`` on an
``EngineBackend`` (CUDA graphs on) with ``DynaServePolicy``, two
instances sharing the card, fed an open-loop trace from
``traffic/generate.py``.  Set-up, in order: the kernels loaded (built
into ``build/repro_torch/`` of the checkout on its first run), the
weights drawn on the card from the seed, the pools sized, every graph key
the cell's traffic reaches captured, and the pre-roll served (requests
part-way through their outputs, then the mix's own arrivals); the window
is ``--seconds`` after that on the session's clock.

Standard output ends with one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` and, traced, ``breakdown``;
``checks`` last, each compared number with its limit.  Standard error
ends with the same numbers, one a line.  Without a CUDA card, or with
fewer than the cell asks for, it prints no result and exits 2; where
``sys.modules`` holds JAX or the JAX package once all is done, just
before the result would be printed, it names them and exits 3.
"""
from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: top-level modules that may not be loaded in the process that prints the
#: result: JAX and the JAX package this port stands beside
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(conf: dict, mix: dict, rate: dict, limits: dict,
             per_layer: dict, end_to_end: dict, seed: int, seconds: float,
             trace: bool, device="cuda", n_pages=None,
             t_process=T_PROCESS) -> dict:
    """Set up, serve the window, read the metrics and check the output;
    the result line's dict.  ``per_layer`` / ``end_to_end``: (reader,
    unit) by metric name.  ``limits``: the cell's ``limits/<cell>.json``.
    ``n_pages`` overrides the pool rule (the CPU has no free-memory
    reading)."""
    import torch

    from cardbench import check
    from cardbench.harness import Harness, compare, log, sample
    from cardbench.record import Window, due_in, failed
    from cardbench.traffic import generate

    h = Harness(conf, seed, device, n_pages=n_pages)
    h.capture(rate["warm_graph_pages"])
    planned = generate.generate(mix, rate, seed, seconds, h.w["vocab_size"])
    w0 = float(rate["preroll_s"])
    s = h.serve(planned, w0, w0 + seconds, trace=trace)
    h.report(s, t_process)

    run = Window(s.w0, s.w1, s.logs, h.w, h.a["page_size"],
                 s.t0 + s.w0 - t_process, h.capture_s, s.marks, s.steps,
                 s.summary, kind=h.kind)
    metrics = {}
    for name, (read, unit) in (per_layer if trace else end_to_end).items():
        v = read(run)
        if v is not None:
            metrics[name] = {"value": v, "unit": unit}

    served = {r: len(o[1]) for r, o in s.outputs.items()}
    bad = failed(s.logs, s.w0, s.w1, served)
    wrong = sorted(r for r, (_, toks) in s.finished().items()
                   if len(toks) != s.logs[r].decode_len)
    pick = sample(s, seed)
    h.release()
    t_ref = time.monotonic()
    got = compare(h, s, pick)
    log(f"[check] readings {json.dumps(got)}")
    log(f"[check] reference over {len(pick)} requests, "
        f"{got.get('tokens', 0)} served "
        f"tokens ({sum(bool(s.logs[r].handoffs) for r in pick)} handed off, "
        f"{sum(s.logs[r].done is None for r in pick)} still streaming) and "
        f"the caches of {len(s.resident)} resident, {got.get('kv_rows', 0)} "
        f"rows, in {time.monotonic() - t_ref:.3f} s, from "
        f"{t_ref - s.t_close:.3f} s after the loop")
    correct, checks = check.verdict(got, limits, len(wrong))
    info = {"platform": "gpu" if h.cuda else h.dev.type,
            "kind": torch.cuda.get_device_name(h.dev) if h.cuda else "cpu",
            "count": 1, "memory_peak_bytes": s.peak_bytes}
    out = {"correct": correct, "attempted": len(due_in(s.logs, s.w0, s.w1)),
           "failed": len(bad), "metrics": metrics, "device": info}
    if s.summary is not None:
        info.update(busy_s=s.summary.busy_s, window_s=s.summary.window_s)
        out["breakdown"] = {"device_ops": s.summary.top_ops(),
                            "idle_gaps": s.summary.top_gaps()}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from cardbench import spec
    from cardbench.traffic import generate
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    import torch
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < cell["chips"]:
        print(f"cardbench: the cell needs {cell['chips']} CUDA card(s); "
              f"{seen} visible", file=sys.stderr)
        return 2
    out = run_cell(spec.config_file(bench, cell["config"]),
                   generate.load_mix(cell["traffic"]),
                   generate.load_rate(cell["name"]), spec.limits(cell["name"]),
                   spec.readers(spec.metrics_of(bench, cell["name"],
                                                "per_layer")),
                   spec.readers(spec.metrics_of(bench, cell["name"],
                                                "end_to_end")),
                   args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"cardbench: modules of JAX or the JAX package are loaded: "
              f"{found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
