#!/usr/bin/env python3
"""Find a cell's knee once, by a sweep of arrival rates on one set-up.

    python3 cardbench/sweep.py --workload qwen2.5-14b.burstgpt --seed 11 \
        --seconds 40 --rates 0.15,0.2,0.25,0.3 --sojourn 22

Each rate serves the cell's mix with that rate in the pre-roll and the
window and ``rate * sojourn`` requests started part-way (the occupancy
Little's law gives), on the same weights and graphs, the slots freed
between rates.  One JSON line a rate: requests due in the window, refused,
waiting for their first step at the window's start and at its close, in
the system at its start, the end-to-end numbers, and the mean time from
due to done of the requests that finished.  The knee is the highest rate
at which none is refused and no more wait at the close than at the start.
Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def waiting(logs, t: float) -> int:
    return sum(1 for g in logs.values() if g.due <= t and not g.rejected
               and (g.running is None or g.running > t))


def in_system(logs, t: float) -> int:
    return sum(1 for g in logs.values() if g.due <= t and not g.rejected
               and (g.done is None or g.done > t))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--sojourn", type=float, required=True)
    args = ap.parse_args(argv)

    from cardbench import spec
    from cardbench.harness import Harness
    from cardbench.record import due_in, gaps, percentile, tokens_in, ttfts
    from cardbench.traffic import generate
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    mix = generate.load_mix(cell["traffic"])
    base = generate.load_rate(cell["name"])
    h = Harness(spec.config_file(bench, cell["config"]), args.seed)
    h.capture(base["warm_graph_pages"])
    for r in [float(x) for x in args.rates.split(",")]:
        rate = dict(base, rate_per_s=r, preroll_rate_per_s=r,
                    warm_requests=int(round(r * args.sojourn)))
        planned = generate.generate(mix, rate, args.seed, args.seconds,
                                    h.w["vocab_size"])
        w0 = rate["preroll_s"]
        s = h.serve(planned, w0, w0 + args.seconds)
        h.report(s)
        h.reset()
        logs, w1 = s.logs, s.w1
        n, good = tokens_in(logs, w0, w1)
        done = [g.done - g.due for g in logs.values()
                if g.done is not None and g.phase != "warm"]
        print(json.dumps({
            "rate_per_s": r, "warm": rate["warm_requests"],
            "due": len(due_in(logs, w0, w1)),
            "refused": sum(g.rejected for g in due_in(logs, w0, w1)),
            "waiting_start": waiting(logs, w0), "waiting_close": waiting(logs, w1),
            "in_system_start": in_system(logs, w0),
            "in_system_close": in_system(logs, w1),
            "ttft_p90_ms": (percentile(ttfts(logs, w0, w1), 90) or 0) * 1e3,
            "tbt_p99_ms": (percentile(gaps(logs, w0, w1), 99) or 0) * 1e3,
            "goodput_tokens_per_s": good / args.seconds,
            "output_tokens_per_s": n / args.seconds,
            "sojourn_s_mean": sum(done) / len(done) if done else None,
            "finished": len(done)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
