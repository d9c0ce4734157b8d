#!/usr/bin/env python3
"""Read the two ends that a cell's correctness limits are set between.

    python3 cardbench/calibrate.py --workload qwen2.5-14b.burstgpt \
        --seeds 11,12,13 --control 3 --seconds 51 [--kv fp8] \
        [--fault state_unchanged]

For each seed, on one set-up (the next seed's weights drawn into the same
tensors, so the graphs stay): the cell's traffic at its own load for
``--seconds`` after its pre-roll, then what ``check.summary`` reads of
the program's served tokens and resident caches against the float32
reference, and what ``check.verdict`` makes of them at the cell's
committed limits.  For the first ``--control`` seeds also the control,
put through the same verdict: the reference in float8 in the program's
place (its first token; its keys and values rounded as a float8 pool
rounds them).  ``--kv fp8`` serves on the program's own lower-precision
path, float8 KV pages, so that the program's readings are that
control's; ``--fault`` plants one of ``faults.FAULTS`` in the timed path.
One JSON line a seed.  Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    from cardbench import check, faults, spec
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--kv", default=None,
                    help="serve on the program's own lower-precision pool "
                         "(fp8 or int8 KV pages) in place of the "
                         "configuration's: its readings are the control's")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS), default=None,
                    help="plant this fault in the timed path")
    args = ap.parse_args(argv)

    from cardbench.harness import Harness, compare, sample
    from cardbench.traffic import generate
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    mix = generate.load_mix(cell["traffic"])
    rate = generate.load_rate(cell["name"])
    limits = spec.limits(cell["name"])
    seeds = [int(x) for x in args.seeds.split(",")]
    conf = spec.config_file(bench, cell["config"])
    if args.kv:
        conf["assumed"]["kv_precision"] = args.kv
    h = Harness(conf, seeds[0])
    h.capture(rate["warm_graph_pages"])
    for i, seed in enumerate(seeds):
        if i:
            h.refill(seed)
        planned = generate.generate(mix, rate, seed, args.seconds,
                                    h.w["vocab_size"])
        w0 = rate["preroll_s"]
        with faults.planted(args.fault):
            s = h.serve(planned, w0, w0 + args.seconds)
        h.reset()
        wrong = sum(len(t) != s.logs[r].decode_len
                    for r, (_, t) in s.finished().items())
        pick = sample(s, seed)
        t0 = time.monotonic()
        got = compare(h, s, pick)
        line = {"seed": seed, "kv": args.kv, "fault": args.fault,
                "program": got,
                "correct": check.verdict(got, limits, wrong)[0],
                "wrong_token_counts": wrong, "requests": len(pick),
                "handed_off": sum(bool(s.logs[r].handoffs) for r in pick),
                "resident": len(s.resident),
                "reference_s": time.monotonic() - t0}
        if i < args.control:
            ctrl = compare(h, s, pick, control=True)
            line["control"] = ctrl
            line["control_correct"] = check.verdict(ctrl, limits, 0)[0]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
