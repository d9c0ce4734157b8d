"""``spans.py``: the idle attribution on synthetic intervals, and a traced
run at smoke size on the CPU, where the program's step records give what
the harness's own tally gives, and a program without tracing runs as
before with the new readers silent."""
import random

import pytest

from cardbench import spans, spec
from cardbench import run as cardrun
from cardbench.record import Window
from cardbench.tests import smoke

BENCH = spec.load_benchmark()
LIMITS = {"compare": [{"statistic": "gap_widest", "limit": 1e-3},
                      {"statistic": "kv_rel_widest", "limit": 1e-3}]}
NEW = ("engine.decode_step_ms_p50", "engine.mixed_step_ms_p90",
       "sched.predict_error_pct", "device.idle_dispatch_share",
       "device.idle_collect_share", "device.idle_loop_share")
STEP_METRICS = NEW[:3]


def brute(idle, named, s0, s1):
    """Charge each nanosecond one at a time."""
    out = {}
    for t in range(s0, s1):
        if not any(a <= t < b for a, b in idle):
            continue
        open_ = [(a, b, n) for a, b, n in named if a <= t < b]
        name = (min(open_, key=lambda s: (-s[0], s[1]))[2] if open_
                else "host.other")
        out[name] = out.get(name, 0) + 1
    return out


def nested(rng, a, b, depth, names):
    """Spans nested inside [a, b) as a thread's stack makes them."""
    out, t = [], a
    while t < b - 2 and depth:
        x = rng.randrange(t, b - 1)
        y = rng.randrange(x + 1, b)
        out.append((x, y, rng.choice(names)))
        out += nested(rng, x, y, depth - 1, names)
        t = y
    return out


@pytest.mark.parametrize("seed", range(8))
def test_every_idle_nanosecond_is_charged_once(seed):
    rng = random.Random(seed)
    s0, s1 = 0, 400
    busy = [(a, a + rng.randrange(1, 30))
            for a in sorted(rng.sample(range(-20, 420), 12))]
    named = nested(rng, -10, 410, 3, list(spans.DISPATCH + spans.COLLECT)
                   + ["session.compose", "policy.place", "handoff.pump"])
    if seed % 2:       # a second thread's spans overlapping the first's
        named += nested(rng, 50, 300, 2, ["handoff.sync"])
    idle = spans.idle_of(busy, s0, s1)
    got = spans.attribute(idle, named)
    assert got == brute(idle, named, s0, s1)
    total = sum(b - a for a, b in idle)
    assert sum(got.values()) == total
    assert sum(spans.by_class(got).values()) == total
    covered = sum(1 for t in range(s0, s1)
                  if any(a <= t < b for a, b in busy))
    assert total == (s1 - s0) - covered


@pytest.mark.parametrize("name,cls", [
    ("engine.dispatch", "dispatch"), ("engine.capture", "dispatch"),
    ("engine.wait", "collect"), ("engine.sample", "collect"),
    ("session.compose", "loop"), ("host.other", "loop"),
    ("handoff.pump", "loop")])
def test_span_classes(name, cls):
    assert spans.class_of(name) == cls


def test_containment_with_slack():
    outer = [(0, 100), (200, 300)]
    inner = [(10, 90), (195, 310), (120, 150), (260, 360)]
    n, off = spans.contained(inner, outer, slack=10)
    assert n == 2 and off == [10, -5]


def run(trace=True):
    return cardrun.run_cell(
        smoke.conf("qwen2.5-14b"), smoke.mix(), smoke.RATE, LIMITS,
        spec.readers(BENCH["per_layer"]), spec.readers(BENCH["end_to_end"]),
        2 ** 31 + 7, 3.0, trace, device="cpu", n_pages=512)


def test_a_traced_run_keeps_one_record_a_harness_step():
    out = run()
    assert out["correct"]
    for name in STEP_METRICS[1:]:
        assert out["metrics"][name]["value"] > 0
    for name in NEW[3:]:          # no profiler on the CPU
        assert name not in out["metrics"]
    pt = spans._RUNS[-1]
    steps = pt.steps_ref
    # step ids count dispatches; a step still in flight when the loop
    # stopped at the close has no record (the session never closed it)
    base = min(r["step"] for r in pt.records)
    by_index = {r["step"] - base: r for r in pt.records}
    missing = set(range(len(steps))) - set(by_index)
    assert len(by_index) == len(pt.records) and steps
    assert max(by_index) < len(steps)
    assert all(i >= len(steps) - 4 for i in missing), missing
    pairs = [(st, by_index[i]) for i, st in enumerate(steps)
             if i in by_index]
    for st, r in pairs:
        assert (r["T"], r["n_pp"], r["n_slots"]) == (st.T, st.n_pp,
                                                     st.n_slots)
        assert r["rows"] == sum(t for t, _, _ in st.items)
    # the harness's pad share, from the program's rows over the same steps
    w0 = smoke.RATE["preroll_s"]
    w1 = w0 + 3.0
    assert all(st.t >= w1 for i, st in enumerate(steps) if i in missing)
    inside = [r for st, r in pairs if w0 <= st.t < w1]
    pad = (1 - sum(r["rows"] for r in inside)
           / sum(r["n_slots"] * r["T"] for r in inside)) * 100
    assert pad == pytest.approx(out["metrics"]["engine.pad_share"]["value"],
                                abs=1e-9)


def test_without_the_programs_trace_the_new_readers_are_silent(monkeypatch):
    monkeypatch.setattr(spans, "_program_trace", lambda: None)
    before = len(spans._RUNS)
    out = run()
    assert out["correct"] and len(spans._RUNS) == before
    assert not set(NEW) & set(out["metrics"])
    assert "engine.pad_share" in out["metrics"]


def test_step_metrics_leave_out_the_profilers_slice(monkeypatch):
    """Only steps collected before the slice began count: the profiler
    slows the launch of the steps inside it."""
    steps = []
    pt = spans.ProgramTrace(steps, s0_ns=10_000_000_000 + 6_000_000_000,
                            zero_ns=10_000_000_000)
    pt.records = [{"t": t, "host_s": 0.5, "T": 1, "device_s": d,
                   "predicted_s": d}
                  for t, d in ((0.5, 9.0), (2.0, 0.010), (3.0, 0.020),
                               (5.0, 0.030), (5.6, 0.5), (7.0, 0.9))]
    monkeypatch.setattr(spans, "_RUNS", [pt])
    w = Window(1.0, 9.0, {}, {}, 8, 1.0, 0.0, [], steps=steps)
    assert [r["t"] for r in spans.steps_in(w)] == [2.0, 3.0, 5.0]
    read = spec.metric_reader("engine.decode_step_ms_p50")
    assert read(w) == pytest.approx(20.0)
    pt.s0_ns = None        # no slice: the whole window
    assert [r["t"] for r in spans.steps_in(w)] == [2.0, 3.0, 5.0, 5.6, 7.0]


def test_the_readers_of_an_untraced_window_give_none():
    read = {n: r for n, (r, _) in spec.readers(
        spec.metrics_of(BENCH, "qwen2.5-14b.burstgpt", "per_layer")).items()}
    w = Window(0.0, 1.0, {}, {}, 8, 1.0, 0.0, [], steps=[])
    for name in NEW:
        assert read[name](w) is None
