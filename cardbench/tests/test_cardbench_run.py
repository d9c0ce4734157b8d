"""A whole run at smoke size on the CPU, the harness's look for a card
skipped: correct on the program as it is, not correct with the timed
path broken underneath in each way a serving cell can break."""
import json
import subprocess
import sys

import pytest

from cardbench import faults, spec
from cardbench import run as cardrun
from cardbench.tests import smoke

BENCH = spec.load_benchmark()
LIMIT = 1e-3        # an f32 program against the f32 reference
LIMITS = {"compare": [{"statistic": "gap_widest", "limit": LIMIT},
                      {"statistic": "kv_rel_widest", "limit": LIMIT}]}


def run(name="qwen2.5-14b", fault=None, seed=2 ** 31 + 7, trace=False):
    return cardrun.run_cell(
        smoke.conf(name), smoke.mix(), smoke.RATE, LIMITS,
        spec.readers(BENCH["per_layer"]), spec.readers(BENCH["end_to_end"]),
        seed, 3.0, trace, device="cpu", n_pages=512)


@pytest.mark.parametrize("name", ["qwen2.5-14b", "qwen3-30b-a3b"])
def test_a_run_is_correct_and_reports_its_metrics(name):
    out = run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 6 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in BENCH["end_to_end"]}
    assert list(out)[-1] == "checks"
    json.dumps(out)


def test_a_traced_run_reports_the_counters():
    out = run(trace=True)
    assert out["correct"]
    for name in ("session.queue_wait_p90_ms", "sched.place_ms_mean",
                 "engine.pad_share", "engine.capture_s"):
        assert name in out["metrics"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_broken_timed_path_is_not_correct(fault):
    with faults.planted(fault):
        out = run()
    assert not out["correct"]
    assert out["checks"]["gap_widest"]["value"] > LIMIT
    if fault == "state_unchanged":
        assert out["checks"]["kv_rel_widest"]["value"] > LIMIT


def test_a_cache_left_unchanged_reads_as_the_reference_does_not():
    with faults.planted("state_unchanged"):
        out = run()
    assert out["checks"]["kv_rel_widest"]["value"] > 0.5


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here: the run would serve")
    p = subprocess.run([sys.executable, str(spec.HERE / "run.py"),
                        "--workload", BENCH["workloads"][0]["name"],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and p.stdout == ""
