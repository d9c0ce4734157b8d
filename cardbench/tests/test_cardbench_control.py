"""The controls, put through the verdict a run makes at the cell's
committed limits (``limits/<cell>.json``): the reference in float8 in the
program's place, and the program's own float8 KV pool.  Each comes out
not correct where the program as configured comes out correct.  Here at
smoke size in bfloat16 on the CPU, and at full width with two layers
where a card is; ``calibrate.py`` reads the same on the card at the
cell's size.  Only the dense cell: the MoE's bf16 routing near-ties make
its served tokens swing as far as the control's (``PERF.md``, Open
questions)."""
import json

import pytest

from cardbench import check, harness, spec
from cardbench.tests import smoke
from cardbench.traffic import generate

CELL = "qwen2.5-14b.burstgpt"


def readings(device, kv=None, layers=None, pages=512):
    """(the program's readings, the reference control's, the finished
    requests with the wrong number of tokens)."""
    conf = smoke.conf("qwen2.5-14b", dtype="bfloat16")
    mix, rate = smoke.mix(), dict(smoke.RATE)
    if layers is not None:          # full width: the published file, cut
        with open(spec.HERE / "configs" / "qwen2.5-14b.json") as f:
            conf = json.load(f)
        conf["num_hidden_layers"] = layers
        rate["warm_graph_pages"] = [1, 0]           # nothing captured
    if kv:
        conf["assumed"]["kv_precision"] = kv
    h = harness.Harness(conf, 2 ** 31 + 5, device, n_pages=pages)
    planned = generate.generate(mix, rate, 2 ** 31 + 5, 3.0,
                                h.w["vocab_size"])
    s = h.serve(planned, rate["preroll_s"], rate["preroll_s"] + 3.0)
    pick = harness.sample(s, 5)
    h.reset()
    wrong = sum(len(t) != s.logs[r].decode_len
                for r, (_, t) in s.finished().items())
    return (harness.compare(h, s, pick),
            harness.compare(h, s, pick, control=True), wrong)


def test_the_control_reads_wider_than_the_program():
    prog, ctrl, _ = readings("cpu")
    assert ctrl["gap_widest"] > prog["gap_widest"]
    assert ctrl["kv_rel_widest"] > 3 * prog["kv_rel_widest"]


def test_the_committed_limits_pass_the_program_and_fail_each_control():
    limits = spec.limits(CELL)
    prog, ctrl, wrong = readings("cpu")
    assert check.verdict(prog, limits, wrong)[0], prog
    assert not check.verdict(ctrl, limits, 0)[0], ctrl
    fp8_pool, _, wrong = readings("cpu", kv="fp8")
    correct, checks = check.verdict(fp8_pool, limits, wrong)
    assert not correct
    assert checks["kv_rel_widest"]["value"] > \
        checks["kv_rel_widest"]["limit"]


@pytest.mark.gpu
def test_the_control_on_the_card_at_full_width(card):
    prog, ctrl, _ = readings(card, layers=2, pages=2048)
    assert ctrl["gap_widest"] > prog["gap_widest"]
    assert ctrl["kv_rel_widest"] > 3 * prog["kv_rel_widest"]
