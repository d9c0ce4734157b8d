"""BENCHMARK.json against its contract, and every file it names found by
name."""
import json
import re

import pytest

from cardbench import spec
from cardbench.traffic import generate

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|_dim$|_rank$|"
                   r"head|expand|experts_per_tok)")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "cardbench/run.py"]
    assert BENCH["paths"] == ["cardbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits: (2 + 14 x 24) runs, each allowed
    # run_seconds + 60, each cell 180 s to compile, 1200 s spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_each_configuration_file_is_found_and_keeps_its_widths(c):
    conf = spec.config_file(BENCH, c["name"])
    assert NAME.match(c["name"]) and c["file"].startswith("cardbench/")
    assert c["reduced"] == conf["reduced"] == []
    assert not any(WIDTH.search(k) for k in c["reduced"])
    assert c["source"] == conf["source"]
    cfg = spec.model_config(conf)
    w = spec.widths(conf)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.hd, cfg.vocab_size) == (
        w["n_layers"], w["d_model"], w["n_heads"], w["n_kv_heads"],
        w["head_dim"], w["vocab_size"])
    if w["moe_experts"]:
        # dropless: every expert's buffer holds every row of a step
        assert cfg.moe_capacity_factor == cfg.moe_experts / cfg.moe_top_k
    assert any(wl["config"] == c["name"] for wl in BENCH["workloads"])


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_traffic_rate_and_limits(wl):
    assert NAME.match(wl["name"]) and wl["chips"] == 1
    assert len(wl["why"]) <= 200
    mix = generate.load_mix(wl["traffic"])
    rate = generate.load_rate(wl["name"])
    assert mix["loop"] == "open" and rate["rate_per_s"] > 0
    for lim in spec.limits(wl["name"])["compare"]:
        assert lim["statistic"] in ("gap_widest", "gap_mean", "off_first",
                                    "kv_rel_widest", "kv_rel_mean")
        assert lim["limit"] > 0
    for kind in ("end_to_end", "per_layer"):
        assert spec.metrics_of(BENCH, wl["name"], kind)


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_each_metric_has_a_reader_and_a_lawful_entry(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert callable(spec.metric_reader(m["name"]))
    if "bound" in m:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    else:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    if m["name"].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_setup_s_is_an_end_to_end_metric_with_its_bound():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
