"""``BENCHMARK.json`` and the files it names, found by name.

A cell names its configuration (``configs/<file>``) and its traffic mix
(``traffic/<mix>.json``, with ``traffic/rates/<cell>.json``); a metric
``<name>`` is read by ``metrics/<name>.py``; a cell's correctness limits
are ``limits/<cell>.json``; its architecture kind (``port.arch_type``)
is ``reference/<kind>.py``.  Adding a cell, a metric or a kind adds files
and entries and edits none.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

from cardbench import reference

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json; one of "
                     f"{[w['name'] for w in bench['workloads']]}")


def config_file(bench: dict, config: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == config:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise SystemExit(f"no configuration {config!r} in BENCHMARK.json")


def widths(conf: dict) -> dict:
    """The sizes that the weights, the yardstick and the reference read,
    by the configuration's kind (``reference.of``)."""
    return reference.of(conf).widths(conf)


def model_config(conf: dict):
    """The port's ``ModelConfig`` for a configuration file: the port's
    registry entry with the file's sizes and stated settings applied, so
    that the file is what runs; refused where the kind's reference does
    not follow it."""
    from repro_torch.configs import get_config
    kind = reference.of(conf)
    cfg = get_config(conf["port"]["registry_name"]).with_(
        arch_type=conf["port"]["arch_type"],
        **kind.port_fields(kind.widths(conf)))
    kind.covers(cfg)
    return cfg


def limits(cell_name: str, root: Path = HERE) -> dict:
    with open(root / "limits" / f"{cell_name}.json") as f:
        return json.load(f)


def metric_reader(name: str, root: Path = HERE) -> Callable:
    """``read(run) -> float | None`` of ``metrics/<name>.py``."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "cardbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell_name: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` entries that the cell reports:
    those without a ``workloads`` key and those that list it."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def readers(entries: List[dict]) -> Dict[str, tuple]:
    """(reader, unit) by metric name."""
    return {m["name"]: (metric_reader(m["name"]), m["unit"])
            for m in entries}
