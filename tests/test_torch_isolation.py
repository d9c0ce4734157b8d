"""The port stands alone: nothing under ``src/repro_torch/`` (nor the
torch examples, ``examples/*_torch.py``, nor ``chip_smoke.py``) imports
JAX, ``ml_dtypes`` or the JAX package, and the framework-free modules and
definitions it copied from ``src/repro/`` still equal their originals once
the import prefix is rewritten, but for the lines ``PORT_DIFFS`` lists
(the engine-level trace and counting that nothing in the port read), so
scheduler decisions stay the same function of the same inputs in both
packages."""
import ast
import difflib
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"

FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")

#: modules copied verbatim, up to ``repro.`` -> ``repro_torch.``
COPIES = [
    "core/paging.py", "core/request.py", "core/precision.py",
    "core/metrics_util.py", "core/costmodel.py", "core/predictor.py",
    "core/kv_transfer.py", "core/local_scheduler.py",
    "core/global_scheduler.py", "core/elastic.py", "core/session.py",
    "core/__init__.py", "sim/policies.py", "engine/block_allocator.py",
    "engine/prefix_cache.py", "engine/sampling.py", "models/config.py",
    "configs/__init__.py", "configs/shapes.py", "configs/chatglm3_6b.py",
    "configs/grok_1_314b.py", "configs/internvl2_76b.py",
    "configs/mamba2_780m.py", "configs/nemotron_4_340b.py",
    "configs/phi4_mini_3_8b.py", "configs/qwen1_5_32b.py",
    "configs/qwen2_5_14b.py", "configs/qwen2_5_32b.py",
    "configs/qwen2_5_72b.py", "configs/qwen3_moe_30b_a3b.py",
    "configs/recurrentgemma_9b.py", "configs/whisper_large_v3.py",
    "data/__init__.py", "data/workloads.py", "data/tokens.py",
    "sim/__init__.py", "sim/simulator.py", "sim/replay.py",
    "serving/__init__.py", "serving/metrics.py", "serving/tracing.py",
    "serving/driver.py", "serving/flightrecorder.py",
    "serving/attribution.py", "serving/loadgen.py", "launch/__init__.py",
]

#: the port's changes to copied modules, as the lines a line diff against
#: the original (import prefix rewritten) takes out (``-``) and puts in
#: (``+``), hunk by hunk in order, one reason each: the engine-level trace
#: (``repro_torch.utils.trace``) and the counting that nothing in the port
#: read; every other line equals the original
PORT_DIFFS = {
    "core/session.py": [
        ("WorkItem was used only by the removed flops_done / bytes_done", """
            -from repro_torch.core.costmodel import BatchCostModel, WorkItem
            +from repro_torch.core.costmodel import BatchCostModel"""),
        ("the engine-level trace", """
            +from repro_torch.utils import trace"""),
        ("flops_done / bytes_done: read only by per_instance_mfu", """
            -        self.flops_done = 0.0
            -        self.bytes_done = 0.0"""),
        ("a traced step's record, closed in _on_batch_done", """
            +    # A traced engine step's record (``repro_torch.utils.trace``), which
            +    # ``_on_batch_done`` closes with the plan's side.
            +    step: Optional[dict] = None"""),
        ("per_instance_mfu: read by nothing in the port", """
            -    per_instance_mfu: List[float]"""),
        ("the session clock's zero on the trace's clock", """
            +            if trace.on:
            +                trace.set_zero(_time.time_ns())"""),
        ("the policy.place span", """
            +        sp = trace.on and trace.begin("policy.place", r.rid)"""),
        ("the policy.place span", """
            +        if sp:
            +            trace.end(sp)"""),
        ("the session.compose span", """
            +        sp = trace.on and trace.begin("session.compose", None, inst.iid)"""),
        ("the session.compose span", """
            +        if sp:
            +            trace.end(sp)"""),
        ("flops_done / bytes_done and their two cost-model calls", """
            -        items = ([WorkItem("prefill", g, m.pos) for m, g in grants] +
            -                 [WorkItem("decode", 1, m.pos) for m in decs])
            -        inst.flops_done += self.cost.flops(items)
            -        inst.bytes_done += self.cost.bytes_moved(items)"""),
        ("the step record closed with the plan's side", """
            +        if res.step is not None:
            +            # a traced engine step: the plan's side of its record
            +            res.step.update(t=h.issued_at,
            +                            prefill=sum(g for _, g in grants),
            +                            decode=len(decs),
            +                            predicted_s=getattr(plan, "predicted_latency",
            +                                                None))
            +            trace.add_step(res.step)"""),
        ("per_instance_mfu", """
            -        mfu, hbm, busy = [], [], []
            +        hbm, busy = [], []"""),
        ("per_instance_mfu", """
            -            mfu.append(inst.flops_done / max(duration, 1e-9) / self.cost.hw.peak_flops)"""),
        ("per_instance_mfu", """
            -            per_instance_mfu=mfu,"""),
    ],
    "serving/tracing.py": [
        ("the engine level documented", """
            +
            +Below the session, the engine level is ``engine`` (the module
            +``repro_torch.utils.trace``, which imports only the standard library so
            +that the engine needs nothing of this package): one process-wide switch,
            +spans at the dispatch, pack, stage, launch, capture, collect, wait,
            +copy and sample of every engine step and at the session's compose,
            +placement and handoffs, and one record an engine step, stamped on the
            +profiler's clock, with the session clock's zero on that clock."""),
        ("the engine level re-exported", """
            -__all__ = ["Tracer"]
            +from repro_torch.utils import trace as engine
            +
            +__all__ = ["Tracer", "engine"]"""),
    ],
    "serving/flightrecorder.py": [
        ("host lanes documented", """
            -  and per-request spans from the same events;
            +  and per-request spans from the same events, and with the engine's
            +  trace (``repro_torch.utils.trace``) one host lane per instance;"""),
        ("the trace's spans passed in", """
            -def to_chrome_trace(events: Iterable[dict]) -> dict:
            +def to_chrome_trace(events: Iterable[dict],
            +                    spans: Optional[dict] = None) -> dict:"""),
        ("device lanes documented", """
            -    from ``exec`` events, KV-stream transfer lanes from
            +    from ``exec`` events (the steps' device time where the engine was
            +    traced, else their host latency), KV-stream transfer lanes from"""),
        ("host lanes documented", """
            -    and elastic scale events.\"\"\"
            +    and elastic scale events.  ``spans``: what
            +    ``repro_torch.utils.trace.take()`` handed over for the same run,
            +    drawn as one host lane per instance (``host-<iid>``; spans of no
            +    instance on ``host``), mapped onto the session clock by its
            +    ``zero_ns``.\"\"\""""),
        ("one host lane an instance", """
            +
            +    # engine host lanes: the trace's spans on the session clock
            +    if spans and spans.get("zero_ns") is not None:
            +        zero = spans["zero_ns"]
            +        for _, name, a, b, parent, key, iid, attrs in spans["spans"]:
            +            args = {"key": key, "parent": parent}
            +            args.update(attrs or {})
            +            out.append({
            +                "name": name, "ph": "X", "pid": pid,
            +                "tid": "host" if iid is None else f"host-{iid}",
            +                "ts": ts((a - zero) * 1e-9), "dur": (b - a) * 1e-3,
            +                "args": args})"""),
        ("the trace's spans passed on", """
            -def export_chrome_trace(events: Iterable[dict], path: str) -> int:
            -    trace = to_chrome_trace(events)
            +def export_chrome_trace(events: Iterable[dict], path: str,
            +                        spans: Optional[dict] = None) -> int:
            +    trace = to_chrome_trace(events, spans)"""),
    ],
}

#: top-level definitions of ``serving/http.py`` the port changes: the
#: engine-backend device field and the engine branch of ``make_session``
HTTP_PORT_ONLY = {"ServerConfig", "make_session"}

#: definitions copied from ``utils/sharding.py``, the mesh helpers among
#: them (the tensor-parallel spec trees stay behind)
SHARDING_DEFS = ["_warn_once", "AchievedParallelism", "achieved_parallelism",
                 "_axis_size", "best_divisible_axes", "spec_for",
                 "named_sharding", "replicated"]
#: the port's own definitions in that file, one reason each
SHARDING_PORT_ONLY = {
    "_spec_tree": "split dims instead of the reference's PartitionSpec trees",
    "tp_param_specs": "split dims instead of the reference's PartitionSpec trees",
    "tp_cache_specs": "split dims instead of the reference's PartitionSpec trees",
    "shard_params": "cuts one shard's views out of a tree (no jax.device_put)",
    "PartitionSpec": "jax.sharding.PartitionSpec has no torch counterpart",
    "Layout": "a device-free jax.sharding.Mesh for the meta-device dryrun",
    "NamedSharding": "a layout and a spec, with jax's shard_shape",
}

#: definitions copied from ``launch/mesh.py``, ``launch/specs.py`` and
#: ``launch/dryrun.py``; ``param_spec`` too, but for the line that sets
#: ``lead`` (the port's layers are not stacked, so no leaf has a stack dim)
VERBATIM_DEFS = {
    "launch/mesh.py": ["data_axes"],
    "launch/specs.py": ["cache_spec", "batch_spec", "effective_window"],
    "launch/dryrun.py": ["_microbatches", "_with_groups"],
}
PARAM_SPEC_LEAD = (
    '    lead = 1 if (names and names[0] in ("blocks", "encoder")) else 0',
    "    lead = 0                            # the port's layers are not stacked")


def _port_files():
    return (sorted(PORT.rglob("*.py"))
            + sorted((ROOT / "examples").glob("*_torch.py"))
            + [ROOT / "chip_smoke.py"])


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_port_files_exist():
    files = _port_files()
    assert len(files) > 30 and all(f.exists() for f in files)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(line, name) for line, name in _imported_roots(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _diff(rel: str):
    """The hunks of a line diff of the port's ``rel`` against the
    original's, import prefix rewritten: the lines each takes out
    (``-``) and puts in (``+``)."""
    ref = (REF / rel).read_text().replace("repro.", "repro_torch.")
    ref, port = ref.splitlines(), (PORT / rel).read_text().splitlines()
    ops = difflib.SequenceMatcher(None, ref, port, autojunk=False)
    return [["-" + line for line in ref[i1:i2]]
            + ["+" + line for line in port[j1:j2]]
            for tag, i1, i2, j1, j2 in ops.get_opcodes() if tag != "equal"]


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_equals_reference(rel):
    if rel in PORT_DIFFS:
        want = [textwrap.dedent(lines).strip("\n").splitlines()
                for _, lines in PORT_DIFFS[rel]]
        assert _diff(rel) == want, (
            f"src/repro_torch/{rel} differs from src/repro/{rel} in more "
            f"or other lines than PORT_DIFFS lists")
        return
    want = (REF / rel).read_text().replace("repro.", "repro_torch.")
    assert (PORT / rel).read_text() == want, (
        f"src/repro_torch/{rel} drifted from src/repro/{rel}: copy it "
        f"again and rewrite only the import prefix")


def _defs(path: Path, prefix: str = ""):
    """Top-level functions and classes by name, with ``prefix.`` rewritten
    to ``repro_torch.``."""
    src = path.read_text()
    if prefix:
        src = src.replace(prefix + ".", "repro_torch.")
    tree = ast.parse(src)
    return {node.name: ast.get_source_segment(src, node)
            for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.ClassDef,
                                 ast.AsyncFunctionDef))}


def _top_level_statements(path: Path, prefix: str = ""):
    """Every top-level statement but the module docstring, as source."""
    src = path.read_text()
    if prefix:
        src = src.replace(prefix + ".", "repro_torch.")
    tree = ast.parse(src)
    body = tree.body[1:] if ast.get_docstring(tree) is not None \
        else tree.body
    return [ast.get_source_segment(src, node) for node in body]


def test_copied_sharding_definitions_equal_reference():
    ref, port = _defs(REF / "utils" / "sharding.py"), \
        _defs(PORT / "utils" / "sharding.py")
    assert set(port) == set(SHARDING_DEFS) | set(SHARDING_PORT_ONLY)
    for name in SHARDING_DEFS:
        assert port[name] == ref[name], name


@pytest.mark.parametrize("rel", sorted(VERBATIM_DEFS))
def test_verbatim_definitions_equal_reference(rel):
    ref, port = _defs(REF / rel, "repro"), _defs(PORT / rel)
    for name in VERBATIM_DEFS[rel]:
        assert port[name] == ref[name], f"{rel}: {name}"


def test_param_spec_differs_from_reference_only_in_lead():
    ref = _defs(REF / "launch" / "specs.py", "repro")["param_spec"]
    port = _defs(PORT / "launch" / "specs.py")["param_spec"]
    old, new = PARAM_SPEC_LEAD
    assert ref.count(old) == 1
    assert port == ref.replace(old, new)


def test_http_differs_from_reference_only_in_server_config_and_make_session():
    """The port's front door is the reference's except for the
    engine-backend device field of ``ServerConfig`` and the engine branch
    of ``make_session``; every other top-level statement is the same."""
    ref_path, port_path = REF / "serving" / "http.py", \
        PORT / "serving" / "http.py"
    ref, port = _defs(ref_path, "repro"), _defs(port_path)
    assert set(port) == set(ref)
    assert [n for n in ref if port[n] != ref[n]] == sorted(HTTP_PORT_ONLY)
    keep = [s for s in _top_level_statements(ref_path, "repro")
            if not any(s.startswith(f"{kw} {name}") for name in HTTP_PORT_ONLY
                       for kw in ("class", "def"))]
    got = [s for s in _top_level_statements(port_path)
           if not any(s.startswith(f"{kw} {name}") for name in HTTP_PORT_ONLY
                      for kw in ("class", "def"))]
    assert got == keep
