"""The port stands alone: nothing under ``src/repro_torch/`` (nor the
torch examples, ``examples/*_torch.py``, nor ``chip_smoke.py``) imports
JAX, ``ml_dtypes`` or the JAX package, and the framework-free modules and
definitions it copied from ``src/repro/`` still equal their originals once
the import prefix is rewritten, so scheduler decisions stay the same
function of the same inputs in both packages."""
import ast
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


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_equals_reference(rel):
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
