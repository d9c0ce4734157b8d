"""The port stands alone: nothing under ``src/repro_torch/`` (nor
``chip_smoke.py``) imports JAX, ``ml_dtypes`` or the JAX package, and the
framework-free modules it copied from ``src/repro/`` still equal their
originals once the import prefix is rewritten, so scheduler decisions stay
the same function of the same inputs in both packages."""
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

#: definitions copied from ``utils/sharding.py`` (the rest of that file
#: builds jax.sharding specs and stays behind)
SHARDING_DEFS = ["_warn_once", "AchievedParallelism", "achieved_parallelism"]
#: the port's own tensor-parallel layout in that file: split dims instead
#: of the reference's PartitionSpec trees, and the shard cutter
SHARDING_PORT_ONLY = ["_spec_tree", "tp_param_specs", "tp_cache_specs",
                      "shard_params"]


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
