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
    "configs/qwen2_5_14b.py",
]

#: definitions copied from ``utils/sharding.py`` (the rest of that file
#: builds jax.sharding specs and stays behind)
SHARDING_DEFS = ["_warn_once", "AchievedParallelism", "achieved_parallelism"]


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


def _defs(path: Path):
    src = path.read_text()
    tree = ast.parse(src)
    return {node.name: ast.get_source_segment(src, node)
            for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.ClassDef))}


def test_copied_sharding_definitions_equal_reference():
    ref, port = _defs(REF / "utils" / "sharding.py"), \
        _defs(PORT / "utils" / "sharding.py")
    assert set(port) == set(SHARDING_DEFS)
    for name in SHARDING_DEFS:
        assert port[name] == ref[name], name
