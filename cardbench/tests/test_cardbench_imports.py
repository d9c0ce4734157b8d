"""Nothing under cardbench/ imports JAX or the JAX package: every import
of every file, by its top-level name compared whole (``repro_torch`` is
the port, ``repro`` the JAX package)."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(HERE.rglob("*.py"))


def top_names(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not set(top_names(path)) & FORBIDDEN


def test_the_walk_tells_the_port_from_the_jax_package(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import repro_torch.core\nfrom repro.core import session\n")
    assert set(top_names(f)) == {"repro_torch", "repro"}


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        assert "repro_torch" not in set(top_names(path))
