"""Nothing under perfbench/ imports JAX, Flax or the JAX package (``repro``,
compared by whole top-level names: ``repro_torch`` is another name), and
nothing under perfbench/reference/ imports the port."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.args[0].value.split(".")[0]


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_or_reference_package(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    assert "repro_torch" not in set(top_level_imports(path))


def test_the_scan_sees_imports():
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / "m.py"
        p.write_text("import jax.numpy\nfrom repro.core import x\nimport repro_torch\n")
        assert list(top_level_imports(p)) == ["jax", "repro", "repro_torch"]
