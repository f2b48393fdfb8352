"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole (the part before the first dot): the port's name begins
with the JAX package's."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "mmtrack_tpu"}


def imported(path: Path) -> set[str]:
    """Top-level names of every module `path` imports, anywhere in it."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").rglob("*.py")):
        names = imported(path)
        assert "mmtrack_torch" not in names, path
        assert names <= {"__future__", "contextlib", "math", "typing", "numpy", "torch",
                         "benchmarks"}, (path, names)
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("benchmarks"):
                assert node.module.startswith("benchmarks.reference"), (path, node.module)


def test_the_check_compares_top_level_names_whole():
    assert "mmtrack_torch".split(".")[0] not in FORBIDDEN
    assert "mmtrack_tpu.models".split(".")[0] in FORBIDDEN
