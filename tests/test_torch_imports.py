"""The port stands alone: no module of mmtrack_torch/ and nothing in
chip_smoke.py imports jax, flax or the JAX package (mmtrack_tpu), at any
level of a module (inside functions too). Each file is parsed with `ast`,
so docstrings and comments that name the JAX package do not count."""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "mmtrack_tpu")


def _sources() -> list[str]:
    out = ["chip_smoke.py"]
    for root, dirs, files in os.walk(os.path.join(REPO, "mmtrack_torch")):
        dirs[:] = sorted(d for d in dirs if not d.startswith(("_build", "__pycache__")))
        out += sorted(os.path.relpath(os.path.join(root, f), REPO)
                      for f in files if f.endswith(".py"))
    return out


def banned_imports(tree: ast.AST) -> list[str]:
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        found += [f"line {node.lineno}: {n}" for n in names if n.split(".")[0] in BANNED]
    return found


SOURCES = _sources()


def test_the_guard_sees_the_port():
    assert len(SOURCES) > 60
    assert "mmtrack_torch/trackers/atom_tracker.py" in SOURCES
    assert banned_imports(ast.parse("def f():\n    import jax.numpy as jnp\n"))
    assert banned_imports(ast.parse("from mmtrack_tpu.ops import fourier\n"))
    assert banned_imports(ast.parse("import flax.linen as nn\n"))
    assert not banned_imports(ast.parse('"""ports mmtrack_tpu/ops/fourier.py"""\nimport torch\n'))
    assert not banned_imports(ast.parse("from .jax_like import x\nimport jaxtyping\n"))


@pytest.mark.parametrize("path", SOURCES)
def test_no_jax_import(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    assert banned_imports(tree) == [], path
