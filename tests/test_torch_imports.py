"""The port stands alone: no file of `pasta_tpu_torch/` and not
`chip_smoke.py` imports jax, jaxlib, flax or the JAX package `pasta_tpu`,
at top level or inside a function. Every import statement of every file is
read with `ast`; one case per file."""

import ast
import glob
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "pasta_tpu"}
FILES = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "pasta_tpu_torch", "**", "*.py"),
              recursive=True)) + ["chip_smoke.py"]


def _imported_roots(tree):
    """(line, top-level package) of every absolute import in the tree."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]


def test_the_port_has_files():
    assert len(FILES) > 30 and "pasta_tpu_torch/serving.py" in FILES


@pytest.mark.parametrize("path", FILES)
def test_file_imports_nothing_of_jax(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = [(line, root) for line, root in _imported_roots(tree)
           if root in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"
