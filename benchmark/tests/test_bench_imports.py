"""Nothing under benchmark/ imports JAX or the JAX package, and the plain
reference imports nothing of the port: each import's top-level name
(before the first dot) is compared whole, so `pasta_tpu_torch` is not
`pasta_tpu`. The tests themselves may import the port."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {"jax", "jaxlib", "flax", "pasta_tpu"}


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def top_level_imports(path):
    """Top-level module names an absolute import of the file names."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_port(path):
    assert "pasta_tpu_torch" not in top_level_imports(path)
    assert "benchmark" not in top_level_imports(path)
    # relative imports stay inside benchmark/reference/
    depth = os.path.relpath(path, os.path.join(HERE, "reference")).count(
        os.sep)
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            assert node.level <= depth + 1, (path, node.lineno)


def test_the_check_compares_whole_names():
    assert "pasta_tpu_torch".split(".")[0] not in JAX
    assert top_level_imports(__file__) == {"ast", "os", "pytest"}
