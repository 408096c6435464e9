"""Nothing under perfbench/ imports JAX or the JAX package (top-level
names compared whole: ``repro_torch`` is not ``repro``), and the plain
reference imports nothing of the port either."""
import ast
import os
import sys

import pytest

from perfbench import files, harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(base):
    for d, _, names in os.walk(base):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


def test_no_jax_or_jax_package():
    for path in _sources(files.HERE):
        bad = set(_imports(path)) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_port():
    for path in _sources(os.path.join(files.HERE, "reference")):
        mods = set(_imports(path))
        assert not mods & (FORBIDDEN | {"repro_torch"}), path
        assert mods <= {"__future__", "contextlib", "dataclasses", "typing",
                        "numpy", "torch", "perfbench"}, (path, mods)


def _forget(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)


def test_runtime_check_compares_whole_names(monkeypatch):
    _forget(monkeypatch)
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", object())
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.models", object())
    assert harness.forbidden_modules() == ["repro"]


@pytest.mark.parametrize("name", ["jax", "flax.linen", "jaxlib"])
def test_runtime_check_flags_jax(monkeypatch, name):
    _forget(monkeypatch)
    monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == [name.split(".")[0]]
