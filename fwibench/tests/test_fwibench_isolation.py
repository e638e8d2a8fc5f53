"""Nothing under fwibench/ imports JAX or the JAX package, and the plain
reference imports nothing of the program; the run's own check of
``sys.modules`` compares top-level names whole."""
import ast
import os
import sys

import pytest

from fwibench import run

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {"jax", "jaxlib", "flax", "devito_fwi_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _files(sub=""):
    for d, _, fs in os.walk(os.path.join(HERE, sub)):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_files()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_anywhere(path):
    assert not set(_imports(path)) & JAX


@pytest.mark.parametrize("path", sorted(_files("reference")),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_program(path):
    names = set(_imports(path))
    assert "devito_fwi_tpu_torch" not in names
    assert "fwibench" not in names or path.endswith("__init__.py")


def test_module_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "devito_fwi_tpu_torch_like", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert run.forbidden_modules() == ["jaxlib"]
