"""The port's package-level names: ``devito_fwi_tpu_torch`` exports every
public name of ``devito_fwi_tpu/__init__.py``, each one the port's own
class or function (defined in a module of the port, not re-exported from
the JAX package), and a plotting name imports without touching
matplotlib until it is called."""
import ast
import inspect
import os
import subprocess
import sys

import pytest

import devito_fwi_tpu
import devito_fwi_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_public_names():
    """The names ``devito_fwi_tpu/__init__.py`` imports into the package,
    read from its source."""
    path = os.path.join(REPO, "devito_fwi_tpu", "__init__.py")
    tree = ast.parse(open(path).read())
    names = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
    return sorted(names)


JAX_NAMES = _jax_public_names()


def test_the_jax_package_exports_33_names():
    assert len(JAX_NAMES) == 33
    assert all(hasattr(devito_fwi_tpu, n) for n in JAX_NAMES)


@pytest.mark.parametrize("name", JAX_NAMES)
def test_port_exports_the_name(name):
    obj = getattr(devito_fwi_tpu_torch, name)
    module = inspect.getmodule(obj)
    assert module is not None
    assert module.__name__.startswith("devito_fwi_tpu_torch."), \
        (name, module.__name__)
    assert obj is not getattr(devito_fwi_tpu, name)


def test_same_kind_of_object():
    """A class in one package is a class in the other, a function a
    function."""
    for name in JAX_NAMES:
        a, b = getattr(devito_fwi_tpu, name), getattr(devito_fwi_tpu_torch,
                                                      name)
        assert inspect.isclass(a) == inspect.isclass(b), name
        assert callable(a) == callable(b), name


def test_package_import_leaves_matplotlib_out():
    """The package exports the plotting functions, and a fresh interpreter
    that imports it has loaded neither matplotlib nor JAX."""
    code = ("import sys, devito_fwi_tpu_torch as t\n"
            "assert callable(t.plot_velocity)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('matplotlib', 'jax', 'devito_fwi_tpu')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_plotting_raises_without_matplotlib(monkeypatch):
    """A plotting call on a machine without matplotlib raises ImportError
    naming it."""
    import builtins

    from devito_fwi_tpu_torch.utils import plotting
    real = builtins.__import__

    def no_mpl(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real(name, *args, **kwargs)
    monkeypatch.setattr(builtins, "__import__", no_mpl)
    with pytest.raises(ImportError, match="matplotlib"):
        plotting.plot_image([[0.0, 1.0], [1.0, 0.0]], show=False)
