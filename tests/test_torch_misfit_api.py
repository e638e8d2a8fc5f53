"""The port's public misfit wrappers: ``Misfit``, ``bfm`` / ``bfmx`` and
``bfm_torch`` (``devito_fwi_tpu_torch.misfit``), against ``bfm_batch`` and
the JAX package's ``bfm_jax``, and the JAX package's BFM checks
(``tests/test_misfit.py``) on the port, all on the CPU."""
import importlib

import numpy as np
import pytest
import torch

from devito_fwi_tpu.misfit import bfm_jax
from devito_fwi_tpu.misfit import bfm as JBfm

import devito_fwi_tpu_torch.misfit as tmisfit
from devito_fwi_tpu_torch.misfit import (Misfit, bfm, bfm_torch, bfmx,
                                         least_square, qWasserstein)

# the module: the package exports the class ``bfm`` under the same name
TB = importlib.import_module("devito_fwi_tpu_torch.misfit.bfm")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this module runs: the suite runs several
    pytest workers on one machine, and torch's thread pool in each of them
    (as many threads as cores) oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _gathers(nt=160, ntr=24, seed=3):
    """Two seeded positive (nt, ntr) gathers: a shifted blob plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(nt)[:, None]
    x = np.arange(ntr)[None, :]

    def blob(t0, x0):
        return np.exp(-((t - t0) ** 2 / 60.0 + (x - x0) ** 2 / 30.0))
    f = blob(70, 10) + 0.05 + 0.01 * rng.random((nt, ntr))
    g = blob(80, 13) + 0.05 + 0.01 * rng.random((nt, ntr))
    return f.astype(np.float32), g.astype(np.float32)


def test_exports_match_the_jax_package():
    """``devito_fwi_tpu_torch.misfit`` exports the JAX package's wrappers
    (``bfm_torch`` in the place of ``bfm_jax``) beside its own names."""
    for name in ("Misfit", "bfm", "bfmx", "bfm_torch", "least_square",
                 "least_square_torch", "qWasserstein"):
        assert name in tmisfit.__all__ and hasattr(tmisfit, name), name
    assert bfmx is bfm


def test_misfit_wrapper_calls_its_operator():
    """``Misfit(op)(x, y) == op(x, y)`` for the L2 and a W2 operator."""
    f, g = _gathers()
    for op in (least_square, qWasserstein(gamma=1.01, method="1d")):
        fw, gw = Misfit(op)(f, g)
        fo, go = op(f, g)
        assert fw == fo and np.array_equal(gw, go)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bfm_torch_is_bfm_batch_of_one(dtype):
    """``bfm_torch`` on one gather equals ``bfm_batch`` on a batch of one,
    bitwise, loss and gradient, handed numpy arrays (with device "cpu") or
    tensors."""
    f, g = (a.astype(dtype) for a in _gathers())
    ft, gt = torch.as_tensor(f), torch.as_tensor(g)
    want = TB.bfm_batch(ft[None], gt[None], num_steps=6, step_scale=2.0)
    for got in (bfm_torch(f, g, num_steps=6, step_scale=2.0, device="cpu"),
                bfm_torch(ft, gt, num_steps=6, step_scale=2.0)):
        assert torch.equal(got[0], want[0][0])
        assert torch.equal(got[1], want[1][0])
        assert got[1].dtype == ft.dtype


def test_bfm_gradient_matches_bfm_jax():
    """``bfm().gradient`` (the JAX class's defaults: 10 steps, step scale
    8, nsub 2) returns a Python float and a numpy array within 1e-4 of
    ``bfm_jax`` (relative for the loss, of the max for the gradient), at
    float32 as the reference driver calls it; the JAX class agrees with
    ``bfm_jax`` the same way."""
    f, g = _gathers()
    solver = bfm(device="cpu")
    assert (solver.num_steps, solver.step_scale, solver.nsub) == (10, 8.0,
                                                                  2)
    loss, grad = solver.gradient(f, g)
    assert type(loss) is float and isinstance(grad, np.ndarray)
    assert grad.shape == f.shape and grad.dtype == np.float32
    jl, jg = bfm_jax(f, g, num_steps=10, step_scale=8.0, nsub=2)
    jl, jg = float(jl), np.asarray(jg)
    assert abs(loss - jl) <= 1e-4 * abs(jl)
    assert np.abs(grad - jg).max() <= 1e-4 * np.abs(jg).max()
    jloss, jgrad = JBfm().gradient(f, g)
    assert abs(loss - jloss) <= 1e-4 * abs(jloss)


def test_bfm_raises_on_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f, g = _gathers()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bfm()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bfm_torch(f, g)


def test_bfm_identical_near_zero():
    """``tests/test_misfit.py::test_bfm_identical_near_zero`` on the port:
    the distance of a density to itself is under 1e-4."""
    x = np.linspace(0, 1, 64)
    y = np.linspace(0, 1, 96)
    f = (np.exp(-((y[:, None] - 0.5) ** 2 + (x[None, :] - 0.5) ** 2) / 0.02)
         + 0.05).astype(np.float32)
    loss, _ = bfm_torch(f, f, num_steps=10, step_scale=1.0, device="cpu")
    assert abs(float(loss)) < 1e-4


def test_bfm_translation_cost():
    """``tests/test_misfit.py::test_bfm_translation_cost`` on the port: a
    blob translated by delta costs 0.5 delta^2 within 3% at 30 steps, within
    0.5% of the 100-step value, and a step along the gradient lowers the
    distance."""
    n = 128
    x = np.linspace(0, 1, n)
    X, Y = np.meshgrid(x, x)
    delta = 0.15
    f = np.exp(-((X - 0.35) ** 2 + (Y - 0.5) ** 2) / 0.005)
    g = np.exp(-((X - 0.35 - delta) ** 2 + (Y - 0.5) ** 2) / 0.005)
    loss, grad = bfm_torch(f, g, num_steps=30, step_scale=1.0, device="cpu")
    loss, grad = float(loss), grad.numpy()
    assert loss == pytest.approx(0.5 * delta ** 2, rel=0.03)
    loss_conv, _ = bfm_torch(f, g, num_steps=100, step_scale=1.0,
                             device="cpu")
    assert loss == pytest.approx(float(loss_conv), rel=5e-3)
    eps = 0.02 / np.abs(grad).max()
    loss2, _ = bfm_torch(f - eps * grad * f.mean(), g, num_steps=30,
                         step_scale=1.0, device="cpu")
    assert float(loss2) < loss
