"""The port's native C++ BFM binding (devito_fwi_tpu_torch.misfit.native) and
``qWasserstein(bfm_backend="native")``, on the CPU, on small gathers (64 x 32,
a few steps: the library spreads a batch over OpenMP threads, and the suite
runs several workers):

* the binding against the JAX package's binding of the same source,
  ``native/bfm2d.cpp``, bitwise (gradient, batch, c-transform, pushforward);
* the native solver against the port's torch BFM (``misfit.bfm``) within
  ``tests/test_native_bfm.py``'s limits: loss 1e-5, gradient 1e-4 of its
  max, pushforward 1e-3;
* ``qWasserstein`` ``__call__``, ``batch`` and ``torch_batch`` on the native
  solver against the JAX one, bitwise, with a dead gather (loss 0, gradient
  0);
* the library is built under the port's ``_build/``, never in ``native/``,
  and a compiler that fails raises with its message.
"""
import importlib

import numpy as np
import pytest
import torch

from devito_fwi_tpu.misfit import native as jnative
from devito_fwi_tpu.misfit import qWasserstein as JqW
from devito_fwi_tpu_torch.misfit import native as tnative
from devito_fwi_tpu_torch.misfit import qWasserstein as TqW
from devito_fwi_tpu_torch.ops.cuda_build import BUILD_DIR

# the module: the package exports the class ``bfm`` under the same name
tbfm = importlib.import_module("devito_fwi_tpu_torch.misfit.bfm")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this module runs: several pytest workers
    share the machine's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True, scope="module")
def _jax_binding_retried():
    """The JAX package's binding loads its library once and keeps a
    failure: in a fresh checkout every test worker runs its ``make -C
    native`` at once, and a worker that loads ``native/libbfm2d.so`` while
    another's compiler still writes it keeps None for good. Before this
    module's tests, long after the workers' imports, such a failure is
    forgotten so that the binding loads the finished library."""
    if jnative._LIB is None:
        jnative._TRIED = False
    yield


def _wavelet(dt, n, freq, delay):
    t = (np.arange(0, n) - delay) * dt
    tmp = np.pi * np.pi * freq * freq * t * t
    return ((1. - 2. * tmp) * np.exp(-tmp)).reshape(n, 1)


def _gathers(shape=(64, 32), d1=20, d2=30, nb=None):
    """Positive Ricker gathers (nt, ntraces), or ``nb`` of them with shifted
    delays."""
    if nb is not None:
        pairs = [_gathers(shape, d1 + 2 * b, d2 + 3 * b)
                 for b in range(nb)]
        return (np.stack([p[0] for p in pairs]),
                np.stack([p[1] for p in pairs]))
    f = np.tile(_wavelet(0.004, shape[0], 5, d1), (1, shape[1]))
    g = np.tile(_wavelet(0.004, shape[0], 5, d2), (1, shape[1]))
    c = -min(f.min(), g.min()) * 1.01
    return (f + c).astype(np.float32), (g + c).astype(np.float32)


def _rel(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    return np.abs(got - np.asarray(want)).max() / \
        max(np.abs(np.asarray(want)).max(), 1e-300)


def test_binding_equals_the_jax_binding():
    f, g = _gathers()
    lt, gt = tnative.bfm_gradient(f, g, num_steps=4, step_scale=1.0)
    lj, gj = jnative.bfm_gradient(f, g, num_steps=4, step_scale=1.0)
    assert lt == lj and np.array_equal(gt, gj)
    lt, gt, phases = tnative.bfm_gradient(f, g, num_steps=4,
                                          return_phases=True)
    assert lt == lj and np.array_equal(gt, gj)
    assert set(phases) == {"update", "legendre", "pushforward", "total"}
    fb, gb = _gathers(nb=3)
    lt, gt = tnative.bfm_gradient_batch(fb, gb, num_steps=3, nsub=0)
    lj, gj = jnative.bfm_gradient_batch(fb, gb, num_steps=3, nsub=0)
    assert np.array_equal(lt, lj) and np.array_equal(gt, gj)
    rng = np.random.default_rng(0)
    u = rng.standard_normal((24, 20)).astype(np.float32)
    assert np.array_equal(tnative.ctransform(u), jnative.ctransform(u))
    mu = rng.uniform(0.5, 1.5, (24, 20)).astype(np.float32)
    xs = (np.arange(20) + 0.5) / 20
    ys = (np.arange(24) + 0.5) / 24
    dual = (0.5 * (xs[None] ** 2 + ys[:, None] ** 2)
            + 1e-3 * u).astype(np.float32)
    assert np.array_equal(tnative.pushforward(mu, dual),
                          jnative.pushforward(mu, dual))
    assert tnative.bfm_native(num_steps=2).gradient(f, g)[0] == \
        jnative.bfm_native(num_steps=2).gradient(f, g)[0]


def test_native_against_the_torch_bfm():
    """The exact sequential-hull solver against the port's batch BFM, within
    the JAX package's native-vs-JAX limits."""
    fb, gb = _gathers(nb=2)
    ln, gn = tnative.bfm_gradient_batch(fb, gb, num_steps=6, step_scale=1.0)
    lt, gt = tbfm.bfm_batch(torch.tensor(fb), torch.tensor(gb), num_steps=6,
                            step_scale=1.0)
    assert np.all(np.abs(ln - lt.numpy()) < 1e-5 * np.abs(lt.numpy()))
    assert _rel(gn, gt) < 1e-4
    rng = np.random.RandomState(0)
    n2, n1 = 48, 40
    mu = rng.rand(n2, n1).astype(np.float32) + 0.5
    mu /= mu.mean()
    xs = (np.arange(n1) + 0.5) / n1
    ys = (np.arange(n2) + 0.5) / n2
    dual = (0.5 * (xs[None, :] ** 2 + ys[:, None] ** 2)).astype(np.float32)
    rho = tnative.pushforward(mu, dual)
    xm, ym = tbfm._pushforward_map(torch.tensor(dual)[None], n1, n2)
    rho_t = tbfm._sampling_pushforward_batch(torch.tensor(mu)[None], xm, ym,
                                             n1, n2, 2, 127)[0]
    assert np.abs(rho - rho_t.numpy()).max() < 1e-3


def test_qwasserstein_native_equals_jax():
    """``__call__`` on one gather, ``batch`` on three with a dead one, and
    ``torch_batch`` (the host round trip) against the JAX native route."""
    kw = dict(gamma=1.01, method="2d", num_steps=3, step_scale=1.0,
              bfm_backend="native")
    jq, tq = JqW(**kw), TqW(**kw)
    f, g = _gathers()
    f = f - 0.3          # the linear transform shifts it positive
    lj, gj = jq(f, g)
    lt, gt = tq(f, g)
    assert lt == lj and np.array_equal(gt, gj)
    fb, gb = _gathers(nb=3)
    fb[1] = gb[1] = 0.0
    lj, gj = jq.batch(fb, gb)
    lt, gt = tq.batch(fb, gb)
    assert np.array_equal(lt, lj) and np.array_equal(gt, gj)
    assert lt[1] == 0.0 and not np.any(gt[1])
    lb, gbt = tq.torch_batch(torch.tensor(fb), torch.tensor(gb))
    assert np.array_equal(lb.numpy(), lt) and np.array_equal(gbt.numpy(),
                                                             gt)


def test_library_is_built_in_the_port(monkeypatch, tmp_path):
    """The library lives under the port's ``_build/`` with a digest of the
    source, the compiler and the flags in its name; ``native/`` is not
    written; a compiler that fails raises with its message."""
    tnative.bfm_gradient(*_gathers(), num_steps=1)
    path = tnative.library_path()
    assert path.parent == BUILD_DIR and path.exists()
    assert path.name.startswith("libbfm2d-")
    assert tnative.available()
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.warns(UserWarning, match="cannot link OpenMP"):
        assert tnative.library_path() != path
    with pytest.raises(RuntimeError, match="false bfm2d.cpp exited"):
        tnative.build()
    assert not list(tmp_path.iterdir())


def test_build_without_openmp_gives_the_same_numbers(monkeypatch, tmp_path):
    """A compiler without an OpenMP runtime builds the library without
    -fopenmp (under another name): its batch gives the OpenMP build's
    numbers bitwise (the solver's OpenMP loops hold no reductions)."""
    import ctypes
    fb, gb = _gathers(nb=2)
    want = tnative.bfm_gradient_batch(fb, gb, num_steps=2)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setitem(tnative._OPENMP, tnative._cxx(), False)
    assert "-fopenmp" not in tnative._flags()
    lib = ctypes.CDLL(str(tnative.build()))
    fp = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
    I, F = ctypes.c_int, ctypes.c_float
    lib.bfm2d_gradient_batch.argtypes = [fp, fp, I, I, I, I, F, I, fp, fp]
    loss = np.empty(2, np.float32)
    grad = np.empty_like(fb)
    assert lib.bfm2d_gradient_batch(fb, gb, 2, 32, 64, 2, 1.0, 2, grad,
                                    loss) == 0
    assert np.array_equal(loss, want[0]) and np.array_equal(grad, want[1])
