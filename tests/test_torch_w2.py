"""The port's quadratic-Wasserstein misfits (devito_fwi_tpu_torch.misfit.w2)
against the JAX package's, on the CPU, on seeded gathers:

* the four positivity transforms, per gather, to 1e-12 at float64;
* ``w2_1d`` per trace with a dead trace (loss 0, gradient 0), to 1e-12 at
  float64 and 5e-5 of the max at float32 (measured 1.0e-5: the quantile
  index comes from ``searchsorted`` here and from a dense count there, the
  same index, but the cumulative sums round in another order at float32);
* ``qWasserstein`` 1d and 2d, ``__call__`` on one gather and ``batch`` on
  three, to 1e-10 at float64 (the JAX 2-D route on its XLA pushforward
  tiers; the port takes the same tier, the slab kernel serving float32
  only);
* the 2-D backends: "torch" and "native" (tests/test_torch_native.py)
  are taken, the JAX package's "jax" is not.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from devito_fwi_tpu.misfit import w2 as JW
from devito_fwi_tpu_torch.misfit import w2 as TW


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this module runs: the suite runs several
    pytest workers on one machine, and torch's thread pool in each of them
    (as many threads as cores) oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _gathers(dtype, B=3, nt=60, ntr=7, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(nt)[:, None]

    def wave(t0):
        return np.exp(-((t - t0 - np.arange(ntr)[None, :]) ** 2) / 20.0)

    f = np.stack([wave(20 + 5 * b) for b in range(B)])
    g = np.stack([wave(24 + 5 * b) for b in range(B)])
    f = f + 0.05 * rng.standard_normal(f.shape)
    g = g + 0.05 * rng.standard_normal(g.shape)
    return f.astype(dtype), g.astype(dtype)


def _rel(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


@pytest.mark.parametrize("kind", ["linear", "square", "exp", "softplus"])
def test_transforms_match_jax(kind):
    f, g = _gathers(np.float64)
    want = jax.vmap(lambda a, b: JW.transform_jax(a, b, kind, 1.01))(
        jnp.asarray(f), jnp.asarray(g))
    got = TW.transform_torch(torch.tensor(f), torch.tensor(g), kind, 1.01)
    for a, b in zip(got, want):
        assert _rel(a, b) < 1e-12


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 5e-5)])
def test_w2_1d_matches_jax_with_a_dead_trace(dtype, tol):
    f, g = _gathers(dtype)
    mu, nu = np.abs(f[0]).T.copy(), np.abs(g[0]).T.copy()   # (ntr, nt)
    mu[3] = 0.0                                             # a dead trace
    lj, gj = jax.vmap(JW.w2_1d_jax)(jnp.asarray(mu), jnp.asarray(nu))
    lt, gt = TW.w2_1d_torch(torch.tensor(mu), torch.tensor(nu))
    assert float(lt[3]) == 0.0 and not torch.any(gt[3])
    assert _rel(lt, lj) < tol
    assert _rel(gt, gj) < tol


@pytest.mark.parametrize("method", ["1d", "2d"])
def test_qwasserstein_call_and_batch_match_jax(method, monkeypatch):
    monkeypatch.setenv("DEVITO_FWI_TPU_PALLAS_INTERPRET", "0")
    f, g = _gathers(np.float64)
    kw = dict(gamma=1.01, method=method, num_steps=4, step_scale=1.0)
    jq, tq = JW.qWasserstein(**kw), TW.qWasserstein(**kw)
    lj, gj = jq(f[0], g[0])
    lt, gt = tq(f[0], g[0])
    assert abs(lt - lj) <= 1e-10 * abs(lj)
    assert gt.shape == f[0].shape and _rel(gt, gj) < 1e-10
    lj, gj = jq.batch(f, g)
    lt, gt = tq.batch(f, g)
    assert _rel(lt, lj) < 1e-10 and _rel(gt, gj) < 1e-10
    fb, rb = tq.torch_batch(torch.tensor(f), torch.tensor(g))
    assert torch.equal(fb, torch.tensor(lt)) and torch.equal(rb,
                                                             torch.tensor(gt))


def test_native_bfm_raises():
    """The native backend, which raised before its binding was ported, is
    taken now; a backend the port does not have still raises."""
    q = TW.qWasserstein(method="2d", bfm_backend="native")
    assert q.bfm_backend == "native" and q._native()
    assert not TW.qWasserstein(method="1d", bfm_backend="native")._native()
    with pytest.raises(ValueError, match="'torch' or 'native'"):
        TW.qWasserstein(method="2d", bfm_backend="jax")
