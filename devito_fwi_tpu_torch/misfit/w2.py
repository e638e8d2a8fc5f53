"""L2 and quadratic-Wasserstein misfits, host and torch forms (port of
``devito_fwi_tpu.misfit.w2``).

* positivity transforms linear/square/exp/softplus with chain-rule factor
  d (reference ``misfit/misfit.py:20-45``);
* 1-D W2 per trace: normalize to probability, CDF quantile map, loss
  ``.5*sum((t-T)^2 mu)``, closed-form gradient by cumulative sums
  (``misfit/misfit.py:47-67``); the quantile index comes from
  ``torch.searchsorted`` on the monotone CDF, the same index as the JAX
  package's dense count without its (nt, nt) temporary;
* 2-D W2 through the batch back-and-forth solver of ``misfit.bfm``
  (``misfit/misfit.py:69-79``), or with ``bfm_backend="native"`` through
  the C++ solver of ``misfit.native`` on the host (the gathers make one
  round trip; the FWI objective sends this misfit to its host-misfit
  path).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["least_square", "least_square_torch", "qWasserstein",
           "transform_torch", "w2_1d_torch"]


def least_square(x, y):
    """L2 misfit (reference ``misfit/misfit.py:5-9``)."""
    residual = x - y
    fval = 0.5 * float(np.linalg.norm(np.asarray(residual).ravel()) ** 2)
    return fval, residual


def least_square_torch(x, y):
    """L2 misfit of gathers (..., nt, nrec) on any device: per-gather
    values 0.5*sum(r^2) over the last two axes, and the residual r."""
    residual = x - y
    return 0.5 * torch.sum(residual * residual, dim=(-2, -1)), residual


def transform_torch(f, g, trans_type="linear", gamma=1.0):
    """Positivity transform of gathers (B, nt, ntr) -> (mu, nu, d), d the
    chain-rule factor; the linear shift is taken per gather."""
    if trans_type == "linear":
        lo = torch.minimum(f.amin(dim=(-2, -1), keepdim=True),
                           g.amin(dim=(-2, -1), keepdim=True))
        c = torch.where(lo < 0, -lo, torch.zeros_like(lo)) * gamma
        return f + c, g + c, torch.ones_like(f)
    if trans_type == "square":
        return f * f, g * g, 2 * f
    if trans_type == "exp":
        mu = torch.exp(gamma * f)
        return mu, torch.exp(gamma * g), gamma * mu
    if trans_type == "softplus":
        mu = torch.log(torch.exp(gamma * f) + 1)
        nu = torch.log(torch.exp(gamma * g) + 1)
        # the true derivative gamma*sigmoid(gamma*f), as the JAX package
        # (documented divergence from the reference's factor)
        return mu, nu, gamma / (1.0 + torch.exp(-gamma * f))
    return f, g, torch.ones_like(f)


def _interp_mono(x, xp, fp):
    """``interp(x, xp, fp)`` along the last axis for a nondecreasing
    ``xp``; ``fp`` (n,) is shared. Same index rule as the JAX package's
    dense count: the last j with xp[j] <= x, clipped to [0, n-2]."""
    n = xp.shape[-1]
    idx = torch.searchsorted(xp, x, right=True) - 1
    idx = idx.clamp(0, n - 2)
    x0 = torch.gather(xp, -1, idx)
    x1 = torch.gather(xp, -1, idx + 1)
    f0 = fp[idx]
    f1 = fp[idx + 1]
    dx = x1 - x0
    pos = dx > 0
    w = torch.where(pos, (x - x0) / torch.where(pos, dx, torch.ones_like(dx)),
                    torch.zeros_like(dx))
    y = f0 + w * (f1 - f0)
    y = torch.where(x <= xp[..., :1], fp[0], y)
    return torch.where(x >= xp[..., -1:], fp[-1], y)


def w2_1d_torch(f, g):
    """Trace-wise quadratic Wasserstein distance of positive signals along
    the last axis (any leading shape): (losses, grads). Replica of
    ``w2_1d_jax`` with its dead-trace guard: a trace whose f or g has no
    mass gives loss 0 and gradient 0."""
    mass = f.sum(-1, keepdim=True)
    mass_g = g.sum(-1, keepdim=True)
    live = (mass > 0) & (mass_g > 0)
    one = torch.ones_like(mass)
    mu = f / torch.where(live, mass, one)
    nu = g / torch.where(live, mass_g, one)
    t = torch.linspace(0.0, 1.0, f.shape[-1], dtype=f.dtype, device=f.device)
    F = torch.cumsum(mu, -1)
    G = torch.cumsum(nu, -1)
    T = _interp_mono(F.contiguous(), G.contiguous(), t)
    d = t - T
    loss = 0.5 * torch.sum(d * d * mu, -1)
    grad = torch.cumsum(d, -1) - d.sum(-1, keepdim=True)
    grad = (grad - torch.sum(grad * mu, -1, keepdim=True)) / \
        torch.where(live, mass, one)
    return (torch.where(live[..., 0], loss, torch.zeros_like(loss)),
            torch.where(live, grad, torch.zeros_like(grad)))


class qWasserstein:
    """Quadratic-Wasserstein misfit (reference ``misfit/misfit.py:11-104``).

    ``__call__`` takes numpy (nt, ntraces) shot gathers and returns
    ``(loss, grad)``; ``batch`` a numpy (nb, nt, ntraces) stack;
    ``torch_batch`` the same on torch tensors on any device, as the FWI
    objective calls it. ``bfm_backend`` "torch" runs the 2-D method on the
    batch solver ``misfit.bfm.bfm_batch``, whose keywords ``bfm_options``
    holds (its backends: push, prep, legendre); "native" on the C++ solver
    of ``misfit.native``, on the host."""

    def __init__(self, trans_type="linear", gamma=1.0, method="1d",
                 num_steps=10, step_scale=1.0, bfm_backend="torch",
                 bfm_options=None):
        self.gamma = gamma
        assert method in ("1d", "2d")
        self.method = method
        self.trans_type = trans_type
        self.num_steps = num_steps
        self.step_scale = step_scale
        if bfm_backend not in ("torch", "native"):
            raise ValueError(f"bfm_backend {bfm_backend!r}: expected "
                             "'torch' or 'native'")
        self.bfm_backend = bfm_backend
        self.bfm_options = dict(bfm_options or {})

    def _native(self):
        return self.method == "2d" and self.bfm_backend == "native"

    def torch_batch(self, f_b, g_b):
        """Batched misfit of (B, nt, ntraces) tensors: (fvals (B,),
        gradients (B, nt, ntraces)), the gradient being the residual the
        adjoint sweep injects. The native solver takes a round trip through
        the host."""
        if self._native():
            losses, grads = self.batch(f_b.cpu().numpy(), g_b.cpu().numpy())
            return (torch.as_tensor(losses, device=f_b.device),
                    torch.as_tensor(grads, device=f_b.device))
        mus, nus, ds = transform_torch(f_b, g_b, self.trans_type, self.gamma)
        if self.method == "1d":
            losses, grads = w2_1d_torch(mus.transpose(-1, -2),
                                        nus.transpose(-1, -2))
            return losses.sum(-1), grads.transpose(-1, -2) * ds
        from .bfm import bfm_batch
        # mass of the TRANSFORMED density (reference misfit.py:73); a dead
        # gather keeps the solver's zero gradient instead of 0/0
        mass = mus.sum(dim=(1, 2)) / (mus.shape[1] * mus.shape[2])
        mass = torch.where(mass > 0, mass, torch.ones_like(mass))
        losses, grads = bfm_batch(mus, nus, num_steps=self.num_steps,
                                  step_scale=self.step_scale,
                                  **self.bfm_options)
        return losses, (grads / mass[:, None, None]) * ds

    def __call__(self, f, g):
        f = np.asarray(f)
        g = np.asarray(g)
        shape = f.shape
        ntr = 1 if f.ndim == 1 else shape[1]
        if self.method == "2d" and ntr <= 1:
            raise ValueError("Can not use 2d method for 1D input.")
        if self._native():
            from .native import bfm_gradient
            mu, nu, d = _transform_np_batch(f[None], g[None],
                                            self.trans_type, self.gamma)
            mass = float(np.sum(mu[0]) / mu[0].size)
            if mass <= 0:  # dead gather: the solver's gradient is 0
                mass = 1.0
            loss, grad = bfm_gradient(mu[0], nu[0], num_steps=self.num_steps,
                                      step_scale=self.step_scale)
            grad = (grad / mass) * d[0]
            return float(loss), grad.reshape(shape)
        fb = torch.as_tensor(f.reshape(shape[0], ntr))[None]
        gb = torch.as_tensor(g.reshape(shape[0], ntr))[None]
        loss, grad = self.torch_batch(fb, gb)
        return float(loss[0]), grad[0].numpy().reshape(shape)

    def batch(self, f_b, g_b):
        """Misfit of a numpy (nb, nt, ntraces) stack: (losses (nb,), grads
        (nb, nt, ntraces)), one batched solve (the native one spreads the
        gathers over OpenMP threads, the mpibfm2d analog)."""
        if self._native():
            from .native import bfm_gradient_batch
            f_b, g_b = np.asarray(f_b), np.asarray(g_b)
            mu, nu, d = _transform_np_batch(f_b, g_b, self.trans_type,
                                            self.gamma)
            mass = mu.reshape(mu.shape[0], -1).sum(axis=1) \
                / float(mu[0].size)
            mass = np.where(mass > 0, mass, 1.0)  # dead-gather guard
            losses, grads = bfm_gradient_batch(mu, nu,
                                               num_steps=self.num_steps,
                                               step_scale=self.step_scale)
            return losses, (grads / mass[:, None, None]) * d
        losses, grads = self.torch_batch(torch.as_tensor(np.asarray(f_b)),
                                         torch.as_tensor(np.asarray(g_b)))
        return losses.numpy(), grads.numpy()


def _transform_np_batch(f, g, trans_type, gamma):
    """Per-gather positivity transform of numpy (nb, nt, ntraces) stacks:
    the numpy twin of ``transform_torch``, as the JAX package's native
    route computes it."""
    if trans_type == "linear":
        mn = np.minimum(f.min(axis=(1, 2)), g.min(axis=(1, 2)))
        c = (np.where(mn < 0, -mn, 0.0) * gamma)[:, None, None]
        return f + c, g + c, np.ones_like(f)
    if trans_type == "square":
        return f * f, g * g, 2 * f
    if trans_type == "exp":
        mu = np.exp(gamma * f)
        return mu, np.exp(gamma * g), gamma * mu
    if trans_type == "softplus":
        mu = np.log(np.exp(gamma * f) + 1)
        nu = np.log(np.exp(gamma * g) + 1)
        # the true derivative (see transform_torch)
        return mu, nu, gamma / (1.0 + np.exp(-gamma * f))
    return f, g, np.ones_like(f)
