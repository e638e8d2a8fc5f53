"""Self-adjoint variable-density visco-acoustic propagators in plain torch.

Port of ``devito_fwi_tpu.ops.self_adjoint`` (the reference's
``seismic/self_adjoint/operators.py``): the half-cell-shifted first
derivatives ``staggered_weights``, ``shifted_derivative`` and
``laplacian_sa``, which the staggered-grid propagators are built from, the
w/Q absorbing field ``setup_w_over_q`` and the four operators ``forward``,
``adjoint``, ``born`` and ``jacobian_adjoint`` of the scalar equation

    b/v^2 [ P.dt2 + (w/Q) P.dt ] = div(b grad P) + s

with the JAX module's discretisation:

* time update ``u[t+1] = s^2 v^2/b (L(u[t]) + q) + (2 - s woq) u[t] +
  (s woq - 1) u[t-1]``, ``L(u) = sum_d D-_d(b D+_d(u))``, the same
  formula in both directions of the time-reversed recursion;
* sources add ``w_p src[t] s^2 v[p]^2/b[p]`` into u[t+1], receivers
  sample u[t]; loop bounds t = 1..nt-2, rec[0] = rec[nt-1] = 0;
* Born drives du with ``q = 2 b dm v^-3 (woq (u0[t]-u0[t-1])/s +
  u0.dt2[t])``; the Jacobian adjoint accumulates ``du[t]`` times the same
  factor over t = nt-2..1.

The operators take tensors on any device and of any float type and run
where their inputs lie, one Python loop a sweep; the tables are numpy
``interp_table`` outputs, gathered and scattered through
``ops.acoustic``'s ``_sampler`` and ``_injector``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.fd import fd_weights
from .acoustic import _injector, _sampler, shift

__all__ = ["staggered_weights", "shifted_derivative", "setup_w_over_q",
           "forward", "adjoint", "born", "jacobian_adjoint",
           "laplacian_sa"]


def staggered_weights(space_order):
    """FD weights for the first derivative evaluated at x0 = x + h/2 (w_plus,
    on offsets -r+1..r) and x0 = x - h/2 (w_minus, on offsets -r..r-1), with
    r = space_order//2. The two discrete operators (zero-Dirichlet beyond
    the grid) are exact negative transposes of each other."""
    r = space_order // 2
    off_p = np.arange(-r + 1, r + 1)
    off_m = np.arange(-r, r)
    w_p = fd_weights(1, off_p, 0.5)
    w_m = fd_weights(1, off_m, -0.5)
    return w_p, off_p, w_m, off_m


def shifted_derivative(u, w, offsets, axis, inv_h):
    """Apply a shifted first-derivative stencil along ``axis`` with
    zero-Dirichlet values beyond the array (devito halo semantics):
    ``(w[0]*u[i+o0] + w[1]*u[i+o1] + ...) * inv_h``, every weight included,
    in offset order."""
    out = w[0] * shift(u, int(offsets[0]), axis)
    for k in range(1, len(w)):
        out = out + w[k] * shift(u, int(offsets[k]), axis)
    return out * inv_h


def laplacian_sa(u, b, wp, op, wm, om, inv_h):
    """The self-adjoint spatial operator ``sum_d D-_d(b * D+_d(u))`` over the
    trailing ``len(inv_h)`` axes, the x term first; ``b`` multiplies each
    axis's inner derivative before the outer one."""
    ndim_sp = len(inv_h)
    offset = u.dim() - ndim_sp
    out = 0.0
    for d in range(ndim_sp):
        axis = offset + d
        g = shifted_derivative(u, wp, op, axis, inv_h[d])
        out = out + shifted_derivative(b * g, wm, om, axis, inv_h[d])
    return out


# ---------------------------------------------------------------------------
# w/Q absorbing boundary field
# ---------------------------------------------------------------------------

def setup_w_over_q(shape_pad, w, qmin, qmax, npad, sigma=0, dtype=np.float32):
    """Numpy build of the w/Q attenuation field on the padded grid
    (reference ``seismic/self_adjoint/utils.py:8-63``), in float64 then
    cast: the normalized distance to the closest boundary (1 in the
    interior), then ``w / exp(log qmin + pos (log qmax - log qmin))``,
    smoothed by ``scipy.ndimage.gaussian_filter`` when ``sigma``."""
    assert w > 0 and qmin > 0 and qmax > 0 and npad > 0
    for n in shape_pad:
        if n - 2 * npad < 1:
            raise ValueError("2 * npad must not exceed dimension size!")
    val = np.ones(shape_pad, dtype=np.float64)
    for axis, n in enumerate(shape_pad):
        idx = np.arange(n, dtype=np.float64)
        pos = np.minimum(idx, n - 1 - idx) / npad
        pos = np.minimum(pos, 1.0)
        shape = [1] * len(shape_pad)
        shape[axis] = n
        val = np.minimum(val, pos.reshape(shape))
    lqmin, lqmax = np.log(qmin), np.log(qmax)
    woq = w / np.exp(lqmin + val * (lqmax - lqmin))
    if sigma:
        from scipy.ndimage import gaussian_filter
        woq = gaussian_filter(woq, sigma=sigma)
    return woq.astype(dtype)


# ---------------------------------------------------------------------------
# propagators
# ---------------------------------------------------------------------------

def _prep(vp, b, woq, dt, spacing, space_order):
    """(lap, v2b, swoq, s, s2): the operator ``lap(u) = L(u)`` and the
    constants of the update, in the type and on the device of ``vp``."""
    dtype, dev = vp.dtype, vp.device
    w_p, off_p, w_m, off_m = staggered_weights(space_order)
    w_p = torch.as_tensor(w_p, dtype=dtype, device=dev)
    w_m = torch.as_tensor(w_m, dtype=dtype, device=dev)
    inv_h = [torch.as_tensor(1.0 / h, dtype=dtype, device=dev)
             for h in spacing]
    s = torch.as_tensor(dt, dtype=dtype, device=dev)
    s2 = s * s
    vp2_over_b = vp * vp / b
    swoq = s * woq

    def lap(u):
        return laplacian_sa(u, b, w_p, off_p, w_m, off_m, inv_h)
    return lap, vp2_over_b, swoq, s, s2


def _update(u, u_prev, L, q, vp2_over_b, swoq, s2):
    """The reference time update (``operators.py:48-66``); the same formula
    serves both directions of the time-reversed recursion."""
    return s2 * vp2_over_b * (L + q) + (2.0 - swoq) * u + (swoq - 1.0) * u_prev


def forward(vp, b, woq, src_wav, src_idx, src_w, rec_idx, rec_w, dt, *,
            nt, spacing, space_order=8, save=False):
    """Forward modeling (reference ``IsoFwdOperator``, operators.py:68-114)
    on the device of ``vp``: ``vp``, ``b``, ``woq`` padded-grid tensors,
    ``src_wav`` (nt, nsrcpt). Returns (rec (nt, nrec), the history (nt,
    *grid) with u[0] = u[1] = 0 if ``save`` else the final two slices)."""
    lap, v2b, swoq, s, s2 = _prep(vp, b, woq, dt, spacing, space_order)
    shape = tuple(vp.shape)
    inject = _injector(src_idx, src_w, None, s2, shape, mul=v2b)
    sample = _sampler(rec_idx, rec_w, shape, vp.device, vp.dtype)
    u = u_prev = torch.zeros_like(vp)
    rec = vp.new_zeros((nt, rec_idx.shape[0]))
    us = vp.new_zeros((nt,) + shape) if save else None
    for t in range(1, nt - 1):
        rec[t] = sample(u)
        unext = inject(_update(u, u_prev, lap(u), 0.0, v2b, swoq, s2),
                       src_wav[t])
        u_prev, u = u, unext
        if save:
            us[t + 1] = u
    if save:
        return rec, us
    return rec, torch.stack([u, u_prev])


def adjoint(vp, b, woq, rec_data, rec_idx, rec_w, src_idx, src_w, dt, *,
            nt, spacing, space_order=8):
    """Adjoint modeling (reference ``IsoAdjOperator``, operators.py:117-160):
    the time-reversed recursion with receiver injection into v[t-1],
    sampled at the source points. Returns (srca (nt, nsrcpt), v final
    slices)."""
    lap, v2b, swoq, s, s2 = _prep(vp, b, woq, dt, spacing, space_order)
    shape = tuple(vp.shape)
    inject = _injector(rec_idx, rec_w, None, s2, shape, mul=v2b)
    sample = _sampler(src_idx, src_w, shape, vp.device, vp.dtype)
    v = v_next = torch.zeros_like(vp)
    srca = vp.new_zeros((nt, src_idx.shape[0]))
    for t in range(nt - 2, 0, -1):
        srca[t] = sample(v)
        vprev = inject(_update(v, v_next, lap(v), 0.0, v2b, swoq, s2),
                       rec_data[t])
        v, v_next = vprev, v
    return srca, torch.stack([v, v_next])


def born(vp, b, woq, dm, src_wav, src_idx, src_w, rec_idx, rec_w, dt, *,
         nt, spacing, space_order=8, save=False):
    """Linearized Jacobian-forward modeling (reference
    ``IsoJacobianFwdOperator``, operators.py:163-221): twin fields (u0, du),
    du driven by ``q = 2 b dm v^-3 (woq u0.dtbw + u0.dt2)``, where u0.dt2 at
    t uses the u0[t+1] of the same step. Returns (rec from du, the u0
    history if ``save`` else its final slices)."""
    lap, v2b, swoq, s, s2 = _prep(vp, b, woq, dt, spacing, space_order)
    shape = tuple(vp.shape)
    inject = _injector(src_idx, src_w, None, s2, shape, mul=v2b)
    sample = _sampler(rec_idx, rec_w, shape, vp.device, vp.dtype)
    coeff = 2.0 * b * dm / (vp * vp * vp)
    z = torch.zeros_like(vp)
    u0, u0_prev, du, du_prev = z, z, z, z
    rec = vp.new_zeros((nt, rec_idx.shape[0]))
    u0s = vp.new_zeros((nt,) + shape) if save else None
    for t in range(1, nt - 1):
        rec[t] = sample(du)
        u0next = inject(_update(u0, u0_prev, lap(u0), 0.0, v2b, swoq, s2),
                        src_wav[t])
        dtbw = (u0 - u0_prev) / s
        dt2 = (u0next - 2.0 * u0 + u0_prev) / s2
        q = coeff * (woq * dtbw + dt2)
        dunext = _update(du, du_prev, lap(du), q, v2b, swoq, s2)
        u0_prev, u0, du_prev, du = u0, u0next, du, dunext
        if save:
            u0s[t + 1] = u0
    if save:
        return rec, u0s
    return rec, torch.stack([u0, u0_prev])


def jacobian_adjoint(vp, b, woq, u0_save, rec_res, rec_idx, rec_w, dt, *,
                     nt, spacing, space_order=8):
    """Gradient with respect to velocity (reference
    ``IsoJacobianAdjOperator``, operators.py:226-280): du stepped backward
    with receiver injection, accumulating ``dm += du[t] * 2 b v^-3 (woq
    u0.dtbw + u0.dt2)[t]`` over t = nt-2..1; ``u0_save`` is the background
    history (nt, *grid). Returns (dm, (du final, zeros))."""
    lap, v2b, swoq, s, s2 = _prep(vp, b, woq, dt, spacing, space_order)
    shape = tuple(vp.shape)
    inject = _injector(rec_idx, rec_w, None, s2, shape, mul=v2b)
    coeff = 2.0 * b / (vp * vp * vp)
    z = torch.zeros_like(vp)
    du, du_next, dm = z, z, torch.zeros_like(vp)
    for t in range(nt - 2, 0, -1):
        u0_m, u0_0, u0_p = u0_save[t - 1], u0_save[t], u0_save[t + 1]
        dtbw = (u0_0 - u0_m) / s
        dt2 = (u0_p - 2.0 * u0_0 + u0_m) / s2
        dm = dm + du * coeff * (woq * dtbw + dt2)
        duprev = inject(_update(du, du_next, lap(du), 0.0, v2b, swoq, s2),
                        rec_res[t])
        du, du_next = duprev, du
    return dm, torch.stack([du, z])
