"""Hand-written viscoacoustic (SLS, 2nd-order) adjoint over a saved
history, in plain torch (the "saved" route).

Port of ``visco_sls2_forward_hist``, ``visco_sls2_adjoint_from_hist`` and
``visco_sls2_value_and_grad`` of ``devito_fwi_tpu.ops.visco_grad``:

* the forward keeps, per step, ``L = lsa(p)`` and the updated memory
  variable ``rn``, the two fields the imaging condition needs;
* the reverse sweep propagates the adjoint (p, p_prev, r) recursion
  (``lsa`` is self-adjoint, so the transpose reuses it) and accumulates
  the gradients of the four pointwise coefficient fields

      a1 = s (tt/t_s) rho     a2 = s / t_s
      a3 = s^2 bm (1 + tt)    a4 = s^2 vp^2

  plus the source scale's vp^2 (2nd-order sources inject ``w dt^2 vp^2``);
* the (vp, qp) gradient is the vector-Jacobian product of that pointwise
  coefficient map, taken with ``torch.autograd.grad``.

``visco_born`` is the Born modeling of any of the six kernels, by
forward-mode AD through ``viscoacoustic.forward`` (the JAX ``jax.jvp``).
"""
from __future__ import annotations

import torch

from .acoustic import _point_table
from .staggered_grad import jvp
from .viscoacoustic import _common, _forward_step, forward

__all__ = ["visco_sls2_forward_hist", "visco_sls2_adjoint_from_hist",
           "visco_sls2_value_and_grad", "visco_born", "coefficient_map",
           "coefficient_vjp"]


def visco_sls2_forward_hist(vp, b, qp, damp, src_wav, src_idx, src_w,
                            rec_idx, rec_w, dt, f0, *, nt, spacing,
                            space_order=4, avg=True, hist_dtype=None):
    """sls/2 forward sweep emitting the imaging-condition history; the
    receivers are those of ``viscoacoustic.forward``. Returns (rec (nt,
    nrec), illum = sum_t p[t+1]^2, (L_hist, rn_hist)), each history (nt-2,
    *grid) in ``hist_dtype`` (default the compute type)."""
    hist_dtype = hist_dtype or vp.dtype
    step, carry, t0, _ = _forward_step(
        vp, b, qp, damp, src_idx, src_w, rec_idx, rec_w, dt, f0, "sls", 2,
        spacing, space_order, avg, collect_hist=True)
    rec = vp.new_zeros((nt, rec_idx.shape[0]))
    illum = torch.zeros_like(vp)
    hist = [vp.new_empty((nt - 1 - t0,) + tuple(vp.shape), dtype=hist_dtype)
            for _ in range(2)]
    for t in range(t0, nt - 1):
        carry, (rec[t], h) = step(carry, src_wav[t])
        illum = illum + carry[0] * carry[0]
        for buf, x in zip(hist, h):
            buf[t - t0] = x
    return rec, illum, tuple(hist)


def coefficient_map(vp, qp, b, dt, f0):
    """The sls/2 coefficient fields ``(a1, a2, a3, a4, vp^2)`` = ``(s
    (tt/t_s) rho, s/t_s, s^2 bm (1+tt), s^2 vp^2, vp^2)`` of (vp, qp) at
    density ``1/b``, in the association of the JAX ``coeff_map`` and of
    the Pallas kernels' host operands; ``s`` and ``f0`` rounded to the type
    of ``vp``."""
    dtype, dev = vp.dtype, vp.device
    s = torch.as_tensor(dt, dtype=dtype, device=dev)
    f0 = torch.as_tensor(f0, dtype=dtype, device=dev)
    t_s = (torch.sqrt(1. + 1. / qp ** 2) - 1. / qp) / f0
    t_ep = 1. / (f0 ** 2 * t_s)
    tt = t_ep / t_s - 1.
    rho = 1.0 / b
    bm = rho * vp * vp
    return (s * (tt / t_s) * rho, s / t_s, s * s * bm * (1. + tt),
            s * s * vp * vp, vp * vp)


def coefficient_vjp(vp, qp, b, dt, f0, cotangents):
    """(g_vp, g_qp): the vector-Jacobian product of ``coefficient_map`` at
    (vp, qp) with ``cotangents`` = (ga1, ga2, ga3, ga4, g_vp2), taken with
    ``torch.autograd.grad``. The cotangents may carry a leading shot axis
    that (vp, qp) lack: the product is then one per shot."""
    shape = torch.broadcast_shapes(vp.shape, cotangents[0].shape)
    with torch.enable_grad():
        vp_ = vp.detach().expand(shape).clone().requires_grad_(True)
        qp_ = qp.detach().expand(shape).clone().requires_grad_(True)
        outs = coefficient_map(vp_, qp_, b, dt, f0)
        g_vp, g_qp = torch.autograd.grad(outs, (vp_, qp_), cotangents)
    return g_vp, g_qp


def visco_sls2_adjoint_from_hist(vp, b, qp, damp, src_wav, src_idx,
                                 src_w, rec_idx, rec_w, res, hist, dt,
                                 f0, *, nt, spacing, space_order=4,
                                 avg=True):
    """Adjoint sls/2 sweep over the saved (L, rn) history; ``res`` is the
    (nt, nrec) residual (the cotangent of the receiver gather). Returns
    the padded-grid (g_vp, g_qp) of ``sum_t <res[t], rec[t]>``."""
    dtype = vp.dtype
    c = _common(vp, b, qp, damp, f0, dt, spacing, space_order, avg)
    s, lsa = c["s"], c["lsa"]
    shape = tuple(vp.shape)
    s_coords, s_wt = _point_table(src_idx, src_w, shape, vp.device, dtype)
    r_coords, r_wt = _point_table(rec_idx, rec_w, shape, vp.device, dtype)
    # the step builder's coefficient fields, in its associations
    a1, a2, a3, a4, _ = coefficient_map(vp, qp, b, dt, f0)
    z = torch.zeros_like(vp)
    t0 = 1
    L_hist, rn_hist = hist
    lp = lpp = lr = pend_R = z
    ga1 = ga2 = ga3 = ga4 = z
    gsrc = s_wt.new_zeros(s_wt.shape)
    # the 2nd-order source scale is src_w * s^2 * vp^2 at the corners: the
    # s^2 folds into the wavelet, so the sweep multiplies by src_w and the
    # sampled adjoint
    src_steps = src_wav * (s * s)
    for t in range(nt - 2, t0 - 1, -1):
        L = L_hist[t - t0].to(dtype)
        rn = rn_hist[t - t0].to(dtype)
        P = damp * lp
        R = damp * (lr - a4 * P)
        # imaging condition (coefficients of this step's update)
        ga3 = ga3 + L * P
        ga4 = ga4 - rn * P
        ga1 = ga1 + L * R
        # ga2 pairs with r^t = rn^{t-1}: the pending R of the step after
        ga2 = ga2 - rn * pend_R
        # the scatter lands after the damp bracket: the raw lambda_p
        gsrc = gsrc + src_steps[t][:, None] * s_wt * lp[s_coords]
        lp_new = 2.0 * P + lsa(a3 * P) + lsa(a1 * R) + lpp
        lp_new = lp_new.index_put(r_coords, res[t][:, None] * r_wt,
                                  accumulate=True)
        lpp = -damp * P
        lr = R - a2 * R
        lp = lp_new
        pend_R = R
    # the last pending term pairs with r^{t0} = 0 and drops
    g_vp2_src = torch.zeros_like(vp).index_put(s_coords, gsrc,
                                               accumulate=True)
    return coefficient_vjp(vp, qp, b, dt, f0, (ga1, ga2, ga3, ga4,
                                               g_vp2_src))


def visco_sls2_value_and_grad(vp, b, qp, damp, src_wav, src_idx, src_w,
                              rec_idx, rec_w, obs, dw, dt, f0, misfit, *,
                              nt, spacing, space_order=4, avg=True,
                              hist_dtype=None):
    """(fval, (g_vp, g_qp), illum, res) through the saved-history route:
    forward, misfit, one adjoint sweep. ``misfit`` is a torch misfit of one
    (nt, nrec) gather returning (value, residual), e.g.
    ``misfit.least_square_torch``."""
    rec, illum, hist = visco_sls2_forward_hist(
        vp, b, qp, damp, src_wav, src_idx, src_w, rec_idx, rec_w, dt, f0,
        nt=nt, spacing=spacing, space_order=space_order, avg=avg,
        hist_dtype=hist_dtype)
    f, res = misfit(rec - dw, obs - dw)
    g_vp, g_qp = visco_sls2_adjoint_from_hist(
        vp, b, qp, damp, src_wav, src_idx, src_w, rec_idx, rec_w,
        res.to(vp.dtype), hist, dt, f0, nt=nt, spacing=spacing,
        space_order=space_order, avg=avg)
    return f, (g_vp, g_qp), illum, res


def visco_born(vp, b, qp, dvp, dqp, damp, src_wav, src_idx, src_w,
               rec_idx, rec_w, dt, f0, *, kernel="sls", time_order=2, nt,
               spacing, space_order=4, avg=True):
    """Linearised (Born) viscoacoustic modeling for any of the six kernels:
    the exact directional derivative of ``viscoacoustic.forward`` at
    padded-grid (vp, qp) along (dvp, dqp) (None: zero), by forward-mode AD
    through the step loop (the JAX package's ``jax.jvp``). Returns (rec,
    drec), each (nt, nrec)."""
    def fwd(vp_, qp_):
        rec, _ = forward(vp_, b, qp_, damp, src_wav, src_idx, src_w,
                         rec_idx, rec_w, dt, f0, kernel=kernel,
                         time_order=time_order, nt=nt, spacing=spacing,
                         space_order=space_order, avg=avg)
        return (rec,)

    (rec,), (drec,) = jvp(fwd, (vp, qp), (dvp, dqp))
    return rec, drec
