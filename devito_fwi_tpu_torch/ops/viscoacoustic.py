"""Viscoacoustic propagators in plain torch: SLS, Ren and Deng-McMechan, 1st
and 2nd order.

Port of ``devito_fwi_tpu.ops.viscoacoustic`` (reference
``seismic/viscoacoustic/operators.py:45-390``), each kernel a Python loop
over the steps on the device of its inputs:

* ``sls`` 1st order: velocity v, memory variable r and pressure p;
* ``sls`` 2nd order: r and p with the self-adjoint spatial operator
  ``lsa(p) = sum_d D-_d(b D+_d p)`` (``self_adjoint.laplacian_sa``);
* ``ren`` and ``deng_mcmechan``, 1st and 2nd order.

Relaxation parameters: ``t_s = (sqrt(1+1/qp^2)-1/qp)/f0``,
``t_ep = 1/(f0^2 t_s)``, ``tt = t_ep/t_s - 1``; ``w0 = 2 pi f0``;
``rho = 1/b``; bulk modulus ``bm = rho vp^2``. Sources inject
``w_p src[t] dt`` (1st order) or ``w_p src[t] dt^2 vp^2`` (2nd order) into
p[t+1]; receivers sample p[t]. The adjoints are the time-reversed
recursions of the reference's backward kernels. Time loops: t = 0..nt-2
(1st order), t = 1..nt-2 (2nd order). Node parameters are averaged to the
staggered points (``staggered.avg_to``).

Out-of-grid interpolation corners are masked and clamped
(``acoustic._point_table``), as a torch index may not leave the grid.
``forward_seg`` runs the same steps in checkpointed segments for autograd
(the objective's "vjp" route, any kernel); the sls/2 gradient's other
routes are the hand-written adjoint of ``ops.visco_grad`` and the kernels
of ``ops.cuda_visco``.
"""
from __future__ import annotations

import numpy as np
import torch

from .acoustic import _point_table
from .remat import checkpointed_loop
from .self_adjoint import laplacian_sa
from .staggered import _as_params, _rec_rows, _wgt, avg_to, d_minus, d_plus

__all__ = ["forward", "forward_seg", "adjoint", "KERNELS"]

KERNELS = {("sls", 1), ("sls", 2), ("ren", 1), ("ren", 2),
           ("deng_mcmechan", 1), ("deng_mcmechan", 2)}


def _common(vp, b, qp, damp, f0, dt, spacing, space_order, avg):
    dtype, dev = vp.dtype, vp.device
    ndim = len(spacing)
    wgt = _wgt(space_order, dtype, dev)
    inv_h = [torch.as_tensor(1.0 / h, dtype=dtype, device=dev)
             for h in spacing]
    s = torch.as_tensor(dt, dtype=dtype, device=dev)
    f0 = torch.as_tensor(f0, dtype=dtype, device=dev)
    w0 = 2.0 * np.pi * f0
    rho = 1.0 / b
    bm = rho * vp * vp
    t_s = (torch.sqrt(1. + 1. / qp ** 2) - 1. / qp) / f0
    t_ep = 1. / (f0 ** 2 * t_s)
    tt = t_ep / t_s - 1.
    b_i = [avg_to(b, (i,), ndim) if avg else b for i in range(ndim)]
    damp_i = [avg_to(damp, (i,), ndim) if avg else damp
              for i in range(ndim)]
    wp_, op_, wm_, om_ = wgt

    def lsa(p):
        """div(b grad(p, shift=+1/2), shift=-1/2)"""
        return laplacian_sa(p, b, wp_, op_, wm_, om_, inv_h)

    def grad_p(p):
        return [d_plus(p, wgt, i, inv_h[i]) for i in range(ndim)]

    def div_v(v):
        return sum(d_minus(v[i], wgt, i, inv_h[i]) for i in range(ndim))

    return dict(ndim=ndim, wgt=wgt, inv_h=inv_h, s=s, w0=w0, rho=rho,
                bm=bm, t_s=t_s, tt=tt, b_i=b_i, damp_i=damp_i, lsa=lsa,
                grad_p=grad_p, div_v=div_v)


def _forward_step(vp, b, qp, damp, src_idx, src_w, rec_idx, rec_w, dt,
                  f0, kernel, time_order, spacing, space_order, avg,
                  save=False, collect_hist=False):
    """The per-step viscoacoustic update shared by ``forward`` and the
    history forward of ``ops.visco_grad``. Returns (step, init, t0, final)
    with ``step(carry, src_t) -> (carry', (rec_t, p_out))``, t0 the first
    source sample (0 for 1st-order kernels, 1 for 2nd-order) and ``final``
    picking p out of a carry. With ``collect_hist`` (sls/2 only) the step
    emits ``(rec_t, (L_t, rn_t))``: the spatial operator's value and the
    updated memory variable, which the adjoint's imaging condition needs.
    The tables are numpy ``interp_table`` outputs."""
    c = _common(vp, b, qp, damp, f0, dt, spacing, space_order, avg)
    s, w0, rho, bm, t_s, tt = (c["s"], c["w0"], c["rho"], c["bm"],
                               c["t_s"], c["tt"])
    lsa, grad_p, div_v = c["lsa"], c["grad_p"], c["div_v"]
    ndim = c["ndim"]
    shape = tuple(vp.shape)
    s_coords, s_wt = _point_table(src_idx, src_w, shape, vp.device, vp.dtype)
    r_coords, r_wt = _point_table(rec_idx, rec_w, shape, vp.device, vp.dtype)
    z = torch.zeros_like(vp)
    if collect_hist and (kernel, time_order) != ("sls", 2):
        raise ValueError("history collection is wired for the sls/2 kernel "
                         "only")

    def rec_of(p):
        return torch.sum(p[r_coords] * r_wt, dim=-1)

    def inject(pn, src_t, scale):
        return pn.index_put(s_coords, src_t[:, None] * scale,
                            accumulate=True)

    if time_order == 1:
        src_scale = s_wt * s  # src * dt (operators.py:28)

        def v_update(v, p):
            gp = grad_p(p)
            return tuple(c["damp_i"][i] * (v[i] - s * c["b_i"][i] * gp[i])
                         for i in range(ndim))

        if kernel == "sls":
            def step(carry, src_t):
                v, r, p = carry
                rec_t = rec_of(p)
                vn = v_update(v, p)
                dvn = div_v(vn)
                rn = damp * (r - s / t_s * r - s / t_s * tt * bm * dvn)
                pn = damp * (p - s * bm * (tt + 1.) * dvn - s * rn)
                pn = inject(pn, src_t, src_scale)
                return (vn, rn, pn), (rec_t, pn if save else None)
            init = (tuple(z for _ in range(ndim)), z, z)
        elif kernel == "ren":
            eta_rho = (vp * vp * rho) / (w0 * qp)

            def step(carry, src_t):
                v, p = carry
                rec_t = rec_of(p)
                vn = v_update(v, p)
                pn = damp * (p - s * bm * div_v(vn) + s * eta_rho * lsa(p))
                pn = inject(pn, src_t, src_scale)
                return (vn, pn), (rec_t, pn if save else None)
            init = (tuple(z for _ in range(ndim)), z)
        else:  # deng_mcmechan
            def step(carry, src_t):
                v, p = carry
                rec_t = rec_of(p)
                vn = v_update(v, p)
                pn = damp * (p - s * bm * div_v(vn) - s * (w0 / qp) * p)
                pn = inject(pn, src_t, src_scale)
                return (vn, pn), (rec_t, pn if save else None)
            init = (tuple(z for _ in range(ndim)), z)

        return step, init, 0, (lambda carry: carry[-1])

    # ---- 2nd order: p (and r for sls), t = 1..nt-2
    src_scale = s_wt * s * s * (vp * vp)[s_coords]  # dt^2/m

    if kernel == "sls":
        def step(carry, src_t):
            p, p_prev, r = carry
            rec_t = rec_of(p)
            L = lsa(p)
            rn = damp * (r + s * (tt / t_s) * rho * L - s / t_s * r)
            pn = damp * (2. * p - damp * p_prev +
                         s * s * bm * (1. + tt) * L -
                         s * s * vp * vp * rn)
            pn = inject(pn, src_t, src_scale)
            if collect_hist:
                return (pn, p, rn), (rec_t, (L, rn))
            return (pn, p, rn), (rec_t, pn if save else None)
        init = (z, z, z)
    elif kernel == "ren":
        eta_rho = (vp * vp * rho) / (w0 * qp)

        def step(carry, src_t):
            # lsa is linear: lsa(p - p_prev) = L - L_prev, and the previous
            # step computed L_prev, so one stencil sweep a step
            p, p_prev, L_prev = carry
            rec_t = rec_of(p)
            L = lsa(p)
            pn = damp * (2. * p - damp * p_prev + s * s * bm * L +
                         s * eta_rho * (L - L_prev))
            pn = inject(pn, src_t, src_scale)
            return (pn, p, L), (rec_t, pn if save else None)
        init = (z, z, z)
    else:  # deng_mcmechan
        def step(carry, src_t):
            p, p_prev = carry
            rec_t = rec_of(p)
            pn = damp * (2. * p - damp * p_prev + s * s * bm * lsa(p) -
                         s * (w0 / qp) * (p - p_prev))
            pn = inject(pn, src_t, src_scale)
            return (pn, p), (rec_t, pn if save else None)
        init = (z, z)

    return step, init, 1, (lambda carry: carry[0])


def forward(vp, b, qp, damp, src_wav, src_idx, src_w, rec_idx, rec_w, dt,
            f0, *, kernel="sls", time_order=2, nt, spacing, space_order=4,
            avg=True, save=False):
    """Viscoacoustic forward modeling on the device of ``vp``. ``vp``,
    ``b``, ``qp``, ``damp`` are padded-grid tensors; ``src_wav`` (nt,
    nsrcpt) tensor; the tables numpy. Returns (rec (nt, nrec), the p
    history (nt, *grid) if ``save`` else the final p)."""
    if (kernel, time_order) not in KERNELS:
        raise ValueError(f"kernel {(kernel, time_order)}: expected one of "
                         f"{sorted(KERNELS)}")
    step, carry, t0, final = _forward_step(
        vp, b, qp, damp, src_idx, src_w, rec_idx, rec_w, dt, f0, kernel,
        time_order, spacing, space_order, avg, save=save)
    rec = vp.new_zeros((nt, rec_idx.shape[0]))
    ps = [torch.zeros_like(vp)] * (t0 + 1) if save else None
    for t in range(t0, nt - 1):
        carry, (rec[t], p_out) = step(carry, src_wav[t])
        if save:
            ps.append(p_out)
    if save:
        return rec, torch.stack(ps)
    return rec, final(carry)


def forward_seg(vp, b, qp, damp, src_wav, src_idx, src_w, rec_idx, rec_w,
                dt, f0, *, kernel="sls", time_order=2, nt, spacing,
                space_order=4, avg=True, n_checkpoints=0):
    """Differentiable ``forward`` for any of the six kernels: the same
    steps in checkpointed segments (``remat.checkpointed_loop``;
    ``n_checkpoints`` <= 0 picks about sqrt(steps) of them), so autograd
    through it is the exact discrete adjoint and keeps only the segment
    starts and one segment's graph. Returns (rec (nt, nrec), illum =
    sum_t p[t+1]^2, accumulated detached)."""
    if (kernel, time_order) not in KERNELS:
        raise ValueError(f"kernel {(kernel, time_order)}: expected one of "
                         f"{sorted(KERNELS)}")
    def make_step(vp_, b_, qp_, damp_):
        step = _forward_step(vp_, b_, qp_, damp_, src_idx, src_w, rec_idx,
                             rec_w, dt, f0, kernel, time_order, spacing,
                             space_order, avg)[0]

        def rec_step(c, src_t):
            c, (rec_t, _) = step(c, src_t)
            return c, (rec_t,)
        return rec_step

    params = _as_params(vp, (vp, b, qp, damp))
    _, carry, t0, _ = _forward_step(
        *params, src_idx, src_w, rec_idx, rec_w, dt, f0, kernel, time_order,
        spacing, space_order, avg)
    # p's slot in the carry: last for the 1st-order kernels (v, [r,] p),
    # first for the 2nd-order ones (p, p_prev[, r or L])
    p_slot = -1 if time_order == 1 else 0
    _, (recs,), illum = checkpointed_loop(
        make_step, params, carry, src_wav[t0:nt - 1], torch.zeros_like(vp),
        n_checkpoints=n_checkpoints,
        energy=lambda c: c[p_slot] * c[p_slot])
    return _rec_rows(recs, t0, nt), illum


def adjoint(vp, b, qp, damp, rec_data, rec_idx, rec_w, src_idx, src_w, dt,
            f0, *, kernel="sls", time_order=2, nt, spacing, space_order=4,
            avg=True):
    """Viscoacoustic adjoint modeling (the reference's backward kernels):
    time-reversed recursion with receiver injection into p[t-1], sampled
    at the sources. ``rec_data`` (nt, nrec) tensor. Returns (srca (nt,
    nsrcpt), final p)."""
    if (kernel, time_order) not in KERNELS:
        raise ValueError(f"kernel {(kernel, time_order)}: expected one of "
                         f"{sorted(KERNELS)}")
    c = _common(vp, b, qp, damp, f0, dt, spacing, space_order, avg)
    s, w0, rho, bm, t_s, tt = (c["s"], c["w0"], c["rho"], c["bm"],
                               c["t_s"], c["tt"])
    lsa = c["lsa"]
    ndim = c["ndim"]
    wgt, inv_h = c["wgt"], c["inv_h"]
    shape = tuple(vp.shape)
    s_coords, s_wt = _point_table(src_idx, src_w, shape, vp.device, vp.dtype)
    r_coords, r_wt = _point_table(rec_idx, rec_w, shape, vp.device, vp.dtype)
    z = torch.zeros_like(vp)

    def grad_of(expr):
        return [d_plus(expr, wgt, i, inv_h[i]) for i in range(ndim)]

    def div_b(v):
        # div(b * v) with staggered b averaging
        return sum(d_minus(c["b_i"][i] * v[i], wgt, i, inv_h[i])
                   for i in range(ndim))

    def srca_of(p):
        return torch.sum(p[s_coords] * s_wt, dim=-1)

    def inject(pn, rec_t, scale):
        return pn.index_put(r_coords, rec_t[:, None] * scale,
                            accumulate=True)

    if time_order == 1:
        rec_scale = r_wt * s

        if kernel == "sls":
            def step(carry, rec_t):
                v, r, p = carry
                srca_t = srca_of(p)
                rn = damp * (r - s / t_s * r - s * p)
                gv = grad_of(bm * (1. + tt) * p)
                gr = grad_of((1. / t_s) * bm * tt * rn)
                vn = tuple(c["damp_i"][i] * (v[i] + s * gv[i] + s * gr[i])
                           for i in range(ndim))
                pn = damp * (p + s * div_b(vn))
                pn = inject(pn, rec_t, rec_scale)
                return (vn, rn, pn), srca_t
            carry = (tuple(z for _ in range(ndim)), z, z)
        elif kernel == "ren":
            eta = (vp * vp) / (w0 * qp)

            def step(carry, rec_t):
                v, p = carry
                srca_t = srca_of(p)
                gv = grad_of(bm * p)
                vn = tuple(c["damp_i"][i] * (v[i] + s * gv[i])
                           for i in range(ndim))
                pn = damp * (p + s * lsa(rho * eta * p) + s * div_b(vn))
                pn = inject(pn, rec_t, rec_scale)
                return (vn, pn), srca_t
            carry = (tuple(z for _ in range(ndim)), z)
        else:  # deng_mcmechan
            def step(carry, rec_t):
                v, p = carry
                srca_t = srca_of(p)
                gv = grad_of(bm * p)
                vn = tuple(c["damp_i"][i] * (v[i] + s * gv[i])
                           for i in range(ndim))
                pn = damp * (p + s * div_b(vn) - s * (w0 / qp) * p)
                pn = inject(pn, rec_t, rec_scale)
                return (vn, pn), srca_t
            carry = (tuple(z for _ in range(ndim)), z)
        t0, pick = 0, -1
    else:
        rec_scale = r_wt * s * s * (vp * vp)[r_coords]

        if kernel == "sls":
            def step(carry, rec_t):
                p, p_next, r = carry
                srca_t = srca_of(p)
                rn = damp * (r + s * (tt / t_s) * p - s / t_s * r)
                pn = damp * (2. * p - damp * p_next +
                             s * s * vp * vp * lsa((1. + tt) * rho * p) -
                             s * s * vp * vp * lsa(rho * rn))
                pn = inject(pn, rec_t, rec_scale)
                return (pn, p, rn), srca_t
            carry = (z, z, z)
        elif kernel == "ren":
            eta = (vp * vp) / (w0 * qp)

            def step(carry, rec_t):
                p, p_next = carry
                srca_t = srca_of(p)
                pn = damp * (2. * p - damp * p_next + s * s * lsa(bm * p) -
                             s * lsa((p_next - p) * rho * eta))
                pn = inject(pn, rec_t, rec_scale)
                return (pn, p), srca_t
            carry = (z, z)
        else:  # deng_mcmechan
            def step(carry, rec_t):
                p, p_next = carry
                srca_t = srca_of(p)
                pn = damp * (2. * p - damp * p_next +
                             s * (w0 / qp) * (p_next - p) +
                             s * s * lsa(bm * p))
                pn = inject(pn, rec_t, rec_scale)
                return (pn, p), srca_t
            carry = (z, z)
        t0, pick = 1, 0

    srca = vp.new_zeros((nt, src_idx.shape[0]))
    for t in range(nt - 2, t0 - 1, -1):
        carry, srca[t] = step(carry, rec_data[t])
    return srca, carry[pick]
