"""Hand-written elastic adjoint over a saved history, in plain torch (the
"saved" route).

Port of the elastic part of ``devito_fwi_tpu.ops.staggered_grad``:

* ``elastic_forward_hist`` runs the forward of ``staggered._elastic_step``
  and keeps, per step, what the imaging condition needs: ``vn_i`` (the
  t+1 velocities) and ``dtau_i`` (the stress divergences multiplying b);
* ``elastic_adjoint_from_hist`` propagates the adjoint velocity-stress
  fields backward with the exact transposes of the staggered derivatives
  (``D+^T = -D-``, ``D-^T = -D+`` under the zero halo), injects the
  residual at the receivers and accumulates the (lam, mu, b) gradients;
  the parameter averages transpose once at the end (``avg_to_T``).

The SLS viscoelastic twin of that pair: ``viscoelastic_forward_hist``
keeps (vn_i, dtau_i, rdn_i, ron_ij) a step, and
``viscoelastic_adjoint_from_hist`` sweeps back over them with the node
coefficient fields ``A1 = s/t_s``, ``B2 = A1 mu (t_es/t_s - 1)``, ``B3 = A1
lam (t_ep/t_s - 1)``, ``Kp = lam t_ep/t_s``, ``Ks = mu t_es/t_s`` and the
averaged off-diagonal triple; the chain rule to (vp, vs, rho, qp, qs) is
``torch.autograd.grad`` of the pointwise coefficient maps (the JAX module's
``jax.vjp``). ``viscoelastic_value_and_grad`` runs forward, misfit and
adjoint. ``elastic_born`` is the Born modeling of the elastic forward, by
forward-mode AD through its step loop (``jvp``, the JAX ``jax.jvp``).
"""
from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD
from torch.overrides import TorchFunctionMode

from .acoustic import _injector, _point_table
from .staggered import (_elastic_step, _pairs, _relax, _viscoelastic_step,
                        _wgt, avg_to, d_minus, d_plus, elastic_forward)

__all__ = ["elastic_forward_hist", "elastic_adjoint_from_hist", "avg_to_T",
           "pad_fold", "elastic_born", "jvp", "viscoelastic_forward_hist",
           "viscoelastic_adjoint_from_hist", "viscoelastic_value_and_grad"]


def avg_to_T(q, dims, ndim):
    """Exact transpose of ``staggered.avg_to`` (per dim ``out[k] =
    0.5 (p[k] + p[k+1])`` with zero beyond the grid): ``p_bar[k] =
    0.5 (q[k] + q[k-1])``. The per-dim folds commute."""
    if not torch.is_tensor(q) or q.dim() == 0:
        return q
    for d in dims:
        axis = q.dim() - ndim + d
        n = q.shape[axis]
        prev = torch.cat([q.new_zeros(q.shape[:axis] + (1,)
                                      + q.shape[axis + 1:]),
                          q.narrow(axis, 0, n - 1)], axis)
        q = 0.5 * (q + prev)
    return q


def pad_fold(g, pads):
    """Transpose of an edge-replicating pad (``np.pad(x, pads,
    mode='edge')``) over the trailing ``len(pads)`` axes: each halo
    margin's sum folds onto the edge cell it replicated, returning the
    physical-domain gradient."""
    off = g.dim() - len(pads)
    for k, (lo, hi) in enumerate(pads):
        ax = off + k
        n = g.shape[ax] - lo - hi
        core = g.narrow(ax, lo, n).clone()
        if lo:
            core.narrow(ax, 0, 1).add_(
                g.narrow(ax, 0, lo).sum(dim=ax, keepdim=True))
        if hi:
            core.narrow(ax, n - 1, 1).add_(
                g.narrow(ax, lo + n, hi).sum(dim=ax, keepdim=True))
        g = core
    return g


def elastic_forward_hist(lam, mu, b, damp, src_wav, src_idx, src_w,
                         rec_idx, rec_w, dt, *, nt, spacing,
                         space_order=4, avg=True, hist_dtype=None):
    """Elastic forward that also returns the imaging-condition history.
    The field updates and receivers are those of
    ``staggered.elastic_forward``. Returns ``(rec1, illum, hist)``:
    ``rec1`` the (nt, nrec) tau_zz gather, ``illum = sum_t |v[t+1]|^2``,
    ``hist`` a tuple of 2*ndim tensors, each (nt-1, *grid) in
    ``hist_dtype`` (default the compute type): ``vn_0..vn_{d-1},
    dtau_0..dtau_{d-1}`` per step."""
    hist_dtype = hist_dtype or lam.dtype
    step, carry = _elastic_step(lam, mu, b, damp, src_idx, src_w, rec_idx,
                                rec_w, dt, spacing, space_order, avg,
                                collect_hist=True)
    nrec = rec_idx.shape[0]
    rec1 = lam.new_zeros((nt, nrec))
    illum = torch.zeros_like(lam)
    hist = [lam.new_empty((nt - 1,) + tuple(lam.shape), dtype=hist_dtype)
            for _ in range(2 * len(spacing))]
    for t in range(nt - 1):
        carry, (rec1[t], h) = step(carry, src_wav[t])
        illum = illum + sum(x * x for x in carry[0])
        for buf, x in zip(hist, h):
            buf[t] = x
    return rec1, illum, tuple(hist)


def elastic_adjoint_from_hist(lam, mu, b, damp, rec_idx, rec_w, res,
                              hist, dt, *, nt, spacing, space_order=4,
                              avg=True):
    """Adjoint velocity-stress sweep over the saved history.

    ``res`` is the (nt, nrec) residual, the cotangent of the rec1 gather
    (row nt-1 is unused: rec1[nt-1] is the constant zero row). Returns the
    padded-grid gradients ``(g_lam, g_mu, g_b)`` of ``sum_t <res[t],
    rec1[t]>``."""
    dtype, dev = lam.dtype, lam.device
    ndim = len(spacing)
    wgt = _wgt(space_order, dtype, dev)
    inv_h = [torch.as_tensor(1.0 / h, dtype=dtype, device=dev)
             for h in spacing]
    s = torch.as_tensor(dt, dtype=dtype, device=dev)
    pairs = _pairs(ndim)
    r_coords, r_wt = _point_table(rec_idx, rec_w, tuple(lam.shape), dev,
                                  dtype)

    def mavg(p, dims):
        return avg_to(p, dims, ndim) if avg else p

    b_i = [mavg(b, (i,)) for i in range(ndim)]
    damp_i = [mavg(damp, (i,)) for i in range(ndim)]
    mu_ij = {ij: mavg(mu, ij) for ij in pairs}
    damp_ij = {ij: mavg(damp, ij) for ij in pairs}

    z = torch.zeros_like(lam)
    vb = [z] * ndim
    tdb = [z] * ndim
    tob = {ij: z for ij in pairs}
    glam, gmun = z, z
    gmup = {ij: z for ij in pairs}
    gbi = [z] * ndim
    for t in range(nt - 2, -1, -1):
        vn = [hist[i][t].to(dtype) for i in range(ndim)]
        dtau = [hist[ndim + i][t].to(dtype) for i in range(ndim)]
        # recompute the velocity derivatives the tau update consumed
        dv = [d_minus(vn[i], wgt, i, inv_h[i]) for i in range(ndim)]
        div_vn = sum(dv)
        gsh = {ij: d_plus(vn[ij[0]], wgt, ij[1], inv_h[ij[1]]) +
               d_plus(vn[ij[1]], wgt, ij[0], inv_h[ij[0]])
               for ij in pairs}

        # tau branch: tdn_i = damp (td_i + s lam div + 2 s mu dv_i) + src,
        # ton_ij = damp_ij (to_ij + s mu_ij g_ij)
        thd = [damp * tdb[i] for i in range(ndim)]
        tho = {ij: damp_ij[ij] * tob[ij] for ij in pairs}
        sthd = sum(thd)

        # imaging condition (parameters of the tau update)
        glam = glam + s * div_vn * sthd
        gmun = gmun + 2.0 * s * sum(dv[i] * thd[i] for i in range(ndim))
        gmup = {ij: gmup[ij] + s * gsh[ij] * tho[ij] for ij in pairs}

        # cotangents into vn through dv/div and g_ij
        dvb = [s * lam * sthd + 2.0 * s * mu * thd[i] for i in range(ndim)]
        gb_ = {ij: s * mu_ij[ij] * tho[ij] for ij in pairs}
        vbt = []
        for i in range(ndim):
            acc = vb[i] - d_plus(dvb[i], wgt, i, inv_h[i])
            for (a, c) in pairs:
                if a == i:
                    acc = acc - d_minus(gb_[(a, c)], wgt, c, inv_h[c])
                elif c == i:
                    acc = acc - d_minus(gb_[(a, c)], wgt, a, inv_h[a])
            vbt.append(acc)
        vhat = [damp_i[i] * vbt[i] for i in range(ndim)]

        # imaging condition (b of the v update) + v/tau carry transposes
        gbi = [gbi[i] + s * dtau[i] * vhat[i] for i in range(ndim)]
        dtb = [s * b_i[i] * vhat[i] for i in range(ndim)]
        td_new = [thd[i] - d_minus(dtb[i], wgt, i, inv_h[i])
                  for i in range(ndim)]
        tob = {ij: tho[ij] - d_plus(dtb[ij[0]], wgt, ij[1], inv_h[ij[1]])
               - d_plus(dtb[ij[1]], wgt, ij[0], inv_h[ij[0]])
               for ij in pairs}
        # the residual lands in tau_zz (rec1 samples the carry at step t)
        td_new[-1] = td_new[-1].index_put(r_coords, res[t][:, None] * r_wt,
                                          accumulate=True)
        vb, tdb = vhat, td_new

    g_mu = gmun
    g_b = torch.zeros_like(lam)
    for ij in pairs:
        g_mu = g_mu + (avg_to_T(gmup[ij], ij, ndim) if avg else gmup[ij])
    for i in range(ndim):
        g_b = g_b + (avg_to_T(gbi[i], (i,), ndim) if avg else gbi[i])
    return glam, g_mu, g_b


_ARITH = frozenset({"add", "sub", "mul", "div", "true_divide", "__radd__",
                    "__rsub__", "__rmul__", "__rtruediv__"})


def _has_tangent(x):
    return torch.is_tensor(x) and fwAD.unpack_dual(x).tangent is not None


class _ZeroTangents(TorchFunctionMode):
    """Gives the operand without a tangent of a binary arithmetic op a zero
    one when the other operand has one. Forward AD otherwise stands for
    the missing tangent with a ZeroTensor, whose arithmetic runs Python
    reference code (about 0.2 ms an op against a few us): the step loop
    of ``jvp`` ran 4-5 times slower than with explicit zeros. A zero
    tangent adds exact zeros, so the tangents are bitwise the same."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", None) in _ARITH and len(args) == 2:
            a, b = args
            if _has_tangent(a) != _has_tangent(b):
                d, o = (a, b) if _has_tangent(a) else (b, a)
                if not torch.is_tensor(o):
                    o = torch.full((), o, dtype=d.dtype, device=d.device)
                if o.is_floating_point():
                    o = fwAD.make_dual(o, torch.zeros_like(o))
                    args = (d, o) if _has_tangent(a) else (o, d)
        return func(*args, **(kwargs or {}))


def jvp(fn, primals, tangents):
    """(fn(*primals), its directional derivative along ``tangents``) by
    forward-mode AD (``torch.autograd.forward_ad``, as ``jax.jvp``); a
    None tangent is zero. ``fn`` returns a tuple of tensors; the primal
    outputs round as ``fn`` alone does."""
    with torch.no_grad(), fwAD.dual_level(), _ZeroTangents():
        duals = [fwAD.make_dual(p, torch.zeros_like(p) if t is None else t)
                 for p, t in zip(primals, tangents)]
        out = [fwAD.unpack_dual(o) for o in fn(*duals)]
    return (tuple(o.primal for o in out),
            tuple(torch.zeros_like(o.primal) if o.tangent is None
                  else o.tangent for o in out))


def elastic_born(vp, vs, rho, dvp, dvs, drho, damp, src_wav, src_idx,
                 src_w, rec_idx, rec_w, dt, *, nt, spacing, space_order=4,
                 avg=True):
    """Linearised (Born) elastic modeling: the exact directional
    derivative of ``staggered.elastic_forward`` at padded-grid (vp, vs,
    rho) along (dvp, dvs, drho) (None: zero), by forward-mode AD through
    the step loop (the JAX package's ``jax.jvp``). Returns ((rec1, rec2),
    (drec1, drec2))."""
    def fwd(vp_, vs_, rho_):
        lam = rho_ * (vp_ * vp_ - 2.0 * vs_ * vs_)
        mu = rho_ * vs_ * vs_
        return elastic_forward(lam, mu, 1.0 / rho_, damp, src_wav, src_idx,
                               src_w, rec_idx, rec_w, dt, nt=nt,
                               spacing=spacing, space_order=space_order,
                               avg=avg)

    return jvp(fwd, (vp, vs, rho), (dvp, dvs, drho))


# ---------------------------------------------------------------------------
# viscoelastic (SLS) saved-history adjoint
# ---------------------------------------------------------------------------

def viscoelastic_forward_hist(lam, mu, b, qp, qs, damp, f0, src_wav,
                              src_idx, src_w, rec_idx, rec_w, dt, *, nt,
                              spacing, space_order=4, avg=True,
                              hist_dtype=None):
    """SLS viscoelastic forward that also returns the imaging-condition
    history: (vn_i, dtau_i, rdn_i, ron_ij) per step, 7 fields in 2-D, each
    (nt-1, *grid) in ``hist_dtype`` (default the compute type). The field
    updates and receivers are those of ``staggered.viscoelastic_forward``.
    Returns (rec1, illum, hist)."""
    hist_dtype = hist_dtype or lam.dtype
    step, carry = _viscoelastic_step(lam, mu, b, qp, qs, damp, f0, src_idx,
                                     src_w, rec_idx, rec_w, dt, spacing,
                                     space_order, avg, collect_hist=True)
    ndim = len(spacing)
    nfields = 3 * ndim + len(_pairs(ndim))
    rec1 = lam.new_zeros((nt, rec_idx.shape[0]))
    illum = torch.zeros_like(lam)
    hist = [lam.new_empty((nt - 1,) + tuple(lam.shape), dtype=hist_dtype)
            for _ in range(nfields)]
    for t in range(nt - 1):
        carry, (rec1[t], h) = step(carry, src_wav[t])
        illum = illum + sum(x * x for x in carry[0])
        for buf, x in zip(hist, h):
            buf[t] = x
    return rec1, illum, tuple(hist)


def _vjp(fn, inputs, cotangents):
    """The vector-Jacobian product of the pointwise map ``fn`` at
    ``inputs`` with ``cotangents`` (one per output of ``fn``), through
    ``torch.autograd.grad``."""
    with torch.enable_grad():
        xs = [x.detach().clone().requires_grad_(True) for x in inputs]
        return torch.autograd.grad(fn(*xs), xs, cotangents)


def viscoelastic_adjoint_from_hist(vp, vs, rho, qp, qs, damp, f0,
                                   rec_idx, rec_w, res, hist, dt, *, nt,
                                   spacing, space_order=4, avg=True):
    """Adjoint SLS viscoelastic sweep over the saved history. Takes the
    physical parameterization (vp, vs, rho, qp, qs) on the padded grid and
    the (nt, nrec) residual ``res`` (the cotangent of the rec1 gather) and
    returns the five padded-grid gradients of ``sum_t <res[t],
    rec1[t]>``."""
    dtype, dev = vp.dtype, vp.device
    ndim = len(spacing)
    wgt = _wgt(space_order, dtype, dev)
    inv_h = [torch.as_tensor(1.0 / h, dtype=dtype, device=dev)
             for h in spacing]
    s = torch.as_tensor(dt, dtype=dtype, device=dev)
    f0 = torch.as_tensor(f0, dtype=dtype, device=dev)
    pairs = _pairs(ndim)

    def mavg(p, dims):
        return avg_to(p, dims, ndim) if avg else p

    def node_coeffs(vp_, vs_, rho_, qp_, qs_):
        lam_ = rho_ * (vp_ * vp_ - 2.0 * vs_ * vs_)
        mu_ = rho_ * vs_ * vs_
        t_s, t_ep, t_es = _relax(qp_, qs_, f0)
        A1 = s / t_s
        B2 = A1 * (mu_ * (t_es / t_s - 1.))
        B3 = A1 * (lam_ * (t_ep / t_s - 1.))
        Kp = lam_ * t_ep / t_s
        Ks = mu_ * t_es / t_s
        # mu/qp/qs/b ride along so that the off-diagonal (averaged) and
        # buoyancy cotangents chain through the same product
        return A1, B2, B3, Kp, Ks, mu_, qp_, qs_, 1.0 / rho_

    def off_coeffs(mu_a, qp_a, qs_a):
        ts_a, _, tes_a = _relax(qp_a, qs_a, f0)
        A1a = s / ts_a
        B2a = A1a * (mu_a * (tes_a / ts_a - 1.))
        Ksa = mu_a * tes_a / ts_a
        return A1a, B2a, Ksa

    mu = rho * vs * vs
    binv = 1.0 / rho
    A1, B2, B3, Kp, Ks, _, _, _, _ = node_coeffs(vp, vs, rho, qp, qs)
    b_i = [mavg(binv, (i,)) for i in range(ndim)]
    damp_i = [mavg(damp, (i,)) for i in range(ndim)]
    mu_a = {ij: mavg(mu, ij) for ij in pairs}
    qp_a = {ij: mavg(qp, ij) for ij in pairs}
    qs_a = {ij: mavg(qs, ij) for ij in pairs}
    damp_a = {ij: mavg(damp, ij) for ij in pairs}
    offc = {ij: off_coeffs(mu_a[ij], qp_a[ij], qs_a[ij]) for ij in pairs}
    # the residual lands unscaled in tau_zz's adjoint
    inject = _injector(rec_idx, rec_w, None, torch.ones_like(s),
                       tuple(vp.shape))

    z = torch.zeros_like(vp)
    lv = [z] * ndim
    ltd = [z] * ndim
    lto = {ij: z for ij in pairs}
    lrd = [z] * ndim
    lro = {ij: z for ij in pairs}
    gA1, gB2, gB3, gKp, gKs = z, z, z, z, z
    gbi = [z] * ndim
    goff = {ij: (z, z, z) for ij in pairs}
    pend_Rd = [z] * ndim
    pend_Ro = {ij: z for ij in pairs}
    for t in range(nt - 2, -1, -1):
        vn = [hist[i][t].to(dtype) for i in range(ndim)]
        dtau = [hist[ndim + i][t].to(dtype) for i in range(ndim)]
        rdn = [hist[2 * ndim + i][t].to(dtype) for i in range(ndim)]
        ron = {ij: hist[3 * ndim + k][t].to(dtype)
               for k, ij in enumerate(pairs)}

        dv = [d_minus(vn[i], wgt, i, inv_h[i]) for i in range(ndim)]
        div_vn = sum(dv)
        gsh = {ij: d_plus(vn[ij[0]], wgt, ij[1], inv_h[ij[1]]) +
               d_plus(vn[ij[1]], wgt, ij[0], inv_h[ij[0]])
               for ij in pairs}

        T = [damp * ltd[i] for i in range(ndim)]
        O = {ij: damp_a[ij] * lto[ij] for ij in pairs}
        Rd = [damp * (lrd[i] + s * T[i]) for i in range(ndim)]
        Ro = {ij: damp_a[ij] * (lro[ij] + s * O[ij]) for ij in pairs}
        sT = sum(T)
        sRd = sum(Rd)

        # imaging: node coefficients of the tau and memory updates
        gKp = gKp + s * div_vn * sT
        gKs = gKs + 2.0 * s * sum(dv[i] * T[i] for i in range(ndim))
        gB2 = gB2 - 2.0 * sum(dv[i] * Rd[i] for i in range(ndim))
        gB3 = gB3 - div_vn * sRd
        # gA1's rd multiplicand is rdn^{t-1}: deferred one iteration
        gA1 = gA1 - sum(rdn[i] * pend_Rd[i] for i in range(ndim))
        goff_new = {}
        for ij in pairs:
            gKsa, gA1a, gB2a = goff[ij]
            gKsa = gKsa + s * gsh[ij] * O[ij]
            gB2a = gB2a - gsh[ij] * Ro[ij]
            gA1a = gA1a - ron[ij] * pend_Ro[ij]
            goff_new[ij] = (gKsa, gA1a, gB2a)
        goff = goff_new

        # cotangents into vn through dv/div/g
        dvb = [2.0 * s * Ks * T[i] - 2.0 * B2 * Rd[i] +
               (s * Kp * sT - B3 * sRd) for i in range(ndim)]
        gb_ = {ij: s * offc[ij][2] * O[ij] - offc[ij][1] * Ro[ij]
               for ij in pairs}
        vbt = []
        for i in range(ndim):
            acc = lv[i] - d_plus(dvb[i], wgt, i, inv_h[i])
            for (a, c) in pairs:
                if a == i:
                    acc = acc - d_minus(gb_[(a, c)], wgt, c, inv_h[c])
                elif c == i:
                    acc = acc - d_minus(gb_[(a, c)], wgt, a, inv_h[a])
            vbt.append(acc)
        vhat = [damp_i[i] * vbt[i] for i in range(ndim)]
        gbi = [gbi[i] + s * dtau[i] * vhat[i] for i in range(ndim)]

        dtb = [s * b_i[i] * vhat[i] for i in range(ndim)]
        ltd = [T[i] - d_minus(dtb[i], wgt, i, inv_h[i]) for i in range(ndim)]
        lto = {ij: O[ij] - d_plus(dtb[ij[0]], wgt, ij[1], inv_h[ij[1]])
               - d_plus(dtb[ij[1]], wgt, ij[0], inv_h[ij[0]])
               for ij in pairs}
        lrd = [Rd[i] - A1 * Rd[i] for i in range(ndim)]
        lro = {ij: Ro[ij] - offc[ij][0] * Ro[ij] for ij in pairs}
        ltd[-1] = inject(ltd[-1], res[t])
        lv = vhat
        pend_Rd, pend_Ro = Rd, Ro
    # the last pending terms pair with rd^0 = ro^0 = 0: dropped exactly

    # staggered-average transposes
    gb_node = torch.zeros_like(vp)
    for i in range(ndim):
        gb_node = gb_node + (avg_to_T(gbi[i], (i,), ndim) if avg else gbi[i])
    gmu_off = torch.zeros_like(vp)
    gqp_off = torch.zeros_like(vp)
    gqs_off = torch.zeros_like(vp)
    for ij in pairs:
        gKsa, gA1a, gB2a = goff[ij]
        gm, gq, gs_ = _vjp(off_coeffs, (mu_a[ij], qp_a[ij], qs_a[ij]),
                           (gA1a, gB2a, gKsa))
        if avg:
            gm, gq, gs_ = (avg_to_T(gm, ij, ndim), avg_to_T(gq, ij, ndim),
                           avg_to_T(gs_, ij, ndim))
        gmu_off = gmu_off + gm
        gqp_off = gqp_off + gq
        gqs_off = gqs_off + gs_

    return _vjp(node_coeffs, (vp, vs, rho, qp, qs),
                (gA1, gB2, gB3, gKp, gKs, gmu_off, gqp_off, gqs_off,
                 gb_node))


def viscoelastic_value_and_grad(vp, vs, rho, qp, qs, damp, f0, src_wav,
                                src_idx, src_w, rec_idx, rec_w, obs, dw,
                                dt, misfit, *, nt, spacing, space_order=4,
                                avg=True, hist_dtype=None):
    """(fval, (g_vp, g_vs, g_rho, g_qp, g_qs), illum, res) of one shot
    through the saved-history route. ``misfit`` maps the (nt, nrec)
    tensors (syn - dw, obs - dw) to (fval, residual), e.g.
    ``misfit.least_square_torch``."""
    lam = rho * (vp * vp - 2.0 * vs * vs)
    mu = rho * vs * vs
    rec1, illum, hist = viscoelastic_forward_hist(
        lam, mu, 1.0 / rho, qp, qs, damp, f0, src_wav, src_idx, src_w,
        rec_idx, rec_w, dt, nt=nt, spacing=spacing, space_order=space_order,
        avg=avg, hist_dtype=hist_dtype)
    f, res = misfit(rec1 - dw, obs - dw)
    grads = viscoelastic_adjoint_from_hist(
        vp, vs, rho, qp, qs, damp, f0, rec_idx, rec_w, res.to(vp.dtype),
        hist, dt, nt=nt, spacing=spacing, space_order=space_order, avg=avg)
    return f, grads, illum, res
