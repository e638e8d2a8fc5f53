"""TTI (tilted transverse isotropy) propagators in plain torch: the centred
kernels of the coupled second-order (u, v) system and the staggered forward.

Port of ``devito_fwi_tpu.ops.tti`` (reference ``seismic/tti/operators.py``):

    m u.dt2 = (1+2eps) Gxx(u) + sqrt(1+2delta) Gzz(v) - damp u.dt
    m v.dt2 = sqrt(1+2delta) Gxx(u) + Gzz(v)          - damp v.dt

with the rotated second derivatives built from half-order centred first
derivatives D1 and their exact transposes:

    Gz  = -(sin th cos ph D1x + sin th sin ph D1y + cos th D1z) u
    Gzz = -(D1x(sin th cos ph Gz) + D1y(sin th sin ph Gz) + D1z(cos th Gz))
    Gxx(+Gyy) = laplace(u) - Gzz(u)

The adjoint applies the rotated operators to the combinations
``ehat p + dhat r`` and ``dhat p + r``. Sources inject ``w src[t] dt^2 / m``
into both u[t+1] and v[t+1]; receivers record u + v. Born drives the twin
system with ``qu = -dm u0.dt2, qv = -dm v0.dt2`` and the Jacobian adjoint
accumulates ``dm -= u0.dt2 du + v0.dt2 dv``.

Every function takes tensors on any device and in any float type and runs
where ``vp`` lies; the interpolation tables are numpy ``interp_table``
outputs (out-of-grid corners masked, ``acoustic._point_table``). Each
operation keeps the JAX function's association, so at float64 the two agree
to rounding. ``phi`` is used in 3-D only (None there means 0).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.fd import fd_weights, second_derivative_weights
from .acoustic import _axis_d2, _ckpt_layout, _point_table, _update, shift
from .self_adjoint import shifted_derivative, staggered_weights

__all__ = ["forward", "adjoint", "born", "jacobian_adjoint",
           "forward_ckpt", "jacobian_adjoint_from_ckpt",
           "forward_staggered"]


def _d1(u, w1, axis, inv_h):
    """Centred first derivative (order space_order//2) along ``axis``,
    zero-Dirichlet; the zero weights skipped, then scaled by ``inv_h``."""
    r = (len(w1) - 1) // 2
    out = 0.0
    for k in range(-r, r + 1):
        if w1[k + r] != 0.0:
            out = out + float(w1[k + r]) * shift(u, k, axis)
    return out * inv_h


def _scalar(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _prep_tti(vp, damp, epsilon, delta, theta, phi, dt, spacing,
              space_order):
    """(gzz, gxx, m, ehat, dhat, s, s2, hd, inv_mhd) of ``_prep_tti`` of the
    JAX module; the operators act on the trailing ``len(spacing)`` axes."""
    np_t = np.float32 if vp.dtype == torch.float32 else np.float64
    ndim = len(spacing)
    r1 = (space_order // 2) // 2
    if r1 < 1:
        raise ValueError("TTI centered kernel needs space_order >= 4")
    w1 = np.asarray(fd_weights(1, np.arange(-r1, r1 + 1), 0.0), dtype=np_t)
    w2 = _scalar(second_derivative_weights(space_order)[space_order // 2:],
                 vp)
    inv_h = [_scalar(1.0 / h, vp) for h in spacing]
    inv_h2 = [_scalar(1.0 / (h * h), vp) for h in spacing]
    m = 1.0 / (vp * vp)
    s = _scalar(dt, vp)
    s2 = s * s
    hd = s * damp
    ehat = 1.0 + 2.0 * epsilon
    dhat = torch.sqrt(1.0 + 2.0 * delta)
    cth, sth = torch.cos(theta), torch.sin(theta)
    if ndim == 3:
        cph = torch.cos(phi) if phi is not None else 1.0
        sph = torch.sin(phi) if phi is not None else 0.0
        dirs = (sth * cph, sth * sph, cth)
    else:
        dirs = (sth, cth)
    off = vp.dim() - ndim

    def gzz(u):
        gz = -sum(dirs[d] * _d1(u, w1, off + d, inv_h[d])
                  for d in range(ndim))
        return -sum(_d1(dirs[d] * gz, w1, off + d, inv_h[d])
                    for d in range(ndim))

    def lap(u):
        out = 0.0
        for d in range(ndim):
            out = out + _axis_d2(u, w2, off + d) * inv_h2[d]
        return out

    def gxx(u):
        return lap(u) - gzz(u)

    inv_mhd = 1.0 / (m + hd)
    return gzz, gxx, m, ehat, dhat, s, s2, hd, inv_mhd


class _Points:
    """Masked, clamped corner tables of one set of sparse points on the
    grid of ``like``: ``gather(f)`` samples (npt,), ``scatter(f, vals)``
    adds (npt, 2**ndim) values (out-of-grid corners add nothing)."""

    def __init__(self, idx, w, like):
        self.coords, self.w = _point_table(idx, w, tuple(like.shape),
                                           like.device, like.dtype)

    def gather(self, f):
        return torch.sum(f[self.coords] * self.w, dim=-1)

    def scatter(self, f, vals):
        return f.index_put(self.coords, vals, accumulate=True)


def _wav(a, like):
    """``a`` (a tensor, or an array, copied when it is read-only) as a
    tensor of ``like``'s type on its device."""
    if not torch.is_tensor(a):
        a = np.asarray(a)
        a = a if a.flags.writeable else a.copy()
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _coupled_step(gzz, gxx, ehat, dhat, m, hd, s2, inv_mhd, u, up, v, vp,
                  qu=0.0, qv=0.0):
    """One forward step of the coupled system, before injection."""
    Gxx_u = gxx(u)
    Gzz_v = gzz(v)
    un = _update(u, up, ehat * Gxx_u + dhat * Gzz_v, qu, m, hd, s2, inv_mhd)
    vn = _update(v, vp, dhat * Gxx_u + Gzz_v, qv, m, hd, s2, inv_mhd)
    return un, vn


def forward(vp, damp, epsilon, delta, theta, phi, src_wav, src_idx, src_w,
            rec_idx, rec_w, dt, *, nt, spacing, space_order=4, save=False):
    """TTI forward modeling. Returns (rec (nt, nrec), u history, v history)
    (each (nt, *grid)) if ``save`` else (rec, (u, u_prev), (v, v_prev))."""
    gzz, gxx, m, ehat, dhat, s, s2, hd, inv_mhd = _prep_tti(
        vp, damp, epsilon, delta, theta, phi, dt, spacing, space_order)
    src = _Points(src_idx, src_w, vp)
    rec_p = _Points(rec_idx, rec_w, vp)
    src_scale = src.w * s2 / m[src.coords]
    wav = _wav(src_wav, vp)
    z = torch.zeros_like(vp)
    u = up = v = vp_ = z
    rec = vp.new_zeros((nt, rec_idx.shape[0]))
    us, vs = ([z, z], [z, z]) if save else (None, None)
    for t in range(1, nt - 1):
        rec[t] = rec_p.gather(u + v)
        un, vn = _coupled_step(gzz, gxx, ehat, dhat, m, hd, s2, inv_mhd, u,
                               up, v, vp_)
        inj = wav[t][:, None] * src_scale
        un = src.scatter(un, inj)
        vn = src.scatter(vn, inj)
        up, u, vp_, v = u, un, v, vn
        if save:
            us.append(u)
            vs.append(v)
    if save:
        return rec, torch.stack(us), torch.stack(vs)
    return rec, torch.stack([u, up]), torch.stack([v, vp_])


def adjoint(vp, damp, epsilon, delta, theta, phi, rec_data, rec_idx, rec_w,
            src_idx, src_w, dt, *, nt, spacing, space_order=4):
    """TTI adjoint modeling: the time-reversed coupled system with
    ``H0 = Gxx(ehat p + dhat r), Hz = Gzz(dhat p + r)``, the receiver data
    injected into both fields. Returns (srca (nt, nsrc), final p)."""
    gzz, gxx, m, ehat, dhat, s, s2, hd, inv_mhd = _prep_tti(
        vp, damp, epsilon, delta, theta, phi, dt, spacing, space_order)
    src = _Points(src_idx, src_w, vp)
    rec_p = _Points(rec_idx, rec_w, vp)
    rec_scale = rec_p.w * s2 / m[rec_p.coords]
    data = _wav(rec_data, vp)
    z = torch.zeros_like(vp)
    p = pn = r = rn = z
    srca = vp.new_zeros((nt, src_idx.shape[0]))
    for t in range(nt - 2, 0, -1):
        srca[t] = src.gather(p + r)
        H0 = gxx(ehat * p + dhat * r)
        Hz = gzz(dhat * p + r)
        pprev = _update(p, pn, H0, 0.0, m, hd, s2, inv_mhd)
        rprev = _update(r, rn, Hz, 0.0, m, hd, s2, inv_mhd)
        inj = data[t][:, None] * rec_scale
        pprev = rec_p.scatter(pprev, inj)
        rprev = rec_p.scatter(rprev, inj)
        pn, p, rn, r = p, pprev, r, rprev
    return srca, p


def born(vp, damp, epsilon, delta, theta, phi, dm, src_wav, src_idx, src_w,
         rec_idx, rec_w, dt, *, nt, spacing, space_order=4):
    """TTI linearized Born modeling: twin coupled systems driven by
    ``qu = -dm u0.dt2, qv = -dm v0.dt2``. Returns the du + dv traces."""
    gzz, gxx, m, ehat, dhat, s, s2, hd, inv_mhd = _prep_tti(
        vp, damp, epsilon, delta, theta, phi, dt, spacing, space_order)
    src = _Points(src_idx, src_w, vp)
    rec_p = _Points(rec_idx, rec_w, vp)
    src_scale = src.w * s2 / m[src.coords]
    wav = _wav(src_wav, vp)
    dm = _wav(dm, vp)
    z = torch.zeros_like(vp)
    u0, u0p, v0, v0p, du, dup, dv, dvp = (z,) * 8
    rec = vp.new_zeros((nt, rec_idx.shape[0]))
    for t in range(1, nt - 1):
        rec[t] = rec_p.gather(du + dv)
        u0n, v0n = _coupled_step(gzz, gxx, ehat, dhat, m, hd, s2, inv_mhd,
                                 u0, u0p, v0, v0p)
        inj = wav[t][:, None] * src_scale
        u0n = src.scatter(u0n, inj)
        v0n = src.scatter(v0n, inj)
        qu = -dm * (u0n - 2.0 * u0 + u0p) / s2
        qv = -dm * (v0n - 2.0 * v0 + v0p) / s2
        dun, dvn = _coupled_step(gzz, gxx, ehat, dhat, m, hd, s2, inv_mhd,
                                 du, dup, dv, dvp, qu, qv)
        u0p, u0, v0p, v0 = u0, u0n, v0, v0n
        dup, du, dvp, dv = du, dun, dv, dvn
    return rec


def _adjoint_step(gzz, gxx, ehat, dhat, m, hd, s2, inv_mhd, rec_p, inj, du,
                  dun, dv, dvn):
    """One reverse step of the coupled adjoint with the residual injected
    into both fields: returns (du_prev, dv_prev)."""
    H0 = gxx(ehat * du + dhat * dv)
    Hz = gzz(dhat * du + dv)
    dup = _update(du, dun, H0, 0.0, m, hd, s2, inv_mhd)
    dvp = _update(dv, dvn, Hz, 0.0, m, hd, s2, inv_mhd)
    return rec_p.scatter(dup, inj), rec_p.scatter(dvp, inj)


def jacobian_adjoint(vp, damp, epsilon, delta, theta, phi, u0_save, v0_save,
                     rec_res, rec_idx, rec_w, dt, *, nt, spacing,
                     space_order=4):
    """TTI gradient over the saved forward histories (``forward(save=
    True)``): the reverse-time coupled adjoint (du, dv) accumulating
    ``dm -= u0.dt2 du + v0.dt2 dv``. Returns (dm, final du)."""
    gzz, gxx, m, ehat, dhat, s, s2, hd, inv_mhd = _prep_tti(
        vp, damp, epsilon, delta, theta, phi, dt, spacing, space_order)
    rec_p = _Points(rec_idx, rec_w, vp)
    rec_scale = rec_p.w * s2 / m[rec_p.coords]
    res = _wav(rec_res, vp)
    us, vs = _wav(u0_save, vp), _wav(v0_save, vp)
    z = torch.zeros_like(vp)
    du = dun = dv = dvn = z
    dm = torch.zeros_like(vp)
    for t in range(nt - 2, 0, -1):
        dt2u = (us[t + 1] - 2.0 * us[t] + us[t - 1]) / s2
        dt2v = (vs[t + 1] - 2.0 * vs[t] + vs[t - 1]) / s2
        dm = dm - (dt2u * du + dt2v * dv)
        dup, dvp = _adjoint_step(gzz, gxx, ehat, dhat, m, hd, s2, inv_mhd,
                                 rec_p, res[t][:, None] * rec_scale, du, dun,
                                 dv, dvn)
        dun, du, dvn, dv = du, dup, dv, dvp
    return dm, du


def forward_ckpt(vp, damp, epsilon, delta, theta, phi, src_wav, src_idx,
                 src_w, rec_idx, rec_w, dt, *, nt, spacing, space_order=4,
                 n_checkpoints=16, with_illum=False):
    """TTI forward recording the receivers and the (u, u_prev, v, v_prev)
    state at each segment start (``acoustic._ckpt_layout``). Returns
    (rec (nt, nrec), seg_starts (nseg, 4, *grid)); ``with_illum`` appends
    illum = sum over the steps t < nsteps of u^2 + v^2."""
    gzz, gxx, m, ehat, dhat, s, s2, hd, inv_mhd = _prep_tti(
        vp, damp, epsilon, delta, theta, phi, dt, spacing, space_order)
    src = _Points(src_idx, src_w, vp)
    rec_p = _Points(rec_idx, rec_w, vp)
    src_scale = src.w * s2 / m[src.coords]
    wav = _wav(src_wav, vp)
    nsteps, seg, nseg = _ckpt_layout(nt, n_checkpoints)
    z = torch.zeros_like(vp)
    u = up = v = vp_ = z
    illum = torch.zeros_like(vp)
    rec = vp.new_zeros((nt, rec_idx.shape[0]))
    starts = []
    for i in range(nseg * seg):
        if i % seg == 0:
            starts.append(torch.stack([u, up, v, vp_]))
        if i < nsteps:
            rec[i + 1] = rec_p.gather(u + v)
        un, vn = _coupled_step(gzz, gxx, ehat, dhat, m, hd, s2, inv_mhd, u,
                               up, v, vp_)
        if i < nsteps:      # the padded tail steps inject nothing
            inj = wav[i + 1][:, None] * src_scale
            un = src.scatter(un, inj)
            vn = src.scatter(vn, inj)
            if with_illum:
                illum = illum + (un * un + vn * vn)
        up, u, vp_, v = u, un, v, vn
    seg_starts = torch.stack(starts)
    if with_illum:
        return rec, seg_starts, illum
    return rec, seg_starts


def jacobian_adjoint_from_ckpt(vp, damp, epsilon, delta, theta, phi,
                               src_wav, src_idx, src_w, seg_starts,
                               rec_res, rec_idx, rec_w, dt, *, nt, spacing,
                               space_order=4, n_checkpoints=16):
    """Checkpointed TTI gradient: each forward segment's (u, v) histories
    recomputed from its start state, then the coupled adjoint (du, dv)
    stepped back through the segment accumulating the unscaled
    ``u0.dt2 du + v0.dt2 dv``, scaled by ``-1/s^2`` once at the end.
    Returns (grad, final du)."""
    gzz, gxx, m, ehat, dhat, s, s2, hd, inv_mhd = _prep_tti(
        vp, damp, epsilon, delta, theta, phi, dt, spacing, space_order)
    src = _Points(src_idx, src_w, vp)
    rec_p = _Points(rec_idx, rec_w, vp)
    src_scale = src.w * s2 / m[src.coords]
    rec_scale = rec_p.w * s2 / m[rec_p.coords]
    wav = _wav(src_wav, vp)
    res = _wav(rec_res, vp)
    starts = _wav(seg_starts, vp)
    nsteps, seg, nseg = _ckpt_layout(nt, n_checkpoints)
    z = torch.zeros_like(vp)
    du = dun = dv = dvn = z
    grad = torch.zeros_like(vp)
    for k in range(nseg - 1, -1, -1):
        base = k * seg
        u, up, v, vp_ = starts[k]
        useg, vseg = [up, u], [vp_, v]
        for i in range(seg):
            un, vn = _coupled_step(gzz, gxx, ehat, dhat, m, hd, s2, inv_mhd,
                                   u, up, v, vp_)
            if base + i < nsteps:
                inj = wav[base + i + 1][:, None] * src_scale
                un = src.scatter(un, inj)
                vn = src.scatter(vn, inj)
            up, u, vp_, v = u, un, v, vn
            useg.append(u)
            vseg.append(v)
        for j in range(seg - 1, -1, -1):
            if base + j >= nsteps:
                continue
            udt2 = useg[j + 2] - 2.0 * useg[j + 1] + useg[j]
            vdt2 = vseg[j + 2] - 2.0 * vseg[j + 1] + vseg[j]
            grad = grad + (udt2 * du + vdt2 * dv)
            dup, dvp = _adjoint_step(
                gzz, gxx, ehat, dhat, m, hd, s2, inv_mhd, rec_p,
                res[base + j + 1][:, None] * rec_scale, du, dun, dv, dvn)
            dun, du, dvn, dv = du, dup, dv, dvp
    return grad * (-(1.0 / s2)), du


def forward_staggered(vp, damp, epsilon, delta, theta, phi, src_wav,
                      src_idx, src_w, rec_idx, rec_w, dt, *, nt, spacing,
                      space_order=4):
    """Staggered TTI forward (reference ``kernel_staggered_2d/3d``): the
    first-order coupled system with rotated particle velocities, u and v at
    the nodes, each velocity staggered +h/2 in its own dim; aligned-dim
    derivatives staggered, off-dim ones centred; absorbing factor
    ``1 - damp``. Forward only, like the reference. Returns rec (nt,
    nrec)."""
    ndim = len(spacing)
    off = vp.dim() - ndim
    w_p, off_p, w_m, off_m = staggered_weights(space_order)
    w_p, w_m = _scalar(w_p, vp), _scalar(w_m, vp)
    np_t = np.float32 if vp.dtype == torch.float32 else np.float64
    r1 = max(space_order // 2 // 2 if space_order >= 4 else 1, 1)
    w1 = np.asarray(fd_weights(1, np.arange(-r1, r1 + 1), 0.0), dtype=np_t)
    inv_h = [_scalar(1.0 / h, vp) for h in spacing]
    m = 1.0 / (vp * vp)
    s = _scalar(dt, vp)
    dampl = 1.0 - damp
    ehat = 1.0 + 2.0 * epsilon
    dhat = torch.sqrt(1.0 + 2.0 * delta)
    cth, sth = torch.cos(theta), torch.sin(theta)
    if ndim == 3:
        cph = torch.cos(phi) if phi is not None else 1.0
        sph = torch.sin(phi) if phi is not None else 0.0

    def dplus(f, ax):
        return shifted_derivative(f, w_p, off_p, off + ax, inv_h[ax])

    def dminus(f, ax):
        return shifted_derivative(f, w_m, off_m, off + ax, inv_h[ax])

    def dc(f, ax):
        return _d1(f, w1, off + ax, inv_h[ax])

    def avg_p(f, ax):
        # node -> staggered +h/2 average along ax
        return 0.5 * (f + shift(f, 1, off + ax))

    def avg_m(f, ax):
        # staggered +h/2 -> node average along ax
        return 0.5 * (f + shift(f, -1, off + ax))

    src = _Points(src_idx, src_w, vp)
    rec_p = _Points(rec_idx, rec_w, vp)
    src_scale = src.w * s * s / m[src.coords]
    wav = _wav(src_wav, vp)
    z = torch.zeros_like(vp)
    u = v = vx = vz = vy = z
    rec = vp.new_zeros((nt, rec_idx.shape[0]))
    for t in range(0, nt - 1):
        rec[t] = rec_p.gather(u + v)
        if ndim == 2:
            vx_n = dampl * vx - dampl * s * (cth * dplus(u, 0) -
                                             sth * avg_p(dc(u, 1), 0))
            vz_n = dampl * vz - dampl * s * (sth * avg_p(dc(v, 0), 1) +
                                             cth * dplus(v, 1))
            dvx = cth * dminus(vx_n, 0) - sth * avg_m(dc(vx_n, 1), 0)
            dvz = sth * avg_m(dc(vz_n, 0), 1) + cth * dminus(vz_n, 1)
            v_n = dampl * (v - s / m * (dhat * dvx + dvz))
            u_n = dampl * (u - s / m * (ehat * dvx + dhat * dvz))
        else:
            vx_n = dampl * vx - dampl * s * (cth * cph * dplus(u, 0) +
                                             cth * sph * avg_p(dc(u, 1), 0) -
                                             sth * avg_p(dc(u, 2), 0))
            vy_n = dampl * vy - dampl * s * (-sph * avg_p(dc(u, 0), 1) +
                                             cph * dplus(u, 1))
            vz_n = dampl * vz - dampl * s * (sth * cph * avg_p(dc(v, 0), 2) +
                                             sth * sph * avg_p(dc(v, 1), 2) +
                                             cth * dplus(v, 2))
            dvx = (cth * cph * dminus(vx_n, 0) +
                   cth * sph * avg_m(dc(vx_n, 1), 0) -
                   sth * avg_m(dc(vx_n, 2), 0))
            dvy = -sph * avg_m(dc(vy_n, 0), 1) + cph * dminus(vy_n, 1)
            dvz = (sth * cph * avg_m(dc(vz_n, 0), 2) +
                   sth * sph * avg_m(dc(vz_n, 1), 2) +
                   cth * dminus(vz_n, 2))
            v_n = dampl * (v - s / m * (dhat * (dvx + dvy) + dvz))
            u_n = dampl * (u - s / m * (ehat * (dvx + dvy) + dhat * dvz))
            vy = vy_n
        inj = wav[t][:, None] * src_scale
        u = src.scatter(u_n, inj)
        v = src.scatter(v_n, inj)
        vx, vz = vx_n, vz_n
    return rec
