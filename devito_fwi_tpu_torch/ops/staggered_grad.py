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

``elastic_born`` and the viscoelastic functions are not ported yet
(ROADMAP.md queue A items 11 and 13).
"""
from __future__ import annotations

import torch

from .acoustic import _point_table
from .staggered import _elastic_step, _pairs, _wgt, avg_to, d_minus, d_plus

__all__ = ["elastic_forward_hist", "elastic_adjoint_from_hist", "avg_to_T",
           "pad_fold"]


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
