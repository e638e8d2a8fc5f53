"""Staggered-grid building blocks and the elastic velocity-stress forward in
plain torch.

Port of ``devito_fwi_tpu.ops.staggered``: the elastic system and the SLS
viscoelastic one. Same conventions as that module:

* velocity component ``v[i]`` lives at nodes shifted +h/2 in dim i;
  diagonal stresses at nodes; off-diagonal ``tau_ij`` shifted +h/2 in both
  i and j;
* the derivative of a node field at +h/2 is the D+ stencil, of a
  +h/2-staggered field at a node the D- stencil
  (``self_adjoint.staggered_weights``);
* node-centred parameters used at a staggered point are averaged over the
  staggered dims with a zero halo (``avg_to``);
* update (reference ``elastic/operators.py:62-65``)::

      v[t+1]   = damp (v + dt b div(tau[t]))
      tau[t+1] = damp (tau + dt lam diag(div v[t+1])
                           + dt mu (grad v[t+1] + grad v[t+1]^T))

  with the source ``w_p src[t] dt`` added to the diagonal stresses at t+1;
  receivers record tau_zz (rec1) and div v (rec2, each ``v[i].d{i}`` as
  the centred derivative on the component's own grid) at t = 0..nt-2, and
  rec[nt-1] = 0;
* the viscoelastic (SLS) system adds the memory tensor r with the
  relaxation times t_s, t_ep, t_es of qp, qs and f0
  (``viscoelastic/operators.py:30-58``), r[t+1] updated before tau[t+1],
  which reads it.

The functions run where their tensors lie, for 1-3 dims; ``fwi``-level code
on the card goes through the CUDA kernels of ``ops.cuda_staggered``
instead, which repeat the 2-D update term for term, where they take the
geometry. ``elastic_forward_seg`` and ``viscoelastic_forward_seg`` run the
same steps in checkpointed segments (``remat.checkpointed_loop``) for
autograd: the objective's "vjp" route.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.fd import fd_weights
from .acoustic import _injector, _point_table, _sampler
from .remat import checkpointed_loop
from .self_adjoint import shifted_derivative, staggered_weights

__all__ = ["elastic_forward", "elastic_forward_seg", "viscoelastic_forward",
           "viscoelastic_forward_seg", "avg_to", "d_plus", "d_minus",
           "d_centered"]


# ---------------------------------------------------------------------------
# staggered helpers
# ---------------------------------------------------------------------------

def _wgt(space_order, dtype, device=None):
    w_p, off_p, w_m, off_m = staggered_weights(space_order)
    return (torch.as_tensor(w_p, dtype=dtype, device=device), off_p,
            torch.as_tensor(w_m, dtype=dtype, device=device), off_m)


def _cwgt(space_order, dtype, device=None):
    r = space_order // 2
    off = np.arange(-r, r + 1)
    return torch.as_tensor(fd_weights(1, off, 0.0), dtype=dtype,
                           device=device), off


def d_centered(u, cwgt, axis, inv_h):
    """Centred first derivative on the field's own grid (integer offsets,
    zero centre weight): devito's evaluation of a bare ``f.dx`` of a
    staggered function, as in the receiver expression
    ``rec2.interpolate(expr=div(v))``."""
    w, off = cwgt
    return shifted_derivative(u, w, off, axis, inv_h)


def d_plus(u, wgt, axis, inv_h):
    """First derivative of a node-centred field evaluated at +h/2."""
    w_p, off_p, _, _ = wgt
    return shifted_derivative(u, w_p, off_p, axis, inv_h)


def d_minus(u, wgt, axis, inv_h):
    """First derivative of a +h/2-staggered field evaluated at the node."""
    _, _, w_m, off_m = wgt
    return shifted_derivative(u, w_m, off_m, axis, inv_h)


def avg_to(p, dims, ndim):
    """Arithmetic average of a node-centred parameter to the grid point
    shifted +h/2 in each dim of ``dims`` (zero beyond the array, like
    devito's halo): per dim ``0.5 * (p[k] + p[k+1])``. Scalars pass
    through."""
    if not torch.is_tensor(p) or p.dim() == 0:
        return p
    for d in dims:
        axis = p.dim() - ndim + d
        n = p.shape[axis]
        nxt = torch.cat([p.narrow(axis, 1, n - 1),
                         p.new_zeros(p.shape[:axis] + (1,)
                                     + p.shape[axis + 1:])], axis)
        p = 0.5 * (p + nxt)
    return p


def _pairs(ndim):
    return [(i, j) for i in range(ndim) for j in range(i + 1, ndim)]


# ---------------------------------------------------------------------------
# elastic
# ---------------------------------------------------------------------------

def _elastic_step(lam, mu, b, damp, src_idx, src_w, rec_idx, rec_w, dt,
                  spacing, space_order, avg, collect_hist=False, hoist=True):
    """The per-step elastic update shared by the plain forward and the
    history forward. Returns (step, init) with ``step(carry, src_t) ->
    (carry', (rec1_t, rec2_t))``, or with ``collect_hist`` ``(carry',
    (rec1_t, hist_t))`` where ``hist_t`` is the tuple ``(vn_0..vn_{d-1},
    dtau_0..dtau_{d-1})`` the adjoint sweep needs (rec2 is then not
    computed). ``hoist=False`` forms the staggered parameter averages in
    each step instead of once (the same values). ``src_idx``/``src_w`` and
    ``rec_idx``/``rec_w`` are numpy ``interp_table`` outputs; the other
    operands tensors (``b`` and ``damp`` may be 0-dim)."""
    dtype, dev = lam.dtype, lam.device
    ndim = len(spacing)
    wgt = _wgt(space_order, dtype, dev)
    cwgt = _cwgt(space_order, dtype, dev)
    inv_h = [torch.as_tensor(1.0 / h, dtype=dtype, device=dev)
             for h in spacing]
    s = torch.as_tensor(dt, dtype=dtype, device=dev)
    pairs = _pairs(ndim)
    shape = tuple(lam.shape)

    def mavg(p, dims):
        return avg_to(p, dims, ndim) if avg else p

    def make_avgs():
        return ([mavg(b, (i,)) for i in range(ndim)],
                [mavg(damp, (i,)) for i in range(ndim)],
                {ij: mavg(mu, ij) for ij in pairs},
                {ij: mavg(damp, ij) for ij in pairs})

    hoisted = make_avgs() if hoist else None
    s_coords, s_wt = _point_table(src_idx, src_w, shape, dev, dtype)
    r_coords, r_wt = _point_table(rec_idx, rec_w, shape, dev, dtype)
    src_scale = s_wt * s  # inject w_p * src[t] * dt (operators.py:20-25)

    def step(carry, src_t):
        b_i, damp_i, mu_ij, damp_ij = hoisted or make_avgs()
        v, td, to = carry
        # receivers sample the fields at time t
        rec1_t = torch.sum(td[-1][r_coords] * r_wt, dim=-1)
        if not collect_hist:
            div_v = sum(d_centered(v[i], cwgt, i, inv_h[i])
                        for i in range(ndim))
            rec2_t = torch.sum(div_v[r_coords] * r_wt, dim=-1)

        # v[t+1] = damp (v + dt b div(tau))
        dtau = []
        for i in range(ndim):
            dt_i = d_plus(td[i], wgt, i, inv_h[i])
            for (a, c) in pairs:
                if a == i:
                    dt_i = dt_i + d_minus(to[(a, c)], wgt, c, inv_h[c])
                elif c == i:
                    dt_i = dt_i + d_minus(to[(a, c)], wgt, a, inv_h[a])
            dtau.append(dt_i)
        vn = [damp_i[i] * (v[i] + s * b_i[i] * dtau[i])
              for i in range(ndim)]
        dv = [d_minus(vn[i], wgt, i, inv_h[i]) for i in range(ndim)]
        div_vn = sum(dv)

        # tau[t+1] = damp (tau + dt lam diag(div v') + dt mu (grad+grad^T))
        tdn = [damp * (td[i] + s * lam * div_vn + 2.0 * s * mu * dv[i])
               for i in range(ndim)]
        ton = {}
        for (i, j) in pairs:
            g = d_plus(vn[i], wgt, j, inv_h[j]) + \
                d_plus(vn[j], wgt, i, inv_h[i])
            ton[(i, j)] = damp_ij[(i, j)] * (to[(i, j)] +
                                             s * mu_ij[(i, j)] * g)
        # source into the diagonal stresses at t+1
        inj = src_t[:, None] * src_scale
        tdn = [t_.index_put(s_coords, inj, accumulate=True) for t_ in tdn]
        if collect_hist:
            return (tuple(vn), tuple(tdn), ton), (rec1_t,
                                                  tuple(vn + dtau))
        return (tuple(vn), tuple(tdn), ton), (rec1_t, rec2_t)

    z = torch.zeros_like(lam)
    init = (tuple(z for _ in range(ndim)), tuple(z for _ in range(ndim)),
            {ij: z for ij in pairs})
    return step, init


def elastic_forward(lam, mu, b, damp, src_wav, src_idx, src_w, rec_idx,
                    rec_w, dt, *, nt, spacing, space_order=4, avg=True):
    """Velocity-stress elastic forward modeling on the device of ``lam``.
    ``lam``, ``mu``, ``b``, ``damp``: padded-grid tensors (``b``, ``damp``
    may be 0-dim); ``src_wav`` (nt, nsrcpt) tensor; the tables numpy.
    Returns (rec1 = tau_zz traces, rec2 = div(v) traces), each (nt,
    nrec)."""
    step, carry = _elastic_step(lam, mu, b, damp, src_idx, src_w, rec_idx,
                                rec_w, dt, spacing, space_order, avg)
    nrec = rec_idx.shape[0]
    rec1 = lam.new_zeros((nt, nrec))
    rec2 = lam.new_zeros((nt, nrec))
    for t in range(nt - 1):
        carry, (rec1[t], rec2[t]) = step(carry, src_wav[t])
    return rec1, rec2


def _as_params(like, values):
    """The parameters of a checkpointed loop as tensors of ``like``'s type
    and device (scalars become 0-dim tensors; tensors pass unchanged)."""
    return tuple(torch.as_tensor(v, dtype=like.dtype, device=like.device)
                 for v in values)


def _rec_rows(recs, t0, nt):
    """The (nt, nrec) gather of the step rows ``recs`` (steps t0..nt-2),
    zero elsewhere, assembled functionally (autograd and forward AD)."""
    z = recs.new_zeros((1,) + tuple(recs.shape[1:]))
    return torch.cat([z.expand((t0,) + tuple(recs.shape[1:])), recs, z])


def elastic_forward_seg(lam, mu, b, damp, src_wav, src_idx, src_w, rec_idx,
                        rec_w, dt, *, nt, spacing, space_order=4, avg=True,
                        n_checkpoints=0, hoist=None):
    """Differentiable ``elastic_forward``: the same steps in checkpointed
    segments (``remat.checkpointed_loop``; ``n_checkpoints`` <= 0 picks
    about sqrt(nt) of them), so autograd through it is the exact discrete
    adjoint and keeps only the segment starts and one segment's graph.
    ``hoist=False`` forms the staggered parameter averages inside each
    step (the same values; autograd then carries cotangents for the four
    base parameters instead of the averaged fields); None means True.
    Returns (rec1, rec2, illum) with ``illum = sum_t |v[t+1]|^2`` over the
    nt-1 steps, accumulated detached."""
    hoist = True if hoist is None else hoist

    def make_step(*prm):
        return _elastic_step(*prm, src_idx, src_w, rec_idx, rec_w, dt,
                             spacing, space_order, avg, hoist=hoist)[0]

    params = _as_params(lam, (lam, mu, b, damp))
    _, carry = _elastic_step(*params, src_idx, src_w, rec_idx, rec_w, dt,
                             spacing, space_order, avg)
    _, (r1, r2), illum = checkpointed_loop(
        make_step, params, carry, src_wav[0:nt - 1], torch.zeros_like(lam),
        n_checkpoints=n_checkpoints,
        energy=lambda c: sum(x * x for x in c[0]))
    return _rec_rows(r1, 0, nt), _rec_rows(r2, 0, nt), illum


# ---------------------------------------------------------------------------
# viscoelastic (SLS)
# ---------------------------------------------------------------------------

def _relax(qp, qs, f0):
    """The SLS relaxation times (t_s, t_ep, t_es) of (qp, qs) at the peak
    frequency ``f0`` (a tensor); ``staggered_grad``'s coefficient maps take
    the same expressions."""
    t_s = (torch.sqrt(1. + 1. / qp ** 2) - 1. / qp) / f0
    t_ep = 1. / (f0 ** 2 * t_s)
    t_es = (1. + f0 * qs * t_s) / (f0 * qs - f0 ** 2 * t_s)
    return t_s, t_ep, t_es


def _viscoelastic_step(lam, mu, b, qp, qs, damp, f0, src_idx, src_w,
                       rec_idx, rec_w, dt, spacing, space_order, avg,
                       collect_hist=False):
    """The per-step SLS viscoelastic update shared by the plain forward and
    the history forward. Returns (step, init) with ``step(carry, src_t) ->
    (carry', (rec1_t, rec2_t))``, or with ``collect_hist`` ``(carry',
    (rec1_t, hist_t))`` where ``hist_t`` is the list ``(vn_0.., dtau_0..,
    rdn_0.., ron_ij..)`` the adjoint sweep's imaging condition needs (rec2
    is then not computed). The tables are numpy ``interp_table`` outputs,
    the other operands tensors."""
    dtype, dev = lam.dtype, lam.device
    ndim = len(spacing)
    wgt = _wgt(space_order, dtype, dev)
    cwgt = _cwgt(space_order, dtype, dev)
    inv_h = [torch.as_tensor(1.0 / h, dtype=dtype, device=dev)
             for h in spacing]
    s = torch.as_tensor(dt, dtype=dtype, device=dev)
    f0 = torch.as_tensor(f0, dtype=dtype, device=dev)
    pairs = _pairs(ndim)
    shape = tuple(lam.shape)

    def mavg(p, dims):
        return avg_to(p, dims, ndim) if avg else p

    t_s, t_ep, t_es = _relax(qp, qs, f0)
    b_i = [mavg(b, (i,)) for i in range(ndim)]
    damp_i = [mavg(damp, (i,)) for i in range(ndim)]
    off = {}
    for ij in pairs:
        ts_a, _, tes_a = _relax(mavg(qp, ij), mavg(qs, ij), f0)
        off[ij] = (mavg(mu, ij), mavg(damp, ij), ts_a, tes_a)
    # inject w_p * src[t] * dt into the diagonal stresses
    inject = _injector(src_idx, src_w, None, s, shape)
    sample = _sampler(rec_idx, rec_w, shape, dev, dtype)

    def step(carry, src_t):
        v, td, to, rd, ro = carry
        rec1_t = sample(td[-1])
        if not collect_hist:
            div_v = sum(d_centered(v[i], cwgt, i, inv_h[i])
                        for i in range(ndim))
            rec2_t = sample(div_v)

        dtau = []
        for i in range(ndim):
            dt_i = d_plus(td[i], wgt, i, inv_h[i])
            for (a, c) in pairs:
                if a == i:
                    dt_i = dt_i + d_minus(to[(a, c)], wgt, c, inv_h[c])
                elif c == i:
                    dt_i = dt_i + d_minus(to[(a, c)], wgt, a, inv_h[a])
            dtau.append(dt_i)
        vn = [damp_i[i] * (v[i] + s * b_i[i] * dtau[i])
              for i in range(ndim)]
        dv = [d_minus(vn[i], wgt, i, inv_h[i]) for i in range(ndim)]
        div_vn = sum(dv)

        # memory variable first (tau reads r[t+1]; operators.py:56-58)
        rdn = [damp * (rd[i] - s / t_s * (rd[i] +
                                          mu * (t_es / t_s - 1.) * 2. * dv[i] +
                                          lam * (t_ep / t_s - 1.) * div_vn))
               for i in range(ndim)]
        ron, grads = {}, {}
        for (i, j) in pairs:
            mu_a, damp_a, ts_a, tes_a = off[(i, j)]
            g = d_plus(vn[i], wgt, j, inv_h[j]) + \
                d_plus(vn[j], wgt, i, inv_h[i])
            grads[(i, j)] = g
            ron[(i, j)] = damp_a * (ro[(i, j)] - s / ts_a * (
                ro[(i, j)] + mu_a * (tes_a / ts_a - 1.) * g))

        tdn = [damp * (s * rdn[i] + td[i] +
                       s * (lam * t_ep / t_s * div_vn +
                            mu * t_es / t_s * 2. * dv[i]))
               for i in range(ndim)]
        ton = {}
        for ij in pairs:
            mu_a, damp_a, ts_a, tes_a = off[ij]
            ton[ij] = damp_a * (s * ron[ij] + to[ij] +
                                s * mu_a * tes_a / ts_a * grads[ij])

        tdn = [inject(t_, src_t) for t_ in tdn]
        carry = (tuple(vn), tuple(tdn), ton, tuple(rdn), ron)
        if collect_hist:
            return carry, (rec1_t, vn + dtau + rdn + [ron[ij] for ij in pairs])
        return carry, (rec1_t, rec2_t)

    z = torch.zeros_like(lam)
    init = (tuple(z for _ in range(ndim)), tuple(z for _ in range(ndim)),
            {ij: z for ij in pairs}, tuple(z for _ in range(ndim)),
            {ij: z for ij in pairs})
    return step, init


def viscoelastic_forward(lam, mu, b, qp, qs, damp, f0, src_wav, src_idx,
                         src_w, rec_idx, rec_w, dt, *, nt, spacing,
                         space_order=4, avg=True):
    """SLS viscoelastic forward modeling with a memory-variable stress
    tensor r (reference ``viscoelastic/operators.py:8-63``) on the device
    of ``lam``. Returns (rec1 = tau_zz, rec2 = div v), each (nt, nrec)."""
    step, carry = _viscoelastic_step(lam, mu, b, qp, qs, damp, f0, src_idx,
                                     src_w, rec_idx, rec_w, dt, spacing,
                                     space_order, avg)
    nrec = rec_idx.shape[0]
    rec1 = lam.new_zeros((nt, nrec))
    rec2 = lam.new_zeros((nt, nrec))
    for t in range(nt - 1):
        carry, (rec1[t], rec2[t]) = step(carry, src_wav[t])
    return rec1, rec2


def viscoelastic_forward_seg(lam, mu, b, qp, qs, damp, f0, src_wav,
                             src_idx, src_w, rec_idx, rec_w, dt, *, nt,
                             spacing, space_order=4, avg=True,
                             n_checkpoints=0):
    """Differentiable ``viscoelastic_forward``: the same steps in
    checkpointed segments, as ``elastic_forward_seg``. Returns (rec1,
    rec2, illum = sum_t |v[t+1]|^2, accumulated detached)."""
    def make_step(lam_, mu_, b_, qp_, qs_, damp_):
        return _viscoelastic_step(lam_, mu_, b_, qp_, qs_, damp_, f0,
                                  src_idx, src_w, rec_idx, rec_w, dt,
                                  spacing, space_order, avg)[0]

    params = _as_params(lam, (lam, mu, b, qp, qs, damp))
    _, carry = _viscoelastic_step(*params[:5], params[5], f0, src_idx,
                                  src_w, rec_idx, rec_w, dt, spacing,
                                  space_order, avg)
    _, (r1, r2), illum = checkpointed_loop(
        make_step, params, carry, src_wav[0:nt - 1], torch.zeros_like(lam),
        n_checkpoints=n_checkpoints,
        energy=lambda c: sum(x * x for x in c[0]))
    return _rec_rows(r1, 0, nt), _rec_rows(r2, 0, nt), illum
