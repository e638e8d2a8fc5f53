"""Staggered-grid building blocks and the elastic velocity-stress forward in
plain torch.

Port of the elastic part of ``devito_fwi_tpu.ops.staggered`` (the
viscoelastic part is not ported yet: ROADMAP.md queue A item 13). Same
conventions as that module:

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
  rec[nt-1] = 0.

The functions run where their tensors lie, for 1-3 dims; ``fwi``-level code
on the card goes through the CUDA kernels of ``ops.cuda_staggered``
instead, which repeat the 2-D update term for term.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.fd import fd_weights
from .acoustic import _point_table
from .self_adjoint import shifted_derivative, staggered_weights

__all__ = ["elastic_forward", "elastic_forward_seg", "avg_to", "d_plus",
           "d_minus", "d_centered"]


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
                  spacing, space_order, avg, collect_hist=False):
    """The per-step elastic update shared by the plain forward and the
    history forward. Returns (step, init) with ``step(carry, src_t) ->
    (carry', (rec1_t, rec2_t))``, or with ``collect_hist`` ``(carry',
    (rec1_t, hist_t))`` where ``hist_t`` is the tuple ``(vn_0..vn_{d-1},
    dtau_0..dtau_{d-1})`` the adjoint sweep needs (rec2 is then not
    computed). ``src_idx``/``src_w`` and ``rec_idx``/``rec_w`` are numpy
    ``interp_table`` outputs; the other operands tensors (``b`` and
    ``damp`` may be 0-dim)."""
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

    b_i = [mavg(b, (i,)) for i in range(ndim)]
    damp_i = [mavg(damp, (i,)) for i in range(ndim)]
    mu_ij = {ij: mavg(mu, ij) for ij in pairs}
    damp_ij = {ij: mavg(damp, ij) for ij in pairs}
    s_coords, s_wt = _point_table(src_idx, src_w, shape, dev, dtype)
    r_coords, r_wt = _point_table(rec_idx, rec_w, shape, dev, dtype)
    src_scale = s_wt * s  # inject w_p * src[t] * dt (operators.py:20-25)

    def step(carry, src_t):
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


def elastic_forward_seg(lam, mu, b, damp, src_wav, src_idx, src_w, rec_idx,
                        rec_w, dt, *, nt, spacing, space_order=4, avg=True,
                        n_checkpoints=0, hoist=None):
    """``elastic_forward`` that also returns the illumination
    ``illum = sum_t |v[t+1]|^2`` over the nt-1 steps. The JAX function
    nests its scan in checkpointed segments for ``jax.vjp``; here the
    loop is plain, and ``n_checkpoints`` and ``hoist`` are accepted for
    signature parity and change nothing. Returns (rec1, rec2, illum)."""
    step, carry = _elastic_step(lam, mu, b, damp, src_idx, src_w, rec_idx,
                                rec_w, dt, spacing, space_order, avg)
    nrec = rec_idx.shape[0]
    rec1 = lam.new_zeros((nt, nrec))
    rec2 = lam.new_zeros((nt, nrec))
    illum = torch.zeros_like(lam)
    for t in range(nt - 1):
        carry, (rec1[t], rec2[t]) = step(carry, src_wav[t])
        illum = illum + sum(x * x for x in carry[0])
    return rec1, rec2, illum
