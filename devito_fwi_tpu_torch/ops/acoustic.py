"""Acoustic isotropic propagator in plain torch: the 2-D/3-D OT2 forward.

Port of the parts of ``devito_fwi_tpu.ops.acoustic`` that the first slice
needs: the stencil pieces (``laplacian_parts`` with the free-surface fix),
the devito-solved leapfrog update ``_update``, the segment layout
``_ckpt_layout`` and the single-shot ``forward`` that ``fwi.fm_single``
and the tests use. Same discretisation as the reference module:

* update rule ``u[t+1] = (s^2*(lap+q) + (2m + s*damp)*u[t] - m*u[t-1])
  / (m + s*damp)`` with ``1/(m + s*damp)`` precomputed once;
* source injection adds ``w_p * src[t] * s^2 / m[p]`` at the 2^ndim corner
  points p into u[t+1]; receivers sample u[t] multilinearly;
* time-loop bounds t = 1 .. nt-2, rec[0] = rec[nt-1] = 0;
* free surface = antisymmetric mirror of negative-z accesses with the z = 0
  plane zeroed in mirrored accesses, on rows 0..r of the last axis.

Functions take tensors on any device; ``forward`` runs where its inputs
lie. Out-of-grid interpolation corners are masked and clamped
(``ops.interp.valid_corners``) because a torch index may not leave the
grid. The adjoint, Born and gradient operators and the OT4 kernel are not
ported yet (ROADMAP.md queue A item 2).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.fd import second_derivative_weights
from .interp import valid_corners

__all__ = ["forward", "laplacian_parts", "shift"]


def shift(u, k, dim):
    """``out[i] = u[i + k]`` along ``dim``, zero where ``i + k`` leaves the
    axis (devito's zero halo beyond the padded grid)."""
    n = u.shape[dim]
    if k == 0:
        return u
    if abs(k) >= n:
        return u.new_zeros(u.shape)
    pad_shape = list(u.shape)
    pad_shape[dim] = abs(k)
    zeros = u.new_zeros(pad_shape)
    if k > 0:
        return torch.cat([u.narrow(dim, k, n - k), zeros], dim)
    return torch.cat([zeros, u.narrow(dim, 0, n + k)], dim)


def _axis_d2(u, w, dim):
    """Order-(2r) second derivative along ``dim`` (unscaled by 1/h^2)."""
    out = w[0] * u
    for k in range(1, len(w)):
        out = out + w[k] * (shift(u, k, dim) + shift(u, -k, dim))
    return out


def _fs_fix_last_axis(u, d2_last, w):
    """Replace rows 0..r of the last-axis second derivative with the
    free-surface mirrored stencil."""
    r = len(w) - 1
    cols = []
    for z in range(r + 1):
        acc = w[0] * u[..., z]
        for k in range(1, r + 1):
            acc = acc + w[k] * u[..., z + k]
            i = z - k
            if i > 0:
                acc = acc + w[k] * u[..., i]
            elif i < 0:
                acc = acc - w[k] * u[..., -i]
        cols.append(acc)
    return torch.cat([torch.stack(cols, -1), d2_last[..., r + 1:]], -1)


def laplacian_parts(u, weights, inv_h2, fs):
    """Laplacian as a sum of per-axis second derivatives over the trailing
    ``len(inv_h2)`` axes; the last axis gets the free-surface fix when
    ``fs``."""
    ndim_sp = len(inv_h2)
    offset = u.dim() - ndim_sp
    lap = 0.0
    for d in range(ndim_sp):
        d2 = _axis_d2(u, weights, offset + d)
        if fs and d == ndim_sp - 1:
            d2 = _fs_fix_last_axis(u, d2, weights)
        lap = lap + d2 * inv_h2[d]
    return lap


def _update(u, u_prev, lap_u, q, m, hd, s2, inv_mhd):
    """The devito-solved leapfrog update; ``hd = s*damp`` and ``inv_mhd =
    1/(m + hd)`` precomputed once."""
    return (s2 * (lap_u + q) + (2.0 * m + hd) * u - m * u_prev) * inv_mhd


def _ckpt_layout(nt, n_checkpoints):
    """(nsteps, seg, nseg): the nt-2 forward steps cut into nseg segments
    of seg steps; the last segment may run past nsteps (padded tail)."""
    nsteps = nt - 2
    seg = -(-nsteps // n_checkpoints)
    nseg = -(-nsteps // seg)
    return nsteps, seg, nseg


def _prep(vp, damp, dt, spacing, space_order):
    dtype = vp.dtype
    w_full = second_derivative_weights(space_order)
    w = torch.as_tensor(w_full[len(w_full) // 2:], dtype=dtype,
                        device=vp.device)
    inv_h2 = [torch.as_tensor(1.0 / (h * h), dtype=dtype, device=vp.device)
              for h in spacing]
    m = 1.0 / (vp * vp)
    s = torch.as_tensor(dt, dtype=dtype, device=vp.device)
    s2 = s * s
    hd = s * damp
    inv_mhd = 1.0 / (m + hd)
    return w, inv_h2, m, s2, hd, inv_mhd


def _point_table(idx, w, shape, device, dtype):
    """Masked, clamped corner coordinates and weights as tensors."""
    valid, cl = valid_corners(idx, shape)
    coords = tuple(torch.as_tensor(cl[..., d], dtype=torch.long,
                                   device=device)
                   for d in range(cl.shape[-1]))
    wt = torch.as_tensor(np.where(valid, w, 0.0), dtype=dtype, device=device)
    return coords, wt


def forward(vp, damp, src_wav, src_idx, src_w, rec_idx, rec_w, dt, *, nt,
            spacing, space_order=4, fs=False, save=False):
    """Single-shot OT2 forward modeling on the device of ``vp``.

    ``vp``, ``damp`` are padded-grid tensors (damp may be a float);
    ``src_wav`` (nt, nsrcpt) tensor; ``src_idx``/``src_w`` and
    ``rec_idx``/``rec_w`` are numpy ``interp_table`` outputs. Returns
    (rec (nt, nrec), u) where u is the saved wavefield (nt, *grid) if
    ``save`` else the final two time slices (2, *grid)."""
    dev, dtype = vp.device, vp.dtype
    w, inv_h2, m, s2, hd, inv_mhd = _prep(vp, damp, dt, spacing,
                                          space_order)
    shape = tuple(vp.shape)
    s_coords, s_w = _point_table(src_idx, src_w, shape, dev, dtype)
    r_coords, r_w = _point_table(rec_idx, rec_w, shape, dev, dtype)
    src_scale = s_w * s2 / m[s_coords]          # (nsrcpt, 2**d)
    z = torch.zeros_like(vp)
    u, u_prev = z, z
    recs = torch.zeros((nt, rec_idx.shape[0]), dtype=dtype, device=dev)
    us = [z, z] if save else None
    for t in range(1, nt - 1):
        recs[t] = torch.sum(u[r_coords] * r_w, dim=-1)
        lap = laplacian_parts(u, w, inv_h2, fs)
        unext = _update(u, u_prev, lap, 0.0, m, hd, s2, inv_mhd)
        unext = unext.index_put(s_coords, src_wav[t][:, None] * src_scale,
                                accumulate=True)
        u_prev, u = u, unext
        if save:
            us.append(u)
    if save:
        return recs, torch.stack(us)
    return recs, torch.stack([u, u_prev])
