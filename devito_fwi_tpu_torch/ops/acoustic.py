"""Acoustic isotropic propagators in plain torch: the OT2 forward, adjoint
and gradient in 2-D and 3-D.

Port of the parts of ``devito_fwi_tpu.ops.acoustic`` that the port runs:
the stencil pieces (``laplacian_parts`` with the free-surface fix), the
devito-solved leapfrog update ``_update``, the step hook ``_make_step``,
the segment layout ``_ckpt_layout``, and the single-shot ``forward``
(``save`` keeps the wavefield), ``adjoint`` and ``gradient`` (the
saved-history adjoint-state gradient, with the receiver-slab injection
``rec_box`` and the fused illumination ``with_illum``). Same
discretisation as the reference module:

* update rule ``u[t+1] = (s^2*(lap+q) + (2m + s*damp)*u[t] - m*u[t-1])
  / (m + s*damp)`` with ``1/(m + s*damp)`` precomputed once;
* source injection adds ``w_p * src[t] * s^2 / m[p]`` at the 2^ndim corner
  points p into u[t+1]; receivers sample u[t] multilinearly;
* time-loop bounds t = 1 .. nt-2, rec[0] = rec[nt-1] = 0;
* free surface = antisymmetric mirror of negative-z accesses with the z = 0
  plane zeroed in mirrored accesses, on rows 0..r of the last axis;
* the gradient accumulates ``-u.dt2[t] * v[t]`` over t = nt-2 .. 1 while
  stepping v backward with receiver-residual injection into v[t-1].

Functions take tensors on any device and of any float type and run where
their inputs lie. Out-of-grid interpolation corners are masked and clamped
(``ops.interp.valid_corners``) because a torch index may not leave the
grid. The step hook (keyword ``step3``) swaps in the CUDA step kernel of
``ops.cuda_acoustic3`` on 3-D float32 grids it takes. Not ported yet
(ROADMAP.md queue A item 2): ``forward_ckpt``, ``gradient_from_ckpt``,
``gradient_checkpointed``, ``born``, the OT4 kernel and ``w_override``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.fd import second_derivative_weights
from .interp import valid_corners

__all__ = ["forward", "adjoint", "gradient", "laplacian_parts", "shift"]


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


def _make_step(m, hd, s2, inv_mhd, w, inv_h2, *, space_order, fs, step3):
    """Leapfrog step closure ``step(u, u_prev) -> u_next`` (no source term;
    callers inject sources and residuals afterwards). ``step3``: True runs
    ``ops.cuda_acoustic3.step3`` (the CUDA kernel on cuda, its twin on the
    CPU) and raises where it does not apply; None runs it on cuda where it
    applies (3-D float32 OT2 without a free surface, a padded nx that
    ``pick_xb`` blocks); False, and None elsewhere, the eager update. The
    kernel repeats the eager association, so the hook is numerically
    invisible."""
    if step3 is not False:
        from . import cuda_acoustic3 as _c3
        reason = _c3.unsupported_reason(tuple(m.shape), space_order, fs,
                                        m.dtype)
        if step3 and reason is not None:
            raise ValueError(f"step3 requested on {reason}")
        if reason is None and (step3 or m.device.type == "cuda"):
            # the constants as Python numbers, read from the device once
            s2f = float(s2)
            wf = tuple(float(v) for v in w)
            ihf = tuple(float(v) for v in inv_h2)
            return lambda u, up: _c3.step3(u, up, m, hd, s2f, w=wf,
                                           inv_h2=ihf, inv_mhd=inv_mhd)
    return lambda u, up: _update(u, up, laplacian_parts(u, w, inv_h2, fs),
                                 0.0, m, hd, s2, inv_mhd)


def forward(vp, damp, src_wav, src_idx, src_w, rec_idx, rec_w, dt, *, nt,
            spacing, space_order=4, fs=False, save=False, step3=None):
    """Single-shot OT2 forward modeling on the device of ``vp``.

    ``vp``, ``damp`` are padded-grid tensors (damp may be a float);
    ``src_wav`` (nt, nsrcpt) tensor; ``src_idx``/``src_w`` and
    ``rec_idx``/``rec_w`` are numpy ``interp_table`` outputs; ``step3`` as
    in ``_make_step``. Returns (rec (nt, nrec), u) where u is the saved
    wavefield (nt, *grid) if ``save`` else the final two time slices
    (2, *grid)."""
    dev, dtype = vp.device, vp.dtype
    w, inv_h2, m, s2, hd, inv_mhd = _prep(vp, damp, dt, spacing,
                                          space_order)
    step = _make_step(m, hd, s2, inv_mhd, w, inv_h2,
                      space_order=space_order, fs=fs, step3=step3)
    shape = tuple(vp.shape)
    s_coords, s_w = _point_table(src_idx, src_w, shape, dev, dtype)
    r_coords, r_w = _point_table(rec_idx, rec_w, shape, dev, dtype)
    src_scale = s_w * s2 / m[s_coords]          # (nsrcpt, 2**d)
    z = torch.zeros_like(vp)
    u, u_prev = z, z
    recs = torch.zeros((nt, rec_idx.shape[0]), dtype=dtype, device=dev)
    # the history is allocated first and filled in place
    us = vp.new_zeros((nt,) + shape) if save else None
    for t in range(1, nt - 1):
        recs[t] = torch.sum(u[r_coords] * r_w, dim=-1)
        unext = step(u, u_prev)
        unext = unext.index_put(s_coords, src_wav[t][:, None] * src_scale,
                                accumulate=True)
        u_prev, u = u, unext
        if save:
            us[t + 1] = u
    if save:
        return recs, us
    return recs, torch.stack([u, u_prev])


def adjoint(vp, damp, rec_data, rec_idx, rec_w, src_idx, src_w, dt, *, nt,
            spacing, space_order=4, fs=False, step3=None):
    """Adjoint modeling: inject the receiver data ``rec_data`` (nt, nrec)
    backward in time and sample at the source points (reference
    ``operators.py:143-180``). Returns (srca (nt, nsrcpt), v final slices
    (2, *grid))."""
    dev, dtype = vp.device, vp.dtype
    w, inv_h2, m, s2, hd, inv_mhd = _prep(vp, damp, dt, spacing,
                                          space_order)
    step = _make_step(m, hd, s2, inv_mhd, w, inv_h2,
                      space_order=space_order, fs=fs, step3=step3)
    shape = tuple(vp.shape)
    s_coords, s_w = _point_table(src_idx, src_w, shape, dev, dtype)
    r_coords, r_w = _point_table(rec_idx, rec_w, shape, dev, dtype)
    rec_scale = r_w * s2 / m[r_coords]
    z = torch.zeros_like(vp)
    v, v_next = z, z
    srca = torch.zeros((nt, src_idx.shape[0]), dtype=dtype, device=dev)
    for t in range(nt - 2, 0, -1):
        srca[t] = torch.sum(v[s_coords] * s_w, dim=-1)
        vprev = step(v, v_next)
        vprev = vprev.index_put(r_coords, rec_data[t][:, None] * rec_scale,
                                accumulate=True)
        v, v_next = vprev, v
    return srca, torch.stack([v, v_next])


def _rec_slabs(rec_res, rec_idx, rec_w, m, s2, rec_box):
    """Receiver residuals (nt, nrec) folded into dense per-step slabs
    (nt, nx, 2[, 2]) between the trailing-axis plane pairs ``rec_box``: one
    product against a small scattered weight matrix, in the model's type at
    full precision (TF32 off). Corners outside the grid or the 2-wide
    windows get zero weight, as the scatter's dropped corners do."""
    from .cuda_acoustic import matmul_full
    dims = tuple(m.shape)
    nx, ndim = dims[0], len(dims)
    rec_idx = np.asarray(rec_idx)
    xi = rec_idx[..., 0]
    valid = (xi >= 0) & (xi < nx)
    q = np.clip(xi, 0, nx - 1).astype(np.int64)
    for d in range(1, ndim):
        cd = rec_idx[..., d]
        b = rec_box[d - 1]
        valid &= (cd == b) | (cd == b + 1)
        q = q * 2 + np.clip(cd - b, 0, 1)
    dev = m.device
    mc = m[tuple(torch.as_tensor(np.clip(rec_idx[..., d], 0, dims[d] - 1),
                                 dtype=torch.long, device=dev)
                 for d in range(ndim))]
    w = torch.as_tensor(np.asarray(rec_w), dtype=m.dtype, device=dev)
    scale = torch.where(torch.as_tensor(valid, device=dev), w * s2 / mc,
                        torch.zeros((), dtype=m.dtype, device=dev))
    nrec = rec_idx.shape[0]
    rows = torch.arange(nrec, device=dev)[:, None].expand(q.shape)
    V = m.new_zeros((nrec, nx * 2 ** (ndim - 1)))
    V.index_put_((rows, torch.as_tensor(q, device=dev)), scale,
                 accumulate=True)
    slabs = matmul_full(rec_res.to(m.dtype), V)
    return slabs.reshape((rec_res.shape[0], nx) + (2,) * (ndim - 1))


def gradient(vp, damp, u_save, rec_res, rec_idx, rec_w, dt, *, nt, spacing,
             space_order=4, fs=False, rec_box=None, with_illum=False,
             step3=None):
    """Adjoint-state gradient w.r.t. squared slowness m:
    ``grad = sum_t -u.dt2[t] * v[t]`` with v the receiver-residual adjoint
    field (reference ``operators.py:183-225``), on the padded grid.

    ``u_save`` is the saved history (nt, *grid) of ``forward(save=True)``;
    ``rec_res`` (nt, nrec) the residual. ``rec_box`` (trailing-axis window
    starts: ``(z0,)`` in 2-D, ``(y0, z0)`` in 3-D) injects the residual as
    dense slabs (``_rec_slabs``) added on those windows instead of the
    per-step scatter; the caller checks that every receiver corner fits
    them. ``with_illum`` also sums ``u[t]^2`` from the same history reads.
    Returns (grad, v final slices (2, *grid)) and, with ``with_illum``, the
    illumination."""
    dev, dtype = vp.device, vp.dtype
    w, inv_h2, m, s2, hd, inv_mhd = _prep(vp, damp, dt, spacing,
                                          space_order)
    step = _make_step(m, hd, s2, inv_mhd, w, inv_h2,
                      space_order=space_order, fs=fs, step3=step3)
    shape = tuple(vp.shape)
    if rec_box is None:
        r_coords, r_w = _point_table(rec_idx, rec_w, shape, dev, dtype)
        rec_scale = r_w * s2 / m[r_coords]

        def inject(vprev, t):
            return vprev.index_put(r_coords,
                                   rec_res[t][:, None] * rec_scale,
                                   accumulate=True)
    else:
        slabs = _rec_slabs(rec_res, rec_idx, rec_w, m, s2, rec_box)
        window = (slice(None),) + tuple(slice(b, b + 2) for b in rec_box)

        def inject(vprev, t):
            vprev[window] += slabs[t]
            return vprev

    z = torch.zeros_like(vp)
    v, v_next = z, z
    grad = torch.zeros_like(vp)
    u_tp1 = u_save[nt - 1].to(dtype)
    u_t = u_save[nt - 2].to(dtype)
    # illum starts at u[nt-1]^2: the loop's u_t covers u[nt-2] .. u[1] and
    # u[0] is zero, so the total is the sum over the whole history
    illum = u_tp1 * u_tp1 if with_illum else None
    for t in range(nt - 2, 0, -1):
        u_tm1 = u_save[t - 1].to(dtype)
        udt2 = (u_tp1 - 2.0 * u_t + u_tm1) / s2
        grad = grad - udt2 * v
        if with_illum:
            illum = illum + u_t * u_t
        vprev = inject(step(v, v_next), t)
        v, v_next = vprev, v
        u_tp1, u_t = u_t, u_tm1
    if with_illum:
        return grad, torch.stack([v, z]), illum
    return grad, torch.stack([v, z])
