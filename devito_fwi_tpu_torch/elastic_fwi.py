"""Elastic FWI objective on torch: misfit and (vp, vs, rho) gradients
through the 2-D staggered-grid velocity-stress propagator.

Port of ``devito_fwi_tpu.elastic_fwi``. ``elastic_fm_multi``,
``elastic_fwi_obj_multi`` and ``ElasticFwiLoss`` keep their signatures and
add ``device``: "cuda" (the default) runs the CUDA kernels of
``ops.cuda_staggered`` and raises when no card is present or when the
geometry is one the kernels do not take; "cpu" runs their plain torch
twins. One gradient evaluation of a shot chunk is

1. the physical (vp, vs, rho) edge-padded, lam = rho (vp^2 - 2 vs^2),
   mu = rho vs^2, b = 1/rho and their staggered averages;
2. ``elastic_fwd_hist_segments``: tau_zz receiver rows, the
   (vx', vz', dtau_x, dtau_z) history in float32 and the illumination;
3. the traces, the batched misfit of the gathers after direct-wave
   subtraction, and the residual folded onto the two receiver rows;
4. ``elastic_grad_stream_segments``: the five images;
5. ``avg_to_T``, the chain rule to (vp, vs, rho), ``pad_fold`` and the
   per-shot source/receiver illumination fix, summed over shots,

and the illumination precondition and the mask follow on the device.
Line-search trials and forward modeling run ``elastic_segments``. Shot
chunks are sized, as the acoustic objective's are, from
``fwi._device_budget`` and each route's bytes per shot (the history:
(nt-1) x 4 fields per shot, 2.1 GB at SMARM2).

The eager torch "saved" route (``ops.staggered_grad``) and the autograd
route are not wired into the objective yet: ``grad_route="saved"`` and
``"vjp"`` raise (ROADMAP.md queue A item 11).
"""
from __future__ import annotations

import numpy as np
import torch

from .fwi import (MISFIT_BYTES_PER_SAMPLE, ResidualStack, _batched_tables,
                  _crop, _device_budget, _device_stack, _illum_fix_factors,
                  _misfit_batch, _resolve_device, _shots_per_batch)
from .models.sources import PointSource
from .ops import cuda_staggered as _cs
from .ops import staggered_grad as _sg
from .ops.cuda_acoustic import matmul_full

__all__ = ["elastic_fm_multi", "elastic_fwi_obj_multi", "ElasticFwiLoss",
           "model_vp_vs_rho"]


def model_vp_vs_rho(model):
    """Recover padded (vp, vs, rho) from a Lame-parametrised model
    (lam = (vp^2 - 2 vs^2)/b, mu = vs^2/b, b = 1/rho)."""
    lam = np.asarray(model.lam, dtype=model.dtype)
    mu = np.asarray(model.mu, dtype=model.dtype)
    b = model.b if isinstance(model.b, np.ndarray) \
        else np.full(model.padded_shape, model.b, dtype=model.dtype)
    b = np.asarray(b, dtype=model.dtype)
    vs = np.sqrt(mu * b)
    vp = np.sqrt((lam + 2.0 * mu) * b)
    rho = 1.0 / b
    return vp, vs, rho


def _damp_field(model):
    damp = model.damp
    if not isinstance(damp, np.ndarray):
        damp = np.full(model.padded_shape, damp, dtype=model.dtype)
    return np.asarray(damp, dtype=model.dtype)


def _pad_edge(t, pads):
    """Edge-replicating pad of the trailing ``len(pads)`` axes."""
    off = t.dim() - len(pads)
    for k, (lo, hi) in enumerate(pads):
        n = t.shape[off + k]
        idx = torch.arange(-lo, n + hi, device=t.device).clamp_(0, n - 1)
        t = t.index_select(off + k, idx)
    return t


class _Tables:
    """Tables, operands and layout one elastic call needs on the device."""

    def __init__(self, geometry, dev, shot_indices=None):
        model = geometry.model
        model._initialize_bcs(bcs="mask")
        s_idx, s_w, r_idx, r_w, src_wav = _batched_tables(geometry)
        self.src_pos = np.asarray(geometry.src_positions)
        if shot_indices is not None:
            sel = np.asarray(shot_indices, dtype=np.int64)
            s_idx, s_w, self.src_pos = s_idx[sel], s_w[sel], \
                self.src_pos[sel]
        if dev.type == "cuda":
            why = _cs.unsupported_reason(model, s_idx, r_idx, src_wav)
            if why is not None:
                raise ValueError(f"elastic kernels on cuda: {why} (run other "
                                 "geometries with device='cpu')")
        self.s_idx, self.s_w, self.r_idx = s_idx, s_w, r_idx
        self.dtype = torch.float32 if model.dtype == np.float32 \
            else torch.float64
        self.dev = dev
        self.nt = geometry.nt
        self.nsteps = self.nt - 1
        self.dt = float(model.critical_dt)
        self.nx, self.nz = model.padded_shape
        self.z0 = int(np.asarray(r_idx)[..., 1].min())
        self.r_w = torch.as_tensor(r_w, device=dev)
        self.W = _cs.zplane_weight_matrix(r_idx, self.r_w, self.nx, self.z0)
        self.src_wav = torch.as_tensor(np.asarray(src_wav, model.dtype),
                                       device=dev)
        self.damp = torch.as_tensor(_damp_field(model), device=dev)
        self.kw = dict(nt=self.nt, nx=self.nx, nz=self.nz,
                       space_order=model.space_order, spacing=model.spacing,
                       z0=self.z0)
        self.spacing = model.spacing
        self.space_order = model.space_order

    def injT(self, lo, hi):
        inj = _cs.source_pattern(self.s_idx[lo:hi], self.s_w[lo:hi],
                                 self.dt, (self.nx, self.nz), self.dtype,
                                 self.dev)
        return inj.transpose(1, 2).contiguous()

    def wav_pad(self, seg):
        nseg = -(-self.nsteps // seg)
        return _cs.pad_wavelet(self.src_wav, self.nsteps, nseg * seg)

    def traces(self, rows):
        """tau_zz rows (B, nseg, seg, 2, nx) -> rec1 (B, nt, nrec)."""
        B = rows.shape[0]
        flat = rows.reshape(B, -1, 2 * self.nx)[:, :self.nsteps]
        rec = rows.new_zeros((B, self.nt, self.W.shape[1]))
        rec[:, :self.nsteps] = matmul_full(flat, self.W)
        return rec

    def res_rows(self, res, seg):
        """Residuals (B, nt, nrec) -> rows (B, nseg, seg, 2, nx), the exact
        transpose of ``traces``."""
        B = res.shape[0]
        nseg = -(-self.nsteps // seg)
        q = matmul_full(res[:, :self.nsteps], self.W.T)
        rows = res.new_zeros((B, nseg * seg, 2 * self.nx))
        rows[:, :self.nsteps] = q
        return rows.reshape(B, nseg, seg, 2, self.nx)


def _shots(rec_all, geometry):
    out = []
    for i in range(rec_all.shape[0]):
        shot = PointSource(name="rec", time_range=geometry.time_axis,
                           coordinates=geometry.rec_positions,
                           dtype=geometry.model.dtype)
        shot.data[:] = rec_all[i]
        out.append(shot)
    return out


def elastic_fm_multi(geometry, device="cuda"):
    """Model all shots through ``elastic_segments`` in one batch; returns
    (rec1 list, rec2 list) of PointSource gathers (tau_zz and div v)."""
    dev = _resolve_device(device)
    model = geometry.model
    tb = _Tables(geometry, dev)
    vp, vs, rho = model_vp_vs_rho(model)
    lam = torch.as_tensor(rho * (vp * vp - 2.0 * vs * vs), device=dev)
    mu = torch.as_tensor(rho * vs * vs, device=dev)
    b = torch.as_tensor(1.0 / rho, device=dev)
    rows = _cs.elastic_segments(*_cs.stagger_params(lam, mu, b, tb.damp),
                                tb.injT(0, geometry.nsrc),
                                tb.wav_pad(tb.nsteps), tb.dt, **tb.kw)
    r1, r2 = _cs._stag_assemble(rows, tb.r_idx, tb.r_w, z0=tb.z0, nt=tb.nt,
                                nsteps=tb.nsteps, nx=tb.nx)
    return (_shots(r1.cpu().numpy(), geometry),
            _shots(r2.cpu().numpy(), geometry))


def _bytes_per_shot(tb, calc_grad, kind):
    """Device bytes one shot holds at the peak of a chunk: on a gradient the
    history, the receiver and residual rows and the reverse's fields
    (10 scratch, two adjoint states of 5; 5 images, illumination, source
    pattern and the finish's temporaries); on a trial the forward's two
    states of 5 fields, the source pattern and the rows; and the
    misfit's."""
    f = 4 if tb.dtype == torch.float32 else 8
    field = tb.nz * tb.nx * f
    misfit = MISFIT_BYTES_PER_SAMPLE[kind] * tb.nt * tb.r_idx.shape[0]
    if not calc_grad:
        return 11 * field + tb.nsteps * 4 * tb.nx * f + misfit
    return tb.nsteps * (4 * field + 4 * tb.nx * f) + 26 * field + misfit


def _finish(glam, g_mu, g_b, vpp, vsp, rhp, pads):
    """Chain rule lam = rho (vp^2 - 2 vs^2), mu = rho vs^2, b = 1/rho on
    the padded grid, then the edge-pad transpose."""
    binv = 1.0 / rhp
    gvp = 2.0 * rhp * vpp * glam
    gvs = -4.0 * rhp * vsp * glam + 2.0 * rhp * vsp * g_mu
    grho = (vpp * vpp - 2.0 * vsp * vsp) * glam + vsp * vsp * g_mu \
        - g_b * (binv * binv)
    return tuple(_sg.pad_fold(g, pads) for g in (gvp, gvs, grho))


def _kernel_images(tb, prm, injT, seg, misfit, obs, dw):
    """The gradient kernels on one chunk: (fvals, residuals, glam, g_mu,
    g_b (B, nx, nz), illum (B, nx, nz))."""
    rows, hist, illumT = _cs.elastic_fwd_hist_segments(
        *prm, injT, tb.wav_pad(seg), tb.dt, seg=seg, **tb.kw)
    fvals, res = misfit(tb.traces(rows) - dw, obs - dw)
    imgs = _cs.elastic_grad_stream_segments(
        *prm, hist, tb.res_rows(res, seg), tb.dt, seg=seg, **tb.kw)
    del hist
    glam, gmun, gmup, gb0, gb1 = (g.transpose(1, 2) for g in imgs)
    g_mu = gmun + _sg.avg_to_T(gmup, (0, 1), 2)
    g_b = _sg.avg_to_T(gb0, (0,), 2) + _sg.avg_to_T(gb1, (1,), 2)
    return fvals, res, glam, g_mu, g_b, illumT.transpose(1, 2)


def elastic_fwi_obj_multi(geometry, obs, misfit_func=None, direct_wave=None,
                          mask=None, precond=True, calc_grad=False,
                          vp=None, vs=None, rho=None, shot_chunk=None,
                          n_checkpoints=0, shot_indices=None,
                          illum_fix=True, grad_route=None, device="cuda"):
    """Multi-shot elastic objective and gradient.

    Parameters mirror the acoustic ``fwi_obj_multi``; ``obs`` is the rec1
    (tau_zz) gather list (e.g. ``elastic_fm_multi(...)[0]``). ``vp``,
    ``vs``, ``rho`` override the model's fields (physical-domain arrays,
    or padded ones, which are cropped); None reads the model. Returns
    (fval, {"vp": g, "vs": g, "rho": g}, residuals) with each gradient on
    the physical domain as float64 numpy (None when not ``calc_grad``).
    ``shot_chunk`` caps the shots per batch (default: as many as the
    card's memory holds). ``grad_route``: None, "auto" or "pallas" run the
    gradient kernels (their twins on the CPU); "saved" and "vjp" raise.
    ``n_checkpoints`` is accepted for signature parity and changes
    nothing."""
    if grad_route not in (None, "auto", "pallas", "saved", "vjp"):
        raise ValueError(f"grad_route={grad_route!r}: expected 'auto', "
                         "'pallas', 'saved' or 'vjp'")
    if grad_route in ("saved", "vjp"):
        raise NotImplementedError(
            f"grad_route={grad_route!r} is not wired into the port's "
            "objective yet (ROADMAP.md queue A item 11)")
    dev = _resolve_device(device)
    model = geometry.model
    misfit, kind = _misfit_batch(misfit_func)
    tb = _Tables(geometry, dev, shot_indices)
    crop_slc = tuple(slice(lo, lo + n)
                     for (lo, _), n in zip(model.padsizes, model.shape))
    mvp, mvs, mrho = model_vp_vs_rho(model)

    def param(user, fallback):
        if user is None:
            return torch.as_tensor(np.asarray(fallback)[crop_slc],
                                   device=dev)
        user = np.asarray(user, dtype=model.dtype)
        if user.shape != model.shape:
            user = user[crop_slc]
        return torch.as_tensor(user, device=dev)

    pads = tuple(tuple(p) for p in model.padsizes)
    vpp, vsp, rhp = (_pad_edge(param(u, f), pads)
                     for u, f in ((vp, mvp), (vs, mvs), (rho, mrho)))
    lam = rhp * (vpp * vpp - 2.0 * vsp * vsp)
    mu = rhp * vsp * vsp
    b = 1.0 / rhp
    prm = _cs.stagger_params(lam, mu, b, tb.damp)

    obs_stack = _device_stack(obs, dev)
    if obs_stack.shape[1] != tb.nt:
        raise ValueError(
            "observed data has %d time samples but the geometry's time axis "
            "has %d" % (obs_stack.shape[1], tb.nt))
    if direct_wave is not None:
        dw_stack = _device_stack(direct_wave, dev)
    if shot_indices is not None:
        sel = torch.as_tensor(np.asarray(shot_indices, dtype=np.int64),
                              device=dev)
        obs_stack = obs_stack[sel]
        if direct_wave is not None:
            dw_stack = dw_stack[sel]
    nsrc = tb.s_idx.shape[0]
    chunk = _shots_per_batch(
        nsrc, shot_chunk, _bytes_per_shot(tb, calc_grad, kind),
        _device_budget(dev) if dev.type == "cuda" else None)
    shape = model.shape
    if calc_grad:
        keep_src, rec_prod = _illum_fix_factors(
            tb.src_pos, geometry.rec_positions, model.spacing, shape, dev)
    fval = 0.0
    residuals = []
    grads = illum = None
    for lo in range(0, nsrc, chunk):
        hi = min(lo + chunk, nsrc)
        obs_c = obs_stack[lo:hi]
        dw = dw_stack[lo:hi] if direct_wave is not None else 0.0
        if not calc_grad:
            rows = _cs.elastic_segments(*prm, tb.injT(lo, hi),
                                        tb.wav_pad(tb.nsteps), tb.dt,
                                        **tb.kw)
            fvals, res = misfit(tb.traces(rows[:, :, :, 0]) - dw, obs_c - dw)
            fval = fval + torch.sum(fvals)
            residuals.append(res)
            continue
        # the history as one segment of all the steps, as the modeling
        # sweep's: on the card the segment is only a layout, and one
        # segment pads nothing
        fvals, res, glam, g_mu, g_b, il = _kernel_images(
            tb, prm, tb.injT(lo, hi), tb.nsteps, misfit, obs_c, dw)
        fval = fval + torch.sum(fvals)
        residuals.append(res)
        fix = keep_src[lo:hi] * rec_prod if illum_fix else 1.0
        gs = tuple(torch.sum(g.double() * fix, dim=0)
                   for g in _finish(glam, g_mu, g_b, vpp, vsp, rhp, pads))
        il = torch.sum(_crop(il, pads, shape).double() * fix, dim=0)
        grads = gs if grads is None else tuple(a + g for a, g in
                                               zip(grads, gs))
        illum = il if illum is None else illum + il
    residuals = ResidualStack(residuals)
    if not calc_grad:
        return float(fval), None, residuals
    if precond:
        scale = 1.0 / torch.sqrt(illum + 1e-30)
        grads = tuple(g * scale for g in grads)
    if mask is not None:
        m = torch.as_tensor(np.asarray(mask), dtype=torch.float64,
                            device=dev)
        grads = tuple(g * m for g in grads)
    out = {name: g.cpu().numpy() for name, g in
           zip(("vp", "vs", "rho"), grads)}
    return float(fval), out, residuals


class ElasticFwiLoss:
    """Adapter exposing the elastic objective through the acoustic
    ``fwi_loss`` signature so ``optimize.minimize(loss_fn=...)`` drives
    elastic inversions unchanged.

    Inverts vp in squared slowness (x = 1/vp^2, the acoustic drivers' box
    bounds) with vs and rho held at the supplied fields; d(misfit)/d(vp)
    is chain-ruled to x by dvp/dx = -vp^3/2."""

    def __init__(self, vs, rho, shot_chunk=None, n_checkpoints=0,
                 device="cuda"):
        self.vs = vs
        self.rho = rho
        self.shot_chunk = shot_chunk
        self.n_checkpoints = n_checkpoints
        self.device = device

    def __call__(self, x, geometry, obs, misfit_func, direct_wave=None,
                 mask=None, precond=True, calc_grad=True,
                 shot_indices=None):
        shape = geometry.model.shape
        vp = 1.0 / np.sqrt(x.reshape(shape))
        fval, grads, residuals = elastic_fwi_obj_multi(
            geometry, obs, misfit_func, direct_wave, mask, precond,
            calc_grad, vp=vp.astype(geometry.model.dtype), vs=self.vs,
            rho=self.rho, shot_chunk=self.shot_chunk,
            n_checkpoints=self.n_checkpoints, shot_indices=shot_indices,
            device=self.device)
        if not calc_grad:
            return fval, None, residuals
        g = grads["vp"] * (-0.5 * vp ** 3)
        return fval, g.reshape(-1).astype(np.float64), residuals
