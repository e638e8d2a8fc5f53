"""Viscoacoustic FWI objective on torch: misfit and (vp, qp) gradients
through the 2-D SLS 2nd-order propagator.

Port of ``devito_fwi_tpu.visco_fwi``. ``visco_fm_multi``,
``visco_fwi_obj_multi`` and ``ViscoFwiLoss`` keep their signatures and add
``device``: "cuda" (the default) runs the CUDA kernels of
``ops.cuda_visco`` and raises when no card is present or when the geometry
is one the kernels do not take; "cpu" runs their plain torch twins. One
gradient evaluation of a shot chunk is

1. the physical (vp, qp) edge-padded, the coefficient fields
   ``visco_grad.coefficient_map`` and the source patterns ``w s^2 vp^2``
   rebuilt from this iterate;
2. ``visco_fwd_hist_segments``: the receiver rows of p, the (L, rn)
   history in float32 and the illumination;
3. the traces, the batched misfit of the gathers after direct-wave
   subtraction, and the residual folded onto the two receiver rows;
4. ``visco_grad_stream_segments``: the images ga1..ga4 and the source
   cotangent;
5. the chain rule to (vp, qp) (``visco_grad.coefficient_vjp``),
   ``pad_fold`` and the per-shot source/receiver illumination fix, summed
   over shots,

and the illumination precondition and the mask follow on the device.
Forward modeling and line-search trials run ``visco_sls2_segments``. Shot
chunks are sized, as the other objectives' are, from ``fwi._device_budget``
and this route's bytes per shot (the history: (nt-2) x 2 fields per shot,
755 MB at SMARMN).

``grad_route="saved"`` runs the eager torch saved-history route of
``ops.visco_grad`` shot by shot; ``"vjp"`` (autograd through a
checkpointed forward) and kernels other than sls/2 raise (ROADMAP.md queue
A item 12).
"""
from __future__ import annotations

import numpy as np
import torch

from .elastic_fwi import _pad_edge, _shots
from .fwi import (MISFIT_BYTES_PER_SAMPLE, ResidualStack, _batched_tables,
                  _crop, _device_budget, _device_stack, _illum_fix_factors,
                  _misfit_batch, _resolve_device, _shots_per_batch,
                  _traces_from_rows)
from .ops import cuda_staggered as _cs
from .ops import cuda_visco as _cv
from .ops import visco_grad as _vg
from .ops.viscoacoustic import KERNELS
from .ops.staggered_grad import pad_fold

__all__ = ["visco_fm_multi", "visco_fwi_obj_multi", "ViscoFwiLoss"]


def _field(model, name, default=None):
    """A model field on the padded grid as numpy of the model's type;
    scalars expand."""
    val = getattr(model, name, default)
    if val is None:
        val = default
    val = np.asarray(val, dtype=model.dtype)
    if val.ndim == 0:
        val = np.full(model.padded_shape, val, dtype=model.dtype)
    return val


class _Tables:
    """Tables, operands and layout one viscoacoustic call needs on the
    device."""

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
                raise ValueError(f"viscoacoustic kernels on cuda: {why} (run "
                                 "other geometries with device='cpu')")
        self.s_idx, self.s_w, self.r_idx, self.r_w_np = s_idx, s_w, r_idx, r_w
        self.dtype = torch.float32 if model.dtype == np.float32 \
            else torch.float64
        self.dev = dev
        self.nt = geometry.nt
        self.nsteps = self.nt - 2
        self.dt = float(model.critical_dt)
        self.f0 = float(geometry.f0)
        self.nx, self.nz = model.padded_shape
        self.z0 = int(np.asarray(r_idx)[..., 1].min())
        self.W = _cs.zplane_weight_matrix(r_idx, torch.as_tensor(r_w,
                                                                 device=dev),
                                          self.nx, self.z0)
        self.src_wav = torch.as_tensor(np.asarray(src_wav, model.dtype),
                                       device=dev)
        self.b = torch.as_tensor(_field(model, "b", 1.0), device=dev)
        self.damp = torch.as_tensor(_field(model, "damp", 1.0), device=dev)
        self.kw = dict(nt=self.nt, nx=self.nx, nz=self.nz,
                       space_order=model.space_order, spacing=model.spacing,
                       z0=self.z0)
        self.spacing = model.spacing
        self.space_order = model.space_order

    def operands(self, vpp, qpp):
        """The kernels' six coefficient operands and vp^2 at the padded
        (vp, qp) of this iterate."""
        return _cv.operands(vpp, self.b, qpp, self.damp, self.dt, self.f0)

    def patterns(self, vp2, lo, hi):
        """Transposed (inj, injw) source patterns of shots lo..hi-1."""
        inj, injw = _cv.source_patterns(self.s_idx[lo:hi], self.s_w[lo:hi],
                                        vp2, self.dt)
        return (inj.transpose(1, 2).contiguous(),
                injw.transpose(1, 2).contiguous())

    def wav_pad(self, seg):
        nseg = -(-self.nsteps // seg)
        return _cv.pad_wavelet(self.src_wav, self.nt, nseg * seg)

    def model_rows(self, prm, injT):
        """The modeling kernel's traces (B, nt, nrec) for one chunk."""
        rows, _ = _cv.visco_sls2_segments(*prm, injT,
                                          self.wav_pad(self.nsteps),
                                          self.dt, **self.kw)
        return self.traces(rows)

    def traces(self, rows):
        """Receiver rows (B, nseg, seg, 2, nx) -> traces (B, nt, nrec)."""
        return _traces_from_rows(rows, self.W, self.nt, self.nsteps)


def _check_kernel(kernel, time_order):
    if (kernel, time_order) not in KERNELS:
        raise ValueError(f"kernel {(kernel, time_order)}: expected one of "
                         f"{sorted(KERNELS)}")
    if (kernel, time_order) != ("sls", 2):
        raise NotImplementedError(
            f"kernel {(kernel, time_order)}: the port's viscoacoustic "
            "objective and batched modeling run the sls/2 kernel; the other "
            "kernels' gradient (autograd in the JAX package) is not ported "
            "(ROADMAP.md queue A item 12)")


def visco_fm_multi(geometry, kernel="sls", time_order=2, device="cuda"):
    """Model all shots through ``visco_sls2_segments`` in one batch; returns
    a list of PointSource gathers. Kernels other than sls/2 raise
    (``ViscoacousticWaveSolver`` models them shot by shot)."""
    _check_kernel(kernel, time_order)
    dev = _resolve_device(device)
    model = geometry.model
    tb = _Tables(geometry, dev)
    vp = torch.as_tensor(_field(model, "vp"), device=dev)
    qp = torch.as_tensor(_field(model, "qp"), device=dev)
    prm, vp2 = tb.operands(vp, qp)
    injT, _ = tb.patterns(vp2, 0, geometry.nsrc)
    return _shots(tb.model_rows(prm, injT).cpu().numpy(), geometry)


def _bytes_per_shot(tb, calc_grad, kind):
    """Device bytes one shot holds at the peak of a chunk: on a gradient the
    history, the receiver and residual rows and the reverse's fields
    (4 scratch, 5 images, illumination, two source patterns and the chain
    rule's temporaries); on a trial the forward's 3 fields (p, pp, r), the
    two source patterns, the final p and the rows; and the misfit's."""
    f = 4 if tb.dtype == torch.float32 else 8
    field = tb.nz * tb.nx * f
    misfit = MISFIT_BYTES_PER_SAMPLE[kind] * tb.nt * tb.r_idx.shape[0]
    if not calc_grad:
        return 6 * field + tb.nsteps * 4 * tb.nx * f + misfit
    return tb.nsteps * (2 * field + 4 * tb.nx * f) + 20 * field + misfit


def _kernel_grads(tb, prm, vp2, vpp, qpp, lo, hi, misfit, obs, dw):
    """The gradient kernels on shots lo..hi-1: (fvals, residuals, g_vp, g_qp
    (B, nx, nz) on the padded grid, illum (B, nx, nz))."""
    seg = tb.nsteps   # one segment: on the card only a layout
    injT, injwT = tb.patterns(vp2, lo, hi)
    wav = tb.wav_pad(seg)
    rows, hist, illumT = _cv.visco_fwd_hist_segments(
        *prm, injT, wav, tb.dt, seg=seg, **tb.kw)
    fvals, res = misfit(tb.traces(rows) - dw, obs - dw)
    s = torch.as_tensor(tb.dt, dtype=tb.dtype, device=tb.dev)
    imgs = _cv.visco_grad_stream_segments(
        *prm, injwT, hist, _cv.residual_rows(res, tb.W, seg), wav * (s * s),
        tb.dt, seg=seg, **tb.kw)
    del hist
    g_vp, g_qp = _vg.coefficient_vjp(vpp, qpp, tb.b, tb.dt, tb.f0,
                                     tuple(g.transpose(1, 2) for g in imgs))
    return fvals, res, g_vp, g_qp, illumT.transpose(1, 2)


def _saved_grads(tb, vpp, qpp, lo, hi, misfit, obs, dw):
    """The eager saved-history route (``ops.visco_grad``) shot by shot,
    with the outputs of ``_kernel_grads``."""
    def one_misfit(syn, ob):
        fv, r = misfit(syn[None], ob[None])
        return fv[0], r[0]

    out = []
    for i in range(lo, hi):
        dwi = dw[i - lo] if torch.is_tensor(dw) else dw
        out.append(_vg.visco_sls2_value_and_grad(
            vpp, tb.b, qpp, tb.damp, tb.src_wav, tb.s_idx[i], tb.s_w[i],
            tb.r_idx, tb.r_w_np, obs[i - lo], dwi, tb.dt, tb.f0, one_misfit,
            nt=tb.nt, spacing=tb.spacing, space_order=tb.space_order))
    fvals = torch.stack([o[0] for o in out])
    res = torch.stack([o[3] for o in out])
    g_vp = torch.stack([o[1][0] for o in out])
    g_qp = torch.stack([o[1][1] for o in out])
    return fvals, res, g_vp, g_qp, torch.stack([o[2] for o in out])


def visco_fwi_obj_multi(geometry, obs, misfit_func=None, direct_wave=None,
                        mask=None, precond=True, calc_grad=False,
                        vp=None, qp=None, kernel="sls", time_order=2,
                        shot_chunk=None, n_checkpoints=0, shot_indices=None,
                        illum_fix=True, grad_route=None, device="cuda"):
    """Multi-shot viscoacoustic objective and gradient. Returns (fval,
    {"vp": g, "qp": g}, residuals) with each gradient on the physical
    domain as float64 numpy (None when not ``calc_grad``). ``vp``/``qp``
    override the model's fields (physical-domain arrays, or padded ones,
    which are cropped); None reads the model. ``shot_chunk`` caps the shots
    per batch (default: as many as the card's memory holds).
    ``grad_route``: None, "auto" or "pallas" run the gradient kernels
    (their twins on the CPU); "saved" the eager saved-history route;
    "vjp" raises, and so do kernels other than sls/2. ``n_checkpoints`` is
    accepted for signature parity and changes nothing."""
    if grad_route not in (None, "auto", "pallas", "saved", "vjp"):
        raise ValueError(f"grad_route={grad_route!r}: expected 'auto', "
                         "'pallas', 'saved' or 'vjp'")
    _check_kernel(kernel, time_order)
    if grad_route == "vjp":
        raise NotImplementedError(
            "grad_route='vjp' (autograd through a checkpointed forward) is "
            "not ported (ROADMAP.md queue A item 12)")
    dev = _resolve_device(device)
    model = geometry.model
    misfit, kind = _misfit_batch(misfit_func)
    tb = _Tables(geometry, dev, shot_indices)
    crop_slc = tuple(slice(lo, lo + n)
                     for (lo, _), n in zip(model.padsizes, model.shape))

    def param(user, name):
        if user is None:
            return torch.as_tensor(_field(model, name)[crop_slc], device=dev)
        user = np.asarray(user, dtype=model.dtype)
        if user.shape != model.shape:
            user = user[crop_slc]
        return torch.as_tensor(user, device=dev)

    pads = tuple(tuple(p) for p in model.padsizes)
    vpp = _pad_edge(param(vp, "vp"), pads)
    qpp = _pad_edge(param(qp, "qp"), pads)
    prm, vp2 = tb.operands(vpp, qpp)

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
            injT, _ = tb.patterns(vp2, lo, hi)
            fvals, res = misfit(tb.model_rows(prm, injT) - dw, obs_c - dw)
            fval = fval + torch.sum(fvals)
            residuals.append(res)
            continue
        if grad_route == "saved":
            out = _saved_grads(tb, vpp, qpp, lo, hi, misfit, obs_c, dw)
        else:
            out = _kernel_grads(tb, prm, vp2, vpp, qpp, lo, hi, misfit,
                                obs_c, dw)
        fvals, res, g_vp, g_qp, il = out
        fval = fval + torch.sum(fvals)
        residuals.append(res)
        fix = keep_src[lo:hi] * rec_prod if illum_fix else 1.0
        gs = tuple(torch.sum(pad_fold(g, pads).double() * fix, dim=0)
                   for g in (g_vp, g_qp))
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
    out = {name: g.cpu().numpy() for name, g in zip(("vp", "qp"), grads)}
    return float(fval), out, residuals


class ViscoFwiLoss:
    """``fwi_loss``-signature adapter: inverts vp in squared slowness
    (x = 1/vp^2) with qp held at the model's field, through
    ``optimize.minimize(loss_fn=...)``; d(misfit)/d(vp) is chain-ruled to
    x by dvp/dx = -vp^3/2."""

    def __init__(self, kernel="sls", time_order=2, shot_chunk=None,
                 n_checkpoints=0, device="cuda"):
        self.kernel = kernel
        self.time_order = time_order
        self.shot_chunk = shot_chunk
        self.n_checkpoints = n_checkpoints
        self.device = device

    def __call__(self, x, geometry, obs, misfit_func, direct_wave=None,
                 mask=None, precond=True, calc_grad=True,
                 shot_indices=None):
        shape = geometry.model.shape
        vp = 1.0 / np.sqrt(x.reshape(shape))
        fval, grads, residuals = visco_fwi_obj_multi(
            geometry, obs, misfit_func, direct_wave, mask, precond,
            calc_grad, vp=vp.astype(geometry.model.dtype),
            kernel=self.kernel, time_order=self.time_order,
            shot_chunk=self.shot_chunk, n_checkpoints=self.n_checkpoints,
            shot_indices=shot_indices, device=self.device)
        if not calc_grad:
            return fval, None, residuals
        g = grads["vp"] * (-0.5 * vp ** 3)
        return fval, g.reshape(-1).astype(np.float64), residuals
