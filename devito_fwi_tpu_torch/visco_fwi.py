"""Viscoacoustic FWI objective on torch: misfit and (vp, qp) gradients
through the six viscoacoustic propagators.

Port of ``devito_fwi_tpu.visco_fwi``. ``visco_fm_multi``,
``visco_fwi_obj_multi`` and ``ViscoFwiLoss`` keep their signatures and add
``device``: "cuda" (the default) raises when no card is present, "cpu"
runs everything in plain torch. ``grad_route`` picks the gradient's route
as in the JAX package:

* the kernels (None, "auto" or "pallas"; their plain twins on the CPU),
  for the sls/2 kernel on a geometry ``cuda_staggered.unsupported_reason``
  takes (2-D float32, the twins also float64; one source point a shot;
  receivers between two adjacent z-planes). One gradient evaluation of a
  shot chunk is

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
     ``pad_fold`` and the per-shot source/receiver illumination fix,
     summed over shots,

  and forward modeling and line-search trials run ``visco_sls2_segments``;
* "saved" (sls/2 only): the eager saved-history route of
  ``ops.visco_grad`` shot by shot, any geometry, float type and device;
* "vjp" (any kernel): ``torch.autograd`` through the checkpointed
  ``viscoacoustic.forward_seg`` shot by shot, the edge pad inside the
  graph, so halo cotangents fold onto the edge cells;
* "auto" runs sls/2 geometries the kernels do not take on "saved" and the
  five other kernels on "vjp", adds one to ``EAGER["objective"]`` and warns
  once per reason; ``visco_fm_multi`` models them shot by shot on the
  eager ``viscoacoustic.forward`` (``EAGER["fm_multi"]``). "pallas" where
  the kernels do not apply, and "saved" on a kernel other than sls/2,
  raise ``ValueError``.

The illumination precondition and the mask follow on the device. Shot
chunks are sized from ``fwi._device_budget`` and each route's bytes per
shot (``_bytes_per_shot``, ``_eager_bytes_per_shot``; the kernels'
history: (nt-2) x 2 fields per shot, 755 MB at SMARMN).
"""
from __future__ import annotations

import numpy as np
import torch

from .elastic_fwi import (EAGER_FIELDS, _finish_grads, _pad_edge,
                          _shots, _vjp_shots)
from .fwi import (MISFIT_BYTES_PER_SAMPLE, ResidualStack, _batched_tables,
                  _crop, _device_budget, _device_stack, _eager_warn,
                  _illum_factors, _misfit_batch, _resolve_device,
                  _shots_per_batch, _traces_from_rows)
from .ops import cuda_staggered as _cs
from .ops import cuda_visco as _cv
from .ops import viscoacoustic as _va
from .ops import visco_grad as _vg
from .ops.remat import segment_layout
from .ops.staggered_grad import pad_fold
from .ops.viscoacoustic import KERNELS

__all__ = ["visco_fm_multi", "visco_fwi_obj_multi", "ViscoFwiLoss", "EAGER",
           "reset_counters"]

# calls that took an eager route because the kernels do not take them:
# objectives ("auto" -> "saved" or "vjp") and visco_fm_multi
EAGER = {"objective": 0, "fm_multi": 0}

# the grid fields autograd saves a step of each kernel's forward in 2-D:
# what one rebuilt segment of viscoacoustic.forward_seg holds a step
# (counted with torch.autograd.graph.saved_tensors_hooks, rounded up;
# tests/test_torch_visco_routes.py holds the figures)
GRAPH_FIELDS_PER_STEP = {("sls", 1): 11, ("sls", 2): 10, ("ren", 1): 6,
                         ("ren", 2): 5, ("deng_mcmechan", 1): 6,
                         ("deng_mcmechan", 2): 5}


def reset_counters():
    for key in EAGER:
        EAGER[key] = 0


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


class _Setup:
    """Tables and operands every route of one viscoacoustic call needs on
    the device."""

    def __init__(self, geometry, dev, shot_indices=None):
        model = geometry.model
        model._initialize_bcs(bcs="mask")
        s_idx, s_w, r_idx, r_w, src_wav = _batched_tables(geometry)
        self.src_pos = np.asarray(geometry.src_positions)
        if shot_indices is not None:
            sel = np.asarray(shot_indices, dtype=np.int64)
            s_idx, s_w, self.src_pos = s_idx[sel], s_w[sel], \
                self.src_pos[sel]
        self.s_idx, self.s_w, self.r_idx, self.r_w_np = s_idx, s_w, r_idx, r_w
        self.reason = _cs.unsupported_reason(model, s_idx, r_idx, src_wav,
                                             twins=dev.type == "cpu")
        self.dtype = torch.float32 if model.dtype == np.float32 \
            else torch.float64
        self.dev = dev
        self.nt = geometry.nt
        self.dt = float(model.critical_dt)
        self.f0 = float(geometry.f0)
        self.src_wav = torch.as_tensor(np.asarray(src_wav, model.dtype),
                                       device=dev)
        self.b = torch.as_tensor(_field(model, "b", 1.0), device=dev)
        self.damp = torch.as_tensor(_field(model, "damp", 1.0), device=dev)
        self.spacing = model.spacing
        self.space_order = model.space_order
        self.op_kw = dict(nt=self.nt, spacing=model.spacing,
                          space_order=model.space_order)

    def forward(self, vpp, qpp, i, kind):
        """Shot i's traces through the eager ``viscoacoustic.forward`` of
        kernel ``kind`` = (name, time order)."""
        return _va.forward(vpp, self.b, qpp, self.damp, self.src_wav,
                           self.s_idx[i], self.s_w[i], self.r_idx,
                           self.r_w_np, self.dt, self.f0, kernel=kind[0],
                           time_order=kind[1], **self.op_kw)[0]


class _Tables(_Setup):
    """Tables, operands and layout one call of the sls/2 kernels needs on
    the device."""

    def __init__(self, geometry, dev, shot_indices=None):
        super().__init__(geometry, dev, shot_indices)
        if dev.type == "cuda" and self.reason is not None:
            raise ValueError(f"viscoacoustic kernels on cuda: {self.reason} "
                             "(the objective's saved and vjp routes take "
                             "such geometries)")
        model = geometry.model
        self.nsteps = self.nt - 2
        self.nx, self.nz = model.padded_shape
        self.z0 = int(np.asarray(self.r_idx)[..., 1].min())
        self.W = _cs.zplane_weight_matrix(
            self.r_idx, torch.as_tensor(self.r_w_np, device=dev), self.nx,
            self.z0)
        self.kw = dict(nt=self.nt, nx=self.nx, nz=self.nz,
                       space_order=model.space_order, spacing=model.spacing,
                       z0=self.z0)

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


def _kernel_reason(kind, st):
    """Why the sls/2 kernels do not run kernel ``kind`` on the geometry of
    ``st``, or None."""
    if kind != ("sls", 2):
        return f"viscoacoustic kernel {kind[0]}/{kind[1]}: the kernels " \
               "run sls/2"
    return st.reason


def visco_fm_multi(geometry, kernel="sls", time_order=2, device="cuda"):
    """Model all shots through ``visco_sls2_segments`` in one batch, or shot
    by shot through the eager ``viscoacoustic.forward`` for the other
    kernels and the geometries the kernels do not take (counted in
    ``EAGER["fm_multi"]``); returns a list of PointSource gathers."""
    _check_kernel(kernel, time_order)
    dev = _resolve_device(device)
    model = geometry.model
    st = _Setup(geometry, dev)
    vp = torch.as_tensor(_field(model, "vp"), device=dev)
    qp = torch.as_tensor(_field(model, "qp"), device=dev)
    reason = _kernel_reason((kernel, time_order), st)
    if reason is not None:
        EAGER["fm_multi"] += 1
        _eager_warn(reason, "ops.viscoacoustic")
        recs = torch.stack([st.forward(vp, qp, i, (kernel, time_order))
                            for i in range(geometry.nsrc)])
        return _shots(recs.cpu().numpy(), geometry)
    tb = _Tables(geometry, dev)
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


def _eager_bytes_per_shot(st, calc_grad, kind, route, kernel,
                          n_checkpoints):
    """Device bytes one shot of an eager chunk holds at its peak: its
    traces, residual and misfit, and ``EAGER_FIELDS`` grid fields (the
    reverse sweep's working set, the padded parameters and the graph
    around the loop, its gradients and illumination); on the saved route
    (shot by shot) also the (L, rn) history of (nt-2) x 2 fields; on the
    vjp route each segment's start (the kernel's state fields and the
    illumination) and one rebuilt segment's graph,
    ``GRAPH_FIELDS_PER_STEP`` saved fields a step (running it back holds
    no more). A trial holds the traces alone. A shot chunk's own peak on
    the card (H100, SMARMN, sls/2, one shot; nt 1338 and 401): saved
    0.7731 and 0.2416 GB against 0.7851 and 0.2440 sized, vjp 0.1472 and
    0.0823 against 0.1789 and 0.1004 (``tools/probe_eager_peaks.py``)."""
    f = 4 if st.dtype == torch.float32 else 8
    field = int(np.prod(st.damp.shape)) * f
    ndim = st.damp.dim()
    traces = (2 + MISFIT_BYTES_PER_SAMPLE[kind] // f) * st.nt * \
        st.r_idx.shape[0] * f
    if not calc_grad:
        return traces
    if route == "saved":
        return ((st.nt - 2) * 2 + EAGER_FIELDS) * field + traces
    nsteps = st.nt - 1 - (kernel[1] - 1)
    seg, nseg = segment_layout(nsteps, n_checkpoints)
    if kernel[1] == 1:
        state = ndim + (2 if kernel[0] == "sls" else 1)
    else:
        state = 2 if kernel[0] == "deng_mcmechan" else 3
    return ((nseg + 1) * (state + 1) + EAGER_FIELDS + seg * (
        GRAPH_FIELDS_PER_STEP[kernel])) * field + \
        traces


def _vjp_grads(st, kind, phys, pads, shape, lo, hi, misfit, obs, dw,
               n_checkpoints):
    """The vjp route on shots lo..hi-1 (``elastic_fwi._vjp_shots`` over the
    checkpointed ``viscoacoustic.forward_seg`` of kernel ``kind``). Returns
    (fvals, residuals, g_vp, g_qp (B, *shape), the cropped illumination
    (B, *shape))."""
    def forward(i, vpp, qpp):
        return _va.forward_seg(
            vpp, st.b, qpp, st.damp, st.src_wav, st.s_idx[i], st.s_w[i],
            st.r_idx, st.r_w_np, st.dt, st.f0, kernel=kind[0],
            time_order=kind[1], n_checkpoints=n_checkpoints, **st.op_kw)

    fvals, res, (g_vp, g_qp), illum = _vjp_shots(
        forward, phys, pads, lo, hi, misfit, obs, dw, st.dtype)
    return fvals, res, g_vp, g_qp, _crop(illum, pads, shape)


def _resolve_route(grad_route, kind, reason):
    """"kernels", "saved" or "vjp" for ``grad_route`` with kernel ``kind``,
    where the kernels refuse the call for ``reason`` (None: they take
    it)."""
    if grad_route not in (None, "auto", "pallas", "saved", "vjp"):
        raise ValueError(f"grad_route={grad_route!r}: expected 'auto', "
                         "'pallas', 'saved' or 'vjp'")
    if grad_route in ("saved", "pallas") and kind != ("sls", 2):
        raise ValueError(f"grad_route={grad_route!r}: the saved-history "
                         "adjoints and the kernels cover the sls/2 kernel "
                         f"only, not {kind[0]}/{kind[1]}")
    if grad_route in ("saved", "vjp"):
        return grad_route
    if reason is None:
        return "kernels"
    if grad_route == "pallas":
        raise ValueError(f"grad_route='pallas': the viscoacoustic kernels "
                         f"do not take this call ({reason})")
    EAGER["objective"] += 1
    _eager_warn(reason, "ops.visco_grad" if kind == ("sls", 2)
                else "ops.viscoacoustic")
    return "saved" if kind == ("sls", 2) else "vjp"


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
    ``grad_route``: None, "auto" or "pallas" run the sls/2 kernels (their
    twins on the CPU) where they take the call, and "auto" runs "saved"
    (sls/2) or "vjp" (the other kernels) elsewhere; "saved" the eager
    saved-history route; "vjp" autograd through the checkpointed forward,
    whose segments ``n_checkpoints`` sets (<= 0: about sqrt(nt))."""
    _check_kernel(kernel, time_order)
    dev = _resolve_device(device)
    fval, grads, illum, residuals = _visco_sums(
        geometry, obs, misfit_func, direct_wave, calc_grad, vp, qp, kernel,
        time_order, shot_chunk, n_checkpoints, shot_indices, illum_fix,
        grad_route, dev)
    if not calc_grad:
        return float(fval), None, residuals
    return float(fval), _finish_grads(grads, illum, precond, mask,
                                ("vp", "qp")), residuals


def _visco_sums(geometry, obs, misfit_func, direct_wave, calc_grad, vp, qp,
                kernel, time_order, shot_chunk, n_checkpoints, shot_indices,
                illum_fix, grad_route, dev):
    """``visco_fwi_obj_multi`` before the precondition: (fval, the two
    gradient sums, illum sum, residuals), the sums fixed and float64 on
    ``dev`` (None without ``calc_grad``)."""
    kind = (kernel, time_order)
    model = geometry.model
    misfit, mkind = _misfit_batch(misfit_func)
    st = _Setup(geometry, dev, shot_indices)
    route = _resolve_route(grad_route, kind, _kernel_reason(kind, st))
    if route == "kernels":
        tb = st = _Tables(geometry, dev, shot_indices)
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
    phys = [param(vp, "vp"), param(qp, "qp")]
    vpp, qpp = (_pad_edge(x, pads) for x in phys)
    if route == "kernels":
        prm, vp2 = tb.operands(vpp, qpp)

    obs_stack = _device_stack(obs, dev)
    if obs_stack.shape[1] != st.nt:
        raise ValueError(
            "observed data has %d time samples but the geometry's time axis "
            "has %d" % (obs_stack.shape[1], st.nt))
    if direct_wave is not None:
        dw_stack = _device_stack(direct_wave, dev)
    if shot_indices is not None:
        sel = torch.as_tensor(np.asarray(shot_indices, dtype=np.int64),
                              device=dev)
        obs_stack = obs_stack[sel]
        if direct_wave is not None:
            dw_stack = dw_stack[sel]
    nsrc = st.s_idx.shape[0]
    per_shot = _bytes_per_shot(tb, calc_grad, mkind) if route == "kernels" \
        else _eager_bytes_per_shot(st, calc_grad, mkind, route, kind,
                                   n_checkpoints)
    chunk = _shots_per_batch(nsrc, shot_chunk, per_shot,
                             _device_budget(dev) if dev.type == "cuda"
                             else None)
    shape = model.shape
    if calc_grad:
        factors = _illum_factors(geometry, st.src_pos, dev)
    fval = 0.0
    residuals = []
    grads = illum = None
    for lo in range(0, nsrc, chunk):
        hi = min(lo + chunk, nsrc)
        obs_c = obs_stack[lo:hi]
        dw = dw_stack[lo:hi] if direct_wave is not None else 0.0
        if not calc_grad:
            if route == "kernels":
                injT, _ = tb.patterns(vp2, lo, hi)
                syn = tb.model_rows(prm, injT)
            else:
                with torch.no_grad():
                    syn = torch.stack([st.forward(vpp, qpp, i, kind)
                                       for i in range(lo, hi)])
            fvals, res = misfit(syn - dw, obs_c - dw)
            fval = fval + torch.sum(fvals)
            residuals.append(res)
            continue
        if route == "vjp":
            fvals, res, g_vp, g_qp, il = _vjp_grads(
                st, kind, phys, pads, shape, lo, hi, misfit, obs_c, dw,
                n_checkpoints)
        else:
            if route == "saved":
                out = _saved_grads(st, vpp, qpp, lo, hi, misfit, obs_c, dw)
            else:
                out = _kernel_grads(tb, prm, vp2, vpp, qpp, lo, hi, misfit,
                                    obs_c, dw)
            fvals, res, g_vp, g_qp, il = out
            g_vp, g_qp = pad_fold(g_vp, pads), pad_fold(g_qp, pads)
            il = _crop(il, pads, shape)
        fval = fval + torch.sum(fvals)
        residuals.append(res)
        keep, rec_prod = factors(lo, hi)
        fix = keep * rec_prod if illum_fix else 1.0
        gs = tuple(torch.sum(g.double() * fix, dim=0) for g in (g_vp, g_qp))
        il = torch.sum(il.double() * fix, dim=0)
        grads = gs if grads is None else tuple(a + g for a, g in
                                               zip(grads, gs))
        illum = il if illum is None else illum + il
    return fval, grads, illum, ResidualStack(residuals)


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
