"""Elastic FWI objective on torch: misfit and (vp, vs, rho) gradients
through the staggered-grid velocity-stress propagator.

Port of ``devito_fwi_tpu.elastic_fwi``. ``elastic_fm_multi``,
``elastic_fwi_obj_multi`` and ``ElasticFwiLoss`` keep their signatures and
add ``device``: "cuda" (the default) raises when no card is present, "cpu"
runs everything in plain torch. ``grad_route`` picks the gradient's route
as in the JAX package:

* the kernels (None, "auto" or "pallas"; their plain twins on the CPU),
  when ``cuda_staggered.unsupported_reason`` takes the geometry: 2-D
  float32 (the twins also float64), one source point a shot, receivers
  between two adjacent z-planes. One gradient evaluation of a shot chunk
  is

  1. the physical (vp, vs, rho) edge-padded, lam = rho (vp^2 - 2 vs^2),
     mu = rho vs^2, b = 1/rho and their staggered averages;
  2. ``elastic_fwd_hist_segments``: tau_zz receiver rows, the (vx', vz',
     dtau_x, dtau_z) history in float32 and the illumination;
  3. the traces, the batched misfit of the gathers after direct-wave
     subtraction, and the residual folded onto the two receiver rows;
  4. ``elastic_grad_stream_segments``: the five images;
  5. ``avg_to_T``, the chain rule to (vp, vs, rho), ``pad_fold`` and the
     per-shot source/receiver illumination fix, summed over shots,

  and line-search trials and forward modeling run ``elastic_segments``;
* "saved": the eager saved-history route of ``ops.staggered_grad`` shot by
  shot (``elastic_forward_hist``, the chunk's misfit,
  ``elastic_adjoint_from_hist``, the chain rule and ``pad_fold``), any
  dimension, float type and device;
* "vjp": ``torch.autograd`` through the checkpointed
  ``staggered.elastic_forward_seg`` shot by shot, the edge pad inside the
  graph, so halo cotangents fold onto the edge cells;
* "auto" on a geometry the kernels do not take (3-D, float64 on cuda,
  receivers off two adjacent z-planes, several source points) runs
  "saved", adds one to ``EAGER["objective"]`` and warns once per reason;
  ``elastic_fm_multi`` models such geometries shot by shot on the eager
  ``staggered.elastic_forward`` (``EAGER["fm_multi"]``). "pallas" on such
  a geometry raises ``ValueError``.

The illumination precondition and the mask follow on the device. Shot
chunks are sized from ``fwi._device_budget`` and each route's bytes per
shot (``_bytes_per_shot``, ``_eager_bytes_per_shot``).
"""
from __future__ import annotations

import numpy as np
import torch

from .fwi import (MISFIT_BYTES_PER_SAMPLE, ResidualStack, _batched_tables,
                  _crop, _device_budget, _device_stack, _eager_warn,
                  _illum_factors, _misfit_batch, _resolve_device,
                  _shots_per_batch)
from .models.sources import PointSource
from .ops import cuda_staggered as _cs
from .ops import staggered as _st
from .ops import staggered_grad as _sg
from .ops.cuda_acoustic import matmul_full
from .ops.remat import segment_layout
from .utils.profiling import span

__all__ = ["elastic_fm_multi", "elastic_fwi_obj_multi", "ElasticFwiLoss",
           "model_vp_vs_rho", "EAGER", "reset_counters"]

# calls that took an eager route because the kernels do not take their
# geometry: objectives ("auto" -> "saved") and elastic_fm_multi
EAGER = {"objective": 0, "fm_multi": 0}

# the grid fields autograd saves a step of the elastic forward, by
# dimension: what one rebuilt segment of elastic_forward_seg holds a step
# (counted with torch.autograd.graph.saved_tensors_hooks, rounded up;
# tests/test_torch_elastic_routes.py holds the figures)
GRAPH_FIELDS_PER_STEP = {2: 14, 3: 23}
# the grid fields an eager route's shot holds besides its history or its
# segments: the reverse sweep's working set, the padded parameters and the
# graph around the loop, the gradients and the illumination
EAGER_FIELDS = 48


def reset_counters():
    for key in EAGER:
        EAGER[key] = 0


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


class _Setup:
    """Tables and operands every route of one elastic call needs on the
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
        self.s_idx, self.s_w, self.r_idx, self.r_w_np = s_idx, s_w, r_idx, r_w
        self.reason = _cs.unsupported_reason(model, s_idx, r_idx, src_wav,
                                             twins=dev.type == "cpu")
        self.dtype = torch.float32 if model.dtype == np.float32 \
            else torch.float64
        self.dev = dev
        self.nt = geometry.nt
        self.nsteps = self.nt - 1
        self.dt = float(model.critical_dt)
        self.src_wav = torch.as_tensor(np.asarray(src_wav, model.dtype),
                                       device=dev)
        self.damp = torch.as_tensor(_damp_field(model), device=dev)
        self.spacing = model.spacing
        self.space_order = model.space_order
        self.op_kw = dict(nt=self.nt, spacing=model.spacing,
                          space_order=model.space_order)

    def shot(self, i):
        """The eager operators' source arguments of shot i."""
        return self.src_wav, self.s_idx[i], self.s_w[i]


class _Tables(_Setup):
    """Tables, operands and layout one call of the kernels needs on the
    device."""

    def __init__(self, geometry, dev, shot_indices=None):
        super().__init__(geometry, dev, shot_indices)
        if dev.type == "cuda" and self.reason is not None:
            raise ValueError(f"elastic kernels on cuda: {self.reason} (the "
                             "objective's saved route takes such "
                             "geometries)")
        model = geometry.model
        self.nx, self.nz = model.padded_shape
        self.z0 = int(np.asarray(self.r_idx)[..., 1].min())
        self.r_w = torch.as_tensor(self.r_w_np, device=dev)
        self.W = _cs.zplane_weight_matrix(self.r_idx, self.r_w, self.nx,
                                          self.z0)
        self.kw = dict(nt=self.nt, nx=self.nx, nz=self.nz,
                       space_order=model.space_order, spacing=model.spacing,
                       z0=self.z0)

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


def _lame(vpp, vsp, rhp):
    """(lam, mu, b) of padded (vp, vs, rho)."""
    return rhp * (vpp * vpp - 2.0 * vsp * vsp), rhp * vsp * vsp, 1.0 / rhp


def elastic_fm_multi(geometry, device="cuda"):
    """Model all shots through ``elastic_segments`` in one batch, or shot by
    shot through the eager ``staggered.elastic_forward`` on a geometry the
    kernels do not take (counted in ``EAGER["fm_multi"]``); returns (rec1
    list, rec2 list) of PointSource gathers (tau_zz and div v)."""
    dev = _resolve_device(device)
    model = geometry.model
    st = _Setup(geometry, dev)
    lam, mu, b = (torch.as_tensor(x, device=dev)
                  for x in _lame(*model_vp_vs_rho(model)))
    if st.reason is not None:
        EAGER["fm_multi"] += 1
        _eager_warn(f"elastic: {st.reason}", "ops.staggered")
        recs = [_st.elastic_forward(lam, mu, b, st.damp, *st.shot(i),
                                    st.r_idx, st.r_w_np, st.dt, **st.op_kw)
                for i in range(geometry.nsrc)]
        r1, r2 = (torch.stack(r) for r in zip(*recs))
    else:
        tb = _Tables(geometry, dev)
        rows = _cs.elastic_segments(*_cs.stagger_params(lam, mu, b, tb.damp),
                                    tb.injT(0, geometry.nsrc),
                                    tb.wav_pad(tb.nsteps), tb.dt, **tb.kw)
        r1, r2 = _cs._stag_assemble(rows, tb.r_idx, tb.r_w, z0=tb.z0,
                                    nt=tb.nt, nsteps=tb.nsteps, nx=tb.nx)
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


def _kernel_images(tb, prm, lo, hi, seg, misfit, obs, dw):
    """The gradient kernels on shots lo..hi-1: (fvals, residuals, the five
    images (B, nx, nz) of ``elastic_grad_stream_segments``, illum (B, nx,
    nz))."""
    with span("fwi.forward"):
        rows, hist, illumT = _cs.elastic_fwd_hist_segments(
            *prm, tb.injT(lo, hi), tb.wav_pad(seg), tb.dt, seg=seg,
            **tb.kw)
    with span("fwi.misfit"):
        fvals, res = misfit(tb.traces(rows) - dw, obs - dw)
    with span("fwi.adjoint"):
        imgs = _cs.elastic_grad_stream_segments(
            *prm, hist, tb.res_rows(res, seg), tb.dt, seg=seg, **tb.kw)
        del hist
    return (fvals, res, tuple(g.transpose(1, 2) for g in imgs),
            illumT.transpose(1, 2))


def _kernel_grads(imgs, vpp, vsp, rhp, pads):
    """The five images of ``_kernel_images`` on the lam, mu and b grids,
    chain-ruled to (vp, vs, rho) and folded (``_finish``)."""
    glam, gmun, gmup, gb0, gb1 = imgs
    g_mu = gmun + _sg.avg_to_T(gmup, (0, 1), 2)
    g_b = _sg.avg_to_T(gb0, (0,), 2) + _sg.avg_to_T(gb1, (1,), 2)
    return _finish(glam, g_mu, g_b, vpp, vsp, rhp, pads)


def _eager_bytes_per_shot(st, calc_grad, kind, route, n_checkpoints):
    """Device bytes one shot of an eager chunk holds at its peak: its
    traces, residual and misfit, and ``EAGER_FIELDS`` grid fields (the
    reverse sweep's working set, the padded parameters and the outer
    graph, its gradients and illumination); on the saved route also its
    history (2 ndim fields a step); on the vjp route each segment's start
    (the 2 ndim + npairs state fields and the illumination) and one
    rebuilt segment's graph, ``GRAPH_FIELDS_PER_STEP`` saved fields a step
    (running it back holds no more). A trial holds the traces alone. A
    shot chunk's own peak on the card (H100, SMARM2, one shot; nt 1421 and
    401): saved 2.1206 and 0.6099 GB against 2.1364 and 0.6146 sized, vjp
    0.2871 and 0.1552 against 0.3231 and 0.1733
    (``tools/probe_eager_peaks.py``). Before its first chunk the call
    forms the illumination fix's receiver masks, (nrec, *shape) float64 at
    once, and frees them: its whole peak, 0.41-0.46 GB at SMARM2, is
    theirs and no shot's."""
    f = 4 if st.dtype == torch.float32 else 8
    field = int(np.prod(st.damp.shape)) * f
    ndim = st.damp.dim()
    nrec = st.r_idx.shape[0]
    traces = (2 + MISFIT_BYTES_PER_SAMPLE[kind] // f) * st.nt * nrec * f
    if not calc_grad:
        return traces
    if route == "saved":
        return (st.nsteps * 2 * ndim + EAGER_FIELDS) * field + traces
    seg, nseg = segment_layout(st.nsteps, n_checkpoints)
    state = 2 * ndim + ndim * (ndim - 1) // 2
    return ((nseg + 1) * (state + 1) + EAGER_FIELDS + seg * (
        GRAPH_FIELDS_PER_STEP[ndim])) * field + \
        traces


def _vjp_shots(forward, phys, pads, lo, hi, misfit, obs, dw, dtype):
    """The vjp route on shots lo..hi-1: ``forward(i, *padded)`` gives shot
    i's (traces, illumination) through a checkpointed forward of the
    edge-padded physical parameters ``phys``, the pad inside the graph.
    Each shot's forward, the chunk's batched misfit, each shot's
    ``torch.autograd.grad``. Returns (fvals, residuals, the physical
    gradients of each parameter (B, *shape), the illuminations (B,
    *grid))."""
    leaves, fwd = [], []
    with torch.enable_grad():
        for i in range(lo, hi):
            xs = [x.detach().clone().requires_grad_(True) for x in phys]
            fwd.append(forward(i, *(_pad_edge(x, pads) for x in xs)))
            leaves.append(xs)
    fvals, res = misfit(torch.stack([r.detach() for r, _ in fwd]) - dw,
                        obs - dw)
    res = res.to(dtype)
    grads, illums = [], []
    for j in range(hi - lo):
        rec, illum = fwd[j]
        grads.append(torch.autograd.grad(rec, leaves[j], res[j]))
        # free this shot's graph before the next reverse
        fwd[j] = leaves[j] = None
        illums.append(illum)
    return (fvals, res, tuple(torch.stack(g) for g in zip(*grads)),
            torch.stack(illums))


def _eager_chunk(st, route, phys, pads, shape, misfit, obs, dw, lo, hi,
                 calc_grad, n_checkpoints):
    """Shots lo..hi-1 on an eager route: (fvals, residuals, and on a
    gradient (g_vp, g_vs, g_rho) (B, *shape) and the cropped illumination
    (B, *shape)). Each shot's forward, the chunk's batched misfit, each
    shot's reverse."""
    pad = [_pad_edge(x, pads) for x in phys]
    lam, mu, b = _lame(*pad)
    args = (st.r_idx, st.r_w_np, st.dt)
    shots = range(lo, hi)
    if not calc_grad:
        with torch.no_grad():
            recs = [_st.elastic_forward(lam, mu, b, st.damp, *st.shot(i),
                                        *args, **st.op_kw)[0] for i in shots]
        fvals, res = misfit(torch.stack(recs) - dw, obs - dw)
        return fvals, res, None, None
    if route == "vjp":
        def forward(i, *padded):
            rec1, _, illum = _st.elastic_forward_seg(
                *_lame(*padded), st.damp, *st.shot(i), *args,
                n_checkpoints=n_checkpoints, **st.op_kw)
            return rec1, illum

        fvals, res, grads, illum = _vjp_shots(forward, phys, pads, lo, hi,
                                              misfit, obs, dw, st.dtype)
        return fvals, res, grads, _crop(illum, pads, shape)
    fwd = [_sg.elastic_forward_hist(lam, mu, b, st.damp, *st.shot(i), *args,
                                    **st.op_kw) for i in shots]
    fvals, res = misfit(torch.stack([f[0] for f in fwd]) - dw, obs - dw)
    res = res.to(st.dtype)
    grads, illums = [], []
    for j in range(hi - lo):
        _, illum, hist = fwd[j]
        glam, g_mu, g_b = _sg.elastic_adjoint_from_hist(
            lam, mu, b, st.damp, st.r_idx, st.r_w_np, res[j], hist, st.dt,
            **st.op_kw)
        grads.append(_finish(glam, g_mu, g_b, *pad, pads))
        # free this shot's history before the next reverse
        fwd[j] = None
        illums.append(_crop(illum, pads, shape))
    return (fvals, res, tuple(torch.stack(g) for g in zip(*grads)),
            torch.stack(illums))


def _resolve_route(grad_route, reason):
    """"kernels", "saved" or "vjp" for ``grad_route`` on a geometry the
    kernels refuse for ``reason`` (None: they take it)."""
    if grad_route not in (None, "auto", "pallas", "saved", "vjp"):
        raise ValueError(f"grad_route={grad_route!r}: expected 'auto', "
                         "'pallas', 'saved' or 'vjp'")
    if grad_route in ("saved", "vjp"):
        return grad_route
    if reason is None:
        return "kernels"
    if grad_route == "pallas":
        raise ValueError(f"grad_route='pallas': the elastic kernels do not "
                         f"take this geometry ({reason})")
    EAGER["objective"] += 1
    _eager_warn(f"elastic: {reason}", "ops.staggered_grad")
    return "saved"


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
    kernels (their twins on the CPU) where they take the geometry, and
    "auto" runs "saved" elsewhere; "saved" the eager saved-history route;
    "vjp" autograd through the checkpointed forward, whose segments
    ``n_checkpoints`` sets (<= 0: about sqrt(nt))."""
    dev = _resolve_device(device)
    fval, grads, illum, residuals = _elastic_sums(
        geometry, obs, misfit_func, direct_wave, calc_grad, vp, vs, rho,
        shot_chunk, n_checkpoints, shot_indices, illum_fix, grad_route, dev)
    with span("fwi.finish"):
        if not calc_grad:
            return float(fval), None, residuals
        return float(fval), _finish_grads(grads, illum, precond, mask,
                                          ("vp", "vs", "rho")), residuals


def _finish_grads(grads, illum, precond, mask, names):
    """The illumination precondition and the mask of the gradient sums on
    the device: {name: float64 numpy}."""
    if precond:
        scale = 1.0 / torch.sqrt(illum + 1e-30)
        grads = tuple(g * scale for g in grads)
    if mask is not None:
        m = torch.as_tensor(np.asarray(mask), dtype=torch.float64,
                            device=illum.device)
        grads = tuple(g * m for g in grads)
    return {name: g.cpu().numpy() for name, g in zip(names, grads)}


def _elastic_sums(geometry, obs, misfit_func, direct_wave, calc_grad, vp,
                  vs, rho, shot_chunk, n_checkpoints, shot_indices,
                  illum_fix, grad_route, dev):
    """``elastic_fwi_obj_multi`` before the precondition: (fval, the three
    gradient sums, illum sum, residuals), the sums fixed and float64 on
    ``dev`` (None without ``calc_grad``)."""
    with span("fwi.prepare"):
        model = geometry.model
        misfit, kind = _misfit_batch(misfit_func)
        st = _Setup(geometry, dev, shot_indices)
        route = _resolve_route(grad_route, st.reason)
        if route == "kernels":
            tb = st = _Tables(geometry, dev, shot_indices)
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
        phys = [param(u, f)
                for u, f in ((vp, mvp), (vs, mvs), (rho, mrho))]
        vpp, vsp, rhp = (_pad_edge(x, pads) for x in phys)
        if route == "kernels":
            prm = _cs.stagger_params(*_lame(vpp, vsp, rhp), tb.damp)

        obs_stack = _device_stack(obs, dev)
        if obs_stack.shape[1] != st.nt:
            raise ValueError(
                "observed data has %d time samples but the geometry's time "
                "axis has %d" % (obs_stack.shape[1], st.nt))
        if direct_wave is not None:
            dw_stack = _device_stack(direct_wave, dev)
        if shot_indices is not None:
            sel = torch.as_tensor(np.asarray(shot_indices, dtype=np.int64),
                                  device=dev)
            obs_stack = obs_stack[sel]
            if direct_wave is not None:
                dw_stack = dw_stack[sel]
        nsrc = st.s_idx.shape[0]
        per_shot = _bytes_per_shot(tb, calc_grad, kind) \
            if route == "kernels" else _eager_bytes_per_shot(
                st, calc_grad, kind, route, n_checkpoints)
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
        if route != "kernels":
            fvals, res, gs, il = _eager_chunk(
                st, route, phys, pads, shape, misfit, obs_c, dw, lo, hi,
                calc_grad, n_checkpoints)
        elif not calc_grad:
            with span("fwi.forward"):
                rows = _cs.elastic_segments(*prm, tb.injT(lo, hi),
                                            tb.wav_pad(tb.nsteps), tb.dt,
                                            **tb.kw)
            with span("fwi.misfit"):
                fvals, res = misfit(tb.traces(rows[:, :, :, 0]) - dw,
                                    obs_c - dw)
        else:
            # the history as one segment of all the steps, as the modeling
            # sweep's: on the card the segment is only a layout, and one
            # segment pads nothing
            fvals, res, imgs, il = _kernel_images(
                tb, prm, lo, hi, tb.nsteps, misfit, obs_c, dw)
        with span("fwi.misfit"):
            fval = fval + torch.sum(fvals)
            residuals.append(res)
        if not calc_grad:
            continue
        with span("fwi.imaging"):
            if route == "kernels":
                gs = _kernel_grads(imgs, vpp, vsp, rhp, pads)
                il = _crop(il, pads, shape)
            keep, rec_prod = factors(lo, hi)
            fix = keep * rec_prod if illum_fix else 1.0
            gs = tuple(torch.sum(g.double() * fix, dim=0) for g in gs)
            il = torch.sum(il.double() * fix, dim=0)
            grads = gs if grads is None else tuple(a + g for a, g in
                                                   zip(grads, gs))
            illum = il if illum is None else illum + il
    return fval, grads, illum, ResidualStack(residuals)


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
        with span("fwi.prepare"):
            shape = geometry.model.shape
            vp = 1.0 / np.sqrt(x.reshape(shape))
            vp_model = vp.astype(geometry.model.dtype)
        fval, grads, residuals = elastic_fwi_obj_multi(
            geometry, obs, misfit_func, direct_wave, mask, precond,
            calc_grad, vp=vp_model, vs=self.vs,
            rho=self.rho, shot_chunk=self.shot_chunk,
            n_checkpoints=self.n_checkpoints, shot_indices=shot_indices,
            device=self.device)
        with span("fwi.finish"):
            if not calc_grad:
                return fval, None, residuals
            g = grads["vp"] * (-0.5 * vp ** 3)
            return fval, g.reshape(-1).astype(np.float64), residuals
