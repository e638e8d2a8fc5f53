"""FWI objective layer on torch: multi-shot modeling, the L2 and
quadratic-Wasserstein misfits and the adjoint-state gradient of the 2-D
and 3-D acoustic wave equation.

Port of the acoustic routes of ``devito_fwi_tpu.fwi``. ``fm_single`` and
``fwi_obj_single`` run one shot through ``ops.wavesolver.AcousticWaveSolver``
(the eager operators of ``ops.acoustic``), as the JAX ones do.
``fm_multi``, ``fwi_obj_multi`` and ``fwi_loss`` keep their signatures and
add ``device``: "cuda" (the default) runs the CUDA kernels of
``ops.cuda_acoustic`` (3-D: ``ops.cuda_acoustic3d`` and
``ops.cuda_acoustic3``; and ``ops.cuda_bfm`` inside the W2-2d misfit)
and raises when no card is present; "cpu" runs their plain torch twins.
One 2-D gradient evaluation of a shot chunk is

1. the batched forward: ``forward_dt2_segments`` records the receiver
   rows, streams the d2u/dt2 history and sums the illumination; on the
   checkpoint route ``forward_ckpt_segments`` keeps the segment-start
   pairs instead of the history;
2. ``_traces_from_rows``, then the batched misfit of the gathers after
   direct-wave subtraction (``least_square``, ``qWasserstein`` 1d or 2d),
   whose gradient is the residual;
3. ``residual_rows``;
4. the adjoint sweep: ``gradient_stream_segments`` over the history, or
   ``gradient_segments``, which recomputes each segment's history from its
   pair (the same gradient, bitwise);
5. the per-shot crop and source/receiver illumination fix, summed over
   shots,

and the illumination precondition and the mask follow on the device, so
one field comes back to the host. Line-search trials and forward modeling
run ``forward_rec_segments``. The explicit adjoint sweep is the gradient:
no autograd is involved. ``stream`` picks the route: None streams when one
shot's history fits ``_device_budget``, 80% of the largest block the
caching allocator can hand out.

Host misfits take the host-misfit path (``fwi_obj_multi`` picks it, as the
JAX package does): misfits the device does not compute (custom numpy
callables, ``qWasserstein`` 2-D on the native C++ solver) and trace
resampling (``resample_dt`` other than ``geometry.dt``). The sweeps stay on
the device, through the same kernels; only the gathers and the residuals
cross to the host, once per shot chunk.

3-D geometries (counterpart of the JAX package's ``_shots_fused_pallas3``
and saved-history route) run ``_shot_objective3``: by default the streamed
pair of ``ops.cuda_acoustic3d`` (``forward_dt2_stream3`` with the receiver
slabs, the traces, the batched misfit, ``residual_slabs3``,
``gradient_stream3``, then the crop and illumination fix per shot);
``saved3=True`` takes the saved-history route instead (the eager
``ops.acoustic.forward(save=True)`` and ``gradient(with_illum=True)`` with
the receiver-slab injection, stepped by the CUDA step kernel of
``ops.cuda_acoustic3``). Trials and ``fm_multi`` run ``forward_rec3``.

Not ported yet (raises ``NotImplementedError``): geometries the kernels do
not take (receivers off two adjacent z-planes, 3-D sources off the y grid,
and on cuda a saved-route grid the step kernel does not take: a free
surface, float64, a padded nx ``pick_xb`` does not block; ROADMAP.md queue
A item 4, which runs them on the eager operators), and a 3-D checkpoint
route (``stream=False``).
"""
from __future__ import annotations

import numpy as np
import torch
from scipy import interpolate

from .misfit.w2 import least_square, least_square_torch
from .models.geometry import AcquisitionGeometry
from .models.sources import PointSource
from .ops import acoustic as _ac
from .ops import cuda_acoustic as _ca
from .ops import cuda_acoustic3 as _c3
from .ops import cuda_acoustic3d as _c3d
from .ops.acoustic import _ckpt_layout
from .ops.interp import interp_table
from .ops.wavesolver import AcousticWaveSolver
from .utils.filters import bandpass, highpass, lowpass

__all__ = ["seismic_filter", "Filter", "resample", "fm_single", "fm_multi",
           "fix_source_illumination", "fwi_obj_single", "fwi_obj_multi",
           "fwi_loss", "ResidualStack"]


def _resolve_device(device):
    """The torch device for an entry point: "cuda" needs a card (no
    silent fall-back to the CPU), "cpu" runs the plain twins."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch sees no CUDA device; pass "
            "device='cpu' to run the plain torch twins")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev}: expected cuda or cpu")
    return dev


# ---------------------------------------------------------------------------
# filters / resampling (reference fwi.py:10-57)
# ---------------------------------------------------------------------------

def seismic_filter(data, filter_type, freqmin=None, freqmax=None, df=None,
                   corners=16, zerophase=False, axis=-1):
    filter_type = filter_type.lower()
    assert filter_type in ("bandpass", "lowpass", "highpass")
    if filter_type == "bandpass":
        if freqmin and freqmax and df:
            return bandpass(data, freqmin, freqmax, df, corners, zerophase,
                            axis)
        raise ValueError
    if filter_type == "lowpass":
        if freqmax and df:
            return lowpass(data, freqmax, df, corners, zerophase, axis)
        raise ValueError
    if filter_type == "highpass":
        if freqmin and df:
            return highpass(data, freqmin, df, corners, zerophase, axis)
        raise ValueError


class Filter:
    def __init__(self, filter_type, freqmin=None, freqmax=None, df=None,
                 corners=10, zerophase=False, axis=-1):
        self.filter_type = filter_type
        self.freqmin = freqmin
        self.freqmax = freqmax
        self.df = df
        self.corners = corners
        self.zerophase = zerophase
        self.axis = axis

    def __call__(self, data):
        return seismic_filter(data, self.filter_type, self.freqmin,
                              self.freqmax, self.df, self.corners,
                              self.zerophase, self.axis)


def resample(x, t, t0, order=3):
    """Spline trace resampling from time axis t0 to t
    (reference ``fwi.py:47-57``)."""
    dt = t[1] - t[0]
    dt0 = t0[1] - t0[0]
    if np.isclose(dt, dt0):
        return x
    nsamples, ntraces = x.shape
    new_x = np.zeros((t.size, ntraces), dtype=np.float32)
    for i in range(ntraces):
        tck = interpolate.splrep(t0, x[:, i], k=order)
        new_x[:, i] = interpolate.splev(t, tck)
    return new_x


# ---------------------------------------------------------------------------
# tables and operands
# ---------------------------------------------------------------------------

def _shot_geometry(geometry, i):
    # propagation steps at the model's critical dt (_solver_dt), so the
    # per-shot geometry deliberately does not carry a resampled dt
    return AcquisitionGeometry(geometry.model, geometry.rec_positions,
                               geometry.src_positions[i, :], geometry.t0,
                               geometry.tn, f0=geometry.f0,
                               src_type=geometry.src_type,
                               a=geometry._a, t0w=geometry._t0w,
                               src_data=geometry._src_data,
                               filter=geometry._filter)


def _batched_tables(geometry):
    """Per-shot source tables + shared receiver table + wavelet (numpy)."""
    model = geometry.model
    s_idx, s_w = interp_table(geometry.src_positions, model.origin_pml,
                              model.spacing, dtype=model.dtype)
    # (nsrc, 2^d, d) -> one point per shot -> (nsrc, 1, 2^d, d)
    s_idx = s_idx[:, None]
    s_w = s_w[:, None]
    r_idx, r_w = interp_table(geometry.rec_positions, model.origin_pml,
                              model.spacing, dtype=model.dtype)
    src_wav = _shot_geometry(geometry, 0).src.data  # (nt, 1); same per shot
    return s_idx, s_w, r_idx, r_w, src_wav


def _solver_dt(geometry):
    return geometry.model.critical_dt


def _pads(model):
    return tuple(tuple(p) for p in model.padsizes)


def _crop(field, pads, shape):
    """Crop the trailing padded-grid axes of ``field`` to the physical
    domain."""
    slc = tuple(slice(lo, lo + n) for (lo, _), n in zip(pads, shape))
    return field[(Ellipsis,) + slc]


def _default_checkpoints(nt):
    """sqrt(nt) segments: the layout of the steps; the checkpoint route
    keeps one pair per segment and recomputes one segment at a time."""
    return max(4, int(np.sqrt(max(nt - 2, 1))))


def _damp(model, dev):
    """model.damp (padded array, or a scalar when nbl = 0) as a tensor."""
    return torch.as_tensor(np.asarray(model.damp, dtype=model.dtype),
                           device=dev)


class _Setup:
    """Everything one modeling or objective call needs on the device."""

    def __init__(self, geometry, dev):
        model = geometry.model
        if model.dim != 2 or not _ca.geometry_supported(geometry):
            raise NotImplementedError(
                "only 2-D geometries with all receivers on two adjacent "
                "z-planes run on the port so far (3-D and general receiver "
                "layouts: ROADMAP.md queue A item 4)")
        self.s_idx, self.s_w, self.r_idx, r_w, src_wav = \
            _batched_tables(geometry)
        self.z0 = int(self.r_idx[..., 1].min())
        self.nt = geometry.nt
        self.dt = float(_solver_dt(geometry))
        self.nsteps, self.seg, self.nseg = _ckpt_layout(
            self.nt, _default_checkpoints(self.nt))
        nx, nz = model.padded_shape
        self.nx, self.nz = nx, nz
        vp = torch.as_tensor(np.asarray(model.vp), device=dev)
        self.m = 1.0 / (vp * vp)
        self.mT = self.m.T.contiguous()
        hd = torch.broadcast_to(self.dt * _damp(model, dev), vp.shape)
        self.hdT = hd.T.contiguous()
        self.wav_pad = _ca.pad_wavelet(torch.as_tensor(src_wav, device=dev),
                                       self.nt, self.nseg * self.seg)
        self.r_w = torch.as_tensor(r_w, device=dev)
        self.W = _ca.receiver_plane_matrix(self.r_idx, self.r_w, self.z0,
                                           nx).T.contiguous()
        self.kw = dict(nt=self.nt, nx=nx, nz=nz,
                       space_order=model.space_order, spacing=model.spacing,
                       z0=self.z0, n_checkpoints=_default_checkpoints(
                           self.nt), fs=model.fs)

    def injT(self, lo, hi):
        """Transposed source patterns (hi-lo, nz, nx) of shots lo..hi-1."""
        inj = _ca.source_pattern(self.s_idx[lo:hi], self.s_w[lo:hi], self.m,
                                 self.dt * self.dt)
        return inj.transpose(-1, -2).contiguous()

    def traces(self, rec_rows):
        return _traces_from_rows(rec_rows, self.W, self.nt, self.nsteps)


class _Setup3:
    """A 3-D modeling or objective call's operands on the device: the
    streamed kernels' transposed (ny, nz, nx) model, the wavelet and the
    receiver tables. Raises for a geometry the kernels do not take."""

    def __init__(self, geometry, dev):
        model = geometry.model
        reason = _c3d.unsupported_reason(geometry)
        if reason is not None:
            raise NotImplementedError(
                f"the 3-D kernels do not take this geometry: {reason} "
                "(ROADMAP.md queue A item 4)")
        self.s_idx, self.s_w, self.r_idx, r_w, src_wav = \
            _batched_tables(geometry)
        self.z0 = int(self.r_idx[..., 2].min())
        self.nt = geometry.nt
        self.nsteps = self.nt - 2
        self.dt = float(_solver_dt(geometry))
        self.vp = torch.as_tensor(np.asarray(model.vp), device=dev)
        self.damp = _damp(model, dev)
        self.m = 1.0 / (self.vp * self.vp)
        self.m3 = self.m.permute(1, 2, 0).contiguous()
        hd = torch.broadcast_to(self.dt * self.damp, self.vp.shape)
        self.hd3 = hd.permute(1, 2, 0).contiguous()
        self.src_wav = torch.as_tensor(src_wav, device=dev)
        self.r_w_np = r_w
        self.r_w = torch.as_tensor(r_w, device=dev)
        self.kw = dict(nt=self.nt, space_order=model.space_order,
                       spacing=model.spacing, z0=self.z0, fs=model.fs)

    def planes(self, lo, hi):
        """(wavelet (hi-lo, nsteps), source planes, their y-planes) of
        shots lo..hi-1."""
        injp, iy = _c3d.source_planes3(self.s_idx[lo:hi], self.s_w[lo:hi],
                                       self.m, self.dt * self.dt)
        wav = self.src_wav[1:self.nt - 1, 0].expand(hi - lo, -1).contiguous()
        return wav, injp, iy

    def traces(self, rec_slab):
        return _c3d.traces_from_slabs3(rec_slab, self.r_idx, self.r_w,
                                       self.m, self.z0, self.nt)


def _traces_from_rows(rec_rows, W, nt, nsteps):
    """Receiver rows (B, nseg, seg, 2, nx) -> traces (B, nt, nrec):
    rec[1+g] = sum_c w_c * row[g, plane_c, x_c] as one product against the
    scattered (2*nx, nrec) weights ``W`` at full f32; rows beyond nsteps
    are layout padding."""
    B = rec_rows.shape[0]
    nx = rec_rows.shape[-1]
    rows = rec_rows.reshape(B, -1, 2 * nx)[:, :nsteps]
    tr = _ca.matmul_full(rows, W)
    rec = rec_rows.new_zeros((B, nt, W.shape[1]))
    rec[:, 1:nsteps + 1] = tr
    return rec


def _illum_fix_factors(src_pos, rec_positions, spacing, shape, dev):
    """Gaussian-mask factors of the source/receiver illumination fix
    (reference ``fwi.py:104-129``, 2-D, its meshgrid axis convention kept):
    (1 - source mask) per shot (B, nx, nz) and the product of (1 - receiver
    mask) over receivers (nx, nz), in float64."""
    dx, dz = spacing
    nx, nz = shape
    f64 = torch.float64
    x = torch.arange(0, nx, dtype=f64, device=dev) * dx
    z = torch.arange(0, nz, dtype=f64, device=dev) * dz
    # reference quirk preserved: meshgrid(z, x) -> xx holds z-values
    xx, zz = torch.meshgrid(z, x, indexing="xy")
    sigma = dx + dz
    sp = torch.as_tensor(np.asarray(src_pos), dtype=f64, device=dev)
    sx, sz = sp[:, 0, None, None], sp[:, 1, None, None]
    smask = torch.exp(-.5 * ((xx - sx) ** 2 + (zz - sz) ** 2) / sigma ** 2)
    rp = torch.as_tensor(np.asarray(rec_positions), dtype=f64, device=dev)
    rx, rz = rp[:, 0, None, None], rp[:, 1, None, None]
    rmasks = torch.exp(-.5 * ((xx[None] - rx) ** 2 + (zz[None] - rz) ** 2)
                       / sigma ** 2)
    return 1. - smask, torch.prod(1. - rmasks, dim=0)


class _IllumFix3:
    """The 3-D source/receiver illumination fix (the 3-D branch of the JAX
    package's ``_fix_illum_jax``, same Gaussian masks with sigma = dx + dz),
    in float64: ``keep(p)`` is 1 - the source mask of a source at p, and
    ``rec_prod`` the product of (1 - receiver mask) taken over the
    receivers one at a time."""

    def __init__(self, rec_positions, spacing, shape, dev):
        f64 = torch.float64
        axes = [torch.arange(n, dtype=f64, device=dev) * h
                for n, h in zip(shape, spacing)]
        self.grid = torch.meshgrid(*axes, indexing="ij")
        self.inv2s2 = -.5 / (spacing[0] + spacing[2]) ** 2
        prod = torch.ones(tuple(shape), dtype=f64, device=dev)
        for p in np.asarray(rec_positions, np.float64):
            prod = prod * (1. - self._gauss(p))
        self.rec_prod = prod

    def _gauss(self, p):
        xx, yy, zz = self.grid
        return torch.exp(((xx - p[0]) ** 2 + (yy - p[1]) ** 2
                          + (zz - p[2]) ** 2) * self.inv2s2)

    def keep(self, src_pos):
        """(B, nx, ny, nz) of 1 - source mask, one per source position."""
        return torch.stack([1. - self._gauss(p)
                            for p in np.asarray(src_pos, np.float64)])


class ResidualStack:
    """List-like view of the per-shot residual gathers: the chunks stay on
    the device and are copied to the host once, only if a caller indexes
    them (e.g. ``minimize.save_residual``)."""

    def __init__(self, stacks):
        self._stacks = list(stacks)  # (chunk, nt, nrec) tensors
        self._host = None

    def _materialize(self):
        if self._host is None:
            self._host = torch.cat(self._stacks).cpu().numpy()
        return self._host

    def __len__(self):
        return sum(int(s.shape[0]) for s in self._stacks)

    def __getitem__(self, i):
        return self._materialize()[i]

    def __iter__(self):
        return iter(self._materialize())


_DEVICE_STACK_CACHE = {}


def _device_stack(objs, dev):
    """Stack shot records on the device once and reuse the copy across
    objective calls (obs and direct-wave data are constant through an
    inversion). Entries keep strong references to the records, so a
    recycled id() cannot alias freed objects. The gathers are not
    content-hashed: build new records rather than editing ``data`` in
    place between calls."""
    key = (tuple(id(o) for o in objs), str(dev))
    entry = _DEVICE_STACK_CACHE.get(key)
    if entry is not None and all(a is b for a, b in zip(entry[0], objs)):
        return entry[1]
    st = torch.as_tensor(np.stack([np.asarray(o.data) for o in objs]),
                         device=dev)
    while len(_DEVICE_STACK_CACHE) >= 8:
        del _DEVICE_STACK_CACHE[next(iter(_DEVICE_STACK_CACHE))]
    _DEVICE_STACK_CACHE[key] = (tuple(objs), st)
    return st


# ---------------------------------------------------------------------------
# forward modeling (reference fwi.py:59-102)
# ---------------------------------------------------------------------------

def fm_single(geometry, save=False, device="cuda"):
    """Model one shot through ``AcousticWaveSolver`` (the eager operators);
    returns (rec PointSource, wavefield ``Wavefield`` on the device)."""
    solver = AcousticWaveSolver(geometry.model, geometry,
                                space_order=geometry.model.space_order,
                                device=device)
    rec, u, _ = solver.forward(vp=geometry.model.vp, save=save)
    return rec, u


def fm_multi(geometry, save=False, device="cuda"):
    """Model all shots of ``geometry`` in one batch through
    ``forward_rec_segments`` (3-D: ``forward_rec3``); returns a list of
    PointSource shot records.
    ``save`` is accepted for signature parity and changes nothing (the
    reference's ``fm_multi`` discards the saved wavefield too)."""
    dev = _resolve_device(device)
    model = geometry.model
    if model.dim == 3:
        st = _Setup3(geometry, dev)
        rec_all = st.traces(_c3d.forward_rec3(
            st.m3, st.hd3, *st.planes(0, geometry.nsrc), st.dt,
            **st.kw)).cpu().numpy()
    else:
        st = _Setup(geometry, dev)
        rec_rows = _ca.forward_rec_segments(st.mT, st.hdT, st.wav_pad,
                                            st.injT(0, geometry.nsrc),
                                            st.dt, **st.kw)
        rec_all = st.traces(rec_rows).cpu().numpy()
    shots = []
    for i in range(geometry.nsrc):
        shot = PointSource(name="rec", time_range=geometry.time_axis,
                           coordinates=geometry.rec_positions,
                           dtype=model.dtype)
        shot.data[:] = rec_all[i]
        shots.append(shot)
    return shots


# ---------------------------------------------------------------------------
# objective + gradient (reference fwi.py:131-246)
# ---------------------------------------------------------------------------

def fix_source_illumination(geometry, g):
    """Gaussian-mask damping of a one-shot field ``g`` (the physical grid)
    at the source and receiver locations (reference ``fwi.py:104-129``,
    its meshgrid axis convention kept), in float64 on the host."""
    if geometry.src_positions.shape[0] > 1:
        raise ValueError("Only single source valid.")
    model = geometry.model
    cpu = torch.device("cpu")
    g = torch.as_tensor(np.asarray(g, np.float64))
    if model.dim == 3:
        fix = _IllumFix3(geometry.rec_positions, model.spacing, model.shape,
                         cpu)
        return (g * fix.keep(geometry.src_positions)[0]
                * fix.rec_prod).numpy()
    keep_src, rec_prod = _illum_fix_factors(
        geometry.src_positions, geometry.rec_positions, model.spacing,
        model.shape, cpu)
    return (g * keep_src[0] * rec_prod).numpy()


def fwi_obj_single(geometry, obs, misfit_func, direct_wave=None,
                   resample_dt=None, calc_grad=False, device="cuda"):
    """Single-shot objective through ``AcousticWaveSolver`` (API parity
    with reference ``fwi.py:131-173``), with trace resampling for the
    misfit when ``resample_dt`` is given. ``misfit_func(syn, obs)`` takes
    and returns host arrays. Returns (fval, cropped gradient, residual
    data, cropped illumination); the last three None-free only with
    ``calc_grad`` (the residual always)."""
    from copy import deepcopy
    solver = AcousticWaveSolver(geometry.model, geometry,
                                space_order=geometry.model.space_order,
                                device=device)
    pred, wfd, _ = solver.forward(vp=geometry.model.vp, save=calc_grad)
    if resample_dt is not None:
        obs = deepcopy(obs).resample(resample_dt)
        pred = pred.resample(resample_dt)
        if direct_wave is not None:
            direct_wave = deepcopy(direct_wave).resample(resample_dt)
    syn_data = pred.data
    obs_data = obs.data
    if direct_wave is not None:
        syn_data = syn_data - direct_wave.data
        obs_data = obs_data - direct_wave.data
    fval, residual_data = misfit_func(syn_data, obs_data)

    residual = PointSource(name="rec", time_range=geometry.time_axis,
                           coordinates=geometry.rec_positions,
                           dtype=geometry.model.dtype)
    residual.data[:] = resample(np.asarray(residual_data),
                                geometry.time_axis.time_values,
                                pred.time_values)[:]
    illum, crop_grad = None, None
    if calc_grad:
        grad, _ = solver.jacobian_adjoint(residual, wfd,
                                          vp=geometry.model.vp)
        pads, shp = _pads(geometry.model), geometry.model.shape
        crop_grad = fix_source_illumination(geometry,
                                            _crop(grad, pads, shp))
        illum = (wfd.data * wfd.data).sum(dim=0).cpu().numpy()
        illum = fix_source_illumination(geometry, _crop(illum, pads, shp))
    return fval, crop_grad, residual.data, illum



# Device bytes the batched misfit holds per gather sample (nt x nrec) of
# one shot at its peak: torch.cuda.max_memory_allocated around the misfit
# of the 29 SMARMN gathers on an H100 (chip_smoke.py phase 9) gave 16.3,
# 79.5 and 391.5; rounded up, 2d with room for the banded pushforward
# tier's one-hot operands (~32 more).
MISFIT_BYTES_PER_SAMPLE = {"least_square": 32, "1d": 96, "2d": 512}


def _misfit_batch(misfit_func):
    """(batched torch misfit of (B, nt, nrec) gathers -> (fvals, residual
    = d misfit / d syn), key of MISFIT_BYTES_PER_SAMPLE)."""
    if misfit_func is None or misfit_func is least_square:
        return least_square_torch, "least_square"
    if not hasattr(misfit_func, "torch_batch"):
        raise NotImplementedError(
            f"misfit {misfit_func!r} has no batched torch form; only the "
            "acoustic objective (fwi.fwi_obj_multi) runs host misfits")
    return misfit_func.torch_batch, getattr(misfit_func, "method", "2d")


def _host_misfit(misfit_func, resample_dt, geometry):
    """True when the misfit runs on the host (the JAX package's host-misfit
    cases): trace resampling, the native 2-D solver, and any misfit without
    a batched torch form."""
    if resample_dt not in (None, geometry.dt):
        return True
    if getattr(misfit_func, "method", None) == "2d" and \
            getattr(misfit_func, "bfm_backend", None) == "native":
        return True
    return not (misfit_func is None or misfit_func is least_square
                or hasattr(misfit_func, "torch_batch"))


def _host_misfit_batch(misfit_func, syn_batch, obs_batch):
    """A host misfit over a (chunk, nt, nrec) batch: the misfit's ``batch``
    entry point when it has one (the native solver's OpenMP batch), else one
    call per shot."""
    batch_fn = getattr(misfit_func, "batch", None)
    if batch_fn is not None:
        losses, res = batch_fn(syn_batch, obs_batch)
        return [float(v) for v in losses], list(res)
    fvals, residuals = [], []
    for syn, ob in zip(syn_batch, obs_batch):
        f_i, res_i = misfit_func(syn, ob)
        fvals.append(float(f_i))
        residuals.append(np.asarray(res_i))
    return fvals, residuals


def _host_misfit_chunk(geometry, rec_host, obs, misfit_func, direct_wave,
                       resample_dt, lo, hi):
    """Host misfit of shots [lo, hi): direct-wave subtraction, optional
    trace resampling to ``resample_dt`` and back, the (batched) misfit.
    ``rec_host`` holds the chunk's synthetic gathers (hi-lo, nt, nrec).
    Returns (fval sum, [residuals at the geometry's dt])."""
    model = geometry.model
    tvals = geometry.time_axis.time_values
    syn_b, obs_b = [], []
    t_m = tvals
    for i in range(lo, hi):
        syn = rec_host[i - lo]
        ob = np.asarray(obs[i].data)
        t_m = tvals
        if resample_dt is not None and \
                not np.isclose(resample_dt, geometry.dt):
            n_new = int(round((tvals[-1] - tvals[0]) / resample_dt)) + 1
            t_m = np.linspace(tvals[0], tvals[0]
                              + (n_new - 1) * resample_dt, n_new)
            syn = resample(syn, t_m, tvals)
            ob = resample(ob, t_m, tvals)
        if direct_wave is not None:
            dw = np.asarray(direct_wave[i].data)
            if t_m is not tvals:
                dw = resample(dw, t_m, tvals)
            syn = syn - dw
            ob = ob - dw
        syn_b.append(syn)
        obs_b.append(ob)
    fvals_c, res_c = _host_misfit_batch(misfit_func, np.stack(syn_b),
                                        np.stack(obs_b))
    residuals = []
    for res_i in res_c:
        res_i = np.asarray(res_i)
        if t_m is not tvals:
            res_i = resample(res_i, tvals, t_m)
        residuals.append(res_i.astype(model.dtype))
    return sum(fvals_c), residuals


def _device_budget(dev):
    """80% of the largest single block the caching allocator can hand out:
    the card's free memory plus the cached segments no live tensor holds
    (the allocator returns those to the card before an allocation fails),
    or the largest unused block of a segment a live tensor holds, whichever
    is larger. The allocator's cached total would overstate it: a small
    live tensor placed in a freed history's block pins the whole segment."""
    free, _ = torch.cuda.mem_get_info(dev)
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    releasable = held = 0
    for seg in torch.cuda.memory_snapshot():
        if seg["device"] != index:
            continue
        unused = [b["size"] for b in seg["blocks"] if b["state"] == "inactive"]
        if len(unused) == len(seg["blocks"]):
            releasable += seg["total_size"]
        elif unused:
            held = max(held, max(unused))
    return int(0.8 * max(free + releasable, held))


def _shots_per_batch(nsrc, shot_chunk, per_shot, budget):
    """Shots per batch: all, or fewer when ``shot_chunk`` asks for it or
    ``per_shot`` bytes each would not fit ``budget`` (None: no limit); at
    least one shot, and the batches as even as possible."""
    chunk = min(nsrc, shot_chunk or nsrc)
    if budget is not None:
        chunk = min(chunk, max(1, budget // max(per_shot, 1)))
    return -(-nsrc // -(-nsrc // chunk))


def _route(nsrc, shot_chunk, calc_grad, stream, st, dev, itemsize,
           misfit_bytes):
    """(shots per batch, stream). A gradient streams the history when
    ``stream`` is True, or when it is None and one shot's history and
    misfit fit ``_device_budget``; otherwise it takes the checkpoint route,
    which holds the segment pairs and one segment's history per shot. The
    batch is ``_shots_per_batch`` of the route's per-shot memory (at least
    one shot: nothing holds less than the checkpoint route)."""
    if dev.type != "cuda":
        return _shots_per_batch(nsrc, shot_chunk, 0, None), \
            stream is not False
    budget = _device_budget(dev)
    field = st.nz * st.nx * itemsize
    hist = st.nseg * st.seg * field + misfit_bytes
    if calc_grad and stream is None:
        stream = hist <= budget
    if not calc_grad:
        per_shot = misfit_bytes
    elif stream:
        per_shot = hist
    else:
        per_shot = (2 * st.nseg + st.seg) * field + misfit_bytes
    return _shots_per_batch(nsrc, shot_chunk, per_shot, budget), bool(stream)


def _shot_objective(geometry, misfit_chunk, kind, calc_grad, shot_chunk,
                    sel, stream, dev, saved3=False):
    """Batched objective over the shots ``sel`` (None: all).
    ``misfit_chunk(syn, lo, hi)`` takes the synthetic traces (hi-lo, nt,
    nrec) of the selected shots lo..hi-1 on the device and returns (their
    misfit, the residual on the device); ``kind`` keys its memory in
    MISFIT_BYTES_PER_SAMPLE. Returns (fval, grad sum, illum sum (both
    cropped, fixed, float64, or None), residuals)."""
    model = geometry.model
    if model.dim == 3:
        return _shot_objective3(geometry, misfit_chunk, kind, calc_grad,
                                shot_chunk, sel, stream, dev, saved3)
    if saved3:
        raise ValueError("saved3 picks a 3-D gradient route; this model is "
                         f"{model.dim}-D")
    st = _Setup(geometry, dev)
    src_pos = np.asarray(geometry.src_positions)
    if sel is not None:
        st.s_idx, st.s_w = st.s_idx[sel], st.s_w[sel]
        src_pos = src_pos[sel]
    nsrc = st.s_idx.shape[0]
    chunk, stream = _route(
        nsrc, shot_chunk, calc_grad, stream, st, dev, st.m.element_size(),
        MISFIT_BYTES_PER_SAMPLE[kind] * st.nt * st.r_idx.shape[0])
    pads, shape = _pads(model), model.shape
    if calc_grad:
        keep_src, rec_prod = _illum_fix_factors(
            src_pos, geometry.rec_positions, model.spacing, shape, dev)
    fval = 0.0
    residuals = []
    grad = illum = None
    for lo in range(0, nsrc, chunk):
        hi = min(lo + chunk, nsrc)
        injT = st.injT(lo, hi)
        if not calc_grad:
            rec_rows = _ca.forward_rec_segments(st.mT, st.hdT, st.wav_pad,
                                                injT, st.dt, **st.kw)
        elif stream:
            rec_rows, hist, illumT = _ca.forward_dt2_segments(
                st.mT, st.hdT, st.wav_pad, injT, st.dt, **st.kw)
        else:
            rec_rows, pairs, illumT = _ca.forward_ckpt_segments(
                st.mT, st.hdT, st.wav_pad, injT, st.dt, **st.kw)
        f_c, res = misfit_chunk(st.traces(rec_rows), lo, hi)
        fval = fval + f_c
        residuals.append(res)
        if not calc_grad:
            continue
        rows = _ca.residual_rows(res, st.r_idx, st.r_w, st.m,
                                 st.dt * st.dt, st.z0, st.nsteps, st.seg,
                                 st.nseg)
        if stream:
            gradT = _ca.gradient_stream_segments(st.mT, st.hdT, hist, rows,
                                                 st.dt, **st.kw)
            # free this chunk's history before the next forward allocates
            # one
            del hist
        else:
            gradT = _ca.gradient_segments(st.mT, st.hdT, st.wav_pad, injT,
                                          pairs, rows, st.dt, **st.kw)
        # crop + illumination fix per shot, in float64: (g*(1-smask))*rprod
        g = _crop(gradT.transpose(-1, -2), pads, shape).double()
        il = _crop(illumT.transpose(-1, -2), pads, shape).double()
        g = torch.sum(g * keep_src[lo:hi] * rec_prod, dim=0)
        il = torch.sum(il * keep_src[lo:hi] * rec_prod, dim=0)
        grad = g if grad is None else grad + g
        illum = il if illum is None else illum + il
    return fval, grad, illum, ResidualStack(residuals)


def _rec_box(r_idx, padded_shape):
    """Trailing-axis starts of the 2-wide windows that hold every receiver
    corner (the saved route's slab injection), or None when the corners do
    not fit such windows inside the grid (the per-step scatter then)."""
    box = []
    for d in range(1, len(padded_shape)):
        vals = np.unique(r_idx[..., d])
        lo = int(vals.min())
        if len(vals) > 2 or vals.max() > lo + 1 or lo < 0 or \
                lo + 2 > padded_shape[d]:
            return None
        box.append(lo)
    return tuple(box)


def _saved_step3(model, dtype, dev):
    """The ``step3`` keyword of the saved route's eager operators: True
    (the step kernel on cuda, its twin on the CPU) where the kernel takes
    the grid, False (the eager update) on the CPU elsewhere; on cuda a grid
    the kernel does not take raises."""
    reason = _c3.unsupported_reason(tuple(model.padded_shape),
                                    model.space_order, model.fs, dtype)
    if reason is None:
        return True
    if dev.type == "cuda":
        raise NotImplementedError(
            f"the saved route's step kernel does not take this grid: {reason}"
            " (ROADMAP.md queue A item 4)")
    return False


def _bytes_per_shot3(st, calc_grad, saved, misfit_bytes):
    """Device bytes one shot of a 3-D chunk holds at its peak: the receiver
    slab of a trial; on the stream route the history, the receiver and
    residual slabs and the illumination, gradient and state fields; on the
    saved route the wavefield history and the reverse sweep's fields."""
    item = st.m.element_size()
    nx, ny, nz = st.m.shape
    field = nx * ny * nz * item
    slab = st.nsteps * ny * 2 * nx * item
    if not calc_grad:
        return slab + misfit_bytes
    if saved:
        return st.nt * field + 8 * field + misfit_bytes
    return st.nsteps * field + 2 * slab + 5 * field + misfit_bytes


def _saved_chunk(st, saved_kw, lo, hi):
    """Forward of shots lo..hi-1 with the wavefield saved: (traces
    (hi-lo, nt, nrec), [history (nt, nx, ny, nz) per shot])."""
    recs, hists = [], []
    for i in range(lo, hi):
        rec, u = _ac.forward(st.vp, st.damp, st.src_wav, st.s_idx[i],
                             st.s_w[i], st.r_idx, st.r_w_np, st.dt,
                             save=True, **saved_kw)
        recs.append(rec)
        hists.append(u)
    return torch.stack(recs), hists


def _shot_objective3(geometry, misfit_chunk, kind, calc_grad, shot_chunk,
                     sel, stream, dev, saved3):
    """``_shot_objective`` of a 3-D geometry: the streamed kernel pair by
    default, the saved-history route with ``saved3`` (gradients only;
    trials always run ``forward_rec3``)."""
    model = geometry.model
    st = _Setup3(geometry, dev)
    if calc_grad and stream is False:
        raise NotImplementedError(
            "3-D gradients have no checkpoint route on the port (ROADMAP.md "
            "queue A item 4); saved3=True takes the saved-history route")
    src_pos = np.asarray(geometry.src_positions)
    if sel is not None:
        st.s_idx, st.s_w = st.s_idx[sel], st.s_w[sel]
        src_pos = src_pos[sel]
    nsrc = st.s_idx.shape[0]
    saved = calc_grad and saved3
    if saved:
        saved_kw = dict(nt=st.nt, spacing=model.spacing,
                        space_order=model.space_order, fs=model.fs,
                        step3=_saved_step3(model, st.m.dtype, dev))
        rec_box = _rec_box(st.r_idx, model.padded_shape)
    per_shot = _bytes_per_shot3(
        st, calc_grad, saved,
        MISFIT_BYTES_PER_SAMPLE[kind] * st.nt * st.r_idx.shape[0])
    chunk = _shots_per_batch(nsrc, shot_chunk, per_shot,
                             _device_budget(dev) if dev.type == "cuda"
                             else None)
    pads, shape = _pads(model), model.shape
    if calc_grad:
        fix = _IllumFix3(geometry.rec_positions, model.spacing, shape, dev)
    fval = 0.0
    residuals = []
    grad = illum = None
    for lo in range(0, nsrc, chunk):
        hi = min(lo + chunk, nsrc)
        if not calc_grad:
            rec = st.traces(_c3d.forward_rec3(st.m3, st.hd3,
                                              *st.planes(lo, hi), st.dt,
                                              **st.kw))
        elif saved:
            rec, hists = _saved_chunk(st, saved_kw, lo, hi)
        else:
            rec_slab, hist, il = _c3d.forward_dt2_stream3(
                st.m3, st.hd3, *st.planes(lo, hi), st.dt, **st.kw)
            rec = st.traces(rec_slab)
            del rec_slab
        f_c, res = misfit_chunk(rec, lo, hi)
        fval = fval + f_c
        residuals.append(res)
        if not calc_grad:
            continue
        if saved:
            gs, ils = [], []
            for i in range(hi - lo):
                g_i, _, il_i = _ac.gradient(
                    st.vp, st.damp, hists[i], res[i], st.r_idx, st.r_w_np,
                    st.dt, rec_box=rec_box, with_illum=True, **saved_kw)
                # free this shot's history before the next reverse sweep
                hists[i] = None
                gs.append(g_i)
                ils.append(il_i)
            g, il = torch.stack(gs), torch.stack(ils)
        else:
            slabs = _c3d.residual_slabs3(res, st.r_idx, st.r_w, st.m,
                                         st.dt * st.dt, st.z0, st.nsteps)
            g = _c3d.gradient_stream3(st.m3, st.hd3, hist, slabs, st.dt,
                                      **st.kw)
            # free this chunk's history before the next forward allocates
            # one
            del hist, slabs
            # (B, ny, nz, nx) -> (B, nx, ny, nz)
            g, il = g.permute(0, 3, 1, 2), il.permute(0, 3, 1, 2)
        # crop + illumination fix per shot, in float64: (g*(1-smask))*rprod
        keep = fix.keep(src_pos[lo:hi])
        g = torch.sum(_crop(g, pads, shape).double() * keep * fix.rec_prod,
                      dim=0)
        il = torch.sum(_crop(il, pads, shape).double() * keep
                       * fix.rec_prod, dim=0)
        grad = g if grad is None else grad + g
        illum = il if illum is None else illum + il
    return fval, grad, illum, ResidualStack(residuals)


def fwi_obj_multi(geometry, obs, misfit_func, direct_wave=None, mask=None,
                  precond=True, calc_grad=False, resample_dt=None,
                  shot_chunk=None, shot_indices=None, device="cuda",
                  stream=None, saved3=False):
    """Multi-shot objective and gradient (reference ``fwi.py:175-205``):
    returns (fval, grad (flat float64 numpy or zeros), residuals).

    ``misfit_func``: ``least_square`` (or None), a ``qWasserstein``, or any
    callable ``(syn, obs) -> (fval, residual)`` on numpy (nt, nrec) gathers,
    which runs on the host, as do the native 2-D solver and trace resampling
    to ``resample_dt``. ``shot_indices`` evaluates only that shot subset
    (random-batch FWI); ``shot_chunk`` caps the shots per batch (default: as
    many as the device memory holds). ``stream`` picks the gradient route:
    True the streamed history, False the checkpoint-and-recompute pair, None
    (the default) streams when one shot's history fits the card's memory.
    A 3-D gradient streams through ``ops.cuda_acoustic3d``; ``saved3=True``
    takes the saved-history route instead (the JAX package's
    ``DEVITO_FWI_TPU_SAVED3`` / ``DEVITO_FWI_TPU_PALLAS3D`` switches)."""
    dev = _resolve_device(device)
    sel = None if shot_indices is None else \
        np.asarray(shot_indices, dtype=np.int64)
    if _host_misfit(misfit_func, resample_dt, geometry):
        # the gathers cross to the host anyway: the shot subset is taken
        # from the host lists
        if sel is not None:
            obs = [obs[i] for i in sel]
            if direct_wave is not None:
                direct_wave = [direct_wave[i] for i in sel]

        def misfit_chunk(syn, lo, hi):
            f_c, res = _host_misfit_chunk(
                geometry, syn.cpu().numpy(), obs, misfit_func, direct_wave,
                resample_dt, lo, hi)
            return f_c, torch.as_tensor(np.stack(res), device=dev)

        # on the device only the traces and the residual: least_square's
        # figure bounds them
        kind = "least_square"
    else:
        misfit, kind = _misfit_batch(misfit_func)
        obs_stack = _device_stack(obs, dev)
        if obs_stack.shape[1] != geometry.nt:
            raise ValueError(
                "observed data has %d time samples but the geometry's time "
                "axis has %d — resample the traces or rebuild the geometry "
                "with a matching dt" % (obs_stack.shape[1], geometry.nt))
        if direct_wave is not None:
            dw_stack = _device_stack(direct_wave, dev)
        else:
            dw_stack = obs_stack.new_zeros((obs_stack.shape[0], 1, 1))
        if sel is not None:
            sel_t = torch.as_tensor(sel, device=dev)
            obs_stack = obs_stack[sel_t]
            if dw_stack.shape[0] > 1:
                dw_stack = dw_stack[sel_t]

        def misfit_chunk(syn, lo, hi):
            dw = dw_stack[lo:hi] if dw_stack.shape[0] > 1 else dw_stack
            fvals, res = misfit(syn - dw, obs_stack[lo:hi] - dw)
            return torch.sum(fvals), res

    fval, grad, illum, residuals = _shot_objective(
        geometry, misfit_chunk, kind, calc_grad, shot_chunk, sel, stream,
        dev, saved3)
    if not calc_grad:
        return (float(fval), np.zeros(geometry.model.shape).reshape(-1),
                residuals)
    # precondition + mask on the device, then one field to the host
    if precond:
        grad = grad / torch.sqrt(illum + 1e-30)
    if mask is not None:
        grad = grad * torch.as_tensor(np.asarray(mask), dtype=grad.dtype,
                                      device=dev)
    return (float(fval), grad.cpu().numpy().reshape(-1).astype(np.float64),
            residuals)


def fwi_loss(x, geometry, obs, misfit_func, direct_wave=None, mask=None,
             precond=True, calc_grad=True, shot_indices=None, device="cuda",
             stream=None, saved3=False):
    """Objective in squared-slowness parameterization
    (reference ``fwi.py:236-246``)."""
    v = 1.0 / np.sqrt(x.reshape(geometry.model.shape))
    geometry.model.update("vp", v.reshape(geometry.model.shape))
    return fwi_obj_multi(geometry, obs, misfit_func, direct_wave, mask,
                         precond, calc_grad, shot_indices=shot_indices,
                         device=device, stream=stream, saved3=saved3)
