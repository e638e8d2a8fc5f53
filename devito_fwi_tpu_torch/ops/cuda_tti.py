"""CUDA kernels for the 2-D TTI gradient sweeps, each beside its plain torch
twin. Counterpart of ``devito_fwi_tpu.ops.pallas_tti``.

Four sweeps carry the TTI gradient:

* ``tti_forward_dt2_segments``: the coupled (u, v) forward that records, per
  step, rows z0 and z0+1 of u + v before the update and streams both
  fields' d2/dt2 histories ``un - 2u + up``, ``vn - 2v + vp``;
* ``tti_gradient_stream_segments``: the coupled adjoint (du, dv) over those
  histories, the residual rows added to both fields after each update,
  returning the unscaled ``sum_t udt2 du + vdt2 dv``;
* ``tti_forward_ckpt_segments``: the same forward keeping, instead of the
  histories, (u, u_prev, v, v_prev) at the start of every segment;
* ``tti_jacobian_adjoint_segments``: the reverse sweep of the checkpoint
  route: for each segment from the last, its forward steps recomputed from
  its start state into a one-segment history, then its adjoint steps. It
  equals ``tti_gradient_stream_segments`` bitwise.

``tti_gradient_batched`` and ``tti_gradient_residual_batched`` (the
counterparts of the JAX ``tti_gradient_batched_pallas`` and
``tti_gradient_residual_batched_pallas``) chain them into per-shot gradients
(B, nx, nz) scaled by ``-1/s^2``; ``tti_forward_batched`` models the
receivers through ``tti_forward_ckpt_segments``.

Fields use the transposed (nz, nx) layout with x contiguous. The six
coefficient operands ``m, hd, eh, dh, st, ct`` (``operands``) are (nz, nx)
and shared by the batch; ``inj`` is (B, nz, nx); ``wav`` (nseg*seg + 1,)
holds dt^2 in slot 0 and step t's wavelet in slot t + 1 (``pack_wavelet``).
Each wrapper checks its operands, forms ``1/(m + hd)`` and ``2m + hd`` once
and then, for CUDA tensors, launches the kernels of ``csrc/tti2d.cu`` (one
ctypes call per sweep on the current stream, one fused launch a step) and
adds one to ``LAUNCHES[name]``; for CPU tensors it runs the plain twin, a
Python loop over the steps with the Pallas kernels' association
(``_make_ops``). On another device it raises. The twins take float32 or
float64; the kernels float32.

Each step, forward or reverse, is one fused launch (``forward_launch``,
``adjoint_launch``): a block owns a 32 x 16 (x, z) tile of one shot, one
cell a thread, forms the field pair whose operators drive the update (the
forward's u and v; the reverse's ``a = eh du + dh dv`` and ``b = dh du +
dv``) once a cell on the tile and an R ring in shared memory, their ``sin
th gz`` and ``cos th gz`` products on an R/2 ring, and updates the tile's
cells. The forwards add the source only at the pattern's non-zero cells
(``cuda_acoustic._source_list``).

Route and memory on the card: the history is float32 and the streamed
route is one segment of nt-2 steps; ``stream=None`` streams when the
batch's two histories fit ``fwi._device_budget``, else the checkpoint pair
runs with the caller's ``n_checkpoints`` (the TPU's VMEM minimum does not
apply).
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace

import numpy as np
import torch

from ..fwi import _device_budget, _traces_from_rows
from ..utils.fd import fd_weights, second_derivative_weights
from . import cuda_build
from .acoustic import _ckpt_layout, shift
from .cuda_acoustic import (_checked, _source_list, residual_rows,
                            source_pattern, tile_launch)
from .cuda_staggered import zplane_weight_matrix

__all__ = ["tti_forward_dt2_segments", "tti_gradient_stream_segments",
           "tti_forward_ckpt_segments", "tti_jacobian_adjoint_segments",
           "tti_forward_dt2_plain", "tti_gradient_stream_plain",
           "tti_forward_ckpt_plain", "tti_jacobian_adjoint_plain",
           "tti_gradient_batched", "tti_gradient_residual_batched",
           "tti_forward_batched", "operands", "pack_wavelet",
           "supported_reason", "forward_launch", "adjoint_launch",
           "KERNELS", "LAUNCHES", "TWIN_CALLS", "reset_counters"]

KERNELS = ("tti_forward_dt2_segments", "tti_gradient_stream_segments",
           "tti_forward_ckpt_segments", "tti_jacobian_adjoint_segments")
# launches of each kernel (one per sweep) and calls of each plain twin
LAUNCHES = dict.fromkeys(KERNELS, 0)
TWIN_CALLS = dict.fromkeys(KERNELS, 0)


def reset_counters():
    for name in KERNELS:
        LAUNCHES[name] = 0
        TWIN_CALLS[name] = 0


# ---------------------------------------------------------------------------
# geometry gate, operands
# ---------------------------------------------------------------------------

def _reason(ndim, is_f32, nz, rec_idx):
    if ndim != 2:
        return f"the TTI kernels are 2-D; the model is {ndim}-D"
    if not is_f32:
        return "the TTI kernels are float32"
    zplanes = np.unique(np.asarray(rec_idx)[..., 1])
    # the kernels record and inject exactly rows z0 and z0+1: the planes
    # must be adjacent, not merely two in number
    if len(zplanes) > 2 or zplanes.max() - zplanes.min() > 1:
        return (f"receivers must lie between two adjacent z-planes; their "
                f"corners span rows {zplanes.tolist()}")
    z0 = int(zplanes.min())
    if not (0 <= z0 and z0 + 2 <= nz):
        return f"receiver rows {z0}, {z0 + 1} leave the padded grid"
    return None


def supported_reason(model, rec_idx):
    """None when the kernels take the geometry, else the condition that
    fails: a 2-D float32 model and every receiver corner on two adjacent
    z-planes z0, z0+1 inside the padded grid (the JAX ``tti_supported``
    without its on-chip memory clause)."""
    return _reason(model.dim, np.dtype(model.dtype) == np.float32,
                   model.padded_shape[-1], rec_idx)


def operands(vp, damp, epsilon, delta, theta, dt):
    """(m, (mT, hdT, ehT, dhT, stT, ctT)): the squared slowness (nx, nz) and
    the six coefficient operands transposed to (nz, nx) and contiguous,
    from untransposed padded fields (``damp`` may be 0-dim): ``hd = dt
    damp`` with dt rounded to the fields' type, ``eh = 1 + 2 eps``, ``dh =
    sqrt(1 + 2 delta)``, ``st, ct = sin, cos theta``."""
    m = 1.0 / (vp * vp)
    s = torch.as_tensor(dt, dtype=vp.dtype, device=vp.device)
    hd = torch.broadcast_to(s * damp, vp.shape)
    fields = (m, hd, 1.0 + 2.0 * epsilon, torch.sqrt(1.0 + 2.0 * delta),
              torch.sin(theta), torch.cos(theta))
    return m, tuple(f.T.contiguous() for f in fields)


def pack_wavelet(src_wav, s2, nt, total):
    """``src_wav[1:nt-1, 0]`` in slots 1..nt-2 of a (total + 1,) vector with
    ``s2`` (dt^2) in slot 0: the kernels read step t's wavelet at t + 1."""
    wav = src_wav.new_zeros((total + 1,))
    wav[0] = s2
    wav[1:nt - 1] = src_wav[1:nt - 1, 0]
    return wav


def _statics(space_order, spacing, dt, dtype):
    """The stencil constants, rounded to ``dtype`` like the Pallas kernels'
    float32 ones: ``w1`` the centred first-derivative weights (radius
    space_order//4), ``w2`` the second-derivative half stencil, ``ihx``,
    ``ihz`` = 1/h, ``ihx2``, ``ihz2`` their squares formed from the rounded
    1/h and rounded once (not 1/h^2), ``s2`` = dt^2."""
    np_t = np.float32 if dtype == torch.float32 else np.float64
    r = space_order // 2
    r1 = r // 2
    if r1 < 1 or r > 8:
        raise ValueError(f"space_order {space_order}: the TTI kernels take "
                         "4 .. 16")

    def rnd(x):
        return float(np_t(x))

    w1 = tuple(rnd(w) for w in fd_weights(1, np.arange(-r1, r1 + 1), 0.0))
    w2 = tuple(rnd(w) for w in second_derivative_weights(space_order)[r:])
    ihx, ihz = rnd(1.0 / spacing[0]), rnd(1.0 / spacing[1])
    return SimpleNamespace(w1=w1, r1=r1, w2=w2, r=r, ihx=ihx, ihz=ihz,
                           ihx2=rnd(ihx * ihx), ihz2=rnd(ihz * ihz),
                           s2=rnd(float(dt) ** 2))


# ---------------------------------------------------------------------------
# plain twins: Python loops over the steps with the kernels' arithmetic
# ---------------------------------------------------------------------------

def _make_ops(st, sth, cth):
    """(gzz, gxx) on the transposed (..., nz, nx) layout with zero-fill
    shifts and the Pallas ``_make_ops_t`` association: D1 summed from its
    first non-zero weight then times 1/h, D2 as ``w0 u + sum_k wk (u[+k] +
    u[-k])`` then times (1/h)^2, the x term first."""
    def d1(u, axis):
        dim, ih = (-1, st.ihx) if axis == 0 else (-2, st.ihz)
        out = None
        for k in range(-st.r1, st.r1 + 1):
            wk = st.w1[k + st.r1]
            if wk == 0.0:
                continue
            t = wk * shift(u, k, dim)
            out = t if out is None else out + t
        return out * ih

    def d2(u, axis):
        dim, ih2 = (-1, st.ihx2) if axis == 0 else (-2, st.ihz2)
        out = st.w2[0] * u
        for k in range(1, st.r + 1):
            out = out + st.w2[k] * (shift(u, k, dim) + shift(u, -k, dim))
        return out * ih2

    def gzz(u):
        gz = -(sth * d1(u, 0) + cth * d1(u, 1))
        return -(d1(sth * gz, 0) + d1(cth * gz, 1))

    def gxx(u):
        return (d2(u, 0) + d2(u, 1)) - gzz(u)

    return gzz, gxx


def _forward_step(ops, prm, s2, w_t, inj, u, up, v, vp):
    """One forward step of the coupled system: (un, vn)."""
    gzz, gxx = ops
    m, two_m_hd, inv_mhd, eh, dh = prm[:5]
    Gxx_u = gxx(u)
    Gzz_v = gzz(v)
    un = (s2 * (eh * Gxx_u + dh * Gzz_v) + two_m_hd * u - m * up) \
        * inv_mhd + w_t * inj
    vn = (s2 * (dh * Gxx_u + Gzz_v) + two_m_hd * v - m * vp) \
        * inv_mhd + w_t * inj
    return un, vn


def _forward_plain(prm, wav, inj, *, st, seg, z0, hist):
    """Forward over every step of the layout; ``hist``: the histories,
    else the segment starts."""
    ops = _make_ops(st, prm[5], prm[6])
    B, nz, nx = inj.shape
    total = wav.shape[0] - 1
    s2 = wav[0]
    u = up = v = vp = inj.new_zeros((B, nz, nx))
    rec = inj.new_empty((B, total, 2, nx))
    if hist:
        udt2 = inj.new_empty((B, total, nz, nx))
        vdt2 = inj.new_empty((B, total, nz, nx))
    else:
        starts = inj.new_empty((B, total // seg, 4, nz, nx))
    for t in range(total):
        if not hist and t % seg == 0:
            starts[:, t // seg] = torch.stack([u, up, v, vp], 1)
        rec[:, t] = u[:, z0:z0 + 2] + v[:, z0:z0 + 2]
        un, vn = _forward_step(ops, prm, s2, wav[t + 1], inj, u, up, v, vp)
        if hist:
            udt2[:, t] = un - 2.0 * u + up
            vdt2[:, t] = vn - 2.0 * v + vp
        up, u, vp, v = u, un, v, vn
    if hist:
        return rec, udt2, vdt2
    return rec, starts


def _adjoint_steps(ops, prm, s2, udt2, vdt2, res, state, z0, lo, hi, t0):
    """Reverse steps t = hi-1 .. lo over histories holding step t at
    ``t - t0``; ``state`` = [du, dun, dv, dvn, grad] is updated in place."""
    gzz, gxx = ops
    m, two_m_hd, inv_mhd, eh, dh = prm[:5]
    du, dun, dv, dvn, grad = state
    for t in range(hi - 1, lo - 1, -1):
        grad = grad + udt2[:, t - t0] * du + vdt2[:, t - t0] * dv
        H0 = gxx(eh * du + dh * dv)
        Hz = gzz(dh * du + dv)
        dup = (s2 * H0 + two_m_hd * du - m * dun) * inv_mhd
        dvp = (s2 * Hz + two_m_hd * dv - m * dvn) * inv_mhd
        dup[:, z0:z0 + 2] = dup[:, z0:z0 + 2] + res[:, t]
        dvp[:, z0:z0 + 2] = dvp[:, z0:z0 + 2] + res[:, t]
        dun, du, dvn, dv = du, dup, dv, dvp
    state[:] = du, dun, dv, dvn, grad


def _adjoint_plain(prm, udt2, vdt2, res, *, st, nsteps, z0):
    B, _, nz, nx = udt2.shape
    ops = _make_ops(st, prm[5], prm[6])
    state = [udt2.new_zeros((B, nz, nx)) for _ in range(5)]
    _adjoint_steps(ops, prm, st.s2, udt2, vdt2, res, state, z0, 0, nsteps, 0)
    return state[4]


def _jacobian_adjoint_plain(prm, wav, inj, starts, res, *, st, nsteps, z0):
    """Per segment k (last first): its seg forward steps from starts[:, k]
    into one-segment histories, then its adjoint steps t < nsteps."""
    ops = _make_ops(st, prm[5], prm[6])
    B, nseg, _, nz, nx = starts.shape
    seg = (wav.shape[0] - 1) // nseg
    s2 = wav[0]
    state = [inj.new_zeros((B, nz, nx)) for _ in range(5)]
    udt2 = inj.new_empty((B, seg, nz, nx))
    vdt2 = inj.new_empty((B, seg, nz, nx))
    for k in range(nseg - 1, -1, -1):
        base = k * seg
        u, up, v, vp = starts[:, k].unbind(1)
        for i in range(seg):
            un, vn = _forward_step(ops, prm, s2, wav[base + i + 1], inj, u,
                                   up, v, vp)
            udt2[:, i] = un - 2.0 * u + up
            vdt2[:, i] = vn - 2.0 * v + vp
            up, u, vp, v = u, un, v, vn
        _adjoint_steps(ops, prm, st.s2, udt2, vdt2, res, state, z0, base,
                       min(base + seg, nsteps), base)
    return state[4]


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# (argtypes, restype) of the C entry points of csrc/tti2d.cu; every pointer
# and the stream are c_void_p, so no 64-bit value is cut
SIGNATURES = {
    "tti2d_forward": ([_P] * 10 + [_I] + [_P] * 5 + [_I] * 7 + [_P] * 2
                      + [_F] * 4 + [_P], _I),
    "tti2d_adjoint": ([_P] * 12 + [_I] * 7 + [_P] * 2 + [_F] * 5 + [_P], _I),
    "tti2d_jacobian_adjoint": ([_P] * 10 + [_I] + [_P] * 5 + [_I] * 8
                               + [_P] * 2 + [_F] * 5 + [_P], _I),
    "tti2d_error_string": ([_I], ctypes.c_char_p),
}


# the fused step's tile and threads (csrc/tti2d.cu kTX x kTZ, kThreads),
# forward and reverse alike
TILE = (32, 16)
THREADS = 512


def _fused_launch(what, B, nz, nx, r):
    if not 2 <= r <= 8:
        raise ValueError(f"{what}: stencil radius {r}; the kernel takes "
                         "2 .. 8")
    tx, tz = TILE
    r1 = r // 2
    smem = 4 * (2 * (tx + 2 * r) * (tz + 2 * r) + 2 * tz * (tx + 2 * r1)
                + 2 * (tz + 2 * r1) * tx)
    return tile_launch(what, B, nz, nx, r, TILE, THREADS, smem,
                       shots_first=True)


def forward_launch(B, nz, nx, r):
    """The fused forward step's launch at these shapes: the tile, threads,
    grid of one step (shots, x tiles, z tiles) and the shared-memory bytes
    of a block (u and v on the tile and an r ring, the four products on
    the tile and an r//2 ring along their axis; at most 23,552 bytes, r =
    8, within a static launch's 48 KB). Raises ValueError for what the
    kernel does not take: a radius outside 2 .. 8 (space orders 4 .. 16),
    an empty grid or one of 2^31 cells, or a launch grid past CUDA's
    (``cuda_acoustic.tile_launch``)."""
    return _fused_launch("tti forward", B, nz, nx, r)


def adjoint_launch(B, nz, nx, r):
    """The fused reverse step's launch, as ``forward_launch``'s (a and b
    in place of u and v), with the same limits."""
    return _fused_launch("tti adjoint", B, nz, nx, r)


def _lib():
    lib = cuda_build.load("tti2d")
    if not getattr(lib, "_argtypes_set", False):
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        lib._argtypes_set = True
    return lib


def _check(lib, fn, err):
    if err:
        raise RuntimeError(f"{fn}: CUDA error {err} "
                           f"({lib.tti2d_error_string(err).decode()})")


def _consts(st):
    """The C entry points' trailing stencil arguments (the weight arrays
    must outlive the call: the caller keeps the tuple)."""
    w1 = np.asarray(st.w1, np.float32)
    w2 = np.asarray(st.w2, np.float32)
    return (w1, w2), (st.r, w1.ctypes.data, w2.ctypes.data, st.ihx, st.ihz,
                      st.ihx2, st.ihz2)


def _ptrs(tensors):
    return tuple(t.data_ptr() for t in tensors)


def _forward_cuda(prm, wav, inj, *, st, seg, z0, hist):
    B, nz, nx = inj.shape
    forward_launch(B, nz, nx, st.r)
    lib = _lib()
    total = wav.shape[0] - 1
    if hist:
        # the histories first, so that they take the largest free blocks
        udt2 = inj.new_empty((B, total, nz, nx))
        vdt2 = inj.new_empty((B, total, nz, nx))
        starts = None
    else:
        starts = inj.new_empty((B, total // seg, 4, nz, nx))
        udt2 = vdt2 = None
    rec = inj.new_empty((B, total, 2, nx))
    scratch = inj.new_zeros((4, B, nz, nx))        # u, up, v, vp
    cells, vals, K = _source_list(inj)
    keep, consts = _consts(st)
    with torch.cuda.device(inj.device):
        err = lib.tti2d_forward(
            *_ptrs(prm), wav.data_ptr(), cells.data_ptr(), vals.data_ptr(),
            K, rec.data_ptr(),
            udt2.data_ptr() if hist else None,
            vdt2.data_ptr() if hist else None,
            None if hist else starts.data_ptr(), scratch.data_ptr(), B, nz,
            nx, total, seg, z0, *consts,
            torch.cuda.current_stream(inj.device).cuda_stream)
    _check(lib, "tti2d_forward", err)
    del keep
    if hist:
        return rec, udt2, vdt2
    return rec, starts


def _adjoint_cuda(prm, udt2, vdt2, res, *, st, nsteps, z0):
    B, total, nz, nx = udt2.shape
    adjoint_launch(B, nz, nx, st.r)
    lib = _lib()
    grad = udt2.new_zeros((B, nz, nx))
    scratch = udt2.new_zeros((4, B, nz, nx))       # du, dun, dv, dvn
    keep, consts = _consts(st)
    with torch.cuda.device(udt2.device):
        err = lib.tti2d_adjoint(
            *_ptrs(prm), udt2.data_ptr(), vdt2.data_ptr(), res.data_ptr(),
            grad.data_ptr(), scratch.data_ptr(), B, nz, nx, total, nsteps,
            z0, *consts, st.s2,
            torch.cuda.current_stream(udt2.device).cuda_stream)
    _check(lib, "tti2d_adjoint", err)
    del keep
    return grad


def _jacobian_adjoint_cuda(prm, wav, inj, starts, res, *, st, nsteps, z0):
    B, nseg, _, nz, nx = starts.shape
    adjoint_launch(B, nz, nx, st.r)
    forward_launch(B, nz, nx, st.r)
    lib = _lib()
    seg = (wav.shape[0] - 1) // nseg
    grad = inj.new_zeros((B, nz, nx))
    hist = inj.new_empty((2, B, seg, nz, nx))
    # the adjoint state and the recompute's state
    scratch = inj.new_zeros((8, B, nz, nx))
    cells, vals, K = _source_list(inj)
    keep, consts = _consts(st)
    with torch.cuda.device(inj.device):
        err = lib.tti2d_jacobian_adjoint(
            *_ptrs(prm), wav.data_ptr(), cells.data_ptr(), vals.data_ptr(),
            K, starts.data_ptr(),
            res.data_ptr(), grad.data_ptr(), hist.data_ptr(),
            scratch.data_ptr(), B, nz, nx, seg, nseg, nsteps, z0, *consts,
            st.s2, torch.cuda.current_stream(inj.device).cuda_stream)
    _check(lib, "tti2d_jacobian_adjoint", err)
    del keep
    return grad


def _prepared(fn, coeffs, extra, extra_shapes, dt, *, nt, nx, nz,
              space_order, spacing, z0, n_checkpoints):
    """Check one call's operands and form what every sweep takes: the layout
    (nsteps, seg, nseg), the stencil constants and the seven coefficient
    operands (m, 2m + hd, 1/(m + hd), eh, dh, st, ct)."""
    nsteps, seg, nseg = _ckpt_layout(nt, n_checkpoints)
    shapes = ((nz, nx),) * 6 + tuple(
        s(nseg, seg) if callable(s) else s for s in extra_shapes)
    dev = _checked(fn, tuple(coeffs) + tuple(extra), shapes, z0, nz)
    mT, hdT, ehT, dhT, stT, ctT = coeffs
    st = _statics(space_order, spacing, dt, mT.dtype)
    prm = (mT, 2.0 * mT + hdT, 1.0 / (mT + hdT), ehT, dhT, stT, ctT)
    return dev, (nsteps, seg, nseg), st, prm


def _forward(fn, plain, coeffs, inj, wav, dt, *, nt, nx, nz, space_order,
             spacing, z0, n_checkpoints):
    """The two forward sweeps; ``fn`` names the one."""
    B = inj.shape[0]
    dev, (nsteps, seg, nseg), st, prm = _prepared(
        fn, coeffs, (inj, wav), ((B, nz, nx), lambda n, s: (n * s + 1,)), dt,
        nt=nt, nx=nx, nz=nz, space_order=space_order, spacing=spacing, z0=z0,
        n_checkpoints=n_checkpoints)
    hist = fn == "tti_forward_dt2_segments"
    kw = dict(st=st, seg=seg, z0=z0, hist=hist)
    if dev.type == "cuda" and not plain:
        out = _forward_cuda(prm, wav, inj, **kw)
        LAUNCHES[fn] += 1
    else:
        TWIN_CALLS[fn] += 1
        out = _forward_plain(prm, wav, inj, **kw)
    rec = out[0].reshape(B, nseg, seg, 2, nx)
    if hist:
        return (rec, out[1].reshape(B, nseg, seg, nz, nx),
                out[2].reshape(B, nseg, seg, nz, nx))
    return rec, out[1]


def _gradient_stream(plain, coeffs, udt2, vdt2, res_rows, dt, *, nt, nx, nz,
                     space_order, spacing, z0, n_checkpoints):
    fn = "tti_gradient_stream_segments"
    B = udt2.shape[0]
    hist_shape = lambda n, s: (B, n, s, nz, nx)  # noqa: E731
    dev, (nsteps, seg, nseg), st, prm = _prepared(
        fn, coeffs, (udt2, vdt2, res_rows),
        (hist_shape, hist_shape, lambda n, s: (B, n, s, 2, nx)), dt, nt=nt,
        nx=nx, nz=nz, space_order=space_order, spacing=spacing, z0=z0,
        n_checkpoints=n_checkpoints)
    u2 = udt2.reshape(B, nseg * seg, nz, nx)
    v2 = vdt2.reshape(B, nseg * seg, nz, nx)
    res = res_rows.reshape(B, nseg * seg, 2, nx)
    kw = dict(st=st, nsteps=nsteps, z0=z0)
    if dev.type == "cuda" and not plain:
        grad = _adjoint_cuda(prm, u2, v2, res, **kw)
        LAUNCHES[fn] += 1
        return grad
    TWIN_CALLS[fn] += 1
    return _adjoint_plain(prm, u2, v2, res, **kw)


def _jacobian_adjoint(plain, coeffs, inj, wav, seg_starts, res_rows, dt, *,
                      nt, nx, nz, space_order, spacing, z0, n_checkpoints):
    fn = "tti_jacobian_adjoint_segments"
    B = inj.shape[0]
    dev, (nsteps, seg, nseg), st, prm = _prepared(
        fn, coeffs, (inj, wav, seg_starts, res_rows),
        ((B, nz, nx), lambda n, s: (n * s + 1,),
         lambda n, s: (B, n, 4, nz, nx), lambda n, s: (B, n, s, 2, nx)), dt,
        nt=nt, nx=nx, nz=nz, space_order=space_order, spacing=spacing, z0=z0,
        n_checkpoints=n_checkpoints)
    res = res_rows.reshape(B, nseg * seg, 2, nx)
    kw = dict(st=st, nsteps=nsteps, z0=z0)
    if dev.type == "cuda" and not plain:
        grad = _jacobian_adjoint_cuda(prm, wav, inj, seg_starts, res, **kw)
        LAUNCHES[fn] += 1
        return grad
    TWIN_CALLS[fn] += 1
    return _jacobian_adjoint_plain(prm, wav, inj, seg_starts, res, **kw)


def tti_forward_dt2_segments(mT, hdT, ehT, dhT, stT, ctT, injT, wav, dt,
                             **kw):
    """Batched TTI forward streaming both fields' d2/dt2 histories.
    Transposed (nz, nx) operands (``operands``), ``injT`` (B, nz, nx),
    ``wav`` (nseg*seg + 1,) from ``pack_wavelet``. Keywords: nt, nx, nz,
    space_order, spacing, z0, n_checkpoints. Returns (rec_rows (B, nseg,
    seg, 2, nx) of u + v before each step, udt2, vdt2 (B, nseg, seg, nz,
    nx))."""
    return _forward("tti_forward_dt2_segments", False,
                    (mT, hdT, ehT, dhT, stT, ctT), injT, wav, dt, **kw)


def tti_gradient_stream_segments(mT, hdT, ehT, dhT, stT, ctT, udt2, vdt2,
                                 res_rows, dt, **kw):
    """Coupled adjoint sweep over the streamed histories with the residual
    rows (B, nseg, seg, 2, nx) (``cuda_acoustic.residual_rows``) added to
    both fields. Returns gradT (B, nz, nx), unscaled (callers apply
    -1/s^2 and transpose)."""
    return _gradient_stream(False, (mT, hdT, ehT, dhT, stT, ctT), udt2,
                            vdt2, res_rows, dt, **kw)


def tti_forward_ckpt_segments(mT, hdT, ehT, dhT, stT, ctT, injT, wav, dt,
                              **kw):
    """Batched TTI forward of the checkpoint route. Operands as in
    ``tti_forward_dt2_segments``. Returns (rec_rows (B, nseg, seg, 2, nx),
    seg_starts (B, nseg, 4, nz, nx): (u, u_prev, v, v_prev) before the
    first step of each segment)."""
    return _forward("tti_forward_ckpt_segments", False,
                    (mT, hdT, ehT, dhT, stT, ctT), injT, wav, dt, **kw)


def tti_jacobian_adjoint_segments(mT, hdT, ehT, dhT, stT, ctT, injT, wav,
                                  seg_starts, res_rows, dt, **kw):
    """Reverse sweep of the checkpoint route: each segment's histories
    recomputed from ``seg_starts`` into a one-segment scratch, then swept
    in reverse. Returns gradT (B, nz, nx), unscaled, equal to
    ``tti_gradient_stream_segments`` on the same forward."""
    return _jacobian_adjoint(False, (mT, hdT, ehT, dhT, stT, ctT), injT, wav,
                             seg_starts, res_rows, dt, **kw)


# The plain twins under the wrappers' signatures, on any device: the
# comparison on the card calls them on CUDA tensors.

def tti_forward_dt2_plain(*args, **kw):
    """Plain torch twin of ``tti_forward_dt2_segments``."""
    *coeffs, injT, wav, dt = args
    return _forward("tti_forward_dt2_segments", True, tuple(coeffs), injT,
                    wav, dt, **kw)


def tti_gradient_stream_plain(*args, **kw):
    """Plain torch twin of ``tti_gradient_stream_segments``."""
    *coeffs, udt2, vdt2, res_rows, dt = args
    return _gradient_stream(True, tuple(coeffs), udt2, vdt2, res_rows, dt,
                            **kw)


def tti_forward_ckpt_plain(*args, **kw):
    """Plain torch twin of ``tti_forward_ckpt_segments``."""
    *coeffs, injT, wav, dt = args
    return _forward("tti_forward_ckpt_segments", True, tuple(coeffs), injT,
                    wav, dt, **kw)


def tti_jacobian_adjoint_plain(*args, **kw):
    """Plain torch twin of ``tti_jacobian_adjoint_segments``."""
    *coeffs, injT, wav, seg_starts, res_rows, dt = args
    return _jacobian_adjoint(True, tuple(coeffs), injT, wav, seg_starts,
                             res_rows, dt, **kw)


# ---------------------------------------------------------------------------
# batched entry points
# ---------------------------------------------------------------------------

def _stream_fits(nt, nx, nz, B, dev):
    """The streamed route on cuda: the batch's two float32 histories of
    nt-2 steps within ``fwi._device_budget``."""
    return 2 * B * (nt - 2) * nz * nx * 4 <= _device_budget(dev)


class _Batch:
    """One call's operands: the checks, the route's layout, the
    coefficient operands, the source patterns, the packed wavelet and the
    receiver weight matrix."""

    def __init__(self, vp, damp, epsilon, delta, theta, src_wav, s_idx, s_w,
                 r_idx, r_w, dt, *, nt, spacing, space_order, n_checkpoints,
                 stream):
        dev = vp.device
        nx, nz = vp.shape
        s_idx = np.asarray(s_idx)
        if s_idx.ndim != 4 or s_idx.shape[1] != 1:
            raise ValueError(f"source table of shape {s_idx.shape}: the TTI "
                             "sweeps take one source point per shot, "
                             "(B, 1, 4, 2)")
        if src_wav.shape[-1] != 1:
            raise ValueError("the TTI sweeps take one wavelet (nt, 1) shared "
                             "by the shots")
        if dev.type == "cuda":
            why = _reason(vp.dim(), vp.dtype == torch.float32, nz, r_idx)
            if why is not None:
                raise ValueError(f"TTI kernels on cuda: {why} (run other "
                                 "geometries with device='cpu')")
        B = s_idx.shape[0]
        if stream is None:
            stream = dev.type != "cuda" or _stream_fits(nt, nx, nz, B, dev)
        self.stream = bool(stream)
        nck = 1 if self.stream else n_checkpoints
        self.nsteps, self.seg, self.nseg = _ckpt_layout(nt, nck)
        self.m, self.ops = operands(vp, damp, epsilon, delta, theta, dt)
        self.s2 = float(dt) ** 2
        self.injT = source_pattern(s_idx, np.asarray(s_w), self.m,
                                   self.s2).transpose(1, 2).contiguous()
        self.wav = pack_wavelet(src_wav, self.s2, nt, self.nseg * self.seg)
        self.z0 = int(np.asarray(r_idx)[..., 1].min())
        self.r_idx = r_idx
        self.r_w = torch.as_tensor(np.asarray(r_w), dtype=vp.dtype,
                                   device=dev)
        self.nt, self.dt = nt, dt
        self.kw = dict(nt=nt, nx=nx, nz=nz, space_order=space_order,
                       spacing=spacing, z0=self.z0, n_checkpoints=nck)
        self.neg_inv_s2 = float(torch.tensor(-1.0 / self.s2,
                                             dtype=vp.dtype))

    def traces(self, rec_rows):
        W = zplane_weight_matrix(self.r_idx, self.r_w, self.kw["nx"],
                                 self.z0)
        return _traces_from_rows(rec_rows, W, self.nt, self.nsteps)

    def rows(self, res):
        return residual_rows(res, self.r_idx, self.r_w, self.m, self.s2,
                             self.z0, self.nsteps, self.seg, self.nseg)

    def forward(self):
        """(rec traces (B, nt, nrec), what the reverse sweep needs)."""
        if self.stream:
            rows, udt2, vdt2 = tti_forward_dt2_segments(
                *self.ops, self.injT, self.wav, self.dt, **self.kw)
            return self.traces(rows), (udt2, vdt2)
        rows, starts = tti_forward_ckpt_segments(
            *self.ops, self.injT, self.wav, self.dt, **self.kw)
        return self.traces(rows), starts

    def gradient(self, saved, res):
        """Per-shot gradients (B, nx, nz) scaled by -1/s^2."""
        rows = self.rows(res)
        if self.stream:
            gradT = tti_gradient_stream_segments(*self.ops, *saved, rows,
                                                 self.dt, **self.kw)
        else:
            gradT = tti_jacobian_adjoint_segments(
                *self.ops, self.injT, self.wav, saved, rows, self.dt,
                **self.kw)
        return gradT.transpose(-1, -2) * self.neg_inv_s2


def tti_gradient_batched(vp, damp, epsilon, delta, theta, src_wav, s_idx,
                         s_w, r_idx, r_w, obs, dt, *, nt, spacing,
                         space_order, n_checkpoints, stream=None):
    """Batched TTI L2 gradient through the four sweeps: forward, residual
    ``rec - obs`` (B, nt, nrec), reverse. ``vp``, ``damp``, ``epsilon``,
    ``delta``, ``theta`` are untransposed padded (nx, nz) tensors (``damp``
    may be 0-dim) on the device to run on; ``src_wav`` (nt, 1) tensor;
    ``s_idx`` (B, 1, 4, 2), ``s_w`` (B, 1, 4), ``r_idx`` (nrec, 4, 2) numpy
    ``interp_table`` outputs, ``r_w`` (nrec, 4). Returns per-shot gradients
    (B, nx, nz). ``stream=None`` streams the histories when they fit (on the
    CPU always), ``True`` streams, ``False`` takes the checkpoint pair with
    ``n_checkpoints`` segments. On cuda a geometry the kernels do not take
    raises ``ValueError``."""
    b = _Batch(vp, damp, epsilon, delta, theta, src_wav, s_idx, s_w, r_idx,
               r_w, dt, nt=nt, spacing=spacing, space_order=space_order,
               n_checkpoints=n_checkpoints, stream=stream)
    rec, saved = b.forward()
    return b.gradient(saved, rec - obs)


def tti_gradient_residual_batched(vp, damp, epsilon, delta, theta, src_wav,
                                  s_idx, s_w, r_idx, r_w, res, dt, *, nt,
                                  spacing, space_order, n_checkpoints,
                                  stream=None):
    """``tti_gradient_batched`` back-propagating a given residual ``res``
    (B, nt, nrec): the ``jacobian_adjoint_from_ckpt`` convention that
    ``AnisotropicWaveSolver.gradient_checkpointed`` uses."""
    b = _Batch(vp, damp, epsilon, delta, theta, src_wav, s_idx, s_w, r_idx,
               r_w, dt, nt=nt, spacing=spacing, space_order=space_order,
               n_checkpoints=n_checkpoints, stream=stream)
    _, saved = b.forward()
    return b.gradient(saved, res)


def tti_forward_batched(vp, damp, epsilon, delta, theta, src_wav, s_idx,
                        s_w, r_idx, r_w, dt, *, nt, spacing, space_order,
                        n_checkpoints=16):
    """Batched TTI modeling through ``tti_forward_ckpt_segments``: the
    receiver traces (B, nt, nrec) of ``tti.forward_ckpt`` for each shot.
    Arguments as in ``tti_gradient_batched``."""
    b = _Batch(vp, damp, epsilon, delta, theta, src_wav, s_idx, s_w, r_idx,
               r_w, dt, nt=nt, spacing=spacing, space_order=space_order,
               n_checkpoints=n_checkpoints, stream=False)
    return b.forward()[0]
