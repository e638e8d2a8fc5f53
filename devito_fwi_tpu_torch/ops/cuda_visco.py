"""CUDA kernels for the 2-D viscoacoustic SLS 2nd-order sweeps, each beside
its plain torch twin. Counterpart of the viscoacoustic part of
``devito_fwi_tpu.ops.pallas_staggered``.

Three sweeps carry viscoacoustic modeling and FWI:

* ``visco_sls2_segments``: forward modeling that records, per step, rows
  z0 and z0+1 of p before the update, and the final p: observed data,
  direct wave, line-search trials and ``ViscoacousticWaveSolver``;
* ``visco_fwd_hist_segments``: the same forward writing the history
  (L, rn) of every step and the illumination ``sum pn^2`` over the steps
  t < nsteps;
* ``visco_grad_stream_segments``: the adjoint (lp, lpp, lr) sweep over that
  history with the residual rows on lp, returning the images ga1..ga4 of
  the four coefficient fields and the dense source cotangent gsrc.

The update, with L = sum_d D-_d(b D+_d p) (``self_adjoint.laplacian_sa``)::

    rn = damp (r + A L - B r)
    pn = damp (2 p - damp pp + C L - D rn) + wav[t] inj

with the coefficient fields ``A = s (tt/t_s) rho``, ``B = s/t_s``,
``C = s^2 bm (1+tt)`` and ``D = s^2 vp^2`` precombined on the host
(``visco_grad.coefficient_map``) and the source pattern
``inj = w s^2 vp^2`` at each shot's source corners (``source_patterns``).
The 2nd-order loop runs t = 1..nt-2: the nsteps = nt-2 steps are laid out
as ``nseg`` segments of ``seg`` steps (the modeling sweep takes one
segment), and the wavelet is ``src_wav[1:nt-1]`` (``pad_wavelet``, the
acoustic loop's layout).

Fields use the transposed (nz, nx) layout with x contiguous. The six
coefficient operands ``damp, b, A, B, C, D`` are (nz, nx) and shared by the
batch; ``inj`` and ``injw`` (B, nz, nx). Each wrapper checks its operands
and, for CUDA tensors, launches the kernels of ``csrc/visco2d.cu`` (one
ctypes call per sweep on the current stream, one fused launch a step) and
adds one to ``LAUNCHES[name]``; for CPU tensors it runs the plain twin, a
Python loop over the steps with the Pallas kernels' association
(``cuda_staggered._make_sd``). On another device it raises. The twins take
float32 or float64; the kernels float32.

The reverse sweep streams its state and images through device memory every
step (29 SMARMN shots: 8.2 MB a field, past the 50 MB L2). Its floor is
its traffic a step: 31 fields for the first design's two launches, 16 for
the fused step (``adjoint_launch``: a 32 x 32 tile a block, C P and A R
with a 2r halo and the fluxes with an r halo in shared memory, lp and lr
ping-pong, lpp and pendR recomputed from the state the previous step read,
the source weights as ``injw``'s non-zero cells, ``_source_list``). The
forwards moved 11 fields a step (15 with the history) in the first
design's flux and update launches; the fused step (``forward_launch``:
p with a 2r halo and the two fluxes with an r halo in shared memory, pn
over pp and rn over r in place, the source as ``inj``'s non-zero cells)
moves 5 (9). Their times on the card are in ``PERF.md`` (kernel table,
rows 19, 22 and 23).
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace

import numpy as np
import torch

from ..fwi import _traces_from_rows
from . import cuda_build
from . import cuda_staggered as _cs
from .cuda_acoustic import _checked, matmul_full, pad_wavelet
from .interp import valid_corners
from .visco_grad import coefficient_map

__all__ = ["visco_sls2_segments", "visco_fwd_hist_segments",
           "visco_grad_stream_segments", "visco_sls2_plain",
           "visco_fwd_hist_plain", "visco_grad_stream_plain",
           "visco_sls2_forward_segments", "operands", "source_patterns",
           "pad_wavelet", "residual_rows", "forward_launch",
           "adjoint_launch", "LAUNCHES", "TWIN_CALLS", "reset_counters"]

KERNELS = ("visco_sls2_segments", "visco_fwd_hist_segments",
           "visco_grad_stream_segments")
# launches of each kernel (one per sweep) and calls of each plain twin
LAUNCHES = dict.fromkeys(KERNELS, 0)
TWIN_CALLS = dict.fromkeys(KERNELS, 0)


def reset_counters():
    for name in KERNELS:
        LAUNCHES[name] = 0
        TWIN_CALLS[name] = 0


# ---------------------------------------------------------------------------
# operands
# ---------------------------------------------------------------------------

def operands(vp, b, qp, damp, dt, f0):
    """The kernels' six coefficient operands ``damp, b, A, B, C, D`` from
    untransposed padded (nx, nz) fields (``b``, ``damp`` may be 0-dim),
    each transposed to (nz, nx) and contiguous, and ``vp^2`` (nx, nz) for
    the source patterns."""
    b, damp, qp = (torch.broadcast_to(p, vp.shape) for p in (b, damp, qp))
    A, Bc, C, D, vp2 = coefficient_map(vp, qp, b, dt, f0)
    return tuple(f.T.contiguous() for f in (damp, b, A, Bc, C, D)), vp2


def source_patterns(s_idx, s_w, vp2, dt):
    """Dense per-shot source patterns (B, nx, nz): ``inj = w s^2 vp^2`` and
    ``injw = w`` at the bilinear corners of each shot's one source point
    (``s`` is dt rounded to the type of ``vp2``). ``s_idx`` (B, 1, 4, 2) and
    ``s_w`` (B, 1, 4) are numpy ``interp_table`` outputs; out-of-grid
    corners add nothing."""
    B = s_idx.shape[0]
    dev, dtype = vp2.device, vp2.dtype
    valid, cl = valid_corners(s_idx[:, 0], tuple(vp2.shape))
    xi = torch.as_tensor(cl[..., 0], dtype=torch.long, device=dev)
    zi = torch.as_tensor(cl[..., 1], dtype=torch.long, device=dev)
    w = torch.as_tensor(np.where(valid, s_w[:, 0], 0.0), dtype=dtype,
                        device=dev)
    s = torch.as_tensor(dt, dtype=dtype, device=dev)
    bi = torch.arange(B, device=dev)[:, None].expand_as(xi)
    zeros = vp2.new_zeros((B,) + tuple(vp2.shape))
    inj = zeros.index_put((bi, xi, zi), w * s * s * vp2[xi, zi],
                          accumulate=True)
    injw = zeros.index_put((bi, xi, zi), w, accumulate=True)
    return inj, injw


def residual_rows(res, W, seg):
    """Residuals (B, nt, nrec) -> rows (B, nseg, seg, 2, nx) through the
    (2*nx, nrec) weights ``W`` (``cuda_staggered.zplane_weight_matrix``):
    the exact transpose of ``fwi._traces_from_rows``, which puts the rows
    of steps t = 1..nt-2 on trace samples 1..nt-2."""
    B, nt = res.shape[:2]
    nsteps = nt - 2
    nseg = -(-nsteps // seg)
    nx = W.shape[0] // 2
    rows = res.new_zeros((B, nseg * seg, 2 * nx))
    rows[:, :nsteps] = matmul_full(res[:, 1:nt - 1], W.T)
    return rows.reshape(B, nseg, seg, 2, nx)


# ---------------------------------------------------------------------------
# plain twins: Python loops over the steps with the kernels' arithmetic
# ---------------------------------------------------------------------------

def _lsa(sd, st, b):
    """``lsa(u) = D-x(b D+x u) + D-z(b D+z u)`` with the Pallas ``lsa``'s
    association."""
    def lsa(u):
        out = sd(b * sd(u, st.P, 0), st.M, 0)
        return out + sd(b * sd(u, st.P, 1), st.M, 1)
    return lsa


def _forward_plain(prm, wav_pad, inj, *, st, nsteps, z0, hist):
    damp, b, A, Bc, C, D = prm
    B, nz, nx = inj.shape
    total = wav_pad.shape[0]
    lsa = _lsa(_cs._make_sd(st), st, b)
    p = pp = r = inj.new_zeros((B, nz, nx))
    rec = inj.new_empty((B, total, 2, nx))
    if hist:
        H = inj.new_empty((B, total, 2, nz, nx))
        illum = inj.new_zeros((B, nz, nx))
    pout = None
    for t in range(total):
        rec[:, t] = p[:, z0:z0 + 2]
        L = lsa(p)
        rn = damp * (r + A * L - Bc * r)
        pn = damp * (2.0 * p - damp * pp + C * L - D * rn)
        pn = pn + wav_pad[t] * inj
        if hist:
            H[:, t, 0] = L
            H[:, t, 1] = rn
            if t < nsteps:
                illum = illum + pn * pn
        pp, p, r = p, pn, rn
        if t == nsteps - 1:
            pout = p
    if hist:
        return rec, H, illum
    return rec, pout


def _adjoint_plain(prm, injw, hist, res, wavs2, *, st, nsteps, z0):
    damp, b, A, Bc, C, D = prm
    B, total, _, nz, nx = hist.shape
    lsa = _lsa(_cs._make_sd(st), st, b)
    z = hist.new_zeros((B, nz, nx))
    lp = lpp = lr = pend = z
    ga1 = ga2 = ga3 = ga4 = gsrc = z
    for t in range(nsteps - 1, -1, -1):
        L, rn = hist[:, t, 0], hist[:, t, 1]
        P = damp * lp
        R = damp * (lr - D * P)
        ga3 = ga3 + L * P
        ga4 = ga4 - rn * P
        ga1 = ga1 + L * R
        ga2 = ga2 - rn * pend
        gsrc = gsrc + wavs2[t] * injw * lp
        lp_new = 2.0 * P + lsa(C * P) + lsa(A * R) + lpp
        # the residual lands on lp's rows z0, z0+1 after + lpp
        lp_new[:, z0:z0 + 2] = lp_new[:, z0:z0 + 2] + res[:, t]
        lpp = -damp * P
        lr = R - Bc * R
        lp = lp_new
        pend = R
    return ga1, ga2, ga3, ga4, gsrc


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# (argtypes, restype) of the C entry points of csrc/visco2d.cu; every
# pointer and the stream are c_void_p, so no 64-bit value is cut
SIGNATURES = {
    "visco2d_forward": ([_P] * 9 + [_I] + [_P] * 5 + [_I] * 7 + [_P] * 2
                        + [_F] * 2 + [_P], _I),
    "visco2d_adjoint": ([_P] * 8 + [_I] + [_P] * 5 + [_I] * 7 + [_P] * 2
                        + [_F] * 2 + [_P], _I),
    "visco2d_error_string": ([_I], ctypes.c_char_p),
}


def _lib():
    lib = cuda_build.load("visco2d")
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
                           f"({lib.visco2d_error_string(err).decode()})")


# the fused step kernels' tile and threads (csrc/visco2d.cu kFTX x kFTZ,
# kFThreads; kATX x kATZ, kAThreads)
FWD_TILE = (32, 32)
FWD_THREADS = 512
ADJ_TILE = (32, 32)
ADJ_THREADS = 512


def forward_launch(B, nz, nx, r):
    """The fused forward step's launch at these shapes: the tile, threads,
    grid of one step (shots, x tiles, z tiles) and shared-memory bytes of a
    block (p on the tile and a 2r halo, the two fluxes on the tile and an r
    halo along their axis; at most 28,672 bytes, r = 8). Raises ValueError
    for what the kernel does not take (``cuda_staggered.tile_launch``)."""
    tx, tz = FWD_TILE
    smem = 4 * ((tx + 4 * r) * (tz + 4 * r) + tz * (tx + 2 * r)
                + (tz + 2 * r) * tx)
    return _cs.tile_launch("visco forward", B, nz, nx, r, FWD_TILE,
                           FWD_THREADS, smem, shots_first=True)


def adjoint_launch(B, nz, nx, r):
    """The fused reverse step's launch at these shapes: the tile, threads,
    grid of one step (shots, x tiles, z tiles) and shared-memory bytes of a
    block (C P and A R on the tile and a 2r halo, the four fluxes on the
    tile and an r halo along their axis, P and R on the tile; at most
    65,536 bytes, r = 8). Raises ValueError for what the kernel does not
    take (``cuda_staggered.tile_launch``)."""
    tx, tz = ADJ_TILE
    smem = 4 * (2 * (tx + 4 * r) * (tz + 4 * r) + 2 * tz * (tx + 2 * r)
                + 2 * (tz + 2 * r) * tx + 2 * tx * tz)
    return _cs.tile_launch("visco adjoint", B, nz, nx, r, ADJ_TILE,
                           ADJ_THREADS, smem, shots_first=True)


def _forward_cuda(prm, wav_pad, inj, *, st, nsteps, z0, hist):
    B, nz, nx = inj.shape
    forward_launch(B, nz, nx, st.r)
    lib = _lib()
    total = wav_pad.shape[0]
    if hist:
        # the history first, so that it takes the largest free block
        H = inj.new_empty((B, total, 2, nz, nx))
        rec = inj.new_empty((B, total, 2, nx))
        illum = inj.new_zeros((B, nz, nx))
        pout = None
    else:
        rec = inj.new_empty((B, total, 2, nx))
        pout = inj.new_empty((B, nz, nx))
        H = illum = None
    cells, vals, K = _cs._source_list(inj)
    scratch = inj.new_empty((3, B, nz, nx))       # p, pp, r
    wp, wm = (_cs._taps32(st, k) for k in ("P", "M"))
    with torch.cuda.device(inj.device):
        err = lib.visco2d_forward(
            *(p.data_ptr() for p in prm), wav_pad.data_ptr(),
            cells.data_ptr(), vals.data_ptr(), K, rec.data_ptr(),
            H.data_ptr() if hist else None,
            illum.data_ptr() if hist else None,
            None if hist else pout.data_ptr(), scratch.data_ptr(), B, nz, nx,
            total, nsteps, z0, st.r, wp.ctypes.data, wm.ctypes.data, st.ihx,
            st.ihz, torch.cuda.current_stream(inj.device).cuda_stream)
    _check(lib, "visco2d_forward", err)
    if hist:
        return rec, H, illum
    return rec, pout


def _adjoint_cuda(prm, injw, hist, res, wavs2, *, st, nsteps, z0):
    B, total, _, nz, nx = hist.shape
    adjoint_launch(B, nz, nx, st.r)
    lib = _lib()
    cells, vals, K = _cs._source_list(injw)
    grads = hist.new_zeros((5, B, nz, nx))
    scratch = hist.new_empty((4, B, nz, nx))      # lp and lr, twice
    wp, wm = (_cs._taps32(st, k) for k in ("P", "M"))
    with torch.cuda.device(hist.device):
        err = lib.visco2d_adjoint(
            *(p.data_ptr() for p in prm), cells.data_ptr(), vals.data_ptr(),
            K, hist.data_ptr(), res.data_ptr(), wavs2.data_ptr(),
            grads.data_ptr(), scratch.data_ptr(), B, nz, nx, total, nsteps,
            z0, st.r, wp.ctypes.data, wm.ctypes.data, st.ihx, st.ihz,
            torch.cuda.current_stream(hist.device).cuda_stream)
    _check(lib, "visco2d_adjoint", err)
    return tuple(grads)


def _forward(fn, plain, prm, inj, wav_pad, dt, *, nt, nx, nz, space_order,
             spacing, z0, seg):
    """The two forward sweeps; ``fn`` names the one."""
    nsteps = nt - 2
    nseg = -(-nsteps // seg)
    B = inj.shape[0]
    dev = _checked(fn, tuple(prm) + (inj, wav_pad),
                   ((nz, nx),) * 6 + ((B, nz, nx), (nseg * seg,)), z0, nz)
    st = _cs._stencils(space_order, spacing, dt, inj.dtype)
    hist = fn == "visco_fwd_hist_segments"
    kw = dict(st=st, nsteps=nsteps, z0=z0, hist=hist)
    if dev.type == "cuda" and not plain:
        out = _forward_cuda(prm, wav_pad, inj, **kw)
        LAUNCHES[fn] += 1
    else:
        TWIN_CALLS[fn] += 1
        out = _forward_plain(prm, wav_pad, inj, **kw)
    if not hist:
        rec, pout = out
        return rec.reshape(B, nseg, seg, 2, nx), pout
    rec, H, illum = out
    return (rec.reshape(B, nseg, seg, 2, nx),
            H.reshape(B, nseg, seg, 2, nz, nx), illum)


def _gradient(plain, prm, injw, hist, res_rows, wavs2, dt, *, nt, nx, nz,
              space_order, spacing, z0, seg):
    fn = "visco_grad_stream_segments"
    nsteps = nt - 2
    nseg = -(-nsteps // seg)
    B = hist.shape[0]
    dev = _checked(fn, tuple(prm) + (injw, hist, res_rows, wavs2),
                   ((nz, nx),) * 6 + ((B, nz, nx), (B, nseg, seg, 2, nz, nx),
                                      (B, nseg, seg, 2, nx), (nseg * seg,)),
                   z0, nz)
    st = _cs._stencils(space_order, spacing, dt, hist.dtype)
    H = hist.reshape(B, nseg * seg, 2, nz, nx)
    res = res_rows.reshape(B, nseg * seg, 2, nx)
    kw = dict(st=st, nsteps=nsteps, z0=z0)
    if dev.type == "cuda" and not plain:
        out = _adjoint_cuda(prm, injw, H, res, wavs2, **kw)
        LAUNCHES[fn] += 1
        return out
    TWIN_CALLS[fn] += 1
    return _adjoint_plain(prm, injw, H, res, wavs2, **kw)


def visco_sls2_segments(damp_t, b_t, A_t, B_t, C_t, D_t, inj_t, wav_pad, dt,
                        *, nt, nx, nz, space_order, spacing, z0):
    """Batched sls/2 modeling sweep. Transposed (nz, nx) coefficient
    operands (``operands``), ``inj_t`` (B, nz, nx) source patterns,
    ``wav_pad`` (nt-2,) from ``pad_wavelet``: the steps are one segment,
    which pads none. Returns (rec_rows (B, 1, nt-2, 2, nx): per step, rows
    z0, z0+1 of p before the update; p_final (B, nz, nx))."""
    return _forward("visco_sls2_segments", False,
                    (damp_t, b_t, A_t, B_t, C_t, D_t), inj_t, wav_pad, dt,
                    nt=nt, nx=nx, nz=nz, space_order=space_order,
                    spacing=spacing, z0=z0, seg=nt - 2)


def visco_fwd_hist_segments(damp_t, b_t, A_t, B_t, C_t, D_t, inj_t,
                            wav_pad, dt, *, nt, nx, nz, space_order,
                            spacing, z0, seg):
    """Batched history-streaming sls/2 forward. Operands as in
    ``visco_sls2_segments``, ``wav_pad`` of length nseg*seg with nseg =
    ceil((nt-2)/seg). Returns (rec_rows (B, nseg, seg, 2, nx), hist (B,
    nseg, seg, 2, nz, nx) of (L, rn) in float32 or the twin's float64,
    illum (B, nz, nx))."""
    return _forward("visco_fwd_hist_segments", False,
                    (damp_t, b_t, A_t, B_t, C_t, D_t), inj_t, wav_pad, dt,
                    nt=nt, nx=nx, nz=nz, space_order=space_order,
                    spacing=spacing, z0=z0, seg=seg)


def visco_grad_stream_segments(damp_t, b_t, A_t, B_t, C_t, D_t, injw_t,
                               hist, res_rows, wavs2, dt, *, nt, nx, nz,
                               space_order, spacing, z0, seg):
    """Batched sls/2 adjoint sweep over the streamed (L, rn) history, with
    the residual rows (B, nseg, seg, 2, nx) on lp. ``injw_t`` (B, nz, nx) is
    the dense source-weight pattern (no vp^2, no s^2); ``wavs2`` the padded
    wavelet times dt^2. Returns (ga1, ga2, ga3, ga4, gsrc), each (B, nz,
    nx); the caller applies the chain rule to (vp, qp)."""
    return _gradient(False, (damp_t, b_t, A_t, B_t, C_t, D_t), injw_t, hist,
                     res_rows, wavs2, dt, nt=nt, nx=nx, nz=nz,
                     space_order=space_order, spacing=spacing, z0=z0,
                     seg=seg)


# The plain twins under the wrappers' signatures, on any device: the
# comparison on the card calls them on CUDA tensors.

def visco_sls2_plain(*args, nt, nx, nz, space_order, spacing, z0):
    """Plain torch twin of ``visco_sls2_segments``."""
    *prm, inj_t, wav_pad, dt = args
    return _forward("visco_sls2_segments", True, tuple(prm), inj_t, wav_pad,
                    dt, nt=nt, nx=nx, nz=nz, space_order=space_order,
                    spacing=spacing, z0=z0, seg=nt - 2)


def visco_fwd_hist_plain(*args, **kw):
    """Plain torch twin of ``visco_fwd_hist_segments``."""
    *prm, inj_t, wav_pad, dt = args
    return _forward("visco_fwd_hist_segments", True, tuple(prm), inj_t,
                    wav_pad, dt, **kw)


def visco_grad_stream_plain(*args, **kw):
    """Plain torch twin of ``visco_grad_stream_segments``."""
    *prm, injw_t, hist, res_rows, wavs2, dt = args
    return _gradient(True, tuple(prm), injw_t, hist, res_rows, wavs2, dt,
                     **kw)


def visco_sls2_forward_segments(vp, b, qp, damp, src_wav, src_idx, src_w,
                                rec_idx, rec_w, dt, f0, *, nt, spacing,
                                space_order=4):
    """One shot of ``viscoacoustic.forward`` (sls, time order 2) through
    ``visco_sls2_segments`` (the counterpart of the JAX
    ``visco_sls2_forward_pallas``; gate with
    ``cuda_staggered.unsupported_reason``).
    ``vp``, ``b``, ``qp``, ``damp`` are untransposed padded tensors (``b``,
    ``damp`` may be 0-dim), ``src_wav`` (nt, 1) tensor, the tables numpy
    ``interp_table`` outputs of the one source point and the receivers.
    Returns (rec (nt, nrec), final p (nx, nz))."""
    nx, nz = vp.shape
    z0 = int(np.asarray(rec_idx)[..., 1].min())
    prm, vp2 = operands(vp, b, qp, damp, dt, f0)
    inj, _ = source_patterns(np.asarray(src_idx)[None],
                             np.asarray(src_w)[None], vp2, dt)
    rows, pout = visco_sls2_segments(
        *prm, inj.transpose(1, 2).contiguous(),
        pad_wavelet(src_wav, nt, nt - 2), dt, nt=nt, nx=nx, nz=nz,
        space_order=space_order, spacing=spacing, z0=z0)
    r_w = torch.as_tensor(np.asarray(rec_w), dtype=vp.dtype, device=vp.device)
    W = _cs.zplane_weight_matrix(rec_idx, r_w, nx, z0)
    return _traces_from_rows(rows, W, nt, nt - 2)[0], pout[0].T
