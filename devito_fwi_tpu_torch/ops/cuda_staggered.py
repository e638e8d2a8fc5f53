"""CUDA kernels for the 2-D velocity-stress elastic sweeps, each beside its
plain torch twin. Counterpart of the elastic part of
``devito_fwi_tpu.ops.pallas_staggered``.

Three sweeps carry elastic modeling and FWI:

* ``elastic_segments``: forward modeling that records, per step, the two
  receiver rows of tau_zz and of div v (the centred derivative of each
  velocity component on its own grid): observed data, direct wave,
  line-search trials and ``ElasticWaveSolver``;
* ``elastic_fwd_hist_segments``: the same forward recording the tau_zz
  rows, the history (vx', vz', dtau_x, dtau_z) of every step and the
  illumination ``sum vx'^2 + vz'^2`` over the steps t < nsteps;
* ``elastic_grad_stream_segments``: the exact-transpose adjoint sweep over
  that history, with the residual rows on the tau_zz adjoint, returning
  five images (lam, mu at the nodes, mu01, b0, b1).

Fields use the transposed (nz, nx) layout with x contiguous, so the two
receiver z-planes z0, z0+1 are two contiguous rows. The nt-1 forward steps
(t = 0..nt-2) are laid out as ``nseg`` segments of ``seg`` steps; on the
card that is only a padding layout: the padded tail steps are stepped with
a zero wavelet, left out of the illumination and skipped in reverse.

The nine parameter operands ``lam, mu, b0, b1, damp, d0, d1, mu01, d01``
(``stagger_params``) are (nz, nx) and shared by the batch; ``inj`` (B, nz,
nx) is each shot's source pattern w * dt (``source_pattern``). Each wrapper
checks its operands and, for CUDA tensors, launches the kernels of
``csrc/elastic2d.cu`` (one ctypes call per sweep on the current stream, one
fused launch a step) and adds one to ``LAUNCHES[name]``; for CPU tensors it
runs the plain twin, a Python loop over the steps with the Pallas kernels'
association (``_make_sd``). On another device it raises. The twins take
float32 or float64; the kernels float32.

The forward sweeps stream the batch state through device memory every
step (31 SMARM2 shots: 11.46 MB a field, past the 50 MB L2). Their bound
if the state never left the chip is 9.673 ms by operations (modeling) and
19.5 ms by the 65 GB history write; the floor of a design that streams the
state is its traffic a step: 16 fields for the first design's two phases
(77.7 ms over 1420 steps on an H100), 10 for the fused step (48.6 ms). The
fused step marches z (``forward_launch``): a block of 64 threads a strip
of 64 - 2r columns of one shot walking down a segment of rows, the z taps
from register queues of each thread's column and the x taps from one row
of each field in shared memory, so that only the x halo and a segment's
2r lead-in rows repeat a neighbour's arithmetic; ping-pong state, the
source as ``inj``'s non-zero cells (``_source_list``). The reverse sweep
moved 35 fields a step in the first design's two launches (170.0 ms over
the sweep), among them three derived stress-adjoint fields written only to
be read again; the fused step (``adjoint_launch``) forms them on its tile
and a 2r halo in shared memory from the stored stress adjoints, then the
velocity adjoints with an r halo, the images and the stress adjoints, and
ping-pongs the adjoint state: 24 fields (116.6 ms). Their times on the
card are in ``PERF.md`` (kernel table, rows 18, 20 and 21).
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace

import numpy as np
import torch

from ..utils.fd import fd_weights
from . import cuda_build
from .acoustic import shift
from .cuda_acoustic import (MAX_RADIUS, SMEM_LIMIT, _checked,  # noqa: F401
                            _source_list, matmul_full,
                            receiver_plane_matrix, tile_launch)
from .interp import valid_corners
from .self_adjoint import staggered_weights
from .staggered import avg_to

__all__ = ["elastic_segments", "elastic_fwd_hist_segments",
           "elastic_grad_stream_segments", "elastic_segments_plain",
           "elastic_fwd_hist_plain", "elastic_grad_stream_plain",
           "elastic_forward_segments", "elastic_supported",
           "elastic_grad_stream_supported", "unsupported_reason",
           "stagger_params", "source_pattern", "pad_wavelet",
           "zplane_weight_matrix", "forward_launch", "adjoint_launch",
           "tile_launch", "LAUNCHES", "TWIN_CALLS", "reset_counters"]

KERNELS = ("elastic_segments", "elastic_fwd_hist_segments",
           "elastic_grad_stream_segments")
# launches of each kernel (one per sweep) and calls of each plain twin
LAUNCHES = dict.fromkeys(KERNELS, 0)
TWIN_CALLS = dict.fromkeys(KERNELS, 0)


def reset_counters():
    for name in KERNELS:
        LAUNCHES[name] = 0
        TWIN_CALLS[name] = 0


# ---------------------------------------------------------------------------
# geometry gates
# ---------------------------------------------------------------------------

def unsupported_reason(model, src_idx, rec_idx, src_wav=None, twins=False):
    """None when the kernels take the geometry, else the condition that
    fails: the grid must be 2-D float32, each shot one source point (with
    one shared wavelet), and every receiver on two adjacent z-planes z0,
    z0+1 inside the padded grid. ``src_idx`` is an ``interp_table`` output,
    (npt, 4, 2) for one shot or (B, npt, 4, 2) for a batch. ``twins=True``
    asks for the plain twins' conditions, which take float64 as well."""
    if model.dim != 2:
        return f"the kernels are 2-D; the model is {model.dim}-D"
    if model.dtype != np.float32 and not (twins and
                                          model.dtype == np.float64):
        return f"the kernels are float32; the model is {model.dtype}"
    s_idx = np.asarray(src_idx)
    if s_idx.ndim not in (3, 4):
        return f"source table of shape {s_idx.shape}: expected (npt, 4, 2) " \
               "or (B, npt, 4, 2)"
    npt = s_idx.shape[-3]
    if npt != 1:
        return f"one source point per shot is supported; got {npt}"
    if src_wav is not None and np.asarray(src_wav).shape[1] != 1:
        return "one wavelet shared by the shots is supported"
    zplanes = np.unique(np.asarray(rec_idx)[..., 1])
    # the kernels record exactly rows z0 and z0+1: the planes must be
    # adjacent, not merely two in number
    if len(zplanes) > 2 or zplanes.max() - zplanes.min() > 1:
        return (f"receivers must lie between two adjacent z-planes; their "
                f"corners span rows {zplanes.tolist()}")
    z0 = int(zplanes.min())
    if not (0 <= z0 and z0 + 2 <= model.padded_shape[1]):
        return f"receiver rows {z0}, {z0 + 1} leave the padded grid"
    return None


def elastic_supported(model, src_idx, rec_idx):
    """True when the modeling kernel applies (see ``unsupported_reason``)."""
    return unsupported_reason(model, src_idx, rec_idx) is None


def elastic_grad_stream_supported(model, src_idx, rec_idx, src_wav):
    """True when the gradient kernels apply. Unlike the TPU gate there is
    no on-chip memory budget: the history streams through device memory
    and the objective sizes shot chunks to fit it."""
    return unsupported_reason(model, src_idx, rec_idx, src_wav) is None


# ---------------------------------------------------------------------------
# operands
# ---------------------------------------------------------------------------

def stagger_params(lam, mu, b, damp):
    """The kernels' nine parameter operands from untransposed (nx, nz)
    fields (``b`` and ``damp`` may be 0-dim): ``lam, mu, b0, b1, damp, d0,
    d1, mu01, d01``, each transposed to (nz, nx) and contiguous; b0/d0 are
    averaged to +h/2 in x, b1/d1 in z, mu01/d01 in both (``avg_to``)."""
    full = [torch.broadcast_to(p, lam.shape) for p in (b, damp)]
    b, damp = full
    fields = (lam, mu, avg_to(b, (0,), 2), avg_to(b, (1,), 2), damp,
              avg_to(damp, (0,), 2), avg_to(damp, (1,), 2),
              avg_to(mu, (0, 1), 2), avg_to(damp, (0, 1), 2))
    return tuple(f.T.contiguous() for f in fields)


def source_pattern(s_idx, s_w, dt, shape, dtype, dev):
    """Dense per-shot source pattern (B, nx, nz): ``w * dt`` (dt rounded to
    ``dtype``) at the bilinear corners of each shot's one source point.
    ``s_idx`` (B, 1, 4, 2) and ``s_w`` (B, 1, 4) are numpy ``interp_table``
    outputs; out-of-grid corners add nothing."""
    B = s_idx.shape[0]
    valid, cl = valid_corners(s_idx[:, 0], tuple(shape))
    xi = torch.as_tensor(cl[..., 0], dtype=torch.long, device=dev)
    zi = torch.as_tensor(cl[..., 1], dtype=torch.long, device=dev)
    w = torch.as_tensor(np.where(valid, s_w[:, 0], 0.0), dtype=dtype,
                        device=dev)
    s = torch.as_tensor(dt, dtype=dtype, device=dev)
    bi = torch.arange(B, device=dev)[:, None].expand_as(xi)
    out = torch.zeros((B,) + tuple(shape), dtype=dtype, device=dev)
    return out.index_put_((bi, xi, zi), w * s, accumulate=True)


def pad_wavelet(src_wav, nsteps, total):
    """``src_wav[0:nsteps, 0]`` zero-padded to the segment-layout length
    (the staggered loop injects src[t] at steps t = 0..nt-2)."""
    out = src_wav.new_zeros((total,))
    out[:nsteps] = src_wav[0:nsteps, 0]
    return out


def zplane_weight_matrix(r_idx, r_w, nx, z0):
    """(2*nx, nrec) weight matrix mapping the two recorded z-plane rows
    (z0, z0+1) to receiver traces; its transpose maps residuals to rows.
    ``r_idx`` numpy, ``r_w`` tensor (nrec, 4)."""
    return receiver_plane_matrix(r_idx, r_w, z0, nx).T.contiguous()


def _stag_assemble(rows, r_idx, r_w, *, z0, nt, nsteps, nx):
    """Modeling rows (B, nseg, seg, 2, 2, nx) -> (rec1, rec2) traces, each
    (B, nt, nrec): the staggered loop records t = 0..nt-2 and rec[nt-1]
    stays 0; one product against the weight matrix at full float32."""
    W = zplane_weight_matrix(r_idx, r_w, nx, z0)
    B = rows.shape[0]
    flat = rows.reshape(B, -1, 2, 2 * nx)[:, :nsteps]
    out = []
    for o in range(2):
        tr = rows.new_zeros((B, nt, W.shape[1]))
        tr[:, :nsteps] = matmul_full(flat[:, :, o], W)
        out.append(tr)
    return out[0], out[1]


# ---------------------------------------------------------------------------
# plain twins: Python loops over the steps with the kernels' arithmetic
# ---------------------------------------------------------------------------

def _stencils(space_order, spacing, dt, dtype):
    """The three derivative stencils as (weight, offset) taps, zero weights
    dropped, weights and 1/h and dt rounded to ``dtype`` like the Pallas
    kernels' constants: D+ (``P``), D- (``M``) and the centred one
    (``C``)."""
    np_t = np.float32 if dtype == torch.float32 else np.float64
    w_p, off_p, w_m, off_m = staggered_weights(space_order)
    r = space_order // 2
    off_c = np.arange(-r, r + 1)
    w_c = fd_weights(1, off_c, 0.0)

    def taps(w, off):
        return tuple((float(np_t(wk)), int(ok)) for wk, ok in zip(w, off)
                     if float(np_t(wk)) != 0.0)

    s = float(np_t(dt))
    return SimpleNamespace(P=taps(w_p, off_p), M=taps(w_m, off_m),
                           C=taps(w_c, off_c), r=r,
                           ihx=float(np_t(1.0 / spacing[0])),
                           ihz=float(np_t(1.0 / spacing[1])), s=s,
                           two_s=2.0 * s)


def _make_sd(st):
    """Shifted derivative on the transposed (..., nz, nx) layout with the
    Pallas ``_make_sd`` association: taps summed in offset order, then
    scaled by 1/h. ``axis`` is the physical dim (0 = x, the last axis; 1 =
    z)."""
    def sd(u, taps, axis):
        dim, ih = (-1, st.ihx) if axis == 0 else (-2, st.ihz)
        acc = None
        for wk, ok in taps:
            term = wk * shift(u, ok, dim)
            acc = term if acc is None else acc + term
        return acc * ih
    return sd


def _forward_plain(prm, wav_pad, inj, *, st, nsteps, z0, hist):
    lam, mu, b0, b1, damp, d0, d1, mu01, d01 = prm
    B, nz, nx = inj.shape
    total = wav_pad.shape[0]
    sd = _make_sd(st)
    P, M, C, s = st.P, st.M, st.C, st.s
    z = inj.new_zeros((B, nz, nx))
    vx = vz = txx = tzz = txz = z
    if hist:
        rec = inj.new_empty((B, total, 2, nx))
        H = inj.new_empty((B, total, 4, nz, nx))
        illum = inj.new_zeros((B, nz, nx))
    else:
        rec = inj.new_empty((B, total, 2, 2, nx))
    for t in range(total):
        if hist:
            rec[:, t] = tzz[:, z0:z0 + 2]
        else:
            rec[:, t, 0] = tzz[:, z0:z0 + 2]
            div_c = sd(vx, C, 0) + sd(vz, C, 1)
            rec[:, t, 1] = div_c[:, z0:z0 + 2]
        # v[t+1] = damp (v + dt b div(tau))
        dtau_x = sd(txx, P, 0) + sd(txz, M, 1)
        dtau_z = sd(tzz, P, 1) + sd(txz, M, 0)
        vxn = d0 * (vx + s * b0 * dtau_x)
        vzn = d1 * (vz + s * b1 * dtau_z)
        if hist:
            H[:, t, 0] = vxn
            H[:, t, 1] = vzn
            H[:, t, 2] = dtau_x
            H[:, t, 3] = dtau_z
            if t < nsteps:
                illum = illum + vxn * vxn + vzn * vzn
        # tau[t+1] = damp (tau + dt lam diag(div v') + dt mu (grad+grad^T))
        dvx = sd(vxn, M, 0)
        dvz = sd(vzn, M, 1)
        div_vn = dvx + dvz
        txxn = damp * (txx + s * lam * div_vn + 2.0 * s * mu * dvx)
        tzzn = damp * (tzz + s * lam * div_vn + 2.0 * s * mu * dvz)
        g = sd(vxn, P, 1) + sd(vzn, P, 0)
        txzn = d01 * (txz + s * mu01 * g)
        wav_t = wav_pad[t]
        vx, vz = vxn, vzn
        txx = txxn + wav_t * inj
        tzz = tzzn + wav_t * inj
        txz = txzn
    if hist:
        return rec, H, illum
    return rec


def _adjoint_plain(prm, hist, res, *, st, nsteps, z0):
    lam, mu, b0, b1, damp, d0, d1, mu01, d01 = prm
    B, total, _, nz, nx = hist.shape
    sd = _make_sd(st)
    P, M, s = st.P, st.M, st.s
    z = hist.new_zeros((B, nz, nx))
    vxb = vzb = txxb = tzzb = txzb = z
    glam = gmun = gmup = gb0 = gb1 = z
    for t in range(nsteps - 1, -1, -1):
        vnx, vnz = hist[:, t, 0], hist[:, t, 1]
        dtx, dtz = hist[:, t, 2], hist[:, t, 3]
        dvx = sd(vnx, M, 0)
        dvz = sd(vnz, M, 1)
        div_vn = dvx + dvz
        g = sd(vnx, P, 1) + sd(vnz, P, 0)

        thx = damp * txxb
        thz = damp * tzzb
        tho = d01 * txzb
        sthd = thx + thz
        glam = glam + s * div_vn * sthd
        gmun = gmun + 2.0 * s * (dvx * thx + dvz * thz)
        gmup = gmup + s * g * tho

        dvbx = s * lam * sthd + 2.0 * s * mu * thx
        dvbz = s * lam * sthd + 2.0 * s * mu * thz
        gb_ = s * mu01 * tho
        vbtx = vxb - sd(dvbx, P, 0) - sd(gb_, M, 1)
        vbtz = vzb - sd(dvbz, P, 1) - sd(gb_, M, 0)
        vhx = d0 * vbtx
        vhz = d1 * vbtz
        gb0 = gb0 + s * dtx * vhx
        gb1 = gb1 + s * dtz * vhz

        dtbx = s * b0 * vhx
        dtbz = s * b1 * vhz
        txxb = thx - sd(dtbx, M, 0)
        tzzb = thz - sd(dtbz, M, 1)
        txzb = tho - sd(dtbx, P, 1) - sd(dtbz, P, 0)
        # the residual lands in tau_zz's adjoint on rows z0, z0+1
        tzzb[:, z0:z0 + 2] = tzzb[:, z0:z0 + 2] + res[:, t]
        vxb, vzb = vhx, vhz
    return glam, gmun, gmup, gb0, gb1


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# (argtypes, restype) of the C entry points of csrc/elastic2d.cu; every
# pointer and the stream are c_void_p, so no 64-bit value is cut
SIGNATURES = {
    "elastic2d_forward": ([_P] * 12 + [_I] + [_P] * 4 + [_I] * 8 + [_P] * 3
                          + [_F] * 4 + [_P], _I),
    "elastic2d_adjoint": ([_P] * 13 + [_I] * 7 + [_P] * 2 + [_F] * 4 + [_P],
                          _I),
    "elastic2d_forward_blocks": ([_I], _I),
    "elastic2d_error_string": ([_I], ctypes.c_char_p),
}


def _lib():
    lib = cuda_build.load("elastic2d")
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
                           f"({lib.elastic2d_error_string(err).decode()})")


def _taps32(st, name):
    """One stencil's weights as a float32 array in offset order, for the
    kernels, which hold the offsets: D+ -r+1..r and D- -r..r-1 (2r taps,
    none zero), the centred one -r..r (2r+1 taps; a zero weight adds
    nothing to a sum, so dropping it in the twin changes no value)."""
    taps = dict((o, w) for w, o in getattr(st, name))
    lo, hi = {"P": (1 - st.r, st.r), "M": (-st.r, st.r - 1),
              "C": (-st.r, st.r)}[name]
    if name != "C" and len(taps) != 2 * st.r:
        raise ValueError(f"stencil {name} has {len(taps)} non-zero taps; "
                         f"the kernels take {2 * st.r}")
    return np.asarray([taps.get(o, 0.0) for o in range(lo, hi + 1)],
                      np.float32)


# the forward march (csrc/elastic2d.cu March, kMarchCols): blocks of
# FWD_THREADS threads, one a column of a strip of FWD_THREADS - 2r columns
# and its r halo; the blocks an SM of an H100 holds at radius 4 (what
# ``elastic2d_forward_blocks`` returns there for the modelling step); the
# fused reverse step's tile and threads (kTX x kTZ, kAThreads)
FWD_THREADS = 64
FWD_BLOCKS_PER_SM = 10
H100_SMS = 132
ADJ_TILE = (32, 32)
ADJ_THREADS = 512


def _march_smem(r):
    """Shared-memory bytes of a march block (csrc/elastic2d.cu
    ``March<R>::kBytes``): two sets of rows, each tau_xx and tau_xz on the
    strip and a 2r halo, vx and vz on the strip and an r halo."""
    return 4 * 2 * (2 * (FWD_THREADS + 2 * r) + 2 * FWD_THREADS)


def forward_launch(B, nz, nx, r, sms=H100_SMS, blocks_per_sm=None):
    """The forward march's launch at these shapes: a block a strip of
    ``strip`` = FWD_THREADS - 2r columns of one shot, walking down a
    segment of ``seg`` rows after 2r lead-in rows; threads, grid of one
    step (strips, segments, shots) and shared-memory bytes of a block.
    The segments split z so that the card's ``sms`` multiprocessors,
    ``blocks_per_sm`` blocks at a time (the card's count for the kernel,
    ``FWD_BLOCKS_PER_SM`` if not given), take the blocks in the fewest
    iterations: rounds of blocks times the rows a block walks. Raises
    ValueError for what the kernel does not take (``tile_launch``)."""
    strip = FWD_THREADS - 2 * r
    tile_launch("elastic forward", B, nz, nx, r, (strip, max(nz, 1)),
                FWD_THREADS, _march_smem(r), shots_first=False)
    slots = sms * (blocks_per_sm or FWD_BLOCKS_PER_SM)
    strips = -(-nx // strip) * B
    best = None
    for nseg in range(1, nz + 1):
        seg = -(-nz // nseg)
        rounds = -(-strips * -(-nz // seg) // slots)
        cost = rounds * (seg + 2 * r)
        if best is None or cost < best[0]:
            best = (cost, seg)
    launch = tile_launch("elastic forward", B, nz, nx, r, (strip, best[1]),
                         FWD_THREADS, _march_smem(r), shots_first=False)
    launch.strip, launch.seg = strip, best[1]
    return launch


def adjoint_launch(B, nz, nx, r):
    """The fused reverse step's launch at these shapes: the tile, threads,
    grid of one step (shots, x tiles, z tiles) and shared-memory bytes of a
    block (the three derived stress-adjoint fields on the tile and a 2r
    halo, the three damped stress adjoints on the tile, the history's vx',
    vz' and the two velocity products (s b) vh on the tile and an r halo;
    at most 98,304 bytes, r = 8). Raises ValueError for what the kernel
    does not take (``tile_launch``)."""
    tx, tz = ADJ_TILE
    smem = 4 * (3 * (tx + 4 * r) * (tz + 4 * r) + 3 * tx * tz
                + 4 * (tx + 2 * r) * (tz + 2 * r))
    return tile_launch("elastic adjoint", B, nz, nx, r, ADJ_TILE,
                       ADJ_THREADS, smem, shots_first=True)


_BLOCKS = {}


def _forward_blocks(lib, r):
    """The blocks of the forward march an SM of the current card holds at
    radius r, asked of the library once. Both sweeps plan their segments
    from the modelling step's count, the smaller: the history sweep, which
    writes 45.8 MB of history a step at the SMARM2 main path, loses more to
    the lead-in rows of shorter segments than it gains from more blocks."""
    key = (torch.cuda.current_device(), r)
    if key not in _BLOCKS:
        n = lib.elastic2d_forward_blocks(r)
        if n < 1:
            _check(lib, "elastic2d_forward_blocks", -n or 1)
        _BLOCKS[key] = n
    return _BLOCKS[key]


def _forward_cuda(prm, wav_pad, inj, *, st, nsteps, z0, hist):
    B, nz, nx = inj.shape
    forward_launch(B, nz, nx, st.r)
    lib = _lib()
    sms = torch.cuda.get_device_properties(inj.device).multi_processor_count
    with torch.cuda.device(inj.device):
        zlen = forward_launch(B, nz, nx, st.r, sms,
                              _forward_blocks(lib, st.r)).seg
    total = wav_pad.shape[0]
    if hist:
        # the history first, so that it takes the largest free block
        H = inj.new_empty((B, total, 4, nz, nx))
        rec = inj.new_empty((B, total, 2, nx))
        illum = inj.new_zeros((B, nz, nx))
    else:
        rec = inj.new_empty((B, total, 2, 2, nx))
        H = illum = None
    cells, vals, K = _source_list(inj)
    scratch = inj.new_empty((10, B, nz, nx))
    wp, wm, wc = (_taps32(st, k) for k in ("P", "M", "C"))
    with torch.cuda.device(inj.device):
        err = lib.elastic2d_forward(
            *(p.data_ptr() for p in prm), wav_pad.data_ptr(),
            cells.data_ptr(), vals.data_ptr(), K, rec.data_ptr(),
            H.data_ptr() if hist else None,
            illum.data_ptr() if hist else None, scratch.data_ptr(), B, nz,
            nx, total, nsteps, z0, st.r, zlen, wp.ctypes.data,
            wm.ctypes.data, wc.ctypes.data, st.ihx, st.ihz, st.s, st.two_s,
            torch.cuda.current_stream(inj.device).cuda_stream)
    _check(lib, "elastic2d_forward", err)
    if hist:
        return rec, H, illum
    return rec


def _adjoint_cuda(prm, hist, res, *, st, nsteps, z0):
    B, total, _, nz, nx = hist.shape
    adjoint_launch(B, nz, nx, st.r)
    lib = _lib()
    grads = hist.new_zeros((5, B, nz, nx))
    scratch = hist.new_empty((10, B, nz, nx))     # two adjoint states
    wp, wm = (_taps32(st, k) for k in ("P", "M"))
    with torch.cuda.device(hist.device):
        err = lib.elastic2d_adjoint(
            *(p.data_ptr() for p in prm), hist.data_ptr(), res.data_ptr(),
            grads.data_ptr(), scratch.data_ptr(), B, nz, nx, total, nsteps,
            z0, st.r, wp.ctypes.data, wm.ctypes.data, st.ihx, st.ihz, st.s,
            st.two_s, torch.cuda.current_stream(hist.device).cuda_stream)
    _check(lib, "elastic2d_adjoint", err)
    return tuple(grads)


def _forward(fn, plain, prm, inj, wav_pad, dt, *, nt, nx, nz, space_order,
             spacing, z0, seg):
    """The two forward sweeps; ``fn`` names the one."""
    nsteps = nt - 1
    nseg = -(-nsteps // seg)
    B = inj.shape[0]
    dev = _checked(fn, tuple(prm) + (inj, wav_pad),
                   ((nz, nx),) * 9 + ((B, nz, nx), (nseg * seg,)), z0, nz)
    st = _stencils(space_order, spacing, dt, inj.dtype)
    hist = fn == "elastic_fwd_hist_segments"
    kw = dict(st=st, nsteps=nsteps, z0=z0, hist=hist)
    if dev.type == "cuda" and not plain:
        out = _forward_cuda(prm, wav_pad, inj, **kw)
        LAUNCHES[fn] += 1
    else:
        TWIN_CALLS[fn] += 1
        out = _forward_plain(prm, wav_pad, inj, **kw)
    if not hist:
        return out.reshape(B, nseg, seg, 2, 2, nx)
    rec, H, illum = out
    return (rec.reshape(B, nseg, seg, 2, nx),
            H.reshape(B, nseg, seg, 4, nz, nx), illum)


def _gradient(plain, prm, hist, res_rows, dt, *, nt, nx, nz, space_order,
              spacing, z0, seg):
    fn = "elastic_grad_stream_segments"
    nsteps = nt - 1
    nseg = -(-nsteps // seg)
    B = hist.shape[0]
    dev = _checked(fn, tuple(prm) + (hist, res_rows),
                   ((nz, nx),) * 9 + ((B, nseg, seg, 4, nz, nx),
                                      (B, nseg, seg, 2, nx)), z0, nz)
    st = _stencils(space_order, spacing, dt, hist.dtype)
    H = hist.reshape(B, nseg * seg, 4, nz, nx)
    res = res_rows.reshape(B, nseg * seg, 2, nx)
    kw = dict(st=st, nsteps=nsteps, z0=z0)
    if dev.type == "cuda" and not plain:
        out = _adjoint_cuda(prm, H, res, **kw)
        LAUNCHES[fn] += 1
        return out
    TWIN_CALLS[fn] += 1
    return _adjoint_plain(prm, H, res, **kw)


def elastic_segments(lam_t, mu_t, b0_t, b1_t, damp_t, d0_t, d1_t, mu01_t,
                     d01_t, inj_t, wav_pad, dt, *, nt, nx, nz, space_order,
                     spacing, z0):
    """Batched elastic modeling sweep. Transposed (nz, nx) parameter
    operands (``stagger_params``), ``inj_t`` (B, nz, nx) source patterns,
    ``wav_pad`` (nt-1,) from ``pad_wavelet``: the steps are one segment,
    which pads none. Returns rec_rows (B, 1, nt-1, 2, 2, nx): per step,
    rows z0, z0+1 of (tau_zz, div v)."""
    return _forward("elastic_segments", False,
                    (lam_t, mu_t, b0_t, b1_t, damp_t, d0_t, d1_t, mu01_t,
                     d01_t), inj_t, wav_pad, dt, nt=nt, nx=nx, nz=nz,
                    space_order=space_order, spacing=spacing, z0=z0,
                    seg=nt - 1)


def elastic_fwd_hist_segments(lam_t, mu_t, b0_t, b1_t, damp_t, d0_t, d1_t,
                              mu01_t, d01_t, inj_t, wav_pad, dt, *, nt, nx,
                              nz, space_order, spacing, z0, seg):
    """Batched history-streaming elastic forward. Operands as in
    ``elastic_segments``, ``wav_pad`` of length nseg*seg with nseg =
    ceil((nt-1)/seg). Returns (rec_rows (B, nseg, seg, 2, nx) tau_zz rows,
    hist (B, nseg, seg, 4, nz, nx) of (vx', vz', dtau_x, dtau_z), illum
    (B, nz, nx))."""
    return _forward("elastic_fwd_hist_segments", False,
                    (lam_t, mu_t, b0_t, b1_t, damp_t, d0_t, d1_t, mu01_t,
                     d01_t), inj_t, wav_pad, dt, nt=nt, nx=nx, nz=nz,
                    space_order=space_order, spacing=spacing, z0=z0, seg=seg)


def elastic_grad_stream_segments(lam_t, mu_t, b0_t, b1_t, damp_t, d0_t,
                                 d1_t, mu01_t, d01_t, hist, res_rows, dt, *,
                                 nt, nx, nz, space_order, spacing, z0, seg):
    """Batched adjoint sweep over the streamed history with the residual
    rows (B, nseg, seg, 2, nx) on tau_zz's adjoint. Returns the five
    transposed images (glam, gmu_node, gmu01, gb0, gb1), each (B, nz, nx);
    the caller applies ``avg_to_T``, the chain rule and ``pad_fold``."""
    return _gradient(False, (lam_t, mu_t, b0_t, b1_t, damp_t, d0_t, d1_t,
                             mu01_t, d01_t), hist, res_rows, dt, nt=nt,
                     nx=nx, nz=nz, space_order=space_order, spacing=spacing,
                     z0=z0, seg=seg)


# The plain twins under the wrappers' signatures, on any device: the
# comparison on the card calls them on CUDA tensors.

def elastic_segments_plain(*args, nt, nx, nz, space_order, spacing, z0):
    """Plain torch twin of ``elastic_segments``."""
    *prm, inj_t, wav_pad, dt = args
    return _forward("elastic_segments", True, tuple(prm), inj_t, wav_pad, dt,
                    nt=nt, nx=nx, nz=nz, space_order=space_order,
                    spacing=spacing, z0=z0, seg=nt - 1)


def elastic_fwd_hist_plain(*args, **kw):
    """Plain torch twin of ``elastic_fwd_hist_segments``."""
    *prm, inj_t, wav_pad, dt = args
    return _forward("elastic_fwd_hist_segments", True, tuple(prm), inj_t,
                    wav_pad, dt, **kw)


def elastic_grad_stream_plain(*args, **kw):
    """Plain torch twin of ``elastic_grad_stream_segments``."""
    *prm, hist, res_rows, dt = args
    return _gradient(True, tuple(prm), hist, res_rows, dt, **kw)


def elastic_forward_segments(lam, mu, b, damp, src_wav, src_idx, src_w,
                             rec_idx, rec_w, dt, *, nt, spacing,
                             space_order=4):
    """One shot of ``staggered.elastic_forward`` through
    ``elastic_segments`` (the counterpart of the JAX
    ``elastic_forward_pallas``; gate with ``elastic_supported``).
    ``lam``, ``mu``, ``b``, ``damp`` are untransposed padded tensors (``b``,
    ``damp`` may be 0-dim), ``src_wav`` (nt, 1) tensor, the tables numpy
    ``interp_table`` outputs of the one source point and the receivers.
    Returns (rec1, rec2) traces, each (nt, nrec)."""
    nx, nz = lam.shape
    dev, dtype = lam.device, lam.dtype
    z0 = int(np.asarray(rec_idx)[..., 1].min())
    nsteps = nt - 1
    inj = source_pattern(np.asarray(src_idx)[None], np.asarray(src_w)[None],
                         dt, (nx, nz), dtype, dev)
    rows = elastic_segments(
        *stagger_params(lam, mu, b, damp), inj.transpose(1, 2).contiguous(),
        pad_wavelet(src_wav, nsteps, nsteps), dt, nt=nt, nx=nx, nz=nz,
        space_order=space_order, spacing=spacing, z0=z0)
    r_w = torch.as_tensor(np.asarray(rec_w), dtype=dtype, device=dev)
    rec1, rec2 = _stag_assemble(rows, rec_idx, r_w, z0=z0, nt=nt,
                                nsteps=nsteps, nx=nx)
    return rec1[0], rec2[0]
