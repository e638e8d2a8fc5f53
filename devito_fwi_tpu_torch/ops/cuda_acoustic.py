"""CUDA kernels for the 2-D acoustic OT2 time loops, each beside its plain
torch twin. Counterpart of ``devito_fwi_tpu.ops.pallas_acoustic``.

Five sweeps carry the 2-D acoustic FWI:

* ``forward_rec_segments``: forward modeling that records the two
  receiver rows of every step (observed data, direct wave, line-search
  trials);
* ``forward_dt2_segments``: the same forward, also streaming the d2u/dt2
  history ``un - 2u + up`` and the illumination ``sum un^2``;
* ``gradient_stream_segments``: the reverse adjoint sweep over that
  history, ``grad = -(1/s^2) sum_t dt2[t] * v[t]``;
* ``forward_ckpt_segments``: the forward that keeps, instead of the
  history, the (u, u_prev) pair at the start of every segment (plus the
  receiver rows and the illumination);
* ``gradient_segments``: the reverse sweep of the checkpoint route: for
  each segment from the last, the forward steps of that segment recomputed
  from its pair into a one-segment history, then its adjoint steps. With
  a float32 history it equals ``gradient_stream_segments`` bitwise.

Fields use the transposed (nz, nx) layout with x contiguous, so the two
receiver z-planes z0, z0+1 are two contiguous rows. The nt-2 forward steps
are laid out as ``nseg`` segments of ``seg`` steps (``_ckpt_layout``); on
the card the segment count is only a padding layout, and the padded tail
steps (``t >= nsteps``) are stepped forward with a zero wavelet, left out
of the illumination and skipped in reverse.

Each wrapper checks its operands, computes ``denom = 1/(m + hd)`` and
``two_m_hd = 2m + hd`` once, and then, for CUDA tensors, launches the
kernel of ``csrc/acoustic2d.cu`` (one ctypes call per sweep on the current
stream) and adds one to ``LAUNCHES[name]``; for CPU tensors it runs the
plain twin, a Python loop over the steps with the kernel's exact
arithmetic (``_make_lap_t``). On another device it raises. The twins take
float32 or float64; the kernels float32.

The forwards, and the recompute of ``gradient_segments``, run as one
fused launch for two steps over 32 x 32 tiles of a shot
(``forward_launch``): u on the tile and a 2r halo in shared memory, the
first step on the tile and an r halo, the second on the tile; the source
added only at the pattern's non-zero cells (``_source_list``). The
reverse sweeps, streamed and after each segment's recompute, run the same
tile in reverse (``adjoint_launch``): two steps a launch, the residual rows
added in the first step's halo too, both steps' gradient terms summed in
registers.
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace

import numpy as np
import torch

from ..utils.fd import second_derivative_weights
from . import cuda_build
from .acoustic import _ckpt_layout, shift
from .interp import interp_table, valid_corners

__all__ = ["forward_rec_segments", "forward_dt2_segments",
           "gradient_stream_segments", "forward_ckpt_segments",
           "gradient_segments", "forward_rec_plain", "forward_dt2_plain",
           "gradient_stream_plain", "forward_ckpt_plain",
           "gradient_segments_plain", "source_pattern",
           "pad_wavelet", "residual_rows", "receiver_plane_matrix",
           "matmul_full", "geometry_supported", "forward_launch",
           "adjoint_launch", "tile_launch", "LAUNCHES", "TWIN_CALLS",
           "reset_counters"]

KERNELS = ("forward_rec_segments", "forward_dt2_segments",
           "gradient_stream_segments", "forward_ckpt_segments",
           "gradient_segments")
# launches of each kernel (one per sweep) and calls of each plain twin
LAUNCHES = dict.fromkeys(KERNELS, 0)
TWIN_CALLS = dict.fromkeys(KERNELS, 0)


def reset_counters():
    for name in KERNELS:
        LAUNCHES[name] = 0
        TWIN_CALLS[name] = 0


def _stencil_constants(space_order, spacing, dt):
    """(w, inv_h2x, inv_h2z, s2): half-stencil weights and the per-axis
    1/h^2 scales with dt^2 folded in (see ``_make_lap_t``)."""
    w_full = second_derivative_weights(space_order)
    w = tuple(float(v) for v in np.asarray(w_full)[len(w_full) // 2:])
    s2 = float(dt) ** 2
    inv_h2x = float(1.0 / spacing[0] ** 2) * s2
    inv_h2z = float(1.0 / spacing[1] ** 2) * s2
    return w, inv_h2x, inv_h2z, s2


def _make_lap_t(w, inv_h2x, inv_h2z, fs):
    """Laplacian on the transposed (..., nz, nx) layout with zero-fill
    shifts. The association is the kernels' and the JAX kernels', term
    for term: w rounded to the field's type, (shift+ + shift-) summed
    before the weight multiply, per-axis accumulation, the x term scaled
    and added first, and under a free surface rows 0..r of the unscaled
    z-derivative replaced by the mirrored stencil (plain +k term, then the
    odd mirror). Folding dt^2/h^2 into one constant per tap gives a
    rounding bias of the same sign every step, which grows over a run."""
    r = len(w) - 1

    def lap(u):
        accx = w[0] * u
        for k in range(1, r + 1):
            accx = accx + w[k] * (shift(u, k, -1) + shift(u, -k, -1))
        accz = w[0] * u
        for k in range(1, r + 1):
            accz = accz + w[k] * (shift(u, k, -2) + shift(u, -k, -2))
        if fs:
            rows = []
            for z in range(r + 1):
                acc = w[0] * u[..., z, :]
                for k in range(1, r + 1):
                    acc = acc + w[k] * u[..., z + k, :]
                    i = z - k
                    if i > 0:
                        acc = acc + w[k] * u[..., i, :]
                    elif i < 0:
                        acc = acc - w[k] * u[..., -i, :]
                rows.append(acc)
            accz = torch.cat([torch.stack(rows, -2), accz[..., r + 1:, :]],
                             -2)
        return accx * inv_h2x + accz * inv_h2z

    return lap


# ---------------------------------------------------------------------------
# operands
# ---------------------------------------------------------------------------

def source_pattern(s_idx, s_w, m, s2):
    """Dense per-shot source pattern (B, nx, nz): ``w * s^2 / m`` at the
    bilinear corners of each shot's source. ``s_idx`` (B, 1, 4, 2) and
    ``s_w`` (B, 1, 4) are numpy ``interp_table`` outputs; ``m`` is the
    untransposed (nx, nz) squared slowness. Out-of-grid corners add
    nothing."""
    B = s_idx.shape[0]
    valid, cl = valid_corners(s_idx[:, 0], tuple(m.shape))
    dev = m.device
    xi = torch.as_tensor(cl[..., 0], dtype=torch.long, device=dev)
    zi = torch.as_tensor(cl[..., 1], dtype=torch.long, device=dev)
    w = torch.as_tensor(np.where(valid, s_w[:, 0], 0.0), dtype=m.dtype,
                        device=dev)
    vals = w * s2 / m[xi, zi]
    bi = torch.arange(B, device=dev)[:, None].expand_as(xi)
    out = m.new_zeros((B,) + tuple(m.shape))
    return out.index_put_((bi, xi, zi), vals, accumulate=True)


def pad_wavelet(src_wav, nt, total):
    """``src_wav[1:nt-1, 0]`` zero-padded to the segment-layout length."""
    out = src_wav.new_zeros((total,))
    out[:nt - 2] = src_wav[1:nt - 1, 0]
    return out


def matmul_full(a, b):
    """``a @ b`` at full precision: TF32 is switched off for matrix products
    and cuDNN during this one product, since its ~3 decimal digits would
    show in the traces and residual rows. The caller's settings are put
    back afterwards."""
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = mm.allow_tf32, dnn.allow_tf32
    mm.allow_tf32 = dnn.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        mm.allow_tf32, dnn.allow_tf32 = saved


def receiver_plane_matrix(r_idx, vals, z0, nx):
    """(nrec, 2*nx) matrix holding each receiver's corner values ``vals``
    (nrec, 4) at column ``plane*nx + x``, plane 0 on row z0 and 1 on row
    z0+1. Corners off those two rows or off the x range get nothing."""
    xi = r_idx[..., 0]
    zi = r_idx[..., 1]
    valid = (xi >= 0) & (xi < nx) & ((zi == z0) | (zi == z0 + 1))
    col = (zi != z0).astype(np.int64) * nx + np.clip(xi, 0, nx - 1)
    dev = vals.device
    rows = torch.arange(r_idx.shape[0], device=dev)[:, None].expand(
        col.shape)
    col_t = torch.as_tensor(col, device=dev)
    vals = torch.where(torch.as_tensor(valid, device=dev), vals,
                       torch.zeros((), dtype=vals.dtype, device=dev))
    out = vals.new_zeros((r_idx.shape[0], 2 * nx))
    return out.index_put_((rows, col_t), vals, accumulate=True)


def residual_rows(res_stack, r_idx, r_w, m, s2, z0, nsteps, seg, nseg):
    """Receiver residuals (B, nt, nrec) folded with the interpolation
    weights and ``s^2/m`` into dense two-row slabs (B, nseg, seg, 2, nx)
    for the reverse sweep: one matrix product against the scattered
    (nrec, 2*nx) weights, at full precision (TF32 off). ``m`` is the
    untransposed (nx, nz) squared slowness; ``r_idx`` numpy, ``r_w``
    tensor (nrec, 4)."""
    B = res_stack.shape[0]
    nx, nz = m.shape
    xi = torch.as_tensor(np.clip(r_idx[..., 0], 0, nx - 1),
                         dtype=torch.long, device=m.device)
    zi = torch.as_tensor(np.clip(r_idx[..., 1], 0, nz - 1),
                         dtype=torch.long, device=m.device)
    V = receiver_plane_matrix(r_idx, r_w * s2 / m[xi, zi], z0, nx)
    res_pad = res_stack.new_zeros((B, nseg * seg, r_idx.shape[0]))
    res_pad[:, :nsteps] = res_stack[:, 1:nsteps + 1]
    rows = matmul_full(res_pad, V)
    return rows.reshape(B, nseg, seg, 2, nx)


def geometry_supported(geometry):
    """True when the kernels apply: 2-D grid and all receivers between the
    same two ADJACENT z-planes (z0, z0+1), both inside the padded grid —
    the kernels record and inject exactly those two rows."""
    model = geometry.model
    if model.dim != 2:
        return False
    r_idx, _ = interp_table(geometry.rec_positions, model.origin_pml,
                            model.spacing, dtype=model.dtype)
    zplanes = np.unique(np.asarray(r_idx)[..., 1])
    if len(zplanes) > 2 or zplanes.max() - zplanes.min() > 1:
        return False
    nz = model.padded_shape[1]
    z0 = int(zplanes.min())
    return 0 <= z0 and z0 + 2 <= nz


# ---------------------------------------------------------------------------
# plain twins: Python loops over the steps with the kernels' arithmetic
# ---------------------------------------------------------------------------

def _forward_plain(m, two_m_hd, denom, wav_pad, inj, *, w, inv_h2x,
                   inv_h2z, nsteps, seg, z0, fs, hist, ckpt):
    B, nz, nx = inj.shape
    total = wav_pad.shape[0]
    lap = _make_lap_t(w, inv_h2x, inv_h2z, fs)
    u = inj.new_zeros((B, nz, nx))
    up = inj.new_zeros((B, nz, nx))
    rec = inj.new_empty((B, total, 2, nx))
    dt2 = inj.new_empty((B, total, nz, nx)) if hist else None
    pairs = inj.new_empty((B, total // seg, 2, nz, nx)) if ckpt else None
    illum = inj.new_zeros((B, nz, nx)) if hist or ckpt else None
    for t in range(total):
        rec[:, t] = u[:, z0:z0 + 2, :]
        if ckpt and t % seg == 0:
            pairs[:, t // seg, 0] = u
            pairs[:, t // seg, 1] = up
        un = (lap(u) + two_m_hd * u - m * up) * denom + wav_pad[t] * inj
        if hist:
            dt2[:, t] = un - 2.0 * u + up
        if illum is not None and t < nsteps:
            illum = illum + un * un
        up, u = u, un
    return rec, dt2 if hist else pairs, illum


def _adjoint_steps(lap, m, two_m_hd, denom, dt2, res, state, z0, lo, hi,
                   t0):
    """Reverse steps t = hi-1 .. lo over a history holding step t at
    ``t - t0``; ``state`` = [v, vn, grad] is updated in place."""
    v, vn, grad = state
    for t in range(hi - 1, lo - 1, -1):
        grad = grad + dt2[:, t - t0] * v
        vnew = (lap(v) + two_m_hd * v - m * vn) * denom
        vnew[:, z0:z0 + 2] = vnew[:, z0:z0 + 2] + res[:, t]
        vn, v = v, vnew
    state[:] = v, vn, grad


def _adjoint_plain(m, two_m_hd, denom, dt2, res, *, w, inv_h2x, inv_h2z,
                   nsteps, z0, fs, neg_inv_s2):
    B, _, nz, nx = dt2.shape
    lap = _make_lap_t(w, inv_h2x, inv_h2z, fs)
    state = [dt2.new_zeros((B, nz, nx)) for _ in range(3)]
    _adjoint_steps(lap, m, two_m_hd, denom, dt2, res, state, z0, 0, nsteps,
                   0)
    return state[2] * neg_inv_s2


def _segments_plain(m, two_m_hd, denom, wav_pad, inj, pairs, res, *, w,
                    inv_h2x, inv_h2z, nsteps, seg, z0, fs, neg_inv_s2):
    """Checkpoint-route reverse sweep: per segment k (last first), the seg
    forward steps from pair k into a one-segment history, then the
    segment's adjoint steps t < nsteps."""
    B, nseg, _, nz, nx = pairs.shape
    lap = _make_lap_t(w, inv_h2x, inv_h2z, fs)
    state = [inj.new_zeros((B, nz, nx)) for _ in range(3)]
    dt2 = inj.new_empty((B, seg, nz, nx))
    for k in range(nseg - 1, -1, -1):
        base = k * seg
        u, up = pairs[:, k, 0], pairs[:, k, 1]
        for i in range(seg):
            un = (lap(u) + two_m_hd * u - m * up) * denom \
                + wav_pad[base + i] * inj
            dt2[:, i] = un - 2.0 * u + up
            up, u = u, un
        _adjoint_steps(lap, m, two_m_hd, denom, dt2, res, state, z0, base,
                       min(base + seg, nsteps), base)
    return state[2] * neg_inv_s2


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

MAX_RADIUS = 8
# shared memory a block can use on the H100 (bytes)
SMEM_LIMIT = 232_448


def tile_launch(what, B, nz, nx, r, tile, threads, smem, shots_first):
    """A fused step kernel's launch: one block a ``tile`` (x, z) of one
    shot, ``threads`` a block, ``smem`` bytes of shared memory; the grid
    (shots, x tiles, z tiles) if ``shots_first``, else (x tiles, z tiles,
    shots). Raises ValueError, naming ``what``, for what the kernel does
    not take: a radius outside 1 .. 8, an empty grid or one of 2^31 cells,
    a launch grid past CUDA's (2^31 - 1, 65535, 65535) or shared memory
    past a block's."""
    if not 1 <= r <= MAX_RADIUS:
        raise ValueError(f"{what}: stencil radius {r}; the kernel takes "
                         f"1 .. {MAX_RADIUS}")
    tx, tz = tile
    tiles = (-(-nx // tx), -(-nz // tz))
    grid = (B,) + tiles if shots_first else tiles + (B,)
    if min(B, nz, nx) < 1 or nz * nx >= 2 ** 31 or grid[0] >= 2 ** 31 \
            or max(grid[1:]) >= 2 ** 16:
        raise ValueError(f"{what}: {B} shots of {nz} x {nx}; the kernel "
                         "takes a positive grid of fewer than 2^31 cells "
                         "and a launch grid of at most (2^31 - 1, 65535, "
                         "65535) blocks")
    if smem > SMEM_LIMIT:
        raise ValueError(f"{what}: {smem} bytes of shared memory a block; "
                         f"the card gives at most {SMEM_LIMIT}")
    return SimpleNamespace(tile=tile, threads=threads, grid=grid, smem=smem)


# the fused forward's tile, threads and steps a launch (csrc/acoustic2d.cu
# kTX x kTZ, kThreads, kSteps)
FWD_TILE = (32, 32)
FWD_THREADS = 512
FWD_STEPS = 2


def _tile_smem(r):
    """Shared-memory bytes of a two-step tile: a field on the tile and a 2r
    halo, the first step's on the tile and an r halo."""
    tx, tz = FWD_TILE
    return 4 * ((tx + 4 * r) * (tz + 4 * r) + (tx + 2 * r) * (tz + 2 * r))


def forward_launch(B, nz, nx, r):
    """The fused forward's launch at these shapes: the tile, threads, grid
    of one launch (shots, x tiles, z tiles), the steps a launch and the
    shared-memory bytes of a block (u on the tile and a 2r halo, the first
    step's field on the tile and an r halo; at most 25,600 bytes, r = 8).
    Raises ValueError for what the kernel does not take (``tile_launch``)."""
    launch = tile_launch("acoustic forward", B, nz, nx, r, FWD_TILE,
                         FWD_THREADS, _tile_smem(r), shots_first=True)
    launch.steps = FWD_STEPS
    return launch


def adjoint_launch(B, nz, nx, r):
    """The reverse sweep's launch at these shapes: the forwards' two-step
    tile in reverse, with ``forward_launch``'s tile, threads, grid, steps a
    launch and shared memory (v on the tile and a 2r halo, step t on the
    tile and an r halo). Raises ValueError for what the kernel does not
    take (``tile_launch``)."""
    launch = tile_launch("acoustic adjoint", B, nz, nx, r, FWD_TILE,
                         FWD_THREADS, _tile_smem(r), shots_first=True)
    launch.steps = FWD_STEPS
    return launch


def _source_list(inj):
    """inj's non-zero cells per shot: (cells (B, K) int32 z * nx + x, -1
    where a shot has fewer, values (B, K)), K at least 1. Adding wt * 0 at
    the other cells would change no value, only the sign of a zero."""
    B = inj.shape[0]
    flat = inj.reshape(B, -1)
    hit = flat != 0
    count = hit.sum(1)
    K = max(int(count.max()), 1)
    b, cell = hit.nonzero(as_tuple=True)
    pos = torch.arange(b.numel(), device=inj.device) - \
        (torch.cumsum(count, 0) - count)[b]
    cells = torch.full((B, K), -1, dtype=torch.int32, device=inj.device)
    vals = inj.new_zeros((B, K))
    cells[b, pos] = cell.to(torch.int32)
    vals[b, pos] = flat[b, cell]
    return cells, vals, K


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


# (argtypes, restype) of the C entry points of csrc/acoustic2d.cu; every
# pointer and the stream are c_void_p, so no 64-bit value is cut
SIGNATURES = {
    "acoustic2d_forward": ([_P] * 6 + [_I] + [_P] * 5 + [_I] * 9
                           + [_P, _F, _F, _P], _I),
    "acoustic2d_adjoint": ([_P] * 7 + [_I] * 8 + [_P, _F, _F, _F, _P], _I),
    "acoustic2d_gradient_segments": ([_P] * 6 + [_I] + [_P] * 6 + [_I] * 9
                                     + [_P, _F, _F, _F, _P], _I),
    "acoustic2d_error_string": ([_I], ctypes.c_char_p),
}


def _lib():
    lib = cuda_build.load("acoustic2d")
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
                           f"({lib.acoustic2d_error_string(err).decode()})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _forward_cuda(m, two_m_hd, denom, wav_pad, inj, *, w, inv_h2x, inv_h2z,
                  nsteps, seg, z0, fs, hist, ckpt):
    B, nz, nx = inj.shape
    forward_launch(B, nz, nx, len(w) - 1)
    lib = _lib()
    total = wav_pad.shape[0]
    rec = inj.new_empty((B, total, 2, nx))
    dt2 = inj.new_empty((B, total, nz, nx)) if hist else None
    pairs = inj.new_empty((B, total // seg, 2, nz, nx)) if ckpt else None
    illum = inj.new_zeros((B, nz, nx)) if hist or ckpt else None
    cells, vals, K = _source_list(inj)
    state = inj.new_empty((4, B, nz, nx))    # u, up and a spare pair
    w32 = np.asarray(w, np.float32)
    with torch.cuda.device(inj.device):
        err = lib.acoustic2d_forward(
            m.data_ptr(), two_m_hd.data_ptr(), denom.data_ptr(),
            wav_pad.data_ptr(), cells.data_ptr(), vals.data_ptr(), K,
            rec.data_ptr(), _ptr(dt2), _ptr(illum), _ptr(pairs),
            state.data_ptr(), B, nz, nx, total, nsteps, seg, z0, int(fs),
            len(w) - 1, w32.ctypes.data, inv_h2x, inv_h2z,
            torch.cuda.current_stream(inj.device).cuda_stream)
    _check(lib, "acoustic2d_forward", err)
    return rec, dt2 if hist else pairs, illum


def _adjoint_fields(like, B, nz, nx):
    """The reverse sweep's 4 fields: the adjoint pair (zeros) and the spare
    pair the two-step tile ping-pongs through."""
    adj = like.new_empty((4, B, nz, nx))
    adj[:2].zero_()
    return adj


def _adjoint_cuda(m, two_m_hd, denom, dt2, res, *, w, inv_h2x, inv_h2z,
                  nsteps, z0, fs, neg_inv_s2):
    B, total, nz, nx = dt2.shape
    adjoint_launch(B, nz, nx, len(w) - 1)
    lib = _lib()
    grad = dt2.new_zeros((B, nz, nx))
    adj = _adjoint_fields(dt2, B, nz, nx)
    w32 = np.asarray(w, np.float32)
    with torch.cuda.device(dt2.device):
        err = lib.acoustic2d_adjoint(
            m.data_ptr(), two_m_hd.data_ptr(), denom.data_ptr(),
            dt2.data_ptr(), res.data_ptr(), grad.data_ptr(), adj.data_ptr(),
            B, nz, nx, total, nsteps, z0, int(fs),
            len(w) - 1, w32.ctypes.data, inv_h2x, inv_h2z, neg_inv_s2,
            torch.cuda.current_stream(dt2.device).cuda_stream)
    _check(lib, "acoustic2d_adjoint", err)
    return grad


def _segments_cuda(m, two_m_hd, denom, wav_pad, inj, pairs, res, *, w,
                   inv_h2x, inv_h2z, nsteps, seg, z0, fs, neg_inv_s2):
    B, nseg, _, nz, nx = pairs.shape
    forward_launch(B, nz, nx, len(w) - 1)
    adjoint_launch(B, nz, nx, len(w) - 1)
    lib = _lib()
    grad = inj.new_zeros((B, nz, nx))
    adj = _adjoint_fields(inj, B, nz, nx)
    state = inj.new_empty((4, B, nz, nx))    # u, up and a spare pair
    scratch = inj.new_empty((B, seg, nz, nx))
    cells, vals, K = _source_list(inj)
    w32 = np.asarray(w, np.float32)
    with torch.cuda.device(inj.device):
        err = lib.acoustic2d_gradient_segments(
            m.data_ptr(), two_m_hd.data_ptr(), denom.data_ptr(),
            wav_pad.data_ptr(), cells.data_ptr(), vals.data_ptr(), K,
            pairs.data_ptr(), res.data_ptr(), scratch.data_ptr(),
            grad.data_ptr(), adj.data_ptr(), state.data_ptr(),
            B, nz, nx, seg, nseg, nsteps, z0, int(fs), len(w) - 1,
            w32.ctypes.data, inv_h2x, inv_h2z, neg_inv_s2,
            torch.cuda.current_stream(inj.device).cuda_stream)
    _check(lib, "acoustic2d_gradient_segments", err)
    return grad


def _checked(fn, tensors, shapes, z0, nz):
    """Validate one call's tensors: one device, one float type (float32 on
    the card), the expected shapes, contiguous; z0 inside the grid."""
    dev = tensors[0].device
    dtype = tensors[0].dtype
    allowed = (torch.float32,) if dev.type == "cuda" else (torch.float32,
                                                           torch.float64)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{fn}: tensors on {dev}; expected cuda or cpu")
    if dtype not in allowed:
        raise TypeError(f"{fn}: dtype {dtype} on {dev.type}; expected one "
                        f"of {allowed}")
    for i, (t, shape) in enumerate(zip(tensors, shapes)):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{fn}: operand {i} is {t.dtype} on "
                             f"{t.device}, operand 0 is {dtype} on {dev}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{fn}: operand {i} has shape "
                             f"{tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: operand {i} is not contiguous")
    if not 0 <= z0 <= nz - 2:
        raise ValueError(f"{fn}: receiver rows z0={z0}, z0+1 outside "
                         f"0..{nz - 1}")
    return dev


def _forward(fn, plain, m, hd, wav_pad, inj, dt, *, nt, nx, nz,
             space_order, spacing, z0, n_checkpoints, fs=False):
    """The three forward sweeps; ``fn`` names the one: receivers only, with
    the history, or with the segment-start pairs."""
    nsteps, seg, nseg = _ckpt_layout(nt, n_checkpoints)
    B = inj.shape[0]
    dev = _checked(fn, (m, hd, wav_pad, inj),
                   ((nz, nx), (nz, nx), (nseg * seg,), (B, nz, nx)), z0, nz)
    w, inv_h2x, inv_h2z, _ = _stencil_constants(space_order, spacing, dt)
    denom = 1.0 / (m + hd)
    two_m_hd = 2.0 * m + hd
    hist = fn == "forward_dt2_segments"
    ckpt = fn == "forward_ckpt_segments"
    kw = dict(w=w, inv_h2x=inv_h2x, inv_h2z=inv_h2z, nsteps=nsteps, seg=seg,
              z0=z0, fs=fs, hist=hist, ckpt=ckpt)
    if dev.type == "cuda" and not plain:
        rec, saved, illum = _forward_cuda(m, two_m_hd, denom, wav_pad, inj,
                                          **kw)
        LAUNCHES[fn] += 1
    else:
        TWIN_CALLS[fn] += 1
        rec, saved, illum = _forward_plain(m, two_m_hd, denom, wav_pad, inj,
                                           **kw)
    rec = rec.reshape(B, nseg, seg, 2, nx)
    if hist:
        return rec, saved.reshape(B, nseg, seg, nz, nx), illum
    if ckpt:
        return rec, saved, illum
    return rec


def _gradient(plain, m, hd, dt2, res_rows, dt, *, nt, nx, nz, space_order,
              spacing, z0, n_checkpoints, fs=False):
    fn = "gradient_stream_segments"
    nsteps, seg, nseg = _ckpt_layout(nt, n_checkpoints)
    B = dt2.shape[0]
    dev = _checked(fn, (m, hd, dt2, res_rows),
                   ((nz, nx), (nz, nx), (B, nseg, seg, nz, nx),
                    (B, nseg, seg, 2, nx)), z0, nz)
    w, inv_h2x, inv_h2z, s2 = _stencil_constants(space_order, spacing, dt)
    denom = 1.0 / (m + hd)
    two_m_hd = 2.0 * m + hd
    kw = dict(w=w, inv_h2x=inv_h2x, inv_h2z=inv_h2z, nsteps=nsteps, z0=z0,
              fs=fs, neg_inv_s2=-1.0 / s2)
    hist = dt2.reshape(B, nseg * seg, nz, nx)
    res = res_rows.reshape(B, nseg * seg, 2, nx)
    if dev.type == "cuda" and not plain:
        grad = _adjoint_cuda(m, two_m_hd, denom, hist, res, **kw)
        LAUNCHES[fn] += 1
        return grad
    TWIN_CALLS[fn] += 1
    return _adjoint_plain(m, two_m_hd, denom, hist, res, **kw)


def _gradient_segments(plain, m, hd, wav_pad, inj, seg_starts, res_rows, dt,
                       *, nt, nx, nz, space_order, spacing, z0,
                       n_checkpoints, fs=False):
    fn = "gradient_segments"
    nsteps, seg, nseg = _ckpt_layout(nt, n_checkpoints)
    B = inj.shape[0]
    dev = _checked(fn, (m, hd, wav_pad, inj, seg_starts, res_rows),
                   ((nz, nx), (nz, nx), (nseg * seg,), (B, nz, nx),
                    (B, nseg, 2, nz, nx), (B, nseg, seg, 2, nx)), z0, nz)
    w, inv_h2x, inv_h2z, s2 = _stencil_constants(space_order, spacing, dt)
    denom = 1.0 / (m + hd)
    two_m_hd = 2.0 * m + hd
    kw = dict(w=w, inv_h2x=inv_h2x, inv_h2z=inv_h2z, nsteps=nsteps, seg=seg,
              z0=z0, fs=fs, neg_inv_s2=-1.0 / s2)
    res = res_rows.reshape(B, nseg * seg, 2, nx)
    if dev.type == "cuda" and not plain:
        grad = _segments_cuda(m, two_m_hd, denom, wav_pad, inj, seg_starts,
                              res, **kw)
        LAUNCHES[fn] += 1
        return grad
    TWIN_CALLS[fn] += 1
    return _segments_plain(m, two_m_hd, denom, wav_pad, inj, seg_starts, res,
                           **kw)


def forward_rec_segments(m, hd, wav_pad, inj, dt, **kw):
    """Forward sweep, receiver rows only. ``m``, ``hd`` (nz, nx) squared
    slowness and dt*damp; ``wav_pad`` (nseg*seg,) from ``pad_wavelet``;
    ``inj`` (B, nz, nx) transposed ``source_pattern``. Keywords: nt, nx,
    nz, space_order, spacing, z0, n_checkpoints, fs=False. Returns rec_rows
    (B, nseg, seg, 2, nx): rows z0, z0+1 of u before each step."""
    return _forward("forward_rec_segments", False, m, hd, wav_pad, inj, dt,
                    **kw)


def forward_dt2_segments(m, hd, wav_pad, inj, dt, **kw):
    """Forward sweep that also streams the history. Operands as in
    ``forward_rec_segments``. Returns (rec_rows (B, nseg, seg, 2, nx),
    dt2 (B, nseg, seg, nz, nx) = un - 2u + up, illum (B, nz, nx) = sum of
    un^2 over the steps t < nsteps)."""
    return _forward("forward_dt2_segments", False, m, hd, wav_pad, inj, dt,
                    **kw)


def gradient_stream_segments(m, hd, dt2, res_rows, dt, **kw):
    """Reverse sweep over the streamed history (``forward_dt2_segments``
    output) with the residual rows (``residual_rows``) injected on rows
    z0, z0+1. Returns grad (B, nz, nx) = -(1/s^2) sum_t dt2[t] * v[t]."""
    return _gradient(False, m, hd, dt2, res_rows, dt, **kw)


def forward_ckpt_segments(m, hd, wav_pad, inj, dt, **kw):
    """Forward sweep of the checkpoint route. Operands as in
    ``forward_rec_segments``. Returns (rec_rows (B, nseg, seg, 2, nx),
    seg_starts (B, nseg, 2, nz, nx): the pair (u, u_prev) before the first
    step of each segment, illum (B, nz, nx))."""
    return _forward("forward_ckpt_segments", False, m, hd, wav_pad, inj, dt,
                    **kw)


def gradient_segments(m, hd, wav_pad, inj, seg_starts, res_rows, dt, **kw):
    """Reverse sweep of the checkpoint route: each segment's history is
    recomputed from ``seg_starts`` (``forward_ckpt_segments``) into a
    one-segment scratch, then swept in reverse with the residual rows.
    Returns grad (B, nz, nx), equal to ``gradient_stream_segments`` on the
    streamed history of the same forward."""
    return _gradient_segments(False, m, hd, wav_pad, inj, seg_starts,
                              res_rows, dt, **kw)


# The plain twins under the wrappers' signatures, on any device: the
# comparison on the card calls them on CUDA tensors.

def forward_rec_plain(m, hd, wav_pad, inj, dt, **kw):
    """Plain torch twin of ``forward_rec_segments``."""
    return _forward("forward_rec_segments", True, m, hd, wav_pad, inj, dt,
                    **kw)


def forward_dt2_plain(m, hd, wav_pad, inj, dt, **kw):
    """Plain torch twin of ``forward_dt2_segments``."""
    return _forward("forward_dt2_segments", True, m, hd, wav_pad, inj, dt,
                    **kw)


def gradient_stream_plain(m, hd, dt2, res_rows, dt, **kw):
    """Plain torch twin of ``gradient_stream_segments``."""
    return _gradient(True, m, hd, dt2, res_rows, dt, **kw)


def forward_ckpt_plain(m, hd, wav_pad, inj, dt, **kw):
    """Plain torch twin of ``forward_ckpt_segments``."""
    return _forward("forward_ckpt_segments", True, m, hd, wav_pad, inj, dt,
                    **kw)


def gradient_segments_plain(m, hd, wav_pad, inj, seg_starts, res_rows, dt,
                            **kw):
    """Plain torch twin of ``gradient_segments``."""
    return _gradient_segments(True, m, hd, wav_pad, inj, seg_starts,
                              res_rows, dt, **kw)
