"""CUDA kernels for the streamed 3-D acoustic OT2 sweeps, each beside its
plain torch twin. Counterpart of ``devito_fwi_tpu.ops.pallas_acoustic3d``.

Three sweeps carry the 3-D acoustic FWI:

* ``forward_rec3``: forward modeling that records the two receiver
  z-planes of every step (observed data, line-search trials);
* ``forward_dt2_stream3``: the same forward, also streaming the d2u/dt2
  history ``un - 2u + up`` and the illumination ``sum un^2``;
* ``gradient_stream3``: the reverse adjoint sweep over that history,
  ``grad = -(1/s^2) sum_t dt2[t] * v[t]``, the residual planes injected
  into the new v.

Fields use the transposed (ny, nz, nx) layout of the JAX kernels with x
contiguous, so the receiver planes z0, z0+1 of a y-plane are two contiguous
rows. There are no Mosaic y-blocks and no (8, 128) tile padding: every
array has the real padded-grid extents, and outside the grid is zero, as
devito's halo is. The nt-2 steps are one run with no padded tail.

Each wrapper checks its operands, computes ``denom = 1/(m + hd)`` and
``two_m_hd = 2m + hd`` once and then, for CUDA tensors, launches the kernel
of ``csrc/acoustic3d.cu`` (one ctypes call per sweep, one launch per step
on the current stream) and adds one to ``LAUNCHES[name]``; for CPU tensors
it runs the plain twin, a Python loop over the steps with the kernel's
exact arithmetic (``_make_lap3``). On another device it raises. The twins
take float32 or float64; the kernels float32.

The three sweeps march in y (``march_launch``): a block owns a 32 x 16
(x, z) tile of one shot and walks a chunk of y-planes, the y taps from a
register queue of its columns, the x and z taps from the plane's tile in
shared memory; the reverse sweep is the same march in reverse mode, v in
the queue, at two blocks an SM over more y-chunks, and a final launch
scales the gradient.

The stencil folds dt^2 into the per-axis scales (``ih2 = s^2/h^2``) as the
JAX kernels do, unlike the eager update and the step kernel of
``ops.cuda_acoustic3``, which scale by s^2 after the Laplacian: each keeps
its own TPU counterpart's association.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..utils.fd import second_derivative_weights
from . import cuda_build
from .acoustic import shift
from .cuda_acoustic import _checked, matmul_full, tile_launch
from .interp import interp_table, valid_corners

__all__ = ["forward_dt2_stream3", "forward_rec3", "gradient_stream3",
           "forward_dt2_stream3_plain", "forward_rec3_plain",
           "gradient_stream3_plain", "source_planes3",
           "plane_weight_matrix", "residual_slabs3", "traces_from_slabs3",
           "geometry_supported3", "unsupported_reason", "march_launch",
           "LAUNCHES", "TWIN_CALLS", "reset_counters"]

KERNELS = ("forward_dt2_stream3", "forward_rec3", "gradient_stream3")
# launches of each kernel (one per sweep) and calls of each plain twin
LAUNCHES = dict.fromkeys(KERNELS, 0)
TWIN_CALLS = dict.fromkeys(KERNELS, 0)


def reset_counters():
    for name in KERNELS:
        LAUNCHES[name] = 0
        TWIN_CALLS[name] = 0


def _stencil_constants3(space_order, spacing, dt):
    """(w, (ih2x, ih2y, ih2z), s2): half-stencil weights and the per-axis
    1/h^2 scales with dt^2 folded in."""
    w_full = second_derivative_weights(space_order)
    w = tuple(float(v) for v in np.asarray(w_full)[len(w_full) // 2:])
    s2 = float(dt) ** 2
    ih2 = tuple(float(1.0 / h ** 2) * s2 for h in spacing)
    return w, ih2, s2


def _make_lap3(w, ih2, fs):
    """Laplacian on the transposed (..., ny, nz, nx) layout with zero-fill
    shifts, the kernels' association term for term: (shift+ + shift-)
    summed before the weight multiply, per-axis accumulation, the x, then
    the y, then the z term scaled and added, and under a free surface rows
    0..r of the unscaled z-derivative replaced by the mirrored stencil
    (plain +k term, then the odd mirror)."""
    r = len(w) - 1
    ih2x, ih2y, ih2z = ih2

    def d2(u, dim):
        acc = w[0] * u
        for k in range(1, r + 1):
            acc = acc + w[k] * (shift(u, k, dim) + shift(u, -k, dim))
        return acc

    def lap(u):
        accx = d2(u, -1)
        accy = d2(u, -3)
        accz = d2(u, -2)
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
        return accx * ih2x + accy * ih2y + accz * ih2z

    return lap


# ---------------------------------------------------------------------------
# operands
# ---------------------------------------------------------------------------

def source_planes3(s_idx, s_w, m, s2):
    """The two dense source y-planes: (injp (B, 2, nz, nx), iy (B,) int32).
    ``injp[b, p]`` holds ``w * s^2 / m`` at the trilinear corners of shot
    b's source on y-plane ``iy[b] + p``. ``s_idx`` (B, 1, 8, 3) and ``s_w``
    (B, 1, 8) are numpy ``interp_table`` outputs; ``m`` is the untransposed
    (nx, ny, nz) squared slowness. Corners outside the grid are masked."""
    B = s_idx.shape[0]
    nx, ny, nz = m.shape
    idx = np.asarray(s_idx)[:, 0]
    valid, cl = valid_corners(idx, (nx, ny, nz))
    iy = cl[..., 1].min(axis=1)
    plane = np.clip(cl[..., 1] - iy[:, None], 0, 1)
    dev = m.device
    xi, yi, zi = (torch.as_tensor(cl[..., d], dtype=torch.long, device=dev)
                  for d in range(3))
    w = torch.as_tensor(np.where(valid, np.asarray(s_w)[:, 0], 0.0),
                        dtype=m.dtype, device=dev)
    vals = w * s2 / m[xi, yi, zi]
    bi = torch.arange(B, device=dev)[:, None].expand_as(xi)
    injp = m.new_zeros((B, 2, nz, nx))
    injp.index_put_((bi, torch.as_tensor(plane, device=dev), zi, xi), vals,
                    accumulate=True)
    return injp, torch.as_tensor(iy.astype(np.int32), device=dev)


def plane_weight_matrix(r_idx, r_w, m, s2, z0, scale_by_m):
    """(nrec, ny*2*nx) scattered weights of the two receiver z-planes:
    column ``(y*2 + p)*nx + x`` sums the receiver's corner weights (times
    ``s^2/m`` when ``scale_by_m``) that land on plane p. Validity is
    checked against the real grid extents; corners off the grid or off the
    two planes get nothing. ``r_w`` is a tensor (nrec, 8)."""
    nx, ny, nz = m.shape
    r_idx = np.asarray(r_idx)
    xi, yi, zi = r_idx[..., 0], r_idx[..., 1], r_idx[..., 2]
    valid = (xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny) & \
        ((zi == z0) | (zi == z0 + 1))
    xc = np.clip(xi, 0, nx - 1)
    yc = np.clip(yi, 0, ny - 1)
    dev = m.device
    wv = r_w.to(m.dtype)
    if scale_by_m:
        mv = m[tuple(torch.as_tensor(c, dtype=torch.long, device=dev)
                     for c in (xc, yc, np.clip(zi, 0, nz - 1)))]
        wv = wv * s2 / mv
    wv = torch.where(torch.as_tensor(valid, device=dev), wv,
                     torch.zeros((), dtype=m.dtype, device=dev))
    col = torch.as_tensor((yc * 2 + (zi != z0)) * nx + xc, dtype=torch.long,
                          device=dev)
    rows = torch.arange(r_idx.shape[0], device=dev)[:, None].expand(col.shape)
    V = m.new_zeros((r_idx.shape[0], ny * 2 * nx))
    return V.index_put_((rows, col), wv, accumulate=True)


def residual_slabs3(res_stack, r_idx, r_w, m, s2, z0, nsteps):
    """Receiver residuals (B, nt, nrec) -> dense injection slabs
    (B, nsteps, ny, 2, nx) with the interpolation weights and ``s^2/m``
    folded in: one product against ``plane_weight_matrix`` at full
    precision (TF32 off), in the model's type."""
    B = res_stack.shape[0]
    nx, ny, _ = m.shape
    V = plane_weight_matrix(r_idx, r_w, m, s2, z0, True)
    rows = matmul_full(res_stack[:, 1:nsteps + 1].to(m.dtype), V)
    return rows.reshape(B, nsteps, ny, 2, nx)


def traces_from_slabs3(rec_slab, r_idx, r_w, m, z0, nt):
    """Receiver slabs (B, nsteps, ny, 2, nx) -> traces (B, nt, nrec): one
    product against the transposed plane weights at full precision;
    rec[0] = rec[nt-1] = 0."""
    B, nsteps = rec_slab.shape[:2]
    V = plane_weight_matrix(r_idx, r_w, m, 1.0, z0, False)
    tr = matmul_full(rec_slab.reshape(B, nsteps, -1), V.T)
    rec = rec_slab.new_zeros((B, nt, V.shape[0]))
    rec[:, 1:nsteps + 1] = tr
    return rec


def unsupported_reason(geometry):
    """Why the streamed kernels do not take ``geometry`` (None when they
    do): they need a 3-D grid, all receivers between the same two ADJACENT
    z-planes inside the padded grid, and every source's y-corners inside
    it (the kernels record and inject exactly those planes)."""
    model = geometry.model
    if model.dim != 3:
        return f"a {model.dim}-D model (the streamed kernels are 3-D)"
    r_idx, _ = interp_table(geometry.rec_positions, model.origin_pml,
                            model.spacing, dtype=model.dtype)
    zplanes = np.unique(np.asarray(r_idx)[..., 2])
    if len(zplanes) > 2 or int(zplanes.max()) - int(zplanes.min()) > 1:
        return "receivers not between two adjacent z-planes"
    nx, ny, nz = model.padded_shape
    z0 = int(zplanes.min())
    if not (0 <= z0 and z0 + 2 <= nz):
        return f"receiver z-planes {z0}, {z0 + 1} outside 0..{nz - 1}"
    s_idx, _ = interp_table(geometry.src_positions, model.origin_pml,
                            model.spacing, dtype=model.dtype)
    sy = np.asarray(s_idx)[..., 1]
    if sy.min() < 0 or sy.max() >= ny:
        return f"a source's y-corners outside 0..{ny - 1}"
    return None


def geometry_supported3(geometry):
    """True when the streamed kernels take ``geometry``."""
    return unsupported_reason(geometry) is None


# ---------------------------------------------------------------------------
# plain twins: Python loops over the steps with the kernels' arithmetic
# ---------------------------------------------------------------------------

def _forward_plain(m, two_m_hd, denom, wav, injp, iy, *, w, ih2, nsteps, z0,
                   fs, hist):
    B = injp.shape[0]
    ny, nz, nx = m.shape
    lap = _make_lap3(w, ih2, fs)
    dt2 = injp.new_empty((B, nsteps, ny, nz, nx)) if hist else None
    rec = injp.new_empty((B, nsteps, ny, 2, nx))
    illum = injp.new_zeros((B, ny, nz, nx)) if hist else None
    u = injp.new_zeros((B, ny, nz, nx))
    up = injp.new_zeros((B, ny, nz, nx))
    bi = torch.arange(B, device=m.device)
    planes = []
    for p in range(2):
        y = iy.long() + p
        # a plane past the grid adds nothing (the kernel never meets it)
        planes.append((y.clamp(max=ny - 1), (y < ny)[:, None, None]))
    for t in range(nsteps):
        rec[:, t] = u[:, :, z0:z0 + 2, :]
        un = (lap(u) + two_m_hd * u - m * up) * denom
        for p, (y, hit) in enumerate(planes):
            add = torch.where(hit, wav[:, t, None, None] * injp[:, p], 0.0)
            un[bi, y] = un[bi, y] + add
        if hist:
            dt2[:, t] = un - 2.0 * u + up
            illum = illum + un * un
        up, u = u, un
    return rec, dt2, illum


def _gradient_plain(m, two_m_hd, denom, dt2, res, *, w, ih2, nsteps, z0, fs,
                    neg_inv_s2):
    B = dt2.shape[0]
    lap = _make_lap3(w, ih2, fs)
    v = dt2.new_zeros((B,) + tuple(m.shape))
    vn = torch.zeros_like(v)
    grad = torch.zeros_like(v)
    for t in range(nsteps - 1, -1, -1):
        grad = grad + dt2[:, t] * v
        vnew = (lap(v) + two_m_hd * v - m * vn) * denom
        vnew[:, :, z0:z0 + 2] = vnew[:, :, z0:z0 + 2] + res[:, t]
        vn, v = v, vnew
    return grad * neg_inv_s2


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# (argtypes, restype) of the sweeps' C entry points in csrc/acoustic3d.cu;
# every pointer and the stream are c_void_p, so no 64-bit value is cut
SIGNATURES = {
    "acoustic3d_forward": ([_P] * 11 + [_I] * 9 + [_P, _F, _F, _F, _P], _I),
    "acoustic3d_gradient": ([_P] * 8 + [_I] * 9 + [_P, _F, _F, _F, _F, _P],
                            _I),
    "acoustic3d_error_string": ([_I], ctypes.c_char_p),
}


# the march's tile and threads (csrc/acoustic3d.cu kMX x kMZ, kMThreads)
MARCH_TILE = (32, 16)
MARCH_THREADS = 512
# blocks of 512 threads the H100 holds at once: 132 SMs, three blocks each
# (the forwards' __launch_bounds__); a forward step's blocks fill it in one
# wave
RESIDENT_BLOCKS = 396
# the reverse march runs two blocks an SM (csrc/acoustic3d.cu
# kReverseBlocks) over two waves: more chunks in flight hide its reads
# (tools/probe_reverses.py on an H100: 32.6 ms at config 5 against 37.0 at
# the forwards' launch)
REVERSE_BLOCKS = 2 * 132 * 2
# the shortest y-chunk: a chunk of c planes reads c + 2r into its queue
MIN_CHUNK = 16


def march_launch(B, ny, nz, nx, r, reverse=False):
    """The march's launch at these shapes: the tile, threads, grid of one
    step (shots, x tiles, z tiles x y-chunks), the y-chunks and their
    length ``ylen`` (planes), and the shared-memory bytes of a block (two
    planes of the tile and an r halo; at most 12,288 bytes, r = 8). The
    y-chunks are as many as ``RESIDENT_BLOCKS`` blocks take (the
    forwards) or ``REVERSE_BLOCKS`` (``reverse``), none shorter than
    ``MIN_CHUNK`` planes. Raises ValueError for what the kernel does not
    take: a radius outside 1 .. 8, an empty grid, a plane of 2^31 cells,
    or a launch grid past CUDA's (``tile_launch``)."""
    tx, tz = MARCH_TILE
    smem = 4 * 2 * (tx + 2 * r) * (tz + 2 * r)
    launch = tile_launch("acoustic3d march", B, nz, nx, r, MARCH_TILE,
                         MARCH_THREADS, smem, shots_first=True)
    if ny < 1:
        raise ValueError(f"acoustic3d march: {ny} y-planes; the kernel "
                         "takes a positive grid")
    tiles = math.prod(launch.grid)
    blocks = REVERSE_BLOCKS if reverse else RESIDENT_BLOCKS
    chunks = max(1, min(blocks // tiles, ny // MIN_CHUNK))
    ylen = -(-ny // chunks)
    chunks = -(-ny // ylen)
    # chunks > 1 only while the blocks stay under ``blocks``, so the z
    # tiles x y-chunks stay within the grid's 65535
    launch.grid = launch.grid[:2] + (launch.grid[2] * chunks,)
    launch.chunks, launch.ylen = chunks, ylen
    return launch


def _lib():
    lib = cuda_build.load("acoustic3d")
    if not getattr(lib, "_sweep_argtypes_set", False):
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        lib._sweep_argtypes_set = True
    return lib


def _check(lib, fn, err):
    if err:
        raise RuntimeError(f"{fn}: CUDA error {err} "
                           f"({lib.acoustic3d_error_string(err).decode()})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _forward_cuda(m, two_m_hd, denom, wav, injp, iy, *, w, ih2, nsteps, z0,
                  fs, hist):
    B = injp.shape[0]
    ny, nz, nx = m.shape
    launch = march_launch(B, ny, nz, nx, len(w) - 1)
    lib = _lib()
    # the history first: at bench config 5 it is 11.2 GB of the chunk
    dt2 = injp.new_empty((B, nsteps, ny, nz, nx)) if hist else None
    rec = injp.new_empty((B, nsteps, ny, 2, nx))
    illum = injp.new_zeros((B, ny, nz, nx)) if hist else None
    u = injp.new_zeros((B, ny, nz, nx))
    up = injp.new_zeros((B, ny, nz, nx))
    w32 = np.asarray(w, np.float32)
    with torch.cuda.device(injp.device):
        err = lib.acoustic3d_forward(
            m.data_ptr(), two_m_hd.data_ptr(), denom.data_ptr(),
            wav.data_ptr(), injp.data_ptr(), iy.data_ptr(), rec.data_ptr(),
            _ptr(dt2), _ptr(illum), u.data_ptr(), up.data_ptr(), B, ny, nz,
            nx, nsteps, z0, int(fs), len(w) - 1, launch.ylen,
            w32.ctypes.data, *ih2,
            torch.cuda.current_stream(injp.device).cuda_stream)
    _check(lib, "acoustic3d_forward", err)
    return rec, dt2, illum


def _gradient_cuda(m, two_m_hd, denom, dt2, res, *, w, ih2, nsteps, z0, fs,
                   neg_inv_s2):
    B = dt2.shape[0]
    ny, nz, nx = m.shape
    launch = march_launch(B, ny, nz, nx, len(w) - 1, reverse=True)
    lib = _lib()
    grad = dt2.new_zeros((B, ny, nz, nx))
    v = dt2.new_zeros((B, ny, nz, nx))
    vn = dt2.new_zeros((B, ny, nz, nx))
    w32 = np.asarray(w, np.float32)
    with torch.cuda.device(dt2.device):
        err = lib.acoustic3d_gradient(
            m.data_ptr(), two_m_hd.data_ptr(), denom.data_ptr(),
            dt2.data_ptr(), res.data_ptr(), grad.data_ptr(), v.data_ptr(),
            vn.data_ptr(), B, ny, nz, nx, nsteps, z0, int(fs), len(w) - 1,
            launch.ylen, w32.ctypes.data, *ih2, neg_inv_s2,
            torch.cuda.current_stream(dt2.device).cuda_stream)
    _check(lib, "acoustic3d_gradient", err)
    return grad


def _forward(fn, plain, m3, hd3, wav, injp, iy, dt, *, nt, space_order,
             spacing, z0, fs=False):
    """The two forward sweeps; ``fn`` names the one."""
    ny, nz, nx = m3.shape
    B, nsteps = injp.shape[0], nt - 2
    dev = _checked(fn, (m3, hd3, wav, injp), ((ny, nz, nx), (ny, nz, nx),
                                              (B, nsteps), (B, 2, nz, nx)),
                   z0, nz)
    if iy.device != dev or iy.dtype != torch.int32 or \
            tuple(iy.shape) != (B,):
        raise ValueError(f"{fn}: iy must be int32 ({B},) on {dev}")
    lo, hi = int(iy.min()), int(iy.max())
    if lo < 0 or hi >= ny:
        raise ValueError(f"{fn}: source planes {lo}..{hi} outside "
                         f"0..{ny - 1}")
    w, ih2, _ = _stencil_constants3(space_order, spacing, dt)
    denom = 1.0 / (m3 + hd3)
    two_m_hd = 2.0 * m3 + hd3
    hist = fn == "forward_dt2_stream3"
    kw = dict(w=w, ih2=ih2, nsteps=nsteps, z0=z0, fs=fs, hist=hist)
    if dev.type == "cuda" and not plain:
        rec, dt2, illum = _forward_cuda(m3, two_m_hd, denom, wav, injp, iy,
                                        **kw)
        LAUNCHES[fn] += 1
    else:
        TWIN_CALLS[fn] += 1
        rec, dt2, illum = _forward_plain(m3, two_m_hd, denom, wav, injp, iy,
                                         **kw)
    return (rec, dt2, illum) if hist else rec


def _gradient(plain, m3, hd3, dt2, res_slab, dt, *, nt, space_order,
              spacing, z0, fs=False):
    fn = "gradient_stream3"
    ny, nz, nx = m3.shape
    B, nsteps = dt2.shape[0], nt - 2
    dev = _checked(fn, (m3, hd3, dt2, res_slab),
                   ((ny, nz, nx), (ny, nz, nx), (B, nsteps, ny, nz, nx),
                    (B, nsteps, ny, 2, nx)), z0, nz)
    w, ih2, s2 = _stencil_constants3(space_order, spacing, dt)
    denom = 1.0 / (m3 + hd3)
    two_m_hd = 2.0 * m3 + hd3
    kw = dict(w=w, ih2=ih2, nsteps=nsteps, z0=z0, fs=fs,
              neg_inv_s2=-1.0 / s2)
    if dev.type == "cuda" and not plain:
        grad = _gradient_cuda(m3, two_m_hd, denom, dt2, res_slab, **kw)
        LAUNCHES[fn] += 1
        return grad
    TWIN_CALLS[fn] += 1
    return _gradient_plain(m3, two_m_hd, denom, dt2, res_slab, **kw)


def forward_dt2_stream3(m3, hd3, wav, injp, iy, dt, **kw):
    """Streamed 3-D forward with history. ``m3``, ``hd3`` (ny, nz, nx)
    transposed squared slowness and dt*damp; ``wav`` (B, nsteps) the
    wavelet ``src[1:nt-1]`` per shot; ``injp``, ``iy`` from
    ``source_planes3``. Keywords: nt, space_order, spacing, z0, fs=False.
    Returns (rec_slab (B, nsteps, ny, 2, nx): planes z0, z0+1 of u before
    each step, dt2 (B, nsteps, ny, nz, nx) = un - 2u + up, illum
    (B, ny, nz, nx) = sum of un^2)."""
    return _forward("forward_dt2_stream3", False, m3, hd3, wav, injp, iy, dt,
                    **kw)


def forward_rec3(m3, hd3, wav, injp, iy, dt, **kw):
    """Streamed 3-D forward, receiver slabs only. Operands as in
    ``forward_dt2_stream3``; returns rec_slab (B, nsteps, ny, 2, nx)."""
    return _forward("forward_rec3", False, m3, hd3, wav, injp, iy, dt, **kw)


def gradient_stream3(m3, hd3, dt2, res_slab, dt, **kw):
    """Reverse sweep over the streamed history (``forward_dt2_stream3``)
    with the residual slabs (``residual_slabs3``) injected on planes z0,
    z0+1. Returns grad (B, ny, nz, nx) = -(1/s^2) sum_t dt2[t] * v[t]."""
    return _gradient(False, m3, hd3, dt2, res_slab, dt, **kw)


# The plain twins under the wrappers' signatures, on any device: the
# comparison on the card calls them on CUDA tensors.

def forward_dt2_stream3_plain(m3, hd3, wav, injp, iy, dt, **kw):
    """Plain torch twin of ``forward_dt2_stream3``."""
    return _forward("forward_dt2_stream3", True, m3, hd3, wav, injp, iy, dt,
                    **kw)


def forward_rec3_plain(m3, hd3, wav, injp, iy, dt, **kw):
    """Plain torch twin of ``forward_rec3``."""
    return _forward("forward_rec3", True, m3, hd3, wav, injp, iy, dt, **kw)


def gradient_stream3_plain(m3, hd3, dt2, res_slab, dt, **kw):
    """Plain torch twin of ``gradient_stream3``."""
    return _gradient(True, m3, hd3, dt2, res_slab, dt, **kw)
