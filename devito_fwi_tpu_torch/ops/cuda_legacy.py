"""The whole-nt 2-D acoustic forward of the legacy Pallas kernel as a CUDA
kernel, beside its plain torch twin. Counterpart of
``devito_fwi_tpu.ops.pallas_legacy``.

``forward_rows`` models a batch of shots without a free surface over the
nt - 2 steps and returns the two receiver rows z0, z0+1 of u at every step,
(B, nt, 2, nx); row t holds time t + 1, and rows nt-2 and nt-1 are zeros
(the Pallas kernel never writes them: a deliberate divergence). It keeps
the legacy kernel's own arithmetic, not the segment kernels' of
``ops.cuda_acoustic``: dt^2 folded into one float32 constant per tap
(``_legacy_constants``), ``c0 u`` first and then, for k = 1..r, four
separate products x+k, x-k, z+k, z-k; ``un = ((lap + (2m + hd) u) - m up)
/ (m + hd)`` with the reciprocal taken once, then ``u = un + wav[t] inj``
(the source added after the division, as a dense masked FMA of one wavelet
for all shots).

``forward_rows`` takes the JAX signature and shapes ((nx, nz) fields and
patterns) and transposes them once to the kernel's (nz, nx) layout, in
which the two receiver rows are contiguous. For CUDA float32 tensors it
launches ``acoustic2d_legacy_forward`` of ``csrc/acoustic2d_legacy.cu``
(one ctypes call, one launch a sweep on the current stream: one
thread-block cluster a shot with the wavefield resident in shared memory,
as ``sweep_launch`` plans it) and adds one to ``LAUNCHES["forward_rows"]``;
for CPU tensors it runs the plain twin (``forward_rows_plain``, a Python
loop with the kernel's arithmetic). On another device it raises. A grid
whose slab does not fit a block's shared memory even at a cluster of 8
raises ``ValueError`` before anything is built or allocated (the Pallas
kernel has a VMEM limit of its own).

``forward_traces`` is the host wrapper of the JAX module: all shots of a
2-D geometry in one batch, the traces summed from the rows. It raises for a
free surface, as the JAX one does, and for receivers off two adjacent
z-planes (``cuda_acoustic.geometry_supported``), where the JAX one gives
wrong traces without a word.
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace

import numpy as np
import torch

from ..utils.fd import second_derivative_weights
from . import cuda_build
from .acoustic import shift
from .cuda_acoustic import SMEM_LIMIT, _source_list, geometry_supported
from .interp import interp_table, valid_corners

__all__ = ["forward_rows", "forward_rows_plain", "forward_traces",
           "operands", "sweep_launch", "max_clusters", "KERNELS",
           "LAUNCHES", "TWIN_CALLS", "reset_counters"]

KERNELS = ("forward_rows",)
# launches of the kernel (one per sweep) and calls of its plain twin
LAUNCHES = dict.fromkeys(KERNELS, 0)
TWIN_CALLS = dict.fromkeys(KERNELS, 0)


def reset_counters():
    for name in KERNELS:
        LAUNCHES[name] = 0
        TWIN_CALLS[name] = 0


def _legacy_constants(space_order, spacing, dt):
    """(c0, cx, cz): the legacy kernel's stencil constants, Python-double
    products with dt^2 folded in (pallas_legacy.py:96-98, :43-53), each
    rounded once to float32. cx[k], cz[k] for k = 0..r (entry 0 unused)."""
    w = np.asarray(second_derivative_weights(space_order)
                   [space_order // 2:], np.float64)
    ihx = float(1.0 / spacing[0] ** 2) * float(dt) ** 2
    ihz = float(1.0 / spacing[1] ** 2) * float(dt) ** 2
    f32 = np.float32
    c0 = float(f32(float(w[0]) * (ihx + ihz)))
    cx = tuple(float(f32(float(wk) * ihx)) for wk in w)
    cz = tuple(float(f32(float(wk) * ihz)) for wk in w)
    return c0, cx, cz


def _rows_plain(m, two_m_hd, denom, wav, inj, *, c0, cx, cz, nt, z0):
    """The twin on (nz, nx) fields: the kernel's steps as torch ops."""
    B, nz, nx = inj.shape
    u = inj.new_zeros((B, nz, nx))
    up = inj.new_zeros((B, nz, nx))
    rec = inj.new_zeros((B, nt, 2, nx))
    for t in range(nt - 2):
        rec[:, t] = u[:, z0:z0 + 2, :]
        acc = c0 * u
        for k in range(1, len(cx)):
            acc = acc + cx[k] * shift(u, k, -1)
            acc = acc + cx[k] * shift(u, -k, -1)
            acc = acc + cz[k] * shift(u, k, -2)
            acc = acc + cz[k] * shift(u, -k, -2)
        un = ((acc + two_m_hd * u) - m * up) * denom
        up, u = u, un + wav[t] * inj
    return rec


# the sweep's threads a block, the largest portable cluster and the
# cluster size it prefers (csrc/acoustic2d_legacy.cu kThreads, kMaxCluster)
THREADS = 512
MAX_CLUSTER = 8
CLUSTER = 4


def sweep_launch(nz, nx, r, K=1):
    """The sweep's launch plan for a (nz, nx) grid at radius ``r`` with
    ``K`` source cells a shot: the cluster size (``CLUSTER``, or the
    smallest larger one whose slab fits a block's shared memory, cut to the
    blocks that own a row), the rows of a slab, the floats of a buffer row
    (nx rounded up to 4 plus ceil(r/4)*4 zero columns each side), the
    threads and the shared-memory bytes of a block (two u buffers of the
    slab and 2r halo rows, the slab's source list). Raises ValueError,
    naming the failing condition, for a radius outside 1 .. 8, an empty
    grid or one of 2^31 cells, or a grid whose slab does not fit 232,448
    bytes even at a cluster of 8."""
    if not 1 <= r <= 8:
        raise ValueError(f"forward_rows: stencil radius {r}; the kernel "
                         "takes 1 .. 8")
    if min(nz, nx) < 1 or nz * nx >= 2 ** 31:
        raise ValueError(f"forward_rows: a {nz} x {nx} grid; the kernel "
                         "takes a positive grid of fewer than 2^31 cells")
    nx4 = -(-nx // 4) * 4
    stride = nx4 + 2 * (-(-r // 4) * 4)
    for cluster in range(min(CLUSTER, MAX_CLUSTER), MAX_CLUSTER + 1):
        rows = -(-nz // cluster)
        smem = 8 * (rows + 2 * r) * stride + 12 * K
        if smem <= SMEM_LIMIT:
            return SimpleNamespace(cluster=-(-nz // rows), rows=rows,
                                   nx4=nx4, stride=stride, threads=THREADS,
                                   smem=smem)
    raise ValueError(
        f"forward_rows: a {nz} x {nx} grid at radius {r} needs {smem} bytes "
        f"of shared memory a block even at a cluster of {MAX_CLUSTER} "
        f"(slabs of {rows} rows); the card gives at most {SMEM_LIMIT}")


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# (argtypes, restype) of the C entry points of csrc/acoustic2d_legacy.cu;
# every pointer and the stream are c_void_p, so no 64-bit value is cut
SIGNATURES = {
    "acoustic2d_legacy_forward": ([_P] * 7 + [_I] * 13 + [_P, _P, _F, _P],
                                  _I),
    "acoustic2d_legacy_max_clusters": ([_I] * 3 + [_P], _I),
    "acoustic2d_legacy_error_string": ([_I], ctypes.c_char_p),
}


def _lib():
    lib = cuda_build.load("acoustic2d_legacy")
    if not getattr(lib, "_argtypes_set", False):
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        lib._argtypes_set = True
    return lib


def _check(lib, err, what):
    if err:
        raise RuntimeError(
            f"{what}: CUDA error {err} "
            f"({lib.acoustic2d_legacy_error_string(err).decode()})")


def max_clusters(launch, r, device=None):
    """The clusters of ``launch`` (``sweep_launch``) the card holds at
    once: shots beyond them run in later waves."""
    lib = _lib()
    active = ctypes.c_int(0)
    with torch.cuda.device(device):
        _check(lib, lib.acoustic2d_legacy_max_clusters(
            r, launch.cluster, launch.smem, ctypes.byref(active)),
            "acoustic2d_legacy_max_clusters")
    return active.value


def _rows_cuda(m, two_m_hd, denom, wav, inj, *, c0, cx, cz, nt, z0):
    B, nz, nx = inj.shape
    r = len(cx) - 1
    # the plan raises before anything is built or allocated
    sweep_launch(nz, nx, r)
    lib = _lib()
    cells, vals, K = _source_list(inj)
    launch = sweep_launch(nz, nx, r, K)
    nx4 = launch.nx4
    # (nz, nx4), zero in the padding lanes
    coef = [torch.nn.functional.pad(f, (0, nx4 - nx))
            for f in (m, two_m_hd, denom)]
    rec = inj.new_empty((B, nt, 2, nx))
    cx32 = np.asarray(cx, np.float32)
    cz32 = np.asarray(cz, np.float32)
    with torch.cuda.device(inj.device):
        err = lib.acoustic2d_legacy_forward(
            *(f.data_ptr() for f in coef), wav.data_ptr(), cells.data_ptr(),
            vals.data_ptr(), rec.data_ptr(), B, nz, nx, nx4, nt, z0, K, r,
            launch.cluster, launch.rows, launch.stride, launch.threads,
            launch.smem, cx32.ctypes.data, cz32.ctypes.data, c0,
            torch.cuda.current_stream(inj.device).cuda_stream)
    _check(lib, err, "acoustic2d_legacy_forward")
    return rec


def _forward_rows(plain, m, hd, wav, inj, dt, *, nt, nx, nz, space_order,
                  spacing, z0):
    fn = "forward_rows"
    dev = m.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{fn}: tensors on {dev}; expected cuda or cpu")
    B = max(inj.shape[0], 1)
    for i, (t, shape) in enumerate(zip((m, hd, wav, inj),
                                       ((nx, nz), (nx, nz), (nt - 2,),
                                        (B, nx, nz)))):
        if t.device != dev or t.dtype != torch.float32:
            raise TypeError(f"{fn}: operand {i} is {t.dtype} on {t.device};"
                            f" expected float32 on {dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: operand {i} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    if nt < 3 or not 0 <= z0 <= nz - 2:
        raise ValueError(f"{fn}: nt={nt} (at least 3) or receiver rows "
                         f"z0={z0}, z0+1 outside 0..{nz - 1}")
    if dev.type == "cuda" and not plain:
        # refuse a grid the sweep does not take before anything is built
        # or allocated
        sweep_launch(nz, nx, space_order // 2)
    c0, cx, cz = _legacy_constants(space_order, spacing, dt)
    mT = m.T.contiguous()
    hdT = hd.T.contiguous()
    kw = dict(c0=c0, cx=cx, cz=cz, nt=nt, z0=z0)
    ops = (mT, 2.0 * mT + hdT, 1.0 / (mT + hdT), wav.contiguous(),
           inj.transpose(1, 2).contiguous())
    if dev.type == "cuda" and not plain:
        rec = _rows_cuda(*ops, **kw)
        LAUNCHES[fn] += 1
        return rec
    TWIN_CALLS[fn] += 1
    return _rows_plain(*ops, **kw)


def forward_rows(m, hd, wav, inj, dt, *, nt, nx, nz, space_order, spacing,
                 z0):
    """Whole-nt forward of a shot batch. ``m``, ``hd`` (nx, nz) float32
    squared slowness and dt*damp; ``wav`` (nt-2,) the wavelet of steps
    1..nt-2, one for all shots; ``inj`` (B, nx, nz) the dense source
    patterns (``w dt^2 / m`` at each shot's source corners). Returns the
    record (B, nt, 2, nx): rows z0 and z0+1 of u at each step (row t holds
    time t+1; rows nt-2, nt-1 zero)."""
    return _forward_rows(False, m, hd, wav, inj, dt, nt=nt, nx=nx, nz=nz,
                         space_order=space_order, spacing=spacing, z0=z0)


def forward_rows_plain(m, hd, wav, inj, dt, *, nt, nx, nz, space_order,
                       spacing, z0):
    """Plain torch twin of ``forward_rows``, on any device: the comparison
    on the card calls it on CUDA tensors."""
    return _forward_rows(True, m, hd, wav, inj, dt, nt=nt, nx=nx, nz=nz,
                         space_order=space_order, spacing=spacing, z0=z0)


def _source_patterns(s_idx, s_w, m_pad, dt):
    """Dense (B, nx, nz) float32 patterns: ``w * dt * dt / m`` at each
    shot's bilinear source corners, every product in float32 (the JAX
    wrapper's numpy arithmetic, pallas_legacy.py:150-155). Corners outside
    the grid are dropped (the JAX wrapper raises at index nx and wraps a
    negative one, both with weight 0)."""
    nsrc, _, ncorner = s_w.shape
    nx, nz = m_pad.shape
    valid, cl = valid_corners(s_idx, (nx, nz))
    inj = np.zeros((nsrc, nx, nz), np.float32)
    dt32 = np.float32(dt)
    for b in range(nsrc):
        for c in range(ncorner):
            if not valid[b, 0, c]:
                continue
            xi, zi = cl[b, 0, c]
            inj[b, xi, zi] += np.float32(s_w[b, 0, c]) * dt32 * dt32 \
                / m_pad[xi, zi]
    return inj


def operands(geometry, vp=None, device="cuda"):
    """``forward_rows``' operands for all shots of a 2-D geometry, as the
    JAX wrapper builds them on the host (float32 numpy, moved to the
    device once): (m, hd, wav, inj, dt, keywords). Raises ``ValueError``
    for a free surface and for receivers that are not all between two
    adjacent z-planes inside the grid."""
    from ..fwi import _batched_tables, _resolve_device, _solver_dt
    model = geometry.model
    if model.fs:
        raise ValueError("forward_traces (forward_rows kernel) has no "
                         "free-surface support; use fwi.fm_multi")
    if not geometry_supported(geometry):
        raise ValueError("forward_traces takes 2-D geometries whose "
                         "receivers all lie between two adjacent z-planes "
                         "inside the grid")
    dev = _resolve_device(device)
    s_idx, s_w, r_idx, _, wav = _batched_tables(geometry)
    dt = float(_solver_dt(geometry))
    nt = geometry.nt
    nx, nz = model.padded_shape
    vp_arr = np.asarray(vp if vp is not None else model.vp,
                        dtype=np.float32)
    m_pad = np.float32(1.0) / (vp_arr * vp_arr)
    damp = model.damp if isinstance(model.damp, np.ndarray) \
        else np.zeros((nx, nz), np.float32)
    hd = (dt * np.asarray(damp)).astype(np.float32)
    inj = _source_patterns(np.asarray(s_idx), np.asarray(s_w), m_pad, dt)
    kw = dict(nt=nt, nx=nx, nz=nz, space_order=model.space_order,
              spacing=model.spacing, z0=int(np.asarray(r_idx)[..., 1].min()))
    return (torch.as_tensor(m_pad, device=dev),
            torch.as_tensor(hd, device=dev),
            torch.as_tensor(np.asarray(wav[1:nt - 1, 0], np.float32),
                            device=dev),
            torch.as_tensor(inj, device=dev), dt, kw)


def _traces(rows, geometry, z0):
    """(nsrc, nt, nrec) float32 traces from the record (B, nt, 2, nx): the
    interpolation weights times the rows, summed over the corners in corner
    order (pallas_legacy.py:168-175); row t is time t+1. Corners off the x
    range carry weight 0 and read a clamped column."""
    model = geometry.model
    nt = geometry.nt
    dev = rows.device
    r_idx, r_w = interp_table(geometry.rec_positions, model.origin_pml,
                              model.spacing, dtype=model.dtype)
    valid, cl = valid_corners(r_idx, model.padded_shape)
    r_w = torch.as_tensor(np.where(valid, r_w, 0.0).astype(np.float32),
                          device=dev)
    steps = rows[:, :nt - 2]
    trace = rows.new_zeros((rows.shape[0], nt, r_idx.shape[0]))
    for c in range(r_idx.shape[1]):
        xi = torch.as_tensor(cl[:, c, 0], dtype=torch.long, device=dev)
        sel = torch.as_tensor((r_idx[:, c, 1] != z0).astype(np.int64),
                              device=dev)
        trace[:, 1:nt - 1] += r_w[:, c] * steps[:, :, sel, xi]
    return trace


def forward_traces(geometry, vp=None, device="cuda"):
    """All-shot forward modeling through ``forward_rows``; returns the
    (nsrc, nt, nrec) float32 traces (numpy). ``device`` "cuda" (the
    default; raises without a card) runs the kernel, "cpu" its twin.
    Raises ``ValueError`` as ``operands`` does."""
    m, hd, wav, inj, dt, kw = operands(geometry, vp, device)
    rows = forward_rows(m, hd, wav, inj, dt, **kw)
    return _traces(rows, geometry, kw["z0"]).cpu().numpy()
