"""One 3-D acoustic OT2 leapfrog step as a CUDA kernel, beside its plain
torch twin. Counterpart of ``devito_fwi_tpu.ops.pallas_acoustic3``.

``step3`` computes ``un = (s2 lap(u) + (2m + hd) u - m up) / (m + hd)`` on a
3-D (nx, ny, nz) grid with zero-Dirichlet edges, the association of the
eager update (``ops.acoustic._update``) term for term, so the step hook of
``ops.acoustic`` that swaps it in is numerically invisible. For CUDA float32
tensors it launches ``acoustic3d_step`` of ``csrc/acoustic3d.cu`` and adds
one to ``LAUNCHES["step3"]``; for CPU tensors it runs ``step3_plain``. On
another device it raises.

``pick_xb`` is the JAX module's x-blocking rule, kept because it decides
where the hook applies (``unsupported_reason``); the CUDA kernel blocks
over (z, y) with one x-plane per block row and needs no x blocking.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build
from .acoustic import laplacian_parts

__all__ = ["pick_xb", "step3", "step3_plain", "unsupported_reason",
           "KERNELS", "LAUNCHES", "TWIN_CALLS", "reset_counters"]

KERNELS = ("step3",)
# launches of the kernel and calls of its plain twin
LAUNCHES = dict.fromkeys(KERNELS, 0)
TWIN_CALLS = dict.fromkeys(KERNELS, 0)


def reset_counters():
    for name in KERNELS:
        LAUNCHES[name] = 0
        TWIN_CALLS[name] = 0


def pick_xb(nx, r, target=16):
    """Largest block height <= ~2*target that divides nx and is a multiple
    of the stencil radius r; None when nx admits no such blocking."""
    best = None
    for xb in range(max(r, 4), min(nx, 2 * target) + 1):
        if nx % xb == 0 and xb % r == 0:
            if best is None or abs(xb - target) < abs(best - target):
                best = xb
    return best


def unsupported_reason(shape, space_order, fs, dtype):
    """Why the step kernel does not take a grid (None when it does): the
    JAX hook's conditions, a 3-D float32 OT2 grid without a free surface
    whose padded nx admits ``pick_xb``."""
    if len(shape) != 3:
        return f"a {len(shape)}-D grid (the step kernel is 3-D)"
    if fs:
        return "a free surface (the step kernel has none)"
    if dtype != torch.float32:
        return f"dtype {dtype} (the step kernel is float32)"
    if pick_xb(shape[0], space_order // 2) is None:
        return (f"padded nx {shape[0]} admits no x blocking for radius "
                f"{space_order // 2} (pick_xb)")
    return None


def step3_plain(u, up, m, hd, s2, *, w, inv_h2, inv_mhd=None):
    """Plain torch twin of ``step3``: the eager Laplacian and update."""
    TWIN_CALLS["step3"] += 1
    if inv_mhd is None:
        inv_mhd = 1.0 / (m + hd)
    lap = laplacian_parts(u, w, inv_h2, False)
    return (s2 * lap + (2.0 * m + hd) * u - m * up) * inv_mhd


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# argtypes of acoustic3d_step in csrc/acoustic3d.cu; the sweeps' entries are
# in ops/cuda_acoustic3d.py (one library)
SIGNATURES = {
    "acoustic3d_step": ([_P] * 6 + [_I] * 3 + [_F, _I, _P, _F, _F, _F, _P],
                        _I),
    "acoustic3d_error_string": ([_I], ctypes.c_char_p),
}


def _lib():
    lib = cuda_build.load("acoustic3d")
    if not getattr(lib, "_step_argtypes_set", False):
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        lib._step_argtypes_set = True
    return lib


def step3(u, up, m, hd, s2, *, w, inv_h2, inv_mhd=None):
    """One leapfrog step ``(s2 lap(u) + (2m + hd) u - m up) / (m + hd)`` of
    (nx, ny, nz) fields. ``s2`` is dt^2 (a float or a 0-d tensor), ``w`` the
    half-stencil weights [w0 .. wr], ``inv_h2`` the three 1/h^2; ``inv_mhd``
    (default ``1/(m + hd)``) may be passed precomputed."""
    fields = (u, up, m, hd) + (() if inv_mhd is None else (inv_mhd,))
    dev = u.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"step3: tensors on {dev}; expected cuda or cpu")
    shape = tuple(u.shape)
    if len(shape) != 3:
        raise ValueError(f"step3: u has shape {shape}, expected (nx, ny, nz)")
    for i, t in enumerate(fields):
        if t.device != dev or t.dtype != u.dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"step3: operand {i} is {t.dtype} {tuple(t.shape)} on "
                f"{t.device}, u is {u.dtype} {shape} on {dev}")
    if dev.type == "cpu":
        return step3_plain(u, up, m, hd, s2, w=w, inv_h2=inv_h2,
                           inv_mhd=inv_mhd)
    if u.dtype != torch.float32:
        raise TypeError(f"step3: dtype {u.dtype} on cuda; expected float32")
    if inv_mhd is None:
        inv_mhd = 1.0 / (m + hd)
    ops = [t.contiguous() for t in (u, up, m, hd, inv_mhd)]
    out = torch.empty_like(ops[0])
    lib = _lib()
    w32 = np.asarray([float(v) for v in w], np.float32)
    ih = [float(v) for v in inv_h2]
    with torch.cuda.device(dev):
        err = lib.acoustic3d_step(
            *(t.data_ptr() for t in ops), out.data_ptr(), *shape, float(s2),
            len(w32) - 1, w32.ctypes.data, *ih,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"acoustic3d_step: CUDA error {err} "
                           f"({lib.acoustic3d_error_string(err).decode()})")
    LAUNCHES["step3"] += 1
    return out
