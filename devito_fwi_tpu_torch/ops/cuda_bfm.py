"""The BFM pushforward slab kernel, on the card and as its plain torch twin.
Counterpart of ``devito_fwi_tpu.ops.pallas_bfm``'s ``pushforward_slabs_nat``
and ``pushforward_slabs`` (the banded Legendre kernel, ROADMAP.md queue B
item 6, is not ported yet).

Both compute, for every (shot, block of R rows), the bilinear supersample
pushforward of the block into an (R + G, lanes) slab: each subsample cell
adds ``wx * wy`` at slab row ``i + rel`` (``wy0``) or ``i + rel + 1``
(``wy1 = mass - wy0``) and lane ``l + dxr`` (``wx0``) or ``l + dxr + 1``
(``wx1 = 1 - wx0``), with ``DX = 2*dxmax + 2`` lane offsets and ``G`` row
offsets. ``misfit.bfm`` prepares the planes (``_slab_planes``) and
overlap-adds the slabs at their blocks' runtime bases (``_slab_push``).

``pushforward_slabs_nat`` takes natural-layout (B, Q, n2p, lanes) planes,
``pushforward_slabs`` blocked (B, nblk, Q, R, lanes) planes; both return
slabs (B, nblk, R + G, lanes). For CUDA tensors each wrapper launches the
kernel of ``csrc/bfm_push.cu`` (one launch, the plane strides as
arguments) and adds one to ``LAUNCHES[name]``; for CPU tensors it runs the
plain twin, which repeats ``_push_block``'s sums in its order (g, then e,
then q), so that the kernel equals it bitwise. On another device it raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

__all__ = ["pushforward_slabs_nat", "pushforward_slabs",
           "pushforward_slabs_nat_plain", "pushforward_slabs_plain",
           "KERNELS", "LAUNCHES", "TWIN_CALLS", "reset_counters",
           "SIGNATURES"]

KERNELS = ("pushforward_slabs_nat", "pushforward_slabs")
# launches of each kernel and calls of each plain twin
LAUNCHES = dict.fromkeys(KERNELS, 0)
TWIN_CALLS = dict.fromkeys(KERNELS, 0)


def reset_counters():
    for name in KERNELS:
        LAUNCHES[name] = 0
        TWIN_CALLS[name] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# (argtypes, restype) of the C entry points of csrc/bfm_push.cu
SIGNATURES = {
    "bfm_push_slabs": ([_P] * 6 + [_I] * 7 + [_L] * 4 + [_P], _I),
    "bfm_push_error_string": ([_I], ctypes.c_char_p),
}


def _lib():
    lib = cuda_build.load("bfm_push")
    if not getattr(lib, "_argtypes_set", False):
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        lib._argtypes_set = True
    return lib


def _blocks(planes, blocked, R):
    """(B, nblk, Q, R, lanes) views of the five planes."""
    if blocked:
        return planes
    B, Q, n2p, lanes = planes[0].shape
    return tuple(p.reshape(B, Q, n2p // R, R, lanes).transpose(1, 2)
                 for p in planes)


def _slabs_plain(planes, blocked, *, G, DX, R):
    """_push_block over all (shot, block) pairs at once: the x-selection
    planes hoisted, then for each g the sum over e of the lane-shifted sum
    over q, added into rows g .. g+R-1 of the slabs."""
    rel, dxr, wy0, mass, wx0 = _blocks(planes, blocked, R)
    B, nblk, Q, _, lanes = wy0.shape
    zero = wy0.new_zeros(())
    wy1 = mass - wy0
    wx1 = 1.0 - wx0
    xsel = [[torch.where(dxr[:, :, q] == e, wx0[:, :, q], zero)
             for e in range(DX)] for q in range(Q)]
    for q in range(Q):
        for e in range(1, DX):
            xsel[q][e] = xsel[q][e] + torch.where(dxr[:, :, q] == e - 1,
                                                  wx1[:, :, q], zero)
    slab = wy0.new_zeros((B, nblk, R + G, lanes))
    for g in range(G):
        m0 = [torch.where(rel[:, :, q] == g, wy0[:, :, q], zero)
              + torch.where(rel[:, :, q] == g - 1, wy1[:, :, q], zero)
              for q in range(Q)]
        acc = None
        for e in range(DX):
            v = xsel[0][e] * m0[0]
            for q in range(1, Q):
                v = v + xsel[q][e] * m0[q]
            if e:
                v = torch.nn.functional.pad(v[..., :lanes - e], (e, 0))
            acc = v if acc is None else acc + v
        slab[:, :, g:g + R] = slab[:, :, g:g + R] + acc
    return slab


def _slabs_cuda(planes, blocked, *, G, DX, R):
    lib = _lib()
    rel, dxr, wy0, mass, wx0 = planes
    if blocked:
        B, nblk, Q, _, lanes = wy0.shape
        strides = (nblk * Q * R * lanes, Q * R * lanes, R * lanes, lanes)
    else:
        B, Q, n2p, lanes = wy0.shape
        nblk = n2p // R
        strides = (Q * n2p * lanes, R * lanes, n2p * lanes, lanes)
    out = wy0.new_empty((B, nblk, R + G, lanes))
    with torch.cuda.device(wy0.device):
        err = lib.bfm_push_slabs(
            rel.data_ptr(), dxr.data_ptr(), wy0.data_ptr(), mass.data_ptr(),
            wx0.data_ptr(), out.data_ptr(), B, nblk, Q, R, G, DX, lanes,
            *strides, torch.cuda.current_stream(wy0.device).cuda_stream)
    if err:
        raise RuntimeError(f"bfm_push_slabs: CUDA error {err} "
                           f"({lib.bfm_push_error_string(err).decode()})")
    return out


def _run(fn, blocked, plain, rel, dxr, wy0, mass, wx0, *, G, dxmax, R):
    planes = (rel, dxr, wy0, mass, wx0)
    dev = wy0.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{fn}: tensors on {dev}; expected cuda or cpu")
    shape = tuple(wy0.shape)
    if not (len(shape) == 5 and shape[3] == R if blocked
            else len(shape) == 4 and shape[2] % R == 0):
        raise ValueError(f"{fn}: planes of shape {shape} do not hold blocks "
                         f"of {R} rows")
    wtype = (torch.float32,) if dev.type == "cuda" else (torch.float32,
                                                         torch.float64)
    for i, p in enumerate(planes):
        want = torch.int32 if i < 2 else wy0.dtype
        if p.device != dev or p.dtype != want or tuple(p.shape) != shape:
            raise ValueError(f"{fn}: plane {i} is {p.dtype} {tuple(p.shape)}"
                             f" on {p.device}; expected {want} {shape} on "
                             f"{dev}")
        if not p.is_contiguous():
            raise ValueError(f"{fn}: plane {i} is not contiguous")
    if wy0.dtype not in wtype:
        raise TypeError(f"{fn}: weights of dtype {wy0.dtype} on {dev.type};"
                        f" expected one of {wtype}")
    kw = dict(G=G, DX=2 * dxmax + 2, R=R)
    if dev.type == "cuda" and not plain:
        out = _slabs_cuda(planes, blocked, **kw)
        LAUNCHES[fn] += 1
        return out
    TWIN_CALLS[fn] += 1
    return _slabs_plain(planes, blocked, **kw)


def pushforward_slabs_nat(rel, dxr, wy0, mass, wx0, *, G, dxmax, R):
    """Slabs (B, nblk, R+G, lanes) from natural-layout (B, Q, n2p, lanes)
    planes, n2p = nblk * R: ``rel``, ``dxr`` int32, ``wy0``, ``mass``,
    ``wx0`` float (float32 on the card)."""
    return _run("pushforward_slabs_nat", False, False, rel, dxr, wy0, mass,
                wx0, G=G, dxmax=dxmax, R=R)


def pushforward_slabs(rel, dxr, wy0, mass, wx0, *, G, dxmax, R):
    """Slabs (B, nblk, R+G, lanes) from blocked (B, nblk, Q, R, lanes)
    planes; the same sums as ``pushforward_slabs_nat``."""
    return _run("pushforward_slabs", True, False, rel, dxr, wy0, mass, wx0,
                G=G, dxmax=dxmax, R=R)


# The plain twins under the wrappers' signatures, on any device: the
# comparison on the card calls them on CUDA tensors.

def pushforward_slabs_nat_plain(rel, dxr, wy0, mass, wx0, *, G, dxmax, R):
    """Plain torch twin of ``pushforward_slabs_nat``."""
    return _run("pushforward_slabs_nat", False, True, rel, dxr, wy0, mass,
                wx0, G=G, dxmax=dxmax, R=R)


def pushforward_slabs_plain(rel, dxr, wy0, mass, wx0, *, G, dxmax, R):
    """Plain torch twin of ``pushforward_slabs``."""
    return _run("pushforward_slabs", True, True, rel, dxr, wy0, mass, wx0,
                G=G, dxmax=dxmax, R=R)
