"""The BFM's kernels, on the card and as their plain torch twins: the
pushforward slab kernel, counterpart of ``devito_fwi_tpu.ops.pallas_bfm``'s
``pushforward_slabs_nat`` and ``pushforward_slabs``; the banded Legendre
transform with its certificate, counterpart of its ``legendre_banded``; and
the anchored Legendre transform with its certificate, the BFM's default
route, counterpart of ``devito_fwi_tpu.misfit.bfm``'s XLA route
``_legendre_last_anchored``.

The slab kernels compute, for every (shot, block of R rows), the bilinear
supersample pushforward of the block into an (R + G, lanes) slab: each
subsample cell adds ``wx * wy`` at slab row ``i + rel`` (``wy0``) or
``i + rel + 1`` (``wy1 = mass - wy0``) and lane ``l + dxr`` (``wx0``) or
``l + dxr + 1`` (``wx1 = 1 - wx0``), with ``DX = 2*dxmax + 2`` lane offsets
and ``G`` row offsets. ``misfit.bfm`` prepares the planes (``_slab_planes``)
and overlap-adds the slabs at their blocks' runtime bases (``_slab_push``).
``pushforward_slabs_nat`` takes natural-layout (B, Q, n2p, lanes) planes,
``pushforward_slabs`` blocked (B, nblk, Q, R, lanes) planes; both return
slabs (B, nblk, R + G, lanes).

``legendre_banded(u, W, K)`` takes a (rows, n) float32 ``u`` and returns
``out[r, i] = max_d (s_i s_{i+d} - u[r, i+d])`` over the Pallas kernel's
offsets d = -W .. ND-1-W (ND = 8 ceil((2W+1)/8); columns outside the row
count as ``-FLT_MAX/8``), ``s_i = (i + 0.5)/n``, and a device flag that is
True iff every row passes the total-monotonicity certificate, so that
``out`` is the full transform (see ``csrc/bfm_legendre.cu``).

``legendre_anchored(u, s, A, Wside)`` takes a (rows, n) float32 ``u`` and
the caller's float32 slopes ``s`` and returns what ``_legendre_last_anchored``
(its plain twin, the torch evaluation) returns: each block of A outputs the
max of ``s_i s_j - u[r, j]`` over its window of W = A ceil((2 Wside + A)/A)
columns from ``k A - Wside``, and a device flag that is True iff ``s`` is
sorted and every row passes the anchors' certificate, so that ``out`` is the
full transform.

For CUDA tensors each wrapper launches its kernel (``csrc/bfm_push.cu``, one
launch, the plane strides as arguments; ``csrc/bfm_legendre.cu``, one launch
of 32-row blocks, ``legendre_launch`` and ``legendre_anchored_launch``) and
adds one to ``LAUNCHES[name]``;
for CPU tensors it runs the plain
twin, which repeats the kernel's arithmetic (the slabs in ``_push_block``'s
order, g, then e, then q), so that the kernel equals it bitwise. On another
device it raises.

The slab kernel must read the five planes and write the slabs once, which
bounds it by device-memory bandwidth (0.407 ms at the 29-shot SMARMN state
on an H100). Each active cell adds to at most four slab elements, so the
kernel does not gather: a block takes one (shot, row block, 32-lane tile),
lists its cells' non-zero products in shared memory (counted, placed by a
prefix sum, sorted per output by (g, e, q)) and sums each output's few
entries in ``_push_block``'s nesting. ``push_launch`` gives its launch and
shared memory (4 Q R (32 + DX - 1) entries of 8 bytes, the worst case; the
wrapper raises beyond Q = 8 or past a block's 232,448 bytes). Its time on
the card is in ``PERF.md`` (kernel table, rows 12-13).

The banded transform is bound by its float operations, a product, a
difference and a max for each band tap and each certificate lane; its
kernel takes 32 rows a block, one a lane, so that the slopes, the same for
every row, and each lane's shared loads serve many evaluations, and checks
the certificate as maxima of the regions left and right of each sample's
band (``csrc/bfm_legendre.cu``). The anchored kernel shares that design:
its anchors are the certificate's samples, walked by the same code, and a
lane's 8 outputs share their block's window, so a step of 4 taps is one
16-byte shared load of u and one broadcast of 4 slopes for 32 evaluations.
Their times on the card are in ``PERF.md`` (kernel table, rows 11 and 24).
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build

__all__ = ["pushforward_slabs_nat", "pushforward_slabs",
           "pushforward_slabs_nat_plain", "pushforward_slabs_plain",
           "legendre_banded", "legendre_banded_plain", "legendre_anchored",
           "legendre_anchored_plain", "KERNELS", "LAUNCHES", "TWIN_CALLS",
           "reset_counters", "SIGNATURES", "LEGENDRE_SIGNATURES",
           "push_launch", "legendre_launch", "legendre_anchored_launch"]

KERNELS = ("pushforward_slabs_nat", "pushforward_slabs", "legendre_banded",
           "legendre_anchored")
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
    "bfm_push_slabs": ([_P] * 6 + [_I] * 7 + [_L] * 5 + [_P], _I),
    "bfm_push_error_string": ([_I], ctypes.c_char_p),
}


# (argtypes, restype) of the C entry points of csrc/bfm_legendre.cu
LEGENDRE_SIGNATURES = {
    "bfm_legendre_banded": ([_P] * 4 + [_I] * 8 + [_P], _I),
    "bfm_legendre_anchored": ([_P] * 4 + [_I] * 8 + [_P], _I),
    "bfm_legendre_error_string": ([_I], ctypes.c_char_p),
}


def _load(source, signatures):
    lib = cuda_build.load(source)
    if not getattr(lib, "_argtypes_set", False):
        for name, (argtypes, restype) in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        lib._argtypes_set = True
    return lib


def _lib():
    return _load("bfm_push", SIGNATURES)


def _legendre_lib():
    return _load("bfm_legendre", LEGENDRE_SIGNATURES)


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


# the slab kernel's launch (csrc/bfm_push.cu kTile, kThreads, kMaxQ)
PUSH_TILE = 32
PUSH_THREADS = 512
PUSH_MAX_Q = 8
SMEM_LIMIT = 232448     # a block's shared memory on an H100 (sm_90)


def push_launch(B, nblk, Q, R, G, DX, lanes):
    """The slab kernel's launch at these shapes: one block per (shot, row
    block, tile of ``PUSH_TILE`` lanes), its threads and its shared-memory
    bytes (8 bytes for each of the 4 Q R (tile + DX - 1) contributions the
    tile's cells can make, 4 for each of its (R + G) x tile outputs, 4 for
    each warp's scan sum). Raises ValueError for what the kernel does not
    take."""
    if not 1 <= Q <= PUSH_MAX_Q:
        raise ValueError(f"slab kernel: Q = {Q} subsamples; it takes 1 .. "
                         f"{PUSH_MAX_Q}")
    if min(B, nblk, R, G, DX, lanes) < 1 or B * nblk >= 2 ** 31 \
            or G * DX * Q >= 2 ** 16:
        raise ValueError(f"slab kernel: B = {B}, nblk = {nblk}, R = {R}, "
                         f"G = {G}, DX = {DX}, lanes = {lanes}")
    cells = Q * R * (PUSH_TILE + DX - 1)
    smem = 8 * 4 * cells + 4 * (R + G) * PUSH_TILE + 4 * (PUSH_THREADS // 32)
    if smem > SMEM_LIMIT:
        raise ValueError(f"slab kernel: Q = {Q}, R = {R}, G = {G}, DX = {DX}"
                         f" need {smem} bytes of shared memory a block; the "
                         f"card has {SMEM_LIMIT}")
    return SimpleNamespace(grid=(B * nblk, -(-lanes // PUSH_TILE)),
                           threads=PUSH_THREADS, smem=smem)


def _slabs_cuda(planes, blocked, *, G, DX, R):
    rel, dxr, wy0, mass, wx0 = planes
    if blocked:
        B, nblk, Q, _, lanes = wy0.shape
        strides = (nblk * Q * R * lanes, Q * R * lanes, R * lanes, lanes)
    else:
        B, Q, n2p, lanes = wy0.shape
        nblk = n2p // R
        strides = (Q * n2p * lanes, R * lanes, n2p * lanes, lanes)
    launch = push_launch(B, nblk, Q, R, G, DX, lanes)
    lib = _lib()
    out = wy0.new_empty((B, nblk, R + G, lanes))
    with torch.cuda.device(wy0.device):
        err = lib.bfm_push_slabs(
            rel.data_ptr(), dxr.data_ptr(), wy0.data_ptr(), mass.data_ptr(),
            wx0.data_ptr(), out.data_ptr(), B, nblk, Q, R, G, DX, lanes,
            *strides, launch.smem,
            torch.cuda.current_stream(wy0.device).cuda_stream)
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


# ---------------------------------------------------------------------------
# banded Legendre transform
# ---------------------------------------------------------------------------

_BIG = float(torch.finfo(torch.float32).max / 8)


def _grid(n, dev):
    """s_i = (i + 0.5)/n, formed in float32 on the host as the Pallas
    wrapper forms its table (an f64 table cast to f32 can sit one ulp off
    the certificate's slopes)."""
    s = (np.arange(n, dtype=np.float32) + np.float32(0.5)) / np.float32(n)
    return torch.as_tensor(s, device=dev)


def _legendre_plain(u, s, W, K):
    """The band as ND full-row maxima over shifted copies of the padded row,
    the certificate as one full-row argmax per sample; (out, ok)."""
    rows, n = u.shape
    ND = -(-(2 * W + 1) // 8) * 8     # the Pallas kernel's chunks of 8
    npad = -(-n // 128) * 128
    up = F.pad(u, (W, ND - W), value=_BIG)            # up[:, k]: u[:, k - W]
    sp = F.pad(s, (W, ND - W))
    acc = torch.full_like(u, -_BIG)
    for d in range(ND):
        acc = torch.maximum(acc, s * sp[d:d + n] - up[:, d:d + n])
    uc = F.pad(u, (0, npad - n), value=_BIG)
    sc = F.pad(s, (0, npad - n))
    lane = torch.arange(npad, device=u.device)

    def first_last(i):
        v = s[i] * sc - uc
        hit = v >= v.amax(1, keepdim=True)
        return (torch.where(hit, lane, n).amin(1),
                torch.where(hit, lane, -1).amax(1))

    ok = torch.ones((), dtype=torch.bool, device=u.device)
    prev_first, _ = first_last(0)
    for m in range(1, -(-(n - 1) // K) + 1):
        i, prev = min(m * K, n - 1), min((m - 1) * K, n - 1)
        first, last = first_last(i)
        ok = ok & torch.all(prev_first >= i - W) & torch.all(last <= prev + W)
        prev_first = first
    return acc, ok


# the banded kernel's launch (csrc/bfm_legendre.cu kRows, kWarps, kV,
# kMaxTile, kMaxS)
LEGENDRE_ROWS = 32
LEGENDRE_WARPS = 8
LEGENDRE_OUTPUTS = 8
LEGENDRE_MAX_TILE = 384
LEGENDRE_MAX_SAMPLES = 8


def legendre_launch(rows, n, W, K):
    """The banded kernel's launch at these shapes: one grid of ``grid``
    blocks of ``threads`` threads, each block ``LEGENDRE_ROWS`` rows, one a
    lane, the row cut into ``tiles`` column tiles of ``tile`` lanes (a
    multiple of 8, at most ``LEGENDRE_MAX_TILE``). ``band_blocks`` blocks
    take a (row block, tile) of the band, needing ``band_smem`` bytes of
    shared memory (the tile of 32 rows and its band halo at an odd pitch,
    the slopes, a staging tile a warp); ``cert_blocks`` take a (row block,
    group of 8 x ``samples`` samples) of the certificate, ``passes`` groups
    a row block, needing ``cert_smem`` (a tile and the slopes); ``smem`` is
    the larger. Raises ValueError for what the kernel
    does not take: no row, rows of fewer than 2 or more than 2^30 lanes,
    grids of 2^31 blocks, K < 1, K > W (the certificate's walk needs
    a < c + 1) and bands too wide for a block's shared memory."""
    if rows < 1 or not 2 <= n <= 2 ** 30:
        raise ValueError(f"banded Legendre: {rows} rows of {n}; the kernel "
                         "takes at least one row of 2 .. 2^30 lanes")
    if not 1 <= K <= W:
        raise ValueError(f"banded Legendre: W = {W}, K = {K}; the kernel "
                         "takes 1 <= K <= W")
    ND = -(-(2 * W + 1) // 8) * 8
    nsamp = -(-(n - 1) // K) + 1
    V, R, warps = LEGENDRE_OUTPUTS, LEGENDRE_ROWS, LEGENDRE_WARPS
    # the fewest tiles of at most LEGENDRE_MAX_TILE lanes, evened out
    tile = -(-(-(-n // -(-n // LEGENDRE_MAX_TILE))) // V) * V
    tiles = -(-n // tile)
    passes = -(-nsamp // (warps * LEGENDRE_MAX_SAMPLES))
    samples = -(-nsamp // (warps * passes))
    band_smem = 4 * (R * (tile + ND + 1) + tile + ND + warps * R * (V + 1))
    cert_smem = 4 * (R * (tile + 1) + tile)
    blocks = -(-rows // R)
    if blocks * (tiles + passes) >= 2 ** 31:
        raise ValueError(f"banded Legendre: {rows} rows of {n} need "
                         f"{blocks * (tiles + passes)} blocks; the grid "
                         "takes fewer than 2^31")
    if band_smem > SMEM_LIMIT:
        raise ValueError(f"banded Legendre: W = {W} needs {band_smem} bytes "
                         "of shared memory a block; the card has "
                         f"{SMEM_LIMIT}")
    return SimpleNamespace(rows_a_block=R, threads=32 * warps, tile=tile,
                           tiles=tiles, samples=samples, passes=passes,
                           band_blocks=blocks * tiles,
                           cert_blocks=blocks * passes,
                           grid=blocks * (tiles + passes),
                           band_smem=band_smem, cert_smem=cert_smem,
                           smem=max(band_smem, cert_smem))


def _legendre_cuda(u, s, W, K):
    rows, n = u.shape
    launch = legendre_launch(rows, n, W, K)
    lib = _legendre_lib()
    out = torch.empty_like(u)
    row_bad = torch.zeros(rows, dtype=torch.int32, device=u.device)
    with torch.cuda.device(u.device):
        err = lib.bfm_legendre_banded(
            u.data_ptr(), s.data_ptr(), out.data_ptr(), row_bad.data_ptr(),
            rows, n, W, K, launch.tile, launch.samples, launch.passes,
            launch.smem, torch.cuda.current_stream(u.device).cuda_stream)
    if err:
        raise RuntimeError(f"bfm_legendre_banded: CUDA error {err} "
                           f"({lib.bfm_legendre_error_string(err).decode()})")
    return out, torch.all(row_bad == 0)


def _legendre_run(plain, u, W, K):
    fn = "legendre_banded"
    dev = u.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{fn}: tensor on {dev}; expected cuda or cpu")
    if u.dim() != 2 or u.shape[0] < 1 or u.shape[1] < 2:
        raise ValueError(f"{fn}: u of shape {tuple(u.shape)}; expected "
                         "(rows, n) with rows >= 1 and n >= 2")
    if u.dtype != torch.float32:
        raise TypeError(f"{fn}: u of dtype {u.dtype}; expected float32")
    if not u.is_contiguous():
        raise ValueError(f"{fn}: u is not contiguous")
    if W < 0 or K < 1:
        raise ValueError(f"{fn}: W = {W}, K = {K}; expected W >= 0, K >= 1")
    s = _grid(u.shape[1], dev)
    if dev.type == "cuda" and not plain:
        out = _legendre_cuda(u, s, W, K)
        LAUNCHES[fn] += 1
        return out
    TWIN_CALLS[fn] += 1
    return _legendre_plain(u, s, W, K)


def legendre_banded(u, W, K):
    """Banded Legendre transform of a (rows, n) float32 ``u`` along its last
    axis and the certificate: ``(out, ok)``, ``ok`` a 0-dim bool tensor on
    ``u``'s device; ``out`` equals ``max_j (s_i s_j - u[:, j])`` when ``ok``
    is True."""
    return _legendre_run(False, u, W, K)


def legendre_banded_plain(u, W, K):
    """Plain torch twin of ``legendre_banded``, on any device."""
    return _legendre_run(True, u, W, K)


# ---------------------------------------------------------------------------
# anchored Legendre transform
# ---------------------------------------------------------------------------

def _legendre_last_anchored(u, s, A=16, Wside=64, max_tmp_elems=32_000_000):
    """Block-banded Legendre transform along the last axis with a
    sampled-argmax certificate: ``(out, ok)``, ``out`` equal to
    ``misfit.bfm._legendre_last(u, s)`` whenever ``ok``; in torch, on any
    device (``legendre_anchored``'s plain twin).

    ``s_i s_j - u_j`` is supermodular in (i, j) for nondecreasing ``s``, so
    its first and last argmax over j are nondecreasing in i. An anchor pass
    takes the exact first/last argmax at every block edge i = k*A; every
    output of block k then has its argmax in [first(k*A), last((k+1)*A)],
    and the certificate checks that bracket against the block's window
    [k*A - Wside, k*A + A - 1 + Wside]. The banded pass evaluates each
    A-output block over its window of W = 2*Wside + A (rounded up to A)
    entries, taken from the padded row as a strided view."""
    n = s.shape[0]
    lead = u.shape[:-1]
    U = u.reshape(-1, n)
    rws = U.shape[0]
    dtype, dev = u.dtype, u.device
    nA = -(-n // A)
    npad = nA * A
    W = -(-(2 * Wside + A) // A) * A
    big = torch.finfo(dtype).max / 8

    # anchor pass: exact first/last argmax at the block edges
    m_idx = torch.clamp(torch.arange(nA + 1, device=dev) * A, max=n - 1)
    s_anchor = s[m_idx]
    blk = max(1, min(nA + 1, max_tmp_elems // max(rws * n, 1)))
    j_iota = torch.arange(n, dtype=torch.int32, device=dev)
    first = torch.empty((rws, nA + 1), dtype=torch.int32, device=dev)
    last = torch.empty_like(first)
    for a0 in range(0, nA + 1, blk):
        cand = s_anchor[a0:a0 + blk, None] * s[None, :] - U[:, None, :]
        hit = cand >= cand.amax(-1, keepdim=True)
        first[:, a0:a0 + blk] = torch.where(hit, j_iota, n).amin(-1)
        last[:, a0:a0 + blk] = torch.where(hit, j_iota, -1).amax(-1)
    kA = torch.arange(nA, dtype=torch.int32, device=dev) * A
    ok = torch.all(first[:, :-1] >= kA - Wside) \
        & torch.all(last[:, 1:] <= kA + (W - Wside - 1)) \
        & torch.all(s[1:] >= s[:-1])      # monotone argmax needs sorted s

    # banded pass: window[r, k, w] = U_pad[r, k*A + w] = U[r, k*A + w - Wside]
    P = npad + W - A
    U_pad = torch.full((rws, P), big, dtype=dtype, device=dev)
    U_pad[:, Wside:Wside + n] = U
    s_pad = torch.zeros(P, dtype=dtype, device=dev)
    s_pad[Wside:Wside + n] = s
    sO = F.pad(s, (0, npad - n)).reshape(nA, A)
    PK = sO[:, :, None] * s_pad.unfold(0, W, A)[:, None, :]   # (nA, A, W)
    rb = max(1, min(rws, max_tmp_elems // max(nA * A * W, 1)))
    out = u.new_empty((rws, npad))
    for r0 in range(0, rws, rb):
        band = U_pad[r0:r0 + rb].unfold(-1, W, A)               # (rb, nA, W)
        out[r0:r0 + rb] = (PK[None] - band[:, :, None, :]).amax(-1) \
            .reshape(-1, npad)
    return out[:, :n].reshape(lead + (n,)), ok


def legendre_anchored_launch(rows, n, A, Wside):
    """The anchored kernel's launch at these shapes: one grid of ``grid``
    blocks of ``threads`` threads, each block ``LEGENDRE_ROWS`` rows, one a
    lane, the outputs cut into ``tiles`` tiles of ``tile`` (a multiple of A,
    at most ``LEGENDRE_MAX_TILE``), each block of A outputs over its window
    of ``window`` = A ceil((2 Wside + A)/A) columns. ``band_blocks`` blocks
    take a (row block, tile), needing ``band_smem`` bytes of shared memory
    (the tile's windows, tile + window - A columns of 32 rows at a pitch of
    an odd number of 16-byte words, their slopes, a staging tile a warp);
    ``cert_blocks`` take a (row block, group of 8 x ``samples`` of the
    ``anchors`` = ceil(n/A) + 1 anchors), ``passes`` groups a row block,
    needing ``cert_smem`` (a tile and the slopes); ``smem`` is the larger.
    Raises ValueError for what the kernel does not take: no row, rows of
    fewer than 2 or more than 2^30 lanes, A not a positive multiple of 8 or
    past ``LEGENDRE_MAX_TILE``, Wside < 0, grids of 2^31 blocks and windows
    too wide for a block's shared memory."""
    if rows < 1 or not 2 <= n <= 2 ** 30:
        raise ValueError(f"anchored Legendre: {rows} rows of {n}; the kernel "
                         "takes at least one row of 2 .. 2^30 lanes")
    V, R, warps = LEGENDRE_OUTPUTS, LEGENDRE_ROWS, LEGENDRE_WARPS
    if A < V or A % V or A > LEGENDRE_MAX_TILE or Wside < 0:
        raise ValueError(f"anchored Legendre: A = {A}, Wside = {Wside}; the "
                         f"kernel takes A a multiple of {V} up to "
                         f"{LEGENDRE_MAX_TILE} and Wside >= 0")
    W = -(-(2 * Wside + A) // A) * A
    npad = -(-n // A) * A
    anchors = npad // A + 1
    # the fewest tiles of at most LEGENDRE_MAX_TILE outputs, evened out
    most = LEGENDRE_MAX_TILE // A * A
    tile = -(-(-(-npad // -(-npad // most))) // A) * A
    tiles = -(-npad // tile)
    passes = -(-anchors // (warps * LEGENDRE_MAX_SAMPLES))
    samples = -(-anchors // (warps * passes))
    L = tile + W - A
    band_smem = 4 * (R * (L + 4) + L + warps * R * (V + 1))
    cert_smem = 4 * (R * (tile + 1) + tile)
    blocks = -(-rows // R)
    if blocks * (tiles + passes) >= 2 ** 31:
        raise ValueError(f"anchored Legendre: {rows} rows of {n} need "
                         f"{blocks * (tiles + passes)} blocks; the grid "
                         "takes fewer than 2^31")
    if band_smem > SMEM_LIMIT:
        raise ValueError(f"anchored Legendre: A = {A}, Wside = {Wside} need "
                         f"{band_smem} bytes of shared memory a block; the "
                         f"card has {SMEM_LIMIT}")
    return SimpleNamespace(rows_a_block=R, threads=32 * warps, tile=tile,
                           tiles=tiles, window=W, anchors=anchors,
                           samples=samples, passes=passes,
                           band_blocks=blocks * tiles,
                           cert_blocks=blocks * passes,
                           grid=blocks * (tiles + passes),
                           band_smem=band_smem, cert_smem=cert_smem,
                           smem=max(band_smem, cert_smem))


def _anchored_cuda(u, s, A, Wside, launch):
    rows, n = u.shape
    lib = _legendre_lib()
    out = torch.empty_like(u)
    ok = torch.empty((), dtype=torch.bool, device=u.device)
    with torch.cuda.device(u.device):
        err = lib.bfm_legendre_anchored(
            u.data_ptr(), s.data_ptr(), out.data_ptr(), ok.data_ptr(), rows,
            n, A, Wside, launch.tile, launch.samples, launch.passes,
            launch.smem, torch.cuda.current_stream(u.device).cuda_stream)
    if err:
        raise RuntimeError(f"bfm_legendre_anchored: CUDA error {err} "
                           f"({lib.bfm_legendre_error_string(err).decode()})")
    return out, ok


def _anchored_run(plain, u, s, A, Wside):
    fn = "legendre_anchored"
    dev = u.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{fn}: tensor on {dev}; expected cuda or cpu")
    if u.dim() != 2 or u.shape[0] < 1 or u.shape[1] < 2:
        raise ValueError(f"{fn}: u of shape {tuple(u.shape)}; expected "
                         "(rows, n) with rows >= 1 and n >= 2")
    if s.device != dev or s.dim() != 1 or s.shape[0] != u.shape[1]:
        raise ValueError(f"{fn}: s of shape {tuple(s.shape)} on {s.device}; "
                         f"expected ({u.shape[1]},) on {dev}")
    if u.dtype != torch.float32 or s.dtype != torch.float32:
        raise TypeError(f"{fn}: u of dtype {u.dtype}, s of dtype {s.dtype}; "
                        "expected float32")
    if not (u.is_contiguous() and s.is_contiguous()):
        raise ValueError(f"{fn}: u or s is not contiguous")
    launch = legendre_anchored_launch(u.shape[0], u.shape[1], A, Wside)
    if dev.type == "cuda" and not plain:
        out = _anchored_cuda(u, s, A, Wside, launch)
        LAUNCHES[fn] += 1
        return out
    TWIN_CALLS[fn] += 1
    return _legendre_last_anchored(u, s, A, Wside)


def legendre_anchored(u, s, A, Wside):
    """Anchored Legendre transform of a (rows, n) float32 ``u`` along its
    last axis with slopes ``s`` (n,) and the certificate: ``(out, ok)``,
    ``ok`` a 0-dim bool tensor on ``u``'s device; ``out`` equals ``max_j
    (s_i s_j - u[:, j])`` when ``ok`` is True. Bitwise
    ``_legendre_last_anchored(u, s, A, Wside)``, output and flag."""
    return _anchored_run(False, u, s, A, Wside)


def legendre_anchored_plain(u, s, A, Wside):
    """Plain torch twin of ``legendre_anchored``, on any device."""
    return _anchored_run(True, u, s, A, Wside)
