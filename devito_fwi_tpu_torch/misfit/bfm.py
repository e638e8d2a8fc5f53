"""Back-and-forth method (BFM) for the 2-D quadratic-Wasserstein distance,
batch-native on torch. Port of the default route of
``devito_fwi_tpu.misfit.bfm`` (reference ``misfit/QW2D/src/fot2d.c``):

* DCT-based Poisson (H^-1) ascent steps (``fot2d.c:459-482``): the
  orthonormal DCT-II/III as products with cosine matrices, at full float32
  (``ops.cuda_acoustic.matmul_full``, TF32 off);
* the c-transform for the quadratic cost as a separable discrete Legendre
  transform (``fot2d.c:50-178``): the anchored block-banded evaluation with
  its sampled-argmax certificate, and the full blocked transform where the
  certificate fails;
* the mass-conserving pushforward through the map ``grad(potential)``
  (``fot2d.c:294-457``) with fixed nsub x nsub supersampling (nsub = 0:
  the two-level adaptive mode), dispatched to three tiers that compute the
  same sums: the slab kernel (``ops.cuda_bfm``), the local-base banded
  matrix product, the exact scatter;
* the adaptive step size and the gradient ``(psi - <mu, psi>)/mean(f)``
  (``fot2d.c:484-496, 606-656``).

Where the JAX package branches with ``lax.cond`` on a device flag (the
Legendre certificate, the pushforward predicates), the port reads the flag
on the host (``bool(flag)``) and runs one branch. ``COUNTS`` counts those
reads, the Legendre fallbacks and the pushforwards by tier.

Backends are keywords (``resolve_backends``) with the JAX package's
values: push "pallas" (the slab kernel first) or "xla" (banded product,
then scatter); prep "nat" or "blocked" (the slab kernel's plane layout);
Legendre "anchor" (the default, as in the JAX package), "banded" (the banded
kernel ``ops.cuda_bfm.legendre_banded`` with its certificate, the full
transform where it fails) or "full". The vectorized slab fold ("vec", a
negative result the JAX package keeps for comparisons) is not ported and
raises ``NotImplementedError``.

``bfm_torch`` solves one gather through ``bfm_batch``; ``bfm`` (alias
``bfmx``) is the host-facing class of the reference driver,
``gradient(f, g) -> (loss, grad)`` on numpy (nt, ntraces) gathers.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import cuda_bfm as _cb
from ..ops.cuda_acoustic import matmul_full

__all__ = ["bfm_batch", "bfm_torch", "bfm", "bfmx", "resolve_backends",
           "COUNTS", "reset_counts"]

# host reads of device flags and the branches they chose
COUNTS = dict(push_slab=0, push_banded=0, push_scatter=0, predicate_reads=0,
              legendre_reads=0, legendre_fallbacks=0)


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


def _read(flag, counter):
    """One host read of a device flag."""
    COUNTS[counter] += 1
    return bool(flag)


def resolve_backends(push="pallas", prep="nat", legendre="anchor"):
    """Check the backend keywords; returns (push, prep, legendre)."""
    if push in ("pallas-vecfold", "vec"):
        raise NotImplementedError(
            "the vectorized slab fold ('vec') is not ported (ROADMAP.md "
            "queue A item 9)")
    if push not in ("pallas", "xla"):
        raise ValueError(f"push backend {push!r}: expected 'pallas' or "
                         "'xla'")
    if prep not in ("nat", "blocked"):
        raise ValueError(f"prep {prep!r}: expected 'nat' or 'blocked'")
    if legendre not in ("anchor", "banded", "full"):
        raise ValueError(f"legendre {legendre!r}: expected 'anchor', "
                         "'banded' or 'full'")
    return push, prep, legendre


# ---------------------------------------------------------------------------
# Legendre transforms
# ---------------------------------------------------------------------------

def _legendre_last(u, s, max_tmp_elems=2_000_000):
    """out[..., i] = max_j (s[i]*s[j] - u[..., j]) along the last axis, in
    blocks of output entries so that the (rows, blk, n) temporary stays
    near ``max_tmp_elems``."""
    n = s.shape[0]
    rows = u.numel() // max(n, 1)
    blk = max(8, min(n, max_tmp_elems // max(rows * n, 1)))
    out = u.new_empty(u.shape)
    for i0 in range(0, n, blk):
        si = s[i0:i0 + blk]
        out[..., i0:i0 + blk] = (si[:, None] * s[None, :]
                                 - u[..., None, :]).amax(-1)
    return out


def _legendre_last_anchored(u, s, A=16, Wside=64, max_tmp_elems=32_000_000):
    """Block-banded Legendre transform along the last axis with a
    sampled-argmax certificate: ``(out, ok)``, ``out`` equal to
    ``_legendre_last(u, s)`` whenever ``ok``.

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


def _legendre_last_anchor_fast(u, s, max_tmp_elems=32_000_000):
    """Anchored Legendre transform, with the full transform where its
    certificate fails (one host read of the flag)."""
    n = s.shape[0]
    A, Wside = (32, 64) if n >= 512 else (8, 32)
    if n <= 2 * Wside + 2 * A:
        return _legendre_last(u, s, max_tmp_elems)
    out, ok = _legendre_last_anchored(u, s, A, Wside, max_tmp_elems)
    if _read(ok, "legendre_reads"):
        return out
    COUNTS["legendre_fallbacks"] += 1
    return _legendre_last(u, s, max_tmp_elems)


def _legendre_last_fast(u, s, max_tmp_elems=2_000_000):
    """Legendre transform along the last axis through the banded kernel
    (``ops.cuda_bfm.legendre_banded``), with the full transform where its
    certificate fails (one host read of the flag). The bands are the JAX
    package's, W/K = 48/16 for n >= 512 and 24/8 below; the certificate
    needs W >= K + the largest displacement. Rows too short for the band to
    save work, and types other than float32, take the full transform. The
    kernel uses its own grid ``s_i = (i + 0.5)/n``, so the endpoints of
    ``s`` are checked in float32 and folded into the flag: other slopes
    fall back to the full transform, which honours ``s``."""
    n = s.shape[0]
    W, K = (48, 16) if n >= 512 else (24, 8)
    if n <= 2 * W + 1 + n // K or u.dtype != torch.float32:
        return _legendre_last(u, s, max_tmp_elems)
    out, ok = _cb.legendre_banded(u.reshape(-1, n).contiguous(), W, K)
    s_ok = (s[0] == float(np.float32(0.5) / np.float32(n))) & \
        (s[-1] == float((np.float32(n - 1) + np.float32(0.5))
                        / np.float32(n)))
    if _read(ok & s_ok, "legendre_reads"):
        return out.reshape(u.shape)
    COUNTS["legendre_fallbacks"] += 1
    return _legendre_last(u, s, max_tmp_elems)


def _legendre_2d(u, sx, sy, max_tmp_elems=2_000_000, legendre="anchor"):
    """out[..., iy, ix] = max_{jx, jy} (x_ix x_jx + y_iy y_jy - u[.., jy, jx])
    as two 1-D passes (fot2d.c:151-173)."""
    fn = {"anchor": _legendre_last_anchor_fast,
          "banded": _legendre_last_fast}.get(legendre, _legendre_last)
    a = fn(u, sx, max_tmp_elems)                            # max over jx
    b = fn(-a.transpose(-1, -2), sy, max_tmp_elems)         # max over jy
    return b.transpose(-1, -2).contiguous()


# ---------------------------------------------------------------------------
# pushforward
# ---------------------------------------------------------------------------

def _pushforward_map(dual, n1, n2):
    """Corner-grid map of a batch of potentials (B, n2, n1): the
    central-difference gradient as a fixed four-point stencil on the
    edge-replicated field (fot2d.c:294-325)."""
    Fp = F.pad(dual[:, None], (2, 2, 2, 2), mode="replicate")[:, 0]
    Rf = Fp[:, 1:n2 + 2, :] + Fp[:, 2:n2 + 3, :]
    xMap = 0.125 * n1 * (Rf[:, :, 2:n1 + 3] + Rf[:, :, 3:n1 + 4]
                         - Rf[:, :, 0:n1 + 1] - Rf[:, :, 1:n1 + 2])
    Cf = Fp[:, :, 1:n1 + 2] + Fp[:, :, 2:n1 + 3]
    yMap = 0.125 * n2 * (Cf[:, 2:n2 + 3, :] + Cf[:, 3:n2 + 4, :]
                         - Cf[:, 0:n2 + 1, :] - Cf[:, 1:n2 + 2, :])
    return xMap, yMap


def _cell_corners_and_stretch(xMap, yMap):
    """Per-cell corner values of the map and the per-axis stretch
    (fot2d.c:419-423), shared by the sampling and the adaptive mask."""
    cx = (xMap[..., :-1, :-1], xMap[..., :-1, 1:], xMap[..., 1:, :-1],
          xMap[..., 1:, 1:])
    cy = (yMap[..., :-1, :-1], yMap[..., :-1, 1:], yMap[..., 1:, :-1],
          yMap[..., 1:, 1:])
    xStretch = torch.maximum((cx[1] - cx[0]).abs(), (cx[3] - cx[2]).abs())
    yStretch = torch.maximum((cy[2] - cy[0]).abs(), (cy[3] - cy[1]).abs())
    return cx, cy, xStretch, yStretch


def _pushforward_subsamples(mu, xMap, yMap, n1, n2, nsub, level_mask=None):
    """Per-subsample factored pushforward quantities of a batch, each
    (B, nsub^2, n2, n1): target columns ``xI``/``xO`` with fraction ``xf``,
    target rows ``yI``/``yO`` with fraction ``yf``, the per-subsample
    ``mass``; and the kept-cell mask (fot2d.c:373-457, fixed sampling).
    ``level_mask`` restricts the contribution to a subset of cells."""
    (c00x, c01x, c10x, c11x), (c00y, c01y, c10y, c11y), xStretch, \
        yStretch = _cell_corners_and_stretch(xMap, yMap)
    xCut = (1.0 / n1) ** (1.0 / 3)
    yCut = (1.0 / n2) ** (1.0 / 3)
    keep = (mu > 0) & (xStretch < xCut) & (yStretch < yCut)
    if level_mask is not None:
        keep = keep & level_mask
    mass = torch.where(keep, mu, torch.zeros_like(mu)) / (nsub * nsub)

    xi_l, xo_l, xf_l, yi_l, yo_l, yf_l = [], [], [], [], [], []
    for l in range(nsub):
        for k in range(nsub):
            a = (k + 0.5) / nsub
            b = (l + 0.5) / nsub
            xPoint = ((1 - b) * (1 - a) * c00x + (1 - b) * a * c01x +
                      b * (1 - a) * c10x + a * b * c11x)
            yPoint = ((1 - b) * (1 - a) * c00y + (1 - b) * a * c01y +
                      b * (1 - a) * c10y + a * b * c11y)
            X = xPoint * n1 - 0.5
            Y = yPoint * n2 - 0.5
            xIndex = torch.floor(X).to(torch.int32)
            yIndex = torch.floor(Y).to(torch.int32)
            xf_l.append(X - xIndex)
            yf_l.append(Y - yIndex)
            xi_l.append(xIndex.clamp(0, n1 - 1))
            xo_l.append((xIndex + 1).clamp(0, n1 - 1))
            yi_l.append(yIndex.clamp(0, n2 - 1))
            yo_l.append((yIndex + 1).clamp(0, n2 - 1))
    Q = nsub * nsub
    mass_q = mass[:, None].expand(mass.shape[0], Q, *mass.shape[1:])
    return (torch.stack(xi_l, 1), torch.stack(xo_l, 1),
            torch.stack(xf_l, 1), torch.stack(yi_l, 1),
            torch.stack(yo_l, 1), torch.stack(yf_l, 1), mass_q, keep)


def _adaptive_hi_mask(xMap, yMap, n1, n2):
    """Cells whose stretch exceeds what 2x2 supersampling resolves
    (fot2d.c:422-423: more than 2 samples on either axis); the adaptive
    mode samples them 4x4."""
    _, _, xStretch, yStretch = _cell_corners_and_stretch(xMap, yMap)
    return (2.0 * n1 * xStretch >= 3.0) | (2.0 * n2 * yStretch >= 3.0)


def _diag_fold(band):
    """(B, R, G, n) -> (B, R+G-1, n): out[:, i+g] += band[:, i, g], as one
    skewed reshape and a reduction."""
    Bb, R, G, n = band.shape
    a = band.permute(0, 3, 2, 1)                    # (B, n, G, R)
    a = F.pad(a, (0, G))
    a = a.reshape(Bb, n, G * (R + G))[:, :, :G * (R + G - 1)]
    a = a.reshape(Bb, n, G, R + G - 1).sum(2)
    return a.transpose(1, 2)


def _col_fold(band, Cb, width):
    """Overlap-add of per-column-block windows (..., nbc, G, Wd), Wd <= 2*Cb,
    into rows (..., G, width): even and odd blocks each land disjointly."""
    nbc, G, Wd = band.shape[-3:]
    lead = band.shape[:-3]
    nbcp = nbc + (nbc % 2)
    band = F.pad(band, (0, 2 * Cb - Wd, 0, 0, 0, nbcp - nbc))
    b = band.transpose(-3, -2)                      # (..., G, nbcp, 2Cb)
    half = nbcp // 2
    ev = b[..., 0::2, :].reshape(*lead, G, half * 2 * Cb)
    od = b[..., 1::2, :].reshape(*lead, G, half * 2 * Cb)

    def place(x, off):
        w = x.shape[-1]
        return F.pad(x, (off, max(0, width - off - w)))[..., :width]

    return place(ev, 0) + place(od, Cb)


def _overlap_add(blocks, bases, R, margin, rows, width):
    """rho (B, rows, width) with block j (B, S, width) added at rows
    j*R + bases[:, j] + margin, blocks in ascending order: one indexed add
    per block, batched over shots (the rows of one block are distinct, so
    the add is deterministic)."""
    B, nblk, S = blocks.shape[:3]
    rho = blocks.new_zeros((B, rows, width))
    bidx = torch.arange(B, device=blocks.device)[:, None]
    span = torch.arange(S, device=blocks.device)
    for j in range(nblk):
        ridx = (j * R + margin + bases[:, j])[:, None] + span
        rho[bidx, ridx] = rho[bidx, ridx] + blocks[:, j]
    return rho


def _local_banded_pushforward_batch(subs, n1, n2, G_local=32, dxmax=7,
                                    margin=128, row_block=32, col_block=32):
    """Local-base banded matrix-product pushforward (the middle tier): per
    (shot, row block), dy re-based at the block's minimum and one-hot over
    the local variation (``G_local`` wide), dx one-hot over a column
    window; the block's product is folded and added at its runtime base.
    Valid when ``_local_band_ok`` and the dx predicate hold. Same additions
    as the scatter, in another order."""
    xI, xO, xf, yI, yO, yf, mass = subs
    B, Q, n2s, n1s = mass.shape
    dev = mass.device
    G, R, Cb = G_local, row_block, col_block
    Wd = Cb + 2 * dxmax + 2
    assert Wd <= 2 * Cb, (Wd, Cb)
    n2p = -(-n2s // R) * R
    nblk = n2p // R
    nbc = -(-n1s // Cb)
    n1p = nbc * Cb

    def prep(a):
        # (B, Q, n2s, n1s) -> (nblk, B, R, nbc, Q*Cb)
        a = F.pad(a, (0, n1p - n1s, 0, n2p - n2s))
        a = a.transpose(1, 2).reshape(B, nblk, R, Q, nbc, Cb)
        a = a.transpose(3, 4).reshape(B, nblk, R, nbc, Q * Cb)
        return a.transpose(0, 1)

    r_glob = torch.arange(n2p, device=dev).reshape(nblk, 1, R, 1, 1)
    base_c = (torch.arange(nbc, device=dev) * Cb).reshape(1, 1, 1, nbc, 1)
    mb = prep(mass)
    act = mb > 0
    fill = torch.full((), margin, device=dev)
    dyI = torch.where(act, prep(yI) - r_glob, fill)
    dyO = torch.where(act, prep(yO) - r_glob, fill)
    bases = torch.minimum(dyI, fill).reshape(nblk, B, -1).amin(-1)
    bases = torch.where(bases == margin, 0, bases).clamp(-margin,
                                                         margin - G)
    oI = prep(xI) - base_c + dxmax
    oO = prep(xO) - base_c + dxmax
    xf_b = prep(xf.to(mass.dtype))
    yf_b = prep(yf.to(mass.dtype))
    gvals = torch.arange(G, device=dev)
    wvals = torch.arange(Wd, device=dev)
    width = n1p + Wd
    blocks = []
    for k in range(nblk):
        relI = dyI[k] - bases[k][:, None, None, None]
        relO = dyO[k] - bases[k][:, None, None, None]
        yfk, xfk = yf_b[k][..., None], xf_b[k][..., None]
        # (B, R, nbc, S, G) one-hot over the local dy, bilinear y weights
        Wy = (relI[..., None] == gvals) * (1 - yfk) \
            + (relO[..., None] == gvals) * yfk
        # (B, R, nbc, S, Wd) one-hot over the local column window
        Xw = ((oI[k][..., None] == wvals) * (1 - xfk)
              + (oO[k][..., None] == wvals) * xfk) * mb[k][..., None]
        band = matmul_full(Wy.transpose(-1, -2), Xw)   # (B, R, nbc, G, Wd)
        blocks.append(_diag_fold(_col_fold(band, Cb, width)))
    rho = _overlap_add(torch.stack(blocks, 1), bases.T, R, margin,
                       n2p + 2 * margin + G, width)
    return rho[:, margin:margin + n2, dxmax:dxmax + n1]


def _local_band_ok(subs, G_local=32, dxmax=7, margin=128, row_block=32):
    """True (a device flag) iff every (shot, row block)'s active dy fits
    ``G_local`` rows above the block minimum, the base within the fold
    margin (the validity condition of the banded tiers; dx apart)."""
    _, _, _, yI, yO, _, mass = subs
    B, Q, n2s, n1s = mass.shape
    R = row_block
    n2p = -(-n2s // R) * R
    act = mass > 0
    r = torch.arange(n2s, device=mass.device).reshape(1, 1, n2s, 1)
    dyI = torch.where(act, yI - r, margin)
    dyO = torch.where(act, yO - r, -margin)

    def blocks(a, fill):
        a = F.pad(a, (0, 0, 0, n2p - n2s), value=fill)
        return a.transpose(1, 2).reshape(B, n2p // R, R, Q, n1s)

    lo = blocks(dyI, margin).amin(dim=(2, 3, 4))          # (B, nblk)
    hi = blocks(dyO, -margin).amax(dim=(2, 3, 4))
    # emptiness from the activity mask itself: an active cell whose dy
    # equals the fill value must not read as empty
    empty = ~blocks(act.to(torch.uint8), 0).amax(dim=(2, 3, 4)).bool()
    lo_c = torch.where(empty, 0, lo)
    ok_width = empty | (hi - lo_c <= G_local - 1)
    ok_base = (lo_c >= -margin) & (lo_c <= margin - G_local)
    return torch.all(ok_width & ok_base)


def _dx_inband_predicate(subs, dxmax):
    """True (a device flag) iff every active subsample's column
    displacements fit [-dxmax, dxmax+1]."""
    xI, xO, _, _, _, _, mass = subs
    c = torch.arange(mass.shape[3], device=mass.device)
    act = mass > 0
    dI = torch.where(act, xI - c, 0)
    dO = torch.where(act, xO - c, 0)
    return (dI.amin() >= -dxmax) & (dO.amax() <= dxmax + 1)


def _scatter_pushforward_batch(subs, n1, n2):
    """The exact scatter of all (subsample, corner) contributions."""
    xI, xO, xf, yI, yO, yf, mass = subs
    B = mass.shape[0]
    Y = torch.cat([yI, yO, yI, yO], 1).long()
    X = torch.cat([xI, xI, xO, xO], 1).long()
    V = torch.cat([(1 - xf) * (1 - yf) * mass, (1 - xf) * yf * mass,
                   xf * (1 - yf) * mass, xf * yf * mass], 1)
    bidx = torch.arange(B, device=mass.device).reshape(B, 1, 1, 1) \
        .expand_as(Y)
    rho = mass.new_zeros((B, n2, n1))
    return rho.index_put_((bidx, Y, X), V, accumulate=True)


def _slab_planes(subs, G, dxmax, margin, R, prep="nat"):
    """The slab kernel's operands from the subsample planes: (the five
    planes rel, dxr (int32), wy0, mass, wx0 in the ``prep`` layout, the
    blocks' runtime bases (B, nblk), lanes). Cells are re-based per
    (shot, R-row block) at the block's least active dy, and padded to
    (n2p, lanes)."""
    xI, xO, xf, yI, yO, yf, mass = subs
    B, Q, n2s, n1s = mass.shape
    dev, dtype = mass.device, mass.dtype
    # targets reach column n1-1+dxmax after the +dxmax rebase
    lanes = -(-(n1s + dxmax) // 128) * 128
    nblk = -(-n2s // R)
    n2p = nblk * R
    r = torch.arange(n2s, device=dev).reshape(1, 1, n2s, 1)
    c = torch.arange(n1s, device=dev).reshape(1, 1, 1, n1s)
    dy = torch.where(mass > 0, yI - r, margin)
    # clipped targets (yO == yI, xO == xI at the edges) fold into the base
    # weight; the kernel derives wy1 = mass - wy0 and wx1 = 1 - wx0
    wy0 = torch.where(yO == yI, mass, (1 - yf) * mass)
    wx0 = torch.where(xO == xI, torch.ones((), dtype=dtype, device=dev),
                      1 - xf)
    dxr = (xI - c + dxmax).clamp(0, 2 * dxmax + 1)

    def lay(a, fill=0):
        a = F.pad(a, (0, lanes - n1s, 0, n2p - n2s), value=fill)
        if prep == "nat":
            return a                               # (B, Q, n2p, lanes)
        a = a.transpose(1, 2).reshape(B, nblk, R, Q, lanes)
        return a.transpose(2, 3).contiguous()      # (B, nblk, Q, R, lanes)

    dy_l = lay(dy, margin)
    if prep == "nat":
        bases = dy_l.reshape(B, Q, nblk, R * lanes).amin(dim=(1, 3))
    else:
        bases = dy_l.reshape(B, nblk, -1).amin(-1)
    bases = torch.where(bases == margin, 0, bases).clamp(-margin,
                                                         margin - G)
    if prep == "nat":
        shift = bases.repeat_interleave(R, 1)[:, None, :, None]
    else:
        shift = bases[:, :, None, None, None]
    planes = ((dy_l - shift).to(torch.int32), lay(dxr).to(torch.int32),
              lay(wy0), lay(mass), lay(wx0, 1))
    return planes, bases, lanes


def _slab_push(subs, n1, n2, G, dxmax, margin, R, prep="nat"):
    """Pushforward through the slab kernel (``pushforward_slabs_nat``, or
    ``pushforward_slabs`` for the blocked layout) over every (shot, R-row
    block), the slabs then overlap-added at their runtime bases. Valid
    when ``_local_band_ok(subs, G, row_block=R)`` and the dx predicate
    hold."""
    planes, bases, lanes = _slab_planes(subs, G, dxmax, margin, R, prep)
    kernel = _cb.pushforward_slabs_nat if prep == "nat" \
        else _cb.pushforward_slabs
    slabs = kernel(*planes, G=G, dxmax=dxmax, R=R)
    n2p = bases.shape[1] * R
    rho = _overlap_add(slabs, bases, R, margin, n2p + 2 * margin + G, lanes)
    return rho[:, margin:margin + n2, dxmax:dxmax + n1]


def _dispatch_push(subs, n1, n2, dmax, push="pallas", prep="nat"):
    """Pushforward, cheapest valid tier first (the JAX package's
    ``_dispatch_push`` predicates, read on the host):

    1. the slab kernel when every (shot, 16-row block)'s local dy fits its
       G = 24 window and |dx| is narrow (push "pallas", float32, Q <= 8);
    2. the local-base banded product with G = 32 over 32-row blocks;
    3. the exact scatter.

    All tiers compute the same sums; ``dmax`` bounds the absolute row
    shift the banded tiers' fold margin takes."""
    dxmax = 7
    margin = dmax + 1
    dx_ok = _read(_dx_inband_predicate(subs, dxmax), "predicate_reads")
    if push == "pallas" and subs[2].dtype == torch.float32 \
            and subs[2].shape[1] <= 8 and dx_ok \
            and _read(_local_band_ok(subs, G_local=24, dxmax=dxmax,
                                     margin=margin, row_block=16),
                      "predicate_reads"):
        COUNTS["push_slab"] += 1
        return _slab_push(subs, n1, n2, G=24, dxmax=dxmax, margin=margin,
                          R=16, prep=prep)
    if dx_ok and _read(_local_band_ok(subs, G_local=32, dxmax=dxmax,
                                      margin=margin), "predicate_reads"):
        COUNTS["push_banded"] += 1
        return _local_banded_pushforward_batch(subs, n1, n2, G_local=32,
                                               dxmax=dxmax, margin=margin)
    COUNTS["push_scatter"] += 1
    return _scatter_pushforward_batch(subs, n1, n2)


def _sampling_pushforward_batch(mu_b, xMap_b, yMap_b, n1, n2, nsub, dmax,
                                push="pallas", prep="nat"):
    """Batch pushforward, normalized to unit mean per shot. ``nsub == 0``
    is the two-level adaptive mode: low-stretch cells 2x2, high-stretch
    cells 4x4 in a second pass run only when there are any."""
    pcount = n1 * n2
    if nsub == 0:
        hi = _adaptive_hi_mask(xMap_b, yMap_b, n1, n2)
        lo_out = _pushforward_subsamples(mu_b, xMap_b, yMap_b, n1, n2, 2,
                                         level_mask=~hi)
        rho = _dispatch_push(lo_out[:7], n1, n2, dmax, push, prep)
        if _read(hi.any(), "predicate_reads"):
            hi_out = _pushforward_subsamples(mu_b, xMap_b, yMap_b, n1, n2,
                                             4, level_mask=hi)
            rho = rho + _dispatch_push(hi_out[:7], n1, n2, dmax, push, prep)
    else:
        out = _pushforward_subsamples(mu_b, xMap_b, yMap_b, n1, n2, nsub)
        rho = _dispatch_push(out[:7], n1, n2, dmax, push, prep)
    total = rho.sum(dim=(1, 2), keepdim=True) / pcount
    return rho / torch.where(total > 0, total, torch.ones_like(total))


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------

def _dct_mat(n, dtype, dev):
    """Orthonormal DCT-II matrix, in ``dtype`` as the JAX package builds
    it."""
    k = torch.arange(n, dtype=dtype, device=dev)[:, None]
    i = torch.arange(n, dtype=dtype, device=dev)[None, :]
    C = math.sqrt(2.0 / n) * torch.cos(math.pi * (i + 0.5) * k / n)
    C[0] = C[0] * math.sqrt(0.5)
    return C


def bfm_batch(f_b, g_b, num_steps=10, step_scale=1.0, nsub=2, dmax=127,
              max_tmp_elems=32_000_000, push="pallas", prep="nat",
              legendre="anchor"):
    """Quadratic-Wasserstein distance and gradient d W2 / d f of two
    (B, n2, n1) stacks of 2-D densities (rows = time/y, columns =
    traces/x), per shot: ``(losses (B,), grads (B, n2, n1))``.

    Mirrors ``fotGradient2d`` (``fot2d.c:606-656``): the inputs are
    normalized to unit mean, each BFM step alternates the H^-1 ascent,
    the convexification and the pushforward on each potential, and the
    gradient is ``(psi - <mu, psi>/pcount)/mean(f)``. ``dmax`` bounds the
    absolute row displacement of the banded pushforward tiers; ``nsub = 0``
    selects two-level adaptive supersampling; ``max_tmp_elems`` bounds the
    Legendre temporaries. A shot whose densities are all zero gets loss 0
    and gradient 0."""
    push, prep, legendre = resolve_backends(push, prep, legendre)
    dtype, dev = f_b.dtype, f_b.device
    B, n2, n1 = f_b.shape
    pcount = n1 * n2

    def psum(x):
        return x.sum(dim=(-2, -1))

    zero = f_b.new_zeros(())
    sum1 = psum(f_b)[:, None, None] / pcount
    sum2 = psum(g_b)[:, None, None] / pcount
    mu = torch.where(sum1 > 0, f_b / sum1, zero)
    nu = torch.where(sum2 > 0, g_b / sum2, zero)
    maxd = torch.maximum(mu.amax(dim=(1, 2)), nu.amax(dim=(1, 2)))
    live = maxd > 0
    one = torch.ones_like(maxd)
    sigma = torch.where(live, step_scale / torch.where(live, maxd, one), one)

    # grid coordinates divided on the host: torch on the card divides by a
    # scalar through its reciprocal, which can round one ulp off (i+0.5)/n,
    # and the banded kernel's table and the other routes must see the same
    # slopes
    xs = ((torch.arange(n1, dtype=dtype) + 0.5) / n1).to(dev)
    ys = ((torch.arange(n2, dtype=dtype) + 0.5) / n2).to(dev)
    quad = 0.5 * (xs[None, :] ** 2 + ys[:, None] ** 2)
    quad_b = quad.expand(B, n2, n1)

    # negative-Laplace DCT kernel (fot2d.c:4-17), built in float64
    f64 = torch.float64
    kx = 2.0 * n1 * n1 * (1 - torch.cos(
        math.pi * torch.arange(n1, dtype=f64, device=dev) / n1))
    ky = 2.0 * n2 * n2 * (1 - torch.cos(
        math.pi * torch.arange(n2, dtype=f64, device=dev) / n2))
    kernel = (kx[None, :] + ky[:, None]).to(dtype)
    kernel[0, 0] = 1.0
    C1 = _dct_mat(n1, dtype, dev)
    C2 = _dct_mat(n2, dtype, dev)
    C1T, C2T = C1.T.contiguous(), C2.T.contiguous()

    def update_potential(phi, rho, target, sigma):
        r = rho - target
        w = matmul_full(matmul_full(C2, r), C1T) / kernel
        w[:, 0, 0] = 0.0
        w = matmul_full(matmul_full(C2T, w), C1)
        h1 = psum(w * r) / pcount
        return phi + sigma[:, None, None] * w, h1

    def compute_w2(phi, dual):
        return psum(quad_b * (mu + nu) - nu * phi - mu * dual) / pcount

    def step_update(sigma, value, old, h1):
        diff = value - old
        up = diff > h1 * sigma * 0.75
        dn = diff < h1 * sigma * 0.25
        return torch.where(up, sigma / 0.8,
                           torch.where(dn, sigma * 0.8, sigma))

    def legendre_2d(u):
        return _legendre_2d(u, xs, ys, max_tmp_elems, legendre)

    def pushforward(dens, potential):
        xMap, yMap = _pushforward_map(potential, n1, n2)
        return _sampling_pushforward_batch(dens, xMap, yMap, n1, n2, nsub,
                                           dmax, push, prep)

    phi, dual, rho = quad_b, quad_b, mu
    old = compute_w2(quad_b, quad_b)
    for _ in range(num_steps):
        # first half: update phi against nu, push nu through phi's map
        phi, h1 = update_potential(phi, rho, nu, sigma)
        dual = legendre_2d(phi)
        phi = legendre_2d(dual)
        value = compute_w2(phi, dual)
        sigma = step_update(sigma, value, old, h1)
        old = value
        rho = pushforward(nu, phi)
        # second half: update dual against mu, push mu through dual's map
        dual, h1 = update_potential(dual, rho, mu, sigma)
        phi = legendre_2d(dual)
        dual = legendre_2d(phi)
        rho = pushforward(mu, dual)
        value = compute_w2(phi, dual)
        sigma = step_update(sigma, value, old, h1)
        old = value

    dual_f = quad_b - dual
    term = psum(mu * dual_f)[:, None, None] / pcount
    grad = torch.where(sum1 > 0, (dual_f - term) / sum1, zero)
    return torch.where(live, old, torch.zeros_like(old)), grad


def bfm_torch(f, g, num_steps=10, step_scale=1.0, nsub=2, device=None,
              **backends):
    """Single-gather quadratic-Wasserstein distance and gradient: ``bfm_batch``
    on a batch of one. ``f``, ``g`` (n2, n1) densities (rows = time);
    tensors run where they lie, numpy arrays go to ``device`` (default
    "cuda", which raises without a card); ``backends`` are ``bfm_batch``'s
    (push, prep, legendre). Returns (loss, grad) as tensors."""
    if not torch.is_tensor(f):
        from ..fwi import _resolve_device
        f = torch.as_tensor(np.asarray(f),
                            device=_resolve_device(device or "cuda"))
    g = torch.as_tensor(g, dtype=f.dtype, device=f.device)
    loss, grad = bfm_batch(f[None], g[None], num_steps=num_steps,
                           step_scale=step_scale, nsub=nsub, **backends)
    return loss[0], grad[0]


class bfm:
    """Host-facing wrapper matching the reference driver's call shape
    (``misfit/bfm.py:145-192``): ``gradient(f, g) -> (loss, grad)`` with f,
    g numpy arrays of shape (nt, ntraces), solved on ``device`` ("cuda",
    raising without a card, or "cpu")."""

    def __init__(self, num_steps=10, step_scale=8.0, nsub=2, device="cuda"):
        from ..fwi import _resolve_device
        self.num_steps = num_steps
        self.step_scale = step_scale
        self.nsub = nsub
        self.device = _resolve_device(device)

    def gradient(self, f, g):
        # reference layout: rows = time (y in the C solver), cols = traces
        loss, grad = bfm_torch(np.asarray(f), np.asarray(g),
                               num_steps=self.num_steps,
                               step_scale=self.step_scale, nsub=self.nsub,
                               device=self.device)
        return float(loss), grad.cpu().numpy()


bfmx = bfm  # reference alias: bfmx was the subprocess driver
