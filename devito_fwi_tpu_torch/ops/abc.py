"""Absorbing-boundary-condition methods in plain torch: PML and hybrid ABC
(HABC).

Port of ``devito_fwi_tpu.ops.abc`` (the reference's boundary-method
studies ``seismic/abc_methods/03_pml.ipynb`` and ``04_habc.ipynb``). The
damping and weight masks are zero in the interior, so every time step is
one uniform update over the whole grid, space order 2, as in the JAX
module:

* PML: pressure u on nodes plus the auxiliary field (phi1, phi2) on the
  dual (half-cell-shifted) grid, the notebook's centred ``u.dtc``,
  Crank-Nicolson phi relaxation and 4-point half-cell averages; damping
  ``zeta(a) = quibar (a - sin(2 pi a)/(2 pi))`` on the left, right and
  bottom layers; Dirichlet x-edges and bottom, then the Neumann top. The
  scan runs ``src_wav[0:nt-1]`` and leaves only rec[nt-1] = 0.
* HABC: the interior prediction everywhere, then the bottom, right and
  left strips blended with a one-way prediction by the weight ramp
  (``habctype`` 1 Clayton-Engquist A1, 2 A2 with the 45-degree corners, 3
  two-term Higdon; ``habcw`` 1 linear, 2 power), then the Neumann top;
  the same loop bounds as the PML.

The JAX ``.at[].set`` edge writes are out-of-place index writes here, in
the JAX order. The forwards run where their tensors lie; numpy inputs go
to ``device`` (default "cuda", which raises without a card). Sources and
receivers go through ``ops.acoustic``'s ``_injector`` and ``_sampler``.
"""
from __future__ import annotations

import numpy as np
import torch

from .acoustic import _injector, _sampler, shift

__all__ = ["pml_profiles", "habc_weights", "extend_velocity",
           "pml_acoustic_forward", "habc_acoustic_forward"]


# ---------------------------------------------------------------------------
# profiles and weights (numpy, precomputed once)
# ---------------------------------------------------------------------------

def _layer_fraction(n, npml, half=False):
    """Depth fraction a in [0, 1] into the left/right layers of an n-point
    axis (0 in the interior). ``half`` shifts sample points by +h/2."""
    i = np.arange(n, dtype=np.float64) + (0.5 if half else 0.0)
    left = np.maximum(0.0, (npml - i) / npml)
    right = np.maximum(0.0, (i - (n - 1 - npml)) / npml)
    return left + right


def pml_profiles(shape, npml, quibar=0.05, dtype=np.float32):
    """Damping fields for the split PML (reference 03_pml cells 28-36):
    zeta = quibar (a - sin(2 pi a) / (2 pi)), layers left/right in x and
    bottom in z. Returns (zx0, zz0) on nodes and (zx1, zz1) on the dual
    grid (stored full-shape, the last row and column replicated like the
    notebook's dampx1/dampz1 extension)."""
    nx, nz = shape

    def zeta(a):
        return quibar * (a - np.sin(2.0 * np.pi * a) / (2.0 * np.pi))

    def z_frac(n, half):
        i = np.arange(n, dtype=np.float64) + (0.5 if half else 0.0)
        return np.maximum(0.0, (i - (n - 1 - npml)) / npml)  # bottom only

    zx0 = np.broadcast_to(zeta(_layer_fraction(nx, npml))[:, None],
                          (nx, nz)).astype(dtype)
    zz0 = np.broadcast_to(zeta(z_frac(nz, False))[None, :],
                          (nx, nz)).astype(dtype)
    # dual grid: nx-1 x nz-1 points at +h/2, edge-extended to full shape
    zx1_ = zeta(_layer_fraction(nx, npml, half=True)[:nx - 1])
    zz1_ = zeta(z_frac(nz, True)[:nz - 1])
    zx1 = np.empty((nx, nz), np.float64)
    zz1 = np.empty((nx, nz), np.float64)
    zx1[:nx - 1, :nz - 1] = zx1_[:, None]
    zz1[:nx - 1, :nz - 1] = zz1_[None, :]
    zx1[nx - 1, :] = zx1[nx - 2, :]
    zz1[nx - 1, :] = zz1[nx - 2, :]
    zx1[:, nz - 1] = zx1[:, nz - 2]
    zz1[:, nz - 1] = zz1[:, nz - 2]
    return (zx0, zz0, zx1.astype(dtype), zz1.astype(dtype))


def habc_weights(shape, npml, habcw=2, habctype=3, dtype=np.float32):
    """Blending weight fields (wx, wz) for the HABC strips (reference
    04_habc cell 25): w = 1 at the outer edge, ramping to 0 at the
    interior. habcw=1 linear; habcw=2 the piecewise power ramp with m = 2
    and the notebook's type-dependent exponent."""
    nx, nz = shape

    def ramp(npts):
        w = np.zeros(npts)
        if habcw == 1:
            for i in range(npts):
                w[i] = (npts - i) / npts
        else:
            m = 2
            alpha = (1.0 + 0.15 * (npts - m) if habctype == 3
                     else 1.5 + 0.07 * (npts - m))
            for i in range(npts):
                w[i] = 1.0 if i <= m else ((npts - i) / (npts - m)) ** alpha
        return w

    wx1d = ramp(npml)
    wx = np.zeros((nx, nz))
    wz = np.zeros((nx, nz))
    for k in range(npml):
        wx[k, :] = wx1d[k]
        wx[nx - 1 - k, :] = wx1d[k]
        wz[:, nz - 1 - k] = wx1d[k]
    return wx.astype(dtype), wz.astype(dtype)


def extend_velocity(v, npml):
    """Edge-replicate a velocity model into the absorbing layers
    (left/right in x, bottom in z)."""
    v = np.asarray(v)
    return np.pad(v, ((npml, npml), (0, npml)), mode="edge")


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def _lap2(u, inv_hx2, inv_hz2):
    """Space-order-2 Laplacian with a zero-Dirichlet halo."""
    return ((shift(u, 1, 0) - 2.0 * u + shift(u, -1, 0)) * inv_hx2 +
            (shift(u, 1, 1) - 2.0 * u + shift(u, -1, 1)) * inv_hz2)


def _sh(u, dx, dz):
    """u shifted so result[i,j] = u[i+dx, j+dz], zero-filled."""
    return shift(shift(u, dx, 0), dz, 1)


def _top_neumann(u):
    """``u[:, 0] = u[:, 1]``, out of place."""
    return torch.cat([u[:, 1:2], u[:, 1:]], 1)


def _inputs(v, src_wav, device):
    """``v`` and ``src_wav`` as tensors: where ``v`` lies when it is a
    tensor, else on ``device`` (default "cuda")."""
    if not torch.is_tensor(v):
        from ..fwi import _resolve_device
        v = torch.as_tensor(np.asarray(v),
                            device=_resolve_device(device or "cuda"))
    return v, torch.as_tensor(src_wav, dtype=v.dtype, device=v.device)


def _consts(v, dt, hx, hz):
    """(s, s2, 1/hx^2, 1/hz^2) as tensors of ``v``'s type."""
    def t(x):
        return torch.as_tensor(x, dtype=v.dtype, device=v.device)
    s = t(dt)
    return s, s * s, t(1.0 / hx ** 2), t(1.0 / hz ** 2)


def _field(a, v):
    """``a`` (an array or a number) as a tensor of ``v``'s type; a number
    divided by a tensor goes through this, since torch's ``number / tensor``
    multiplies by the reciprocal."""
    return torch.as_tensor(a, dtype=v.dtype, device=v.device)


# ---------------------------------------------------------------------------
# PML forward
# ---------------------------------------------------------------------------

def pml_acoustic_forward(v, src_wav, src_idx, src_w, rec_idx, rec_w, dt, *,
                         nt, spacing, npml, quibar=0.05, v_dual=None,
                         device=None):
    """Acoustic forward modeling with the split-field PML (reference
    ``03_pml.ipynb`` cells 37-42). ``v`` is the velocity on the extended
    grid (layers included; see ``extend_velocity``); the src/rec tables
    (numpy ``interp_table`` outputs) are built against the extended-grid
    origin. Returns (rec (nt, nrec), u final)."""
    v, src_wav = _inputs(v, src_wav, device)
    nx, nz = v.shape
    hx, hz = spacing
    zx0, zz0, zx1, zz1 = (_field(z, v) for z in pml_profiles(
        (nx, nz), npml, quibar, np.float64))
    if v_dual is None:
        vd = 0.25 * (v + _sh(v, 1, 0) + _sh(v, 0, 1) + _sh(v, 1, 1))
        vd = torch.cat([vd[:nx - 1], vd[nx - 2:nx - 1]], 0)
        vd = torch.cat([vd[:, :nz - 1], vd[:, nz - 2:nz - 1]], 1)
    else:
        vd = _field(v_dual, v)

    s, s2, inv_hx2, inv_hz2 = _consts(v, dt, hx, hz)
    v2 = v * v
    vd2 = vd * vd
    S = zx0 + zz0
    P = zx0 * zz0
    A = 1.0 / s2 + S / (2.0 * s)           # u[t+1] coefficient
    inject = _injector(src_idx, src_w, None, s2, (nx, nz), mul=v2)
    sample = _sampler(rec_idx, rec_w, (nx, nz), v.device, v.dtype)

    # phi relaxation factors (Crank-Nicolson)
    d1a = 1.0 / s - zx1 / 2.0
    d1b = 1.0 / (1.0 / s + zx1 / 2.0)
    d2a = 1.0 / s - zz1 / 2.0
    d2b = 1.0 / (1.0 / s + zz1 / 2.0)
    g1 = (zz1 - zx1) * vd2 * (0.25 / hx)
    g2 = (zx1 - zz1) * vd2 * (0.25 / hz)
    edges_x = torch.tensor([0, nx - 1], device=v.device)
    edge_z = torch.tensor([nz - 1], device=v.device)

    z = torch.zeros_like(v)
    u, um, p1, p2 = z, z, z, z
    rec = v.new_zeros((nt, rec_idx.shape[0]))
    for t in range(nt - 1):
        rec[t] = sample(u)

        # div~(phi) at nodes (notebook pde02b/c index arithmetic)
        dphi = ((_sh(p1, 0, -1) + p1 - _sh(p1, -1, -1) - _sh(p1, -1, 0))
                * (0.5 / hx) +
                (_sh(p2, -1, 0) + p2 - _sh(p2, -1, -1) - _sh(p2, 0, -1))
                * (0.5 / hz))
        rhs = ((2.0 * u - um) / s2 + S * um / (2.0 * s) - P * u +
               v2 * _lap2(u, inv_hx2, inv_hz2) + dphi)
        un = inject(rhs / A, src_wav[t])
        # bc: Dirichlet x-edges + bottom, Neumann top (notebook cell 41)
        un = un.index_fill(0, edges_x, 0.).index_fill(1, edge_z, 0.)
        un = _top_neumann(un)

        # phi updates read u[t+1] and u[t] (4-point half-cell averages)
        ax = (_sh(un, 1, 0) + _sh(un, 1, 1) - un - _sh(un, 0, 1) +
              _sh(u, 1, 0) + _sh(u, 1, 1) - u - _sh(u, 0, 1))
        bz = (_sh(un, 0, 1) + _sh(un, 1, 1) - un - _sh(un, 1, 0) +
              _sh(u, 0, 1) + _sh(u, 1, 1) - u - _sh(u, 1, 0))
        p1 = (p1 * d1a + g1 * ax) * d1b
        p2 = (p2 * d2a + g2 * bz) * d2b
        u, um = un, u
    return rec, u


# ---------------------------------------------------------------------------
# HABC forward
# ---------------------------------------------------------------------------

def _clayton_a1(u3, u2, v, s, h, d):
    """Clayton-Engquist A1 prediction (04_habc cell 36): strip whose
    interior lies toward shift direction d = (dx, dz)."""
    vd = v * s
    hh = h
    return (((-vd + hh) * u2 + (vd + hh) * _sh(u2, *d) +
             (vd - hh) * _sh(u3, *d)) / (vd + hh))


def _clayton_a2(u3, u2, u1, v, s, h, ht, d, t_):
    """Clayton-Engquist A2 prediction (04_habc cell 37). ``h`` is the
    normal spacing, ``ht`` the tangential one, ``d`` the unit shift toward
    the interior, ``t_`` the tangential unit shift."""
    s2 = s * s
    c1 = 1.0 / (2.0 * s2) + v / (2.0 * s * h)
    c2 = -1.0 / (2.0 * s2) + v / (2.0 * s * h) - v * v / (2.0 * ht ** 2)
    c3 = -1.0 / (2.0 * s2) - v / (2.0 * s * h)
    c4 = 1.0 / s2
    c5 = v * v / (4.0 * ht ** 2)
    tp = tuple(t_)
    tm = tuple(-x for x in t_)
    dpt = tuple(a + b for a, b in zip(d, tp))
    dmt = tuple(a + b for a, b in zip(d, tm))
    return ((c2 * (_sh(u3, *d) + u1) + c3 * _sh(u1, *d) +
             c4 * (u2 + _sh(u2, *d)) +
             c5 * (_sh(u3, *dpt) + _sh(u3, *dmt) +
                   _sh(u1, *tp) + _sh(u1, *tm))) / c1)


def _higdon(u3, u2, u1, v, s, h, d):
    """Two-term Higdon prediction, angles 0 and pi/4, space/time averaging
    parameters a = b = 1/2 (04_habc cell 38)."""
    d2 = tuple(2 * x for x in d)
    ga = []
    for alpha in (0.0, np.pi / 4):
        ca = float(np.cos(alpha))
        gt = _field(ca * 0.5, s) / s   # time-difference coefficient
        gs = ca * 0.5 / h * v      # space-difference coefficient
        ga.append((gt + gs, -gt + gs, gt - gs, -gt - gs))
    (c11, c12, c13, c14), (c21, c22, c23, c24) = ga
    return (u2 * (-c11 * c22 - c12 * c21) +
            _sh(u3, *d) * (-c11 * c23 - c13 * c21) +
            _sh(u2, *d) * (-c11 * c24 - c12 * c23 - c14 * c21 - c13 * c22) +
            u1 * (-c12 * c22) +
            _sh(u1, *d) * (-c12 * c24 - c14 * c22) +
            _sh(u3, *d2) * (-c13 * c23) +
            _sh(u2, *d2) * (-c13 * c24 - c14 * c23) +
            _sh(u1, *d2) * (-c14 * c24)) / (c11 * c21)


def _corner_45(u3, u2, v, s, hx, hz, dx, dz):
    """The A2 path's 45-degree corner one-way update (04_habc cells
    stencil4/stencil5): ``dx``, ``dz`` are the shifts toward the
    interior."""
    r2 = float(np.sqrt(2.0))
    q = _field(r2, v) / (4.0 * v * s)
    ax = 1.0 / (4.0 * hx)
    az = 1.0 / (4.0 * hz)
    num = ((-ax + az - q) * _sh(u3, 0, dz) +
           (ax - az - q) * _sh(u3, dx, 0) +
           (ax + az - q) * _sh(u3, dx, dz) +
           (-ax - az + q) * u2 +
           (-ax + az + q) * _sh(u2, 0, dz) +
           (ax - az + q) * _sh(u2, dx, 0) +
           (ax + az + q) * _sh(u2, dx, dz))
    return num / (ax + az + q)


def habc_acoustic_forward(v, src_wav, src_idx, src_w, rec_idx, rec_w, dt, *,
                          nt, spacing, npml, habctype=3, habcw=2,
                          device=None):
    """Acoustic forward modeling with the hybrid ABC (reference
    ``04_habc.ipynb``): the interior prediction everywhere, then the
    bottom / right / left strips replaced (in the notebook's write order)
    by the weight-blended one-way predictions. Returns (rec (nt, nrec),
    None)."""
    v, src_wav = _inputs(v, src_wav, device)
    nx, nz = v.shape
    hx, hz = spacing
    wx, wz = (_field(w, v) for w in habc_weights((nx, nz), npml, habcw,
                                                  habctype, np.float64))
    ii, jj = np.meshgrid(np.arange(nx), np.arange(nz), indexing="ij")

    def mask(m):
        return torch.as_tensor(m, device=v.device)
    m_left = mask(ii < npml)
    m_right = mask(ii >= nx - npml)
    m_bottom = mask((jj >= nz - npml) & (ii >= npml) & (ii < nx - npml))
    # A2 corner diagonals (stencil4/5)
    m_diag_r = mask((ii - jj == nx - nz) & (ii >= nx - npml))
    m_diag_l = mask((ii + jj == nz - 1) & (ii < npml))

    s, s2, inv_hx2, inv_hz2 = _consts(v, dt, hx, hz)
    v2 = v * v
    inject = _injector(src_idx, src_w, None, s2, (nx, nz), mul=v2)
    sample = _sampler(rec_idx, rec_w, (nx, nz), v.device, v.dtype)

    def one_way(u3, u2, u1, h, ht, d, t_):
        if habctype == 1:
            return _clayton_a1(u3, u2, v, s, h, d)
        if habctype == 2:
            return _clayton_a2(u3, u2, u1, v, s, h, ht, d, t_)
        return _higdon(u3, u2, u1, v, s, h, d)

    z = torch.zeros_like(v)
    u, um = z, z
    rec = v.new_zeros((nt, rec_idx.shape[0]))
    for t in range(nt - 1):
        rec[t] = sample(u)

        # interior prediction + source (04_habc stencil0 + src_term)
        un = inject(2.0 * u - um + s2 * v2 * _lap2(u, inv_hx2, inv_hz2),
                    src_wav[t])

        u1, u2 = um, u
        # bottom strip first, refresh, then right, then left (cell 40)
        u3 = un
        aux_b = one_way(u3, u2, u1, hz, hx, (0, -1), (1, 0))
        u3 = torch.where(m_bottom, (1.0 - wz) * u3 + wz * aux_b, u3)
        aux_r = one_way(u3, u2, u1, hx, hz, (-1, 0), (0, 1))
        aux_l = one_way(u3, u2, u1, hx, hz, (1, 0), (0, 1))
        u3 = torch.where(m_right, (1.0 - wx) * u3 + wx * aux_r, u3)
        u3 = torch.where(m_left, (1.0 - wx) * u3 + wx * aux_l, u3)
        if habctype == 2:
            diag_r = _corner_45(u3, u2, v, s, hx, hz, -1, -1)
            diag_l = _corner_45(u3, u2, v, s, hx, hz, 1, -1)
            u3 = torch.where(m_diag_r, (1.0 - wz) * u3 + wz * diag_r, u3)
            u3 = torch.where(m_diag_l, (1.0 - wx) * u3 + wx * diag_l, u3)
        u, um = _top_neumann(u3), u
    return rec, None
