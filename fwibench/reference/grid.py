"""Plain definitions the reference solvers share, in NumPy: finite-difference
weights, the absorbing-layer profile, the edge-padded grid, the CFL step,
the time axis, the Ricker wavelet, the bilinear point tables, the
source/receiver illumination masks and the Marmousi acquisition.

Everything here follows the devito-fwi reference's definitions
(``seismic/model.py``, ``seismic/source.py``, ``seismic/utils.py``,
``fwi.py``) and is written from them; nothing is imported from the program.
"""
from __future__ import annotations

import itertools
import math

import numpy as np

__all__ = ["fd_weights", "second_derivative_weights", "staggered_weights",
           "damping_profile", "pad_edge", "elastic_critical_dt", "num_steps",
           "ricker", "point_table", "illum_fix_factors", "acquisition",
           "Grid"]


def fd_weights(order, offsets, x0=0.0):
    """Weights w with f^(order)(x0) ~ sum_j w_j f(offsets_j), from the
    moment conditions sum_j w_j (o_j - x0)^k / k! = [k == order],
    k = 0..n-1 (a Vandermonde solve in float64)."""
    d = np.asarray(offsets, np.float64) - x0
    n = len(d)
    a = np.array([d ** k / math.factorial(k) for k in range(n)])
    rhs = np.zeros(n)
    rhs[order] = 1.0
    return np.linalg.solve(a, rhs)


def second_derivative_weights(space_order):
    """Central second-derivative weights on offsets -r..r, r = so/2."""
    r = space_order // 2
    return fd_weights(2, np.arange(-r, r + 1))


def staggered_weights(space_order):
    """First-derivative weights at +h/2 on offsets -r+1..r (D+) and at
    -h/2 on offsets -r..r-1 (D-), r = so/2: (w_plus, off_plus, w_minus,
    off_minus)."""
    r = space_order // 2
    op, om = np.arange(-r + 1, r + 1), np.arange(-r, r)
    return fd_weights(1, op, 0.5), op, fd_weights(1, om, -0.5), om


def damping_profile(padded_shape, nbl, spacing, kind):
    """The sine-taper absorbing layer of ``seismic/model.py:13-51`` on the
    padded grid: ``kind`` "damp" is 0 inside and grows into the layer,
    "mask" is 1 inside and falls. Layer position p gives
    ``coeff (p - sin(2 pi p) / (2 pi)) / h``, coeff = 1.5 ln(1000) / nbl;
    on the low side p = (nbl - i + 1) / nbl for cell i < nbl, on the high
    side p = (j + 2) / nbl for the j-th layer cell."""
    sign = -1.0 if kind == "mask" else 1.0
    out = np.full(padded_shape, 1.0 if kind == "mask" else 0.0)
    coeff = 1.5 * np.log(1.0 / 0.001) / nbl

    def taper(p):
        return coeff * (p - np.sin(2 * np.pi * p) / (2 * np.pi))

    for axis, h in enumerate(spacing):
        shape = [1] * len(padded_shape)
        shape[axis] = nbl
        lo = taper((nbl - np.arange(nbl) + 1.0) / nbl) / h
        hi = taper((np.arange(nbl) + 2.0) / nbl) / h
        n = padded_shape[axis]
        idx = [slice(None)] * len(padded_shape)
        idx[axis] = slice(0, nbl)
        out[tuple(idx)] += sign * lo.reshape(shape)
        idx[axis] = slice(n - nbl, n)
        out[tuple(idx)] += sign * hi.reshape(shape)
    return out


def pad_edge(field, nbl):
    """Edge replication of a physical-grid field into the layers."""
    return np.pad(field, nbl, mode="edge")


def elastic_critical_dt(lam, mu, b, space_order, spacing):
    """The staggered scheme's CFL step of ``seismic/model.py:339-370``: the
    Courant number sqrt(ndim)/ndim / (sum|w| / 2) of the order-so D+
    weights, the fastest P speed sqrt(min b (max lam + 2 max mu)) in
    float32, rounded to three significant digits as the reference does."""
    ndim = len(spacing)
    w = fd_weights(1, np.arange(-space_order // 2 + 1, space_order // 2 + 1),
                   0.5)
    courant = math.sqrt(ndim) / ndim / (np.sum(np.abs(w)) / 2.0)
    vmax = float(np.sqrt(np.min(b) * (np.max(lam) + 2 * np.max(mu))))
    return float(np.float32("%.3e" % (courant * min(spacing) / vmax)))


def num_steps(tn, dt):
    """Samples of the time axis 0..tn at step dt (``TimeAxis``: a ceil)."""
    return int(np.ceil((tn + dt) / dt))


def ricker(nt, dt, f0):
    """The Ricker wavelet (1 - 2 r^2) exp(-r^2), r = pi f0 (t - 1/f0), on
    the axis of nt samples of step dt."""
    t = np.linspace(0.0, dt * (nt - 1), nt)
    r = np.pi * f0 * (t - 1.0 / f0)
    return (1.0 - 2.0 * r ** 2) * np.exp(-r ** 2)


def point_table(coords, origin, spacing, shape):
    """Bilinear corners of points on the padded grid: (idx (n, 4, 2) int64
    clamped into the grid, w (n, 4), zero for corners outside)."""
    pos = (np.asarray(coords, np.float64) - np.asarray(origin)) \
        / np.asarray(spacing)
    i0 = np.floor(pos).astype(np.int64)
    frac = pos - i0
    corners = np.array(list(itertools.product((0, 1), repeat=2)))
    idx = i0[:, None, :] + corners[None]
    w = np.ones(idx.shape[:2])
    for d in range(2):
        w = w * np.where(corners[None, :, d] == 1, frac[:, d:d + 1],
                         1.0 - frac[:, d:d + 1])
    hi = np.asarray(shape) - 1
    inside = np.all((idx >= 0) & (idx <= hi), axis=-1)
    return np.clip(idx, 0, hi), np.where(inside, w, 0.0)


def illum_fix_factors(src, rec, spacing, shape):
    """The source/receiver masks of the reference ``fwi.py:104-129``: per
    shot 1 - exp(-((X - sx)^2 + (Z - sz)^2) / (2 sigma^2)) and the product
    over receivers of the same, sigma = dx + dz, in float64 on the
    physical grid. The reference builds its grids as ``meshgrid(z, x)``,
    so at cell (i, j) its "X" holds the depth z_j and its "Z" the offset
    x_i; that convention is kept. Returns (keep (nsrc, nx, nz), rec_prod
    (nx, nz))."""
    dx, dz = spacing
    nx, nz = shape
    gx = np.broadcast_to(np.arange(nz)[None, :] * dz, shape)  # "X": depth
    gz = np.broadcast_to(np.arange(nx)[:, None] * dx, shape)  # "Z": offset
    s2 = (dx + dz) ** 2

    def mask(p):
        return np.exp(-0.5 * ((gx - p[0]) ** 2 + (gz - p[1]) ** 2) / s2)

    keep = np.stack([1.0 - mask(p) for p in np.asarray(src, np.float64)])
    prod = np.ones(shape)
    for p in np.asarray(rec, np.float64):
        prod = prod * (1.0 - mask(p))
    return keep, prod


def acquisition(shape, spacing, nsrc, depth_cells, jitter):
    """The Marmousi drivers' surface acquisition: nsrc sources evenly from
    x = 0 to the far edge, moved along x by ``jitter`` (nsrc,) shares of
    their spacing, and one receiver a cell from x = h to the far edge less
    h, all at ``depth_cells`` cells deep. Returns (src (nsrc, 2), rec
    (nx, 2)) in metres."""
    nx = shape[0]
    h = spacing[0]
    width = (nx - 1) * h
    src = np.empty((nsrc, 2))
    src[:, 0] = np.linspace(0, width, num=nsrc) \
        + np.asarray(jitter) * width / (nsrc - 1)
    src[:, 1] = depth_cells * h
    rec = np.empty((nx, 2))
    rec[:, 0] = np.linspace(h, width - h, num=nx)
    rec[:, 1] = depth_cells * h
    return src, rec


class Grid:
    """The padded grid of a physical shape: nbl cells of absorbing layer
    on every side, the origin of the padded grid and the crop back."""

    def __init__(self, shape, spacing, nbl):
        self.shape = tuple(shape)
        self.spacing = tuple(float(h) for h in spacing)
        self.nbl = nbl
        self.padded = tuple(n + 2 * nbl for n in shape)
        self.origin = tuple(-nbl * h for h in self.spacing)

    def crop(self, field):
        b = self.nbl
        return field[..., b:b + self.shape[0], b:b + self.shape[1]]

    def table(self, coords):
        return point_table(coords, self.origin, self.spacing, self.padded)
