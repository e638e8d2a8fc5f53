"""Half-cell-shifted first derivatives: the skew-adjoint pair the
staggered-grid propagators are built from.

Port of ``staggered_weights``, ``shifted_derivative`` and ``laplacian_sa``
of ``devito_fwi_tpu.ops.self_adjoint``. The self-adjoint visco-acoustic
propagator of that module is not ported yet (ROADMAP.md queue A item 14).
"""
from __future__ import annotations

import numpy as np

from ..utils.fd import fd_weights
from .acoustic import shift

__all__ = ["staggered_weights", "shifted_derivative", "laplacian_sa"]


def staggered_weights(space_order):
    """FD weights for the first derivative evaluated at x0 = x + h/2 (w_plus,
    on offsets -r+1..r) and x0 = x - h/2 (w_minus, on offsets -r..r-1), with
    r = space_order//2. The two discrete operators (zero-Dirichlet beyond
    the grid) are exact negative transposes of each other."""
    r = space_order // 2
    off_p = np.arange(-r + 1, r + 1)
    off_m = np.arange(-r, r)
    w_p = fd_weights(1, off_p, 0.5)
    w_m = fd_weights(1, off_m, -0.5)
    return w_p, off_p, w_m, off_m


def shifted_derivative(u, w, offsets, axis, inv_h):
    """Apply a shifted first-derivative stencil along ``axis`` with
    zero-Dirichlet values beyond the array (devito halo semantics):
    ``(w[0]*u[i+o0] + w[1]*u[i+o1] + ...) * inv_h``, every weight included,
    in offset order."""
    out = w[0] * shift(u, int(offsets[0]), axis)
    for k in range(1, len(w)):
        out = out + w[k] * shift(u, int(offsets[k]), axis)
    return out * inv_h


def laplacian_sa(u, b, wp, op, wm, om, inv_h):
    """The self-adjoint spatial operator ``sum_d D-_d(b * D+_d(u))`` over the
    trailing ``len(inv_h)`` axes, the x term first; ``b`` multiplies each
    axis's inner derivative before the outer one."""
    ndim_sp = len(inv_h)
    offset = u.dim() - ndim_sp
    out = 0.0
    for d in range(ndim_sp):
        axis = offset + d
        g = shifted_derivative(u, wp, op, axis, inv_h[d])
        out = out + shifted_derivative(b * g, wm, om, axis, inv_h[d])
    return out
