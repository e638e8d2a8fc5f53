"""Sparse point <-> grid transfer: multilinear scatter/gather tables.

Replaces devito's symbolic ``src.inject`` / ``rec.interpolate``
(reference ``seismic/acoustic/operators.py:134-137``) with precomputed
static neighbor indices + weights, so that injection is a scatter-add and
sampling is a gather — no dynamic shapes.

Out-of-grid corners keep their (out-of-bounds) indices with weight 0. A
torch index out of bounds raises (or fires a device assert), so every
tensor built from these tables masks such corners and clamps their
indices (``valid_corners``); they then contribute nothing, matching
devito's behavior for points on the outer grid edge.
"""
from __future__ import annotations

import itertools

import numpy as np

__all__ = ["interp_table", "valid_corners"]


def interp_table(coords, origin_pml, spacing, dtype=np.float32):
    """Build the multilinear interpolation table for sparse points.

    Parameters
    ----------
    coords : (npoint, ndim) physical coordinates (same units as origin/spacing).
    origin_pml : (ndim,) origin of the *padded* grid.
    spacing : (ndim,) grid spacing.

    Returns
    -------
    idx : (npoint, 2**ndim, ndim) int32 — corner indices on the padded grid.
    w   : (npoint, 2**ndim) dtype — multilinear corner weights.
    """
    coords = np.asarray(coords, dtype=np.float64).reshape(-1, len(spacing))
    origin = np.asarray(origin_pml, dtype=np.float64)
    h = np.asarray(spacing, dtype=np.float64)
    npoint, ndim = coords.shape

    pos = (coords - origin) / h
    i0 = np.floor(pos).astype(np.int64)
    frac = pos - i0

    corners = np.array(list(itertools.product((0, 1), repeat=ndim)),
                       dtype=np.int64)  # (2**ndim, ndim)
    idx = i0[:, None, :] + corners[None, :, :]
    # weight per corner: prod over dims of (1-frac) or frac
    w = np.ones((npoint, corners.shape[0]), dtype=np.float64)
    for d in range(ndim):
        fd = frac[:, d][:, None]
        w = w * np.where(corners[None, :, d] == 1, fd, 1.0 - fd)
    # a NEGATIVE corner index would wrap to the far grid edge under
    # Python-style indexing (wrong physics, no error). Remap below-origin
    # corners to a huge positive index — out of bounds on any grid, so
    # the masks discard them like the high-side ones — and zero their
    # weights.
    neg = (idx < 0).any(axis=-1)
    if neg.any():
        idx = np.where(neg[..., None], np.int64(2**30), idx)
        w = np.where(neg, 0.0, w)
    return idx.astype(np.int32), w.astype(dtype)


def valid_corners(idx, shape):
    """Mask and clamp an ``interp_table`` index table for a grid of
    ``shape``: returns ``(valid, clamped)`` where ``valid`` (npoint,
    2**ndim) marks the corners inside the grid and ``clamped`` is the
    table with every corner clamped into it, so a tensor gather or
    scatter at ``clamped`` never leaves the grid. Callers zero the
    weights where ``valid`` is False."""
    idx = np.asarray(idx)
    hi = np.asarray(shape, dtype=np.int64) - 1
    valid = np.all((idx >= 0) & (idx <= hi), axis=-1)
    return valid, np.clip(idx, 0, hi).astype(idx.dtype)
