"""Finite-difference operators on batched 2-D fields (B, nx, nz) in plain
torch, with devito's zero halo beyond the padded grid: each stencil pads the
field with zeros once and sums its weighted shifted views."""
from __future__ import annotations

import torch.nn.functional as F

__all__ = ["shifted", "laplacian"]


def _pad(u, axis, lo, hi):
    # F.pad lists the last axis first; axis 1 is x, axis 2 is z
    return F.pad(u, (lo, hi, 0, 0) if axis == 2 else (0, 0, lo, hi))


def shifted(u, weights, offsets, axis, scale):
    """``scale * sum_k w_k u[i + o_k]`` along ``axis`` of (B, nx, nz)
    fields, zero beyond the array; ``offsets`` ascend by one."""
    lo, hi = -int(offsets[0]), int(offsets[-1])
    p = _pad(u, axis, max(lo, 0), max(hi, 0))
    n = u.shape[axis]
    base = max(lo, 0)
    out = None
    for w, o in zip(weights, offsets):
        view = p.narrow(axis, base + int(o), n)
        if out is None:
            out = view * float(w * scale)
        else:
            out.add_(view, alpha=float(w * scale))
    return out


def laplacian(u, weights, inv_h2):
    """sum over x and z of ``inv_h2[d] (w_0 u + sum_k w_k (u[i+k] +
    u[i-k]))`` for central weights ``weights`` on offsets -r..r."""
    r = (len(weights) - 1) // 2
    p = F.pad(u, (r, r, r, r))
    nx, nz = u.shape[1], u.shape[2]
    out = u * float(weights[r] * (inv_h2[0] + inv_h2[1]))
    for k in range(1, r + 1):
        wx, wz = float(weights[r + k] * inv_h2[0]), \
            float(weights[r + k] * inv_h2[1])
        out.add_(p[:, r + k:r + k + nx, r:r + nz], alpha=wx)
        out.add_(p[:, r - k:r - k + nx, r:r + nz], alpha=wx)
        out.add_(p[:, r:r + nx, r + k:r + k + nz], alpha=wz)
        out.add_(p[:, r:r + nx, r - k:r - k + nz], alpha=wz)
    return out
