"""Inversion utilities (reference ``seismic/inversion/inversion_utils.py``).

Port of ``devito_fwi_tpu.inversion``: the residual and the box-constrained
update work on host arrays, as the camembert example keeps its models.
"""
from __future__ import annotations

import numpy as np

__all__ = ["compute_residual", "update_with_box"]


def compute_residual(res, dobs, dsyn):
    """res = dsyn - dobs. Accepts PointSource-like objects (with ``.data``)
    or plain arrays; returns the same kind it was given."""
    if hasattr(res, "data"):
        res.data[:] = np.asarray(dsyn.data) - np.asarray(dobs.data)
        return res
    return dsyn - dobs


def update_with_box(vp, alpha, dm, vmin=2.0, vmax=3.5):
    """In-place gradient update with box constraint:
    ``vp = clip(vp + alpha dm, vmin, vmax)``
    (reference ``inversion_utils.py:28-39``)."""
    vp[:] = np.clip(vp + alpha * dm, vmin, vmax)
    return vp
