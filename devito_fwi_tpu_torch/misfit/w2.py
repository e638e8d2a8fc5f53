"""L2 misfit, host and torch forms (port of the L2 part of
``devito_fwi_tpu.misfit.w2``; the quadratic-Wasserstein misfits wait for a
later slice, ROADMAP.md queue A item 9)."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["least_square", "least_square_torch"]


def least_square(x, y):
    """L2 misfit (reference ``misfit/misfit.py:5-9``)."""
    residual = x - y
    fval = 0.5 * float(np.linalg.norm(np.asarray(residual).ravel()) ** 2)
    return fval, residual


def least_square_torch(x, y):
    """L2 misfit of gathers (..., nt, nrec) on any device: per-gather
    values 0.5*sum(r^2) over the last two axes, and the residual r."""
    residual = x - y
    return 0.5 * torch.sum(residual * residual, dim=(-2, -1)), residual
