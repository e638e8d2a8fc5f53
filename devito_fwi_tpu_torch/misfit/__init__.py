"""Misfit layer: L2 and the quadratic-Wasserstein misfits (W2-1d per
trace, W2-2d through the batch BFM solver of ``misfit.bfm``), the
reference's ``Misfit`` wrapper and the one-gather BFM wrappers."""
from .w2 import (Misfit, least_square, least_square_torch, qWasserstein,
                 transform_torch, w2_1d_torch)
from .bfm import bfm, bfm_torch, bfmx

__all__ = ["least_square", "least_square_torch", "qWasserstein",
           "transform_torch", "w2_1d_torch", "Misfit", "bfm", "bfmx",
           "bfm_torch"]
