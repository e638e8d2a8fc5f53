"""Misfit layer: L2 and the quadratic-Wasserstein misfits (W2-1d per
trace, W2-2d through the batch BFM solver of ``misfit.bfm``)."""
from .w2 import (least_square, least_square_torch, qWasserstein,
                 transform_torch, w2_1d_torch)

__all__ = ["least_square", "least_square_torch", "qWasserstein",
           "transform_torch", "w2_1d_torch"]
