"""Misfit layer: the L2 misfit (the W2 misfits are not ported yet)."""
from .w2 import least_square, least_square_torch

__all__ = ["least_square", "least_square_torch"]
