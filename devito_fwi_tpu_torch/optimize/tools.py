"""Small IO helpers (reference ``optimize/tools.py``, with its missing
``os`` import fixed)."""
from __future__ import annotations

import os

import numpy as np

__all__ = ["Writer", "loadnpy", "savenpy", "exists"]


class Writer:
    """Append-only scalar metric files (same as optimizers.Writer)."""

    def __init__(self, path="."):
        self.path = path
        os.makedirs(path, exist_ok=True)

    def __call__(self, filename, val):
        with open(os.path.join(self.path, filename), "a") as f:
            f.write("%e\n" % val)


def loadnpy(filename):
    return np.load(filename)


def savenpy(filename, v):
    np.save(filename, v)
    os.rename(filename + ".npy", filename)


def exists(names):
    """True if all given paths exist."""
    if isinstance(names, str):
        names = [names]
    return all(name and os.path.exists(name) for name in names)
