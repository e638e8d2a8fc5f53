"""Math utilities for the optimization layer (reference ``optimize/math.py``;
port of ``devito_fwi_tpu.optimize.math``):
Gaussians, Hilbert transform, model-quality metric, and simple FD helpers
used for diagnostics/regularization (`nabla`, `nabla2`, `grad`, `tv`).
Fresh numpy implementations with the same call shapes.
"""
from __future__ import annotations

import numpy as np
from scipy.signal import hilbert as _analytic

__all__ = ["gauss2", "hilbert", "nextpow2", "normalize", "eigsorted",
           "q_factor", "nabla", "nabla2", "grad", "tv", "dot", "angle",
           "backtrack2", "polyfit2", "infinity"]

infinity = np.inf


def gauss2(X, Y, mu, sigma, normalize=True):
    """Bell-shaped 2-D Gaussian on meshgrid coords (reference ``math.py:14``)."""
    D = sigma[0, 0] * sigma[1, 1] - sigma[0, 1] * sigma[1, 0]
    B = np.linalg.inv(sigma)
    X = X - mu[0]
    Y = Y - mu[1]
    Z = B[0, 0] * X ** 2 + B[0, 1] * X * Y + B[1, 0] * X * Y \
        + B[1, 1] * Y ** 2
    Z = np.exp(-0.5 * Z)
    if normalize:
        Z *= (2. * np.pi * np.sqrt(abs(D))) ** (-1.)
    return Z


def hilbert(w):
    return np.imag(_analytic(w))


def nextpow2(n):
    return int(2 ** np.ceil(np.log2(n)))


def normalize(v):
    return v / abs(v).max()


def eigsorted(A):
    vals, vecs = np.linalg.eigh(A)
    order = vals.argsort()[::-1]
    return vals[order], vecs[:, order]


def q_factor(m, mtrue):
    """Model-quality metric ``10 log10(|m - mtrue|^2 / |mtrue|^2)``
    (reference ``math.py:114-121``)."""
    normsq_diff = np.linalg.norm(m - mtrue) ** 2
    normsq_true = np.linalg.norm(mtrue) ** 2
    return 10 * np.log10(normsq_diff / normsq_true)


def nabla(V, h=None):
    """Sum of first-order centered spatial derivatives on a 2-D grid with
    one-sided edges (reference ``math.py:126-160``)."""
    V = np.asarray(V, dtype=np.float64)
    W = np.zeros(V.shape)
    if h is None or (isinstance(h, list) and not h):
        h = np.ones((V.ndim, 1))
    W[1:-1, 1:-1] += (V[1:-1, 2:] - V[1:-1, :-2]) / (2. * h[0])
    W[1:-1, 1:-1] += (V[2:, 1:-1] - V[:-2, 1:-1]) / (2. * h[1])
    W[0, 1:-1] = (V[1, 1:-1] - V[0, 1:-1]) / h[1] \
        + (V[0, 2:] - V[0, :-2]) / (2. * h[0])
    W[-1, 1:-1] = (V[-1, 1:-1] - V[-2, 1:-1]) / h[1] \
        + (V[-1, 2:] - V[-1, :-2]) / (2. * h[0])
    W[1:-1, 0] = (V[2:, 0] - V[:-2, 0]) / (2. * h[1]) \
        + (V[1:-1, 1] - V[1:-1, 0]) / h[0]
    W[1:-1, -1] = (V[2:, -1] - V[:-2, -1]) / (2. * h[1]) \
        + (V[1:-1, -1] - V[1:-1, -2]) / h[0]
    W[0, 0] = (V[1, 0] - V[0, 0]) / h[1] + (V[0, 1] - V[0, 0]) / h[0]
    W[0, -1] = (V[1, -1] - V[0, -1]) / h[1] + (V[0, -2] - V[0, -1]) / h[0]
    W[-1, 0] = (V[-2, 0] - V[-1, 0]) / h[1] + (V[-1, 1] - V[-1, 0]) / h[0]
    W[-1, -1] = (V[-1, -1] - V[-2, -1]) / h[1] \
        + (V[-1, -1] - V[-1, -2]) / h[0]
    return W


def nabla2(V, h=None):
    """Sum of second-order spatial derivatives (generalized Laplacian) with
    replicated edges (reference ``math.py:163-196``)."""
    V = np.asarray(V, dtype=np.float64)
    W = np.zeros(V.shape)
    if h is None or (isinstance(h, list) and not h):
        h = np.ones((V.ndim, 1))
    W[1:-1, 1:-1] += (V[1:-1, 2:] - 2. * V[1:-1, 1:-1]
                      + V[1:-1, :-2]) / h[0] ** 2
    W[1:-1, 1:-1] += (V[2:, 1:-1] - 2. * V[1:-1, 1:-1]
                      + V[:-2, 1:-1]) / h[1] ** 2
    W[0, 1:-1] = W[1, 1:-1]
    W[-1, 1:-1] = W[-2, 1:-1]
    W[1:-1, 0] = W[1:-1, 1]
    W[1:-1, -1] = W[1:-1, -2]
    W[0, 0] = (W[0, 1] + W[1, 0]) / 2
    W[0, -1] = (W[0, -2] + W[1, -1]) / 2
    W[-1, 0] = (W[-1, 1] + W[-2, 0]) / 2
    W[-1, -1] = (W[-1, -2] + W[-2, -1]) / 2
    return W


def grad(V, h=None):
    """Centered first-derivative components (one-sided at edges)."""
    V = np.asarray(V, dtype=np.float64)
    if h is None or (isinstance(h, list) and not h):
        h = np.ones((V.ndim, 1))
    gx = np.gradient(V, axis=1) / h[0]
    gz = np.gradient(V, axis=0) / h[1]
    return gx, gz


def tv(V, h=None, eps=1e-6):
    """Total-variation magnitude ``sqrt(|grad V|^2 + eps)``."""
    gx, gz = grad(V, h)
    return np.sqrt(gx ** 2 + gz ** 2 + eps)


# single source of truth: the line search and optimizer modules own
# the canonical implementations (a private sorted-fit polyfit2 variant
# here used to silently diverge from the 3-point-window one the line
# search actually uses — reference optimize/math.py:51-60)
from .line_search import backtrack2, polyfit2  # noqa: E402,F401
from .optimizers import dot, angle             # noqa: E402,F401
