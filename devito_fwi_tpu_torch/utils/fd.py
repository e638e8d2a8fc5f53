"""Finite-difference weights and absorbing-boundary (damping) profiles.

Numpy replacement for the symbolic machinery the reference delegates to
sympy/devito:

* ``fd_weights`` re-implements the Fornberg (1988) recursion that
  ``sympy.finite_diff_weights`` provides in the reference
  (cf. reference ``seismic/model.py:2,339-353``).
* ``damping_profile`` reproduces the sine-taper absorbing layer that the
  reference builds with a devito ``Operator`` over SubDimensions
  (cf. reference ``seismic/model.py:13-51``) as a plain numpy precompute —
  it is evaluated once per model, so there is nothing to accelerate.
"""
from __future__ import annotations

import numpy as np

__all__ = ["fd_weights", "second_derivative_weights",
           "drp_second_derivative_weights", "damping_profile",
           "pad_edge", "cfl_coefficient"]


def fd_weights(deriv_order: int, offsets, x0: float = 0.0) -> np.ndarray:
    """Fornberg finite-difference weights.

    Returns the weights ``w`` such that ``f^(m)(x0) ~= sum_j w[j] f(offsets[j])``.
    Equivalent to ``sympy.finite_diff_weights(m, offsets, x0)[-1][-1]`` used by
    the reference for its CFL coefficient (reference ``seismic/model.py:348-353``).
    """
    offsets = np.asarray(offsets, dtype=np.float64)
    n = len(offsets)
    m = deriv_order
    if n <= m:
        raise ValueError("need more than deriv_order points")
    # Fornberg recursion (Mathematics of Computation, 1988).
    c = np.zeros((n, m + 1), dtype=np.float64)
    c1 = 1.0
    c4 = offsets[0] - x0
    c[0, 0] = 1.0
    for i in range(1, n):
        mn = min(i, m)
        c2 = 1.0
        c5 = c4
        c4 = offsets[i] - x0
        for j in range(i):
            c3 = offsets[i] - offsets[j]
            c2 *= c3
            if j == i - 1:
                for k in range(mn, 0, -1):
                    c[i, k] = c1 * (k * c[i - 1, k - 1] - c5 * c[i - 1, k]) / c2
                c[i, 0] = -c1 * c5 * c[i - 1, 0] / c2
            for k in range(mn, 0, -1):
                c[j, k] = (c4 * c[j, k] - k * c[j, k - 1]) / c3
            c[j, 0] = c4 * c[j, 0] / c3
        c1 = c2
    return c[:, m]


def second_derivative_weights(space_order: int) -> np.ndarray:
    """Central weights for an order-`space_order`-accurate second derivative.

    Stencil half-width is ``space_order // 2`` — this matches what devito
    generates for ``u.laplace`` on a ``Function(space_order=so)`` (the
    reference's stencils, e.g. ``seismic/acoustic/operators.py:38-56``).
    """
    r = space_order // 2
    if r < 1:
        raise ValueError("space_order must be >= 2")
    return fd_weights(2, np.arange(-r, r + 1), 0.0)


def drp_second_derivative_weights(space_order: int,
                                  theta_max: float = 1.8) -> np.ndarray:
    """Dispersion-reduced (DRP) second-derivative weights of the same
    stencil width as ``second_derivative_weights(space_order)``.

    The analog of the reference's custom-coefficient study
    (``seismic/tutorials/07_DRP_schemes.ipynb``, devito
    ``coefficients='symbolic'``): instead of matching the maximal Taylor
    order, the symmetric weights minimize the dispersion error

        int_0^theta_max [ W(theta) + theta^2 ]^2 dtheta,
        W(theta) = w0 + 2 sum_j w_j cos(j theta)

    over the wavenumber band theta = k h in [0, theta_max], subject to
    consistency (W(0) = 0) and exact second-order accuracy
    (sum_j j^2 w_j = 1). Solved as an equality-constrained least-squares
    (KKT) system. Larger ``theta_max`` trades small-k accuracy for a
    wider accurate band (usable down to ~4 points per wavelength). The
    default band reproduces the tutorial's published order-10 upper-layer
    weight table [-3.05033, 1.77768, -0.315476, ...] to ~3 decimals.
    """
    r = space_order // 2
    if r < 2:
        raise ValueError("DRP needs space_order >= 4")
    # unknowns: w_1..w_r (w0 follows from W(0)=0)
    theta = np.linspace(0.0, theta_max, 400)
    # W(theta) = sum_j w_j (2 cos(j theta) - 2); target -theta^2
    A = np.stack([2.0 * np.cos(j * theta) - 2.0 for j in range(1, r + 1)],
                 axis=1)
    b = -theta ** 2
    # constraint: sum_j j^2 w_j = 1
    C = np.array([[float(j * j) for j in range(1, r + 1)]])
    d = np.array([1.0])
    n = r
    kkt = np.zeros((n + 1, n + 1))
    kkt[:n, :n] = A.T @ A
    kkt[:n, n:] = C.T
    kkt[n:, :n] = C
    rhs = np.concatenate([A.T @ b, d])
    sol = np.linalg.solve(kkt, rhs)
    wj = sol[:n]
    w0 = -2.0 * np.sum(wj)
    return np.concatenate([wj[::-1], [w0], wj])


def cfl_coefficient(space_order: int, ndim: int, elastic: bool = False) -> float:
    """CFL (Courant) coefficient.

    Replicates reference ``seismic/model.py:339-353`` exactly, including its
    use of the *full* ``(-so..so)`` stencil for the acoustic coefficient.
    """
    if elastic:
        offsets = np.arange(-space_order // 2 + 1, space_order // 2 + 1)
        w = fd_weights(1, offsets, 0.5)
        c_fd = np.sum(np.abs(w)) / 2.0
        return float(np.sqrt(ndim) / ndim / c_fd)
    a1 = 4.0  # 2nd order in time
    w = fd_weights(2, np.arange(-space_order, space_order + 1), 0.0)
    return float(np.sqrt(a1 / (ndim * np.sum(np.abs(w)))))


def damping_profile(shape_pad, padsizes, spacing, abc_type: str = "damp",
                    fs: bool = False, dtype=np.float32) -> np.ndarray:
    """Sine-taper absorbing-boundary profile on the padded grid.

    Numpy re-derivation of the reference's ``initialize_damp``
    (``seismic/model.py:13-51``):

    * ``abc_type='damp'``: 0 inside the domain, increasing into the layer.
    * ``abc_type='mask'``: 1 inside the domain, decreasing into the layer.
    * taper value at layer position ``pos``:
      ``coeff * (pos - sin(2*pi*pos)/(2*pi)) / h`` with
      ``coeff = 1.5*log(1/0.001)/nbl``.
    * with a free surface the top-z strip is skipped.
    """
    ndim = len(shape_pad)
    damp = np.full(shape_pad, 1.0 if abc_type == "mask" else 0.0, dtype=np.float64)
    sign = -1.0 if abc_type == "mask" else 1.0

    def taper(nb):
        coeff = 1.5 * np.log(1.0 / 0.001) / nb
        return lambda pos: coeff * (pos - np.sin(2.0 * np.pi * pos) / (2.0 * np.pi))

    for axis, ((nbl, nbr), h) in enumerate(zip(padsizes, spacing)):
        # left strip (skipped for the vertical axis under a free surface)
        if (not fs or axis != ndim - 1) and nbl > 0:
            f = taper(nbl)
            i = np.arange(nbl, dtype=np.float64)
            pos = np.abs((nbl - i + 1.0) / nbl)
            val = sign * f(pos) / h
            sl = [None] * ndim
            sl[axis] = slice(0, nbl)
            damp[tuple(s if s is not None else slice(None) for s in sl)] += \
                _bcast(val, axis, ndim)
        # right strip (always)
        if nbr > 0:
            f = taper(nbr)
            j = np.arange(nbr, dtype=np.float64)
            pos = np.abs((j + 2.0) / nbr)
            val = sign * f(pos) / h
            sl = [None] * ndim
            sl[axis] = slice(shape_pad[axis] - nbr, shape_pad[axis])
            damp[tuple(s if s is not None else slice(None) for s in sl)] += \
                _bcast(val, axis, ndim)
    return damp.astype(dtype)


def _bcast(vec, axis, ndim):
    shape = [1] * ndim
    shape[axis] = len(vec)
    return vec.reshape(shape)


def pad_edge(field: np.ndarray, padsizes) -> np.ndarray:
    """Pad a physical parameter into the absorbing layers by edge replication,
    like devito's ``initialize_function`` (reference ``seismic/model.py:167-178``)."""
    return np.pad(field, [tuple(p) for p in padsizes], mode="edge")
