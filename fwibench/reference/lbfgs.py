"""The first iteration of the devito-fwi L-BFGS inversion, in NumPy: the
steepest-descent direction of the first call, the bracketing line search
(``optimize/line_search/bracket.py`` with its initial step of
``step_len_init`` max|m| / max|p| and its cap of ``step_len_max`` max|m| /
max|p|) over misfit-only trials, and the bounded update of
``minimize.py``. ``follow`` then evaluates the objective and gradient at the
accepted model, the second call of the inversion."""
from __future__ import annotations

import numpy as np

__all__ = ["bracket_step", "follow"]


def _polyfit2(x, f):
    i = int(np.argmin(f))
    p = np.polyfit(x[i - 1:i + 2], f[i - 1:i + 2], 2)
    if p[0] > 0:
        return -p[1] / (2 * p[0])
    raise RuntimeError("parabolic fit is not convex")


def _bracketed(x, f):
    imin = int(f.argmin())
    return bool(f.min() < f[0] and np.any(f[imin:] > f.min()))


def _good_enough(x, f, thresh=np.log10(1.2)):
    if not _bracketed(x, f):
        return False
    x0 = _polyfit2(x, f)
    return bool(np.any(np.abs(np.log10(x[1:] / x0)) < thresh))


def _backtrack2(f0, g0, x1, f1, b1=0.1, b2=0.5):
    x2 = -g0 * x1 ** 2 / (2 * (f1 - f0 - g0 * x1))
    return min(max(x2, b1 * x1), b2 * x1)


def bracket_step(xs, fs, gtg, gtp, max_ls, step_len_max):
    """The next trial of the first iteration's bracketing search from the
    trials (xs, fs) so far (xs[0] = 0, fs[0] the objective at the start):
    (alpha, status), status > 0 accepts alpha, 0 tries it, < 0 fails."""
    count = len(xs) - 1
    order = np.argsort(np.abs(xs))
    x, f = np.asarray(xs)[order], np.asarray(fs)[order]
    bad = ~np.isfinite(f)
    bad_min = None
    if bad.any():
        bad_min = float(x[bad].min())
        if not np.isfinite(fs[-1]):
            return (0.1 * bad_min, 0) if count <= max_ls else (0, -1)
        x, f = x[~bad], f[~bad]
    if _bracketed(x, f) and _good_enough(x, f):
        alpha, status = x[f.argmin()], 1
    elif _bracketed(x, f):
        alpha, status = _polyfit2(x, f), 0
    elif count <= max_ls and np.all(f <= f[0]):
        alpha, status = 1.618034 * x[-1], 0
    elif count <= max_ls:
        alpha, status = _backtrack2(f[0], gtp / gtg, x[1], f[1]), 0
    else:
        return 0, -1
    if bad_min is not None and status == 0 and alpha >= bad_min:
        alpha = 0.5 * (float(x[-1]) + bad_min)
    if alpha > step_len_max:
        alpha, status = step_len_max, 1
    return alpha, status


def follow(objective, m0, bounds, step_len_init, step_len_max, max_ls):
    """The first L-BFGS iteration from ``m0`` and the gradient at the
    accepted model: {"f": [f0, f1], "g": [g0, g1], "trials": [(m, f)],
    "m1": model}."""
    lo, hi = bounds
    f0, g0 = objective(m0, True)
    p = -g0
    norm_m, norm_p = np.abs(m0).max(), np.abs(p).max()
    gtg, gtp = float(np.dot(g0, g0)), float(np.dot(g0, p))
    cap = step_len_max * norm_m / norm_p
    alpha = step_len_init * norm_m / norm_p
    xs, fs, trials = [0.0], [f0], []
    while True:
        m_t = np.clip(m0 + alpha * p, lo, hi)
        f_t, _ = objective(m_t, False)
        trials.append((m_t, f_t))
        xs.append(alpha)
        fs.append(f_t)
        alpha, status = bracket_step(xs, fs, gtg, gtp, max_ls, cap)
        if status > 0:
            m1 = np.clip(m0 + alpha * p, lo, hi)
            break
        if status < 0:
            # the search failed on a steepest-descent direction: the
            # inversion stops at its starting model
            m1 = m0
            break
    f1, g1 = objective(m1, True)
    return {"f": [f0, f1], "g": [g0, g1], "trials": trials, "m1": m1}
