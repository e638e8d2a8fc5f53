"""Nonlinear optimizers: steepest descent, NLCG, L-BFGS.

Behavior parity with the reference ``optimize/`` package (``base.py``,
``optimizer/NLCG.py``, ``optimizer/LBFGS.py``) with two deliberate
divergences, both documented in SURVEY.md §7:

* L-BFGS history update uses the *correct* secant pair ``y = g - g_old``;
  the reference's ``optimizer/LBFGS.py:58`` has ``y = g = self.g`` which
  stores the old gradient instead.
* L-BFGS history lives in device-friendly in-memory arrays rather than
  ``np.memmap`` files (state persistence is handled by the checkpoint
  module instead).
"""
from __future__ import annotations

import os

import numpy as np

from ..utils.profiling import span
from . import line_search as line_search_mod
from .tools import append_text

__all__ = ["SteepestDescent", "NLCG", "LBFGS", "dot", "angle"]


def dot(x, y):
    return np.dot(np.squeeze(np.asarray(x).ravel()),
                  np.squeeze(np.asarray(y).ravel()))


def angle(x, y):
    xy = dot(x, y)
    xx = dot(x, x)
    yy = dot(y, y)
    return np.arccos(xy / (xx * yy) ** 0.5)


class Writer:
    """Append-only scalar metric files (reference ``optimize/base.py:177-190``)."""

    def __init__(self, path="."):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.__call__("step_count", 0)

    def __call__(self, filename, val):
        append_text(os.path.join(self.path, filename), "%e\n" % val)


_METRIC_FILES = ["factor", "gradient_norm_L1", "gradient_norm_L2", "fval",
                 "restarted", "slope", "step_count", "sim_count",
                 "step_length", "theta"]


class base:
    """Line-search orchestration shared by all methods
    (reference ``optimize/base.py:6-168``)."""

    def __init__(self, line_search_method="Bracket", max_ls=10,
                 step_len_init=None, step_len_max=None, log_path=".",
                 verbose=1):
        assert line_search_method in ("Backtrack", "Bracket")
        self.line_search_method = line_search_method
        self.max_ls = max_ls
        self.log_path = log_path
        self.step_len_init = step_len_init
        self.step_len_max = step_len_max
        self.verbose = verbose
        self.restarted = 0

    @property
    def name(self):
        raise NotImplementedError

    @property
    def call_count(self):
        raise NotImplementedError

    def setup(self, resume=False):
        """``resume=True`` preserves the existing metric files and
        optim_info table (a resumed inversion must append to its
        pre-interrupt history, not wipe it)."""
        self.writer = Writer(self.log_path)
        self.line_search = getattr(line_search_mod, self.line_search_method)(
            step_count_max=self.max_ls, path=self.log_path,
            preserve_log=resume)
        if not resume:
            self.check_path()

    def compute_direction(self, m, g):
        return -g

    def initialize_search(self, m, g, p, fval):
        norm_m = np.abs(m).max()
        norm_p = np.abs(p).max()
        gtg = dot(g, g)
        gtp = dot(g, p)
        if self.restarted:
            self.line_search.clear_history()
        if self.step_len_max:
            self.line_search.step_len_max = self.step_len_max * norm_m / norm_p
        alpha, _ = self.line_search.initialize(0., fval, gtg, gtp)
        if self.step_len_init and len(self.line_search.step_lens) <= 1:
            alpha = self.step_len_init * norm_m / norm_p
        return alpha

    def update_search(self, alpha, fval):
        return self.line_search.update(alpha, fval)

    def finalize_search(self, g, p):
        x = self.line_search.search_history()[0]
        f = self.line_search.search_history()[1]
        self.writer("factor", -dot(g, g) ** -0.5 * (f[1] - f[0]) / (x[1] - x[0]))
        self.writer("gradient_norm_L1", np.linalg.norm(np.asarray(g).ravel(), 1))
        self.writer("gradient_norm_L2", np.linalg.norm(np.asarray(g).ravel(), 2))
        self.writer("fval", f[0])
        self.writer("restarted", self.restarted)
        self.writer("slope", (f[1] - f[0]) / (x[1] - x[0]))
        self.writer("step_count", self.line_search.step_count)
        self.writer("step_length", x[f.argmin()])
        self.writer("theta", 180. * np.pi ** -1 * angle(p, -g))
        self.line_search.writer.newline()

    def check_path(self):
        with span("loop.dumps"):
            for name in _METRIC_FILES:
                f = os.path.join(self.log_path, name)
                if os.path.exists(f):
                    os.remove(f)

    def retry_status(self, g, p):
        theta = angle(p, -g)
        if self.verbose >= 2:
            print("\t theta: %.3f" % theta)
        return 0 if abs(theta) < 1e-3 else 1

    def restart(self):
        self.line_search.clear_history()
        self.restarted = 1
        self.line_search.writer.iter -= 1
        self.line_search.writer.newline()


# ---------------------------------------------------------------------------
# inner direction engines
# ---------------------------------------------------------------------------

class _SD:
    def __init__(self):
        self.call_count = 0

    def compute_direction(self, m, g):
        self.call_count += 1
        return -g, 0


class _NLCG:
    """Reference ``optimize/optimizer/NLCG.py``.

    **Documented divergence**: the reference defaults ``thresh=0``,
    which makes the conjugacy-loss check
    ``|g.g_old|/|g.g| > thresh`` fire for ANY non-orthogonal gradient
    pair — default-constructed NLCG silently restarts every iteration
    and degenerates to steepest descent (the reference never
    instantiates NLCG in a driver, so it never hit this). The default
    here is 1.0 (restart when the overlap exceeds the gradient's own
    norm — SeisFlows' published default for this same check); pass
    ``thresh=0.`` explicitly to reproduce the reference literally."""

    def __init__(self, beta_type="FR", max_call=np.inf, thresh=1.0):
        assert beta_type in ("FR", "PR", "HS", "DY")
        self.beta_type = beta_type
        self.g_old = None
        self.g_new = None
        self.p_old = None
        self.p_new = None
        self.thresh = thresh
        self.call_count = 0
        self.max_call = max_call

    def compute_direction(self, m, g):
        self.g_old = self.g_new
        self.p_old = self.p_new
        self.g_new = g
        self.call_count += 1
        if self.call_count == 1:
            self.p_new = -g
            return -g, 0
        elif self.call_count > self.max_call:
            self.restart()
            return -g, 1

        if self.beta_type == "FR":
            beta = _fletcher_reeves(self.g_new, self.g_old)
        elif self.beta_type == "PR":
            beta = _pollak_ribere(self.g_new, self.g_old)
        elif self.beta_type == "HS":
            beta = _hestenes_stiefel(self.g_new, self.g_old, self.p_old)
        else:
            beta = _dai_yuan(self.g_new, self.g_old, self.p_old)

        self.p_new = -self.g_new + beta * self.p_old

        if abs(dot(self.g_new, self.g_old) / dot(self.g_new, self.g_new)) \
                > self.thresh:
            # loss of conjugacy
            self.restart()
            return -g, 1
        elif dot(self.p_new, self.g_new) / dot(self.g_new, self.g_new) > 0.:
            # not a descent direction
            self.restart()
            return -g, 1
        return self.p_new, 0

    def restart(self):
        self.call_count = 0


def _fletcher_reeves(g_new, g_old):
    den = dot(g_old, g_old)
    return dot(g_new, g_new) / den if den != 0 else 0


def _pollak_ribere(g_new, g_old):
    den = dot(g_old, g_old)
    beta = dot(g_new, g_new - g_old) / den if den != 0 else 0
    return max(beta, 0)


def _hestenes_stiefel(g_new, g_old, p_old):
    den = dot(p_old, g_new - g_old)
    return -dot(g_new, g_new - g_old) / den if den != 0 else 0


def _dai_yuan(g_new, g_old, p_old):
    den = dot(p_old, g_new - g_old)
    return -dot(g_new, g_new) / den if den != 0 else 0


class _LBFGS:
    """Two-loop recursion with Liu-Nocedal M3 scaling
    (reference ``optimize/optimizer/LBFGS.py`` with the y-update fixed)."""

    def __init__(self, memory=10, thresh=0., max_call=np.inf):
        self.memory = memory
        self.max_call = max_call
        self.thresh = thresh
        self.call_count = 0
        self.memory_used = 0
        self.g = None
        self.m = None
        self.S = None
        self.Y = None

    def compute_direction(self, m, g):
        self.call_count += 1
        if self.call_count == 1:
            self.g = g
            self.m = m
            return -g, 0
        elif self.call_count > self.max_call:
            self.restart()
            return -g, 1

        self.update(m, g)
        q = self.apply(g)
        self.g = g
        self.m = m
        if self.check_status(g, q) != 0:
            self.restart()
            return -g, 1
        return -q, 0

    def update(self, m, g):
        s = np.asarray(m - self.m, dtype=np.float64)
        # NOTE: the reference has `y = g = self.g` (LBFGS.py:58), storing the
        # *old* gradient; the correct secant pair is the gradient difference.
        y = np.asarray(g - self.g, dtype=np.float64)
        n = len(s)
        if self.S is None:
            self.S = np.zeros((n, self.memory))
            self.Y = np.zeros((n, self.memory))
        self.S[:, 1:] = self.S[:, :-1]
        self.Y[:, 1:] = self.Y[:, :-1]
        self.S[:, 0] = s
        self.Y[:, 0] = y
        self.memory_used = min(self.memory_used + 1, self.memory)

    def apply(self, q):
        q = np.asarray(q, dtype=np.float64).copy()
        S, Y = self.S, self.Y
        kk = self.memory_used
        rh = np.zeros(kk)
        al = np.zeros(kk)
        for ii in range(kk):
            rh[ii] = 1 / np.dot(Y[:, ii], S[:, ii])
            al[ii] = rh[ii] * np.dot(S[:, ii], q)
            q = q - al[ii] * Y[:, ii]
        r = q
        sty = np.dot(Y[:, 0], S[:, 0])
        yty = np.dot(Y[:, 0], Y[:, 0])
        r *= sty / yty
        for ii in range(kk - 1, -1, -1):
            be = rh[ii] * np.dot(Y[:, ii], r)
            r = r + S[:, ii] * (al[ii] - be)
        return r

    def restart(self):
        self.call_count = 0
        self.memory_used = 0
        if self.S is not None:
            self.S[:] = 0.
            self.Y[:] = 0.

    def check_status(self, g, r):
        theta = 180. * np.pi ** -1 * angle(g, r)
        if not 0. < theta < 90.:
            return 1  # not a descent direction
        elif theta > 90. - self.thresh:
            return 1  # practical safeguard
        return 0


# ---------------------------------------------------------------------------
# public optimizer classes
# ---------------------------------------------------------------------------

class SteepestDescent(base):
    def __init__(self, ls_method="Bracket", max_ls=5, step_len_init=0.05,
                 step_len_max=0.5, log_path=".", verbose=1):
        super().__init__(line_search_method=ls_method, max_ls=max_ls,
                         step_len_init=step_len_init,
                         step_len_max=step_len_max, log_path=log_path,
                         verbose=verbose)

    @property
    def name(self):
        return "SteepestDescent"

    @property
    def call_count(self):
        return self.sd.call_count

    def setup(self, resume=False):
        super().setup(resume=resume)
        self.sd = _SD()

    def compute_direction(self, m, g):
        p, self.restarted = self.sd.compute_direction(m, g)
        return p

    def restart(self):
        pass  # steepest descent never requires restarts


class NLCG(base):
    """Nonlinear conjugate gradient (see ``_NLCG`` for the documented
    ``thresh`` default divergence from the reference)."""

    def __init__(self, max_call=np.inf, thresh=1.0, beta_type="FR",
                 ls_method="Bracket", max_ls=5, step_len_init=0.05,
                 step_len_max=0.5, log_path=".", verbose=1):
        super().__init__(line_search_method=ls_method, max_ls=max_ls,
                         step_len_init=step_len_init,
                         step_len_max=step_len_max, log_path=log_path,
                         verbose=verbose)
        self.max_call = max_call
        self.thresh = thresh
        self.beta_type = beta_type

    @property
    def name(self):
        return "NLCG"

    @property
    def call_count(self):
        return self.nlcg.call_count

    def setup(self, resume=False):
        super().setup(resume=resume)
        self.nlcg = _NLCG(beta_type=self.beta_type, max_call=self.max_call,
                          thresh=self.thresh)

    def compute_direction(self, m, g):
        p, self.restarted = self.nlcg.compute_direction(m, g)
        return p

    def restart(self):
        super().restart()
        self.nlcg.restart()


class LBFGS(base):
    def __init__(self, memory=5, max_call=np.inf, thresh=0,
                 ls_method="Bracket", max_ls=5, step_len_init=0.05,
                 step_len_max=0.5, log_path=".", verbose=1):
        super().__init__(line_search_method=ls_method, max_ls=max_ls,
                         step_len_init=step_len_init,
                         step_len_max=step_len_max, log_path=log_path,
                         verbose=verbose)
        self.memory = memory
        self.max_call = max_call
        self.thresh = thresh

    @property
    def name(self):
        return "LBFGS"

    @property
    def call_count(self):
        return self.lbfgs.call_count

    def setup(self, resume=False):
        super().setup(resume=resume)
        self.lbfgs = _LBFGS(memory=self.memory, max_call=self.max_call,
                            thresh=self.thresh)

    def compute_direction(self, m, g):
        p, self.restarted = self.lbfgs.compute_direction(m, g)
        return p

    def restart(self):
        super().restart()
        self.lbfgs.restart()
