"""Line searches: bracketing and backtracking.

API/behavior parity with the reference ``optimize/line_search/``
(``bracket.py``, ``backtrack.py``, ``base.py``) including the `optim_info`
log format. Host-side numpy — these operate on scalars and small vectors;
the heavy lifting (objective evaluations) happens in the FWI objective
between `update` calls.
"""
from __future__ import annotations

import os

import numpy as np

from .tools import append_text

__all__ = ["Bracket", "Backtrack", "backtrack2", "polyfit2"]


def backtrack2(f0, g0, x1, f1, b1=0.1, b2=0.5):
    """Safeguarded parabolic backtrack (reference ``optimize/math.py:31-42``)."""
    x2 = -g0 * x1 ** 2 / (2 * (f1 - f0 - g0 * x1))
    if x2 > b2 * x1:
        x2 = b2 * x1
    elif x2 < b1 * x1:
        x2 = b1 * x1
    return x2


def polyfit2(x, f):
    """Parabolic fit through the bracketing triple
    (reference ``optimize/math.py:51-60``)."""
    i = np.argmin(f)
    p = np.polyfit(x[i - 1:i + 2], f[i - 1:i + 2], 2)
    if p[0] > 0:
        return -p[1] / (2 * p[0])
    raise RuntimeError("parabolic fit is not convex")


def count_zeros(a):
    return sum(np.array(a) == 0)


class Writer:
    """`optim_info` ITER/STEPLEN/MISFIT table writer
    (reference ``optimize/line_search/base.py:104-148``)."""

    def __init__(self, path=".", preserve=False):
        self.iter = 0
        os.makedirs(path, exist_ok=True)
        self.filename = os.path.join(path, "optim_info")
        if os.path.exists(self.filename) and not preserve:
            os.remove(self.filename)
        if preserve and os.path.exists(self.filename):
            # resume: continue ITER numbering from the existing table
            # instead of restarting at 1
            with open(self.filename) as fileobj:
                for row in fileobj:
                    head = row[:10].strip()
                    if head and head != "ITER" and not head.startswith("="):
                        try:
                            self.iter = max(self.iter, int(head))
                        except ValueError:
                            pass
        else:
            self.write_header()

    def __call__(self, steplen=None, funcval=None):
        if self.iter == 0 or steplen == 0.0:
            self.iter += 1
            row = "%10d  %10.3e  %10.3e\n" % (self.iter, steplen, funcval)
        else:
            row = 12 * " " + "%10.3e  %10.3e\n" % (steplen, funcval)
        append_text(self.filename, row)

    def write_header(self):
        headers = ["ITER", "STEPLEN", "MISFIT"]
        append_text(self.filename,
                    "".join("%10s  " % h for h in headers) + "\n"
                    + "%10s  " % (10 * "=") * len(headers) + "\n")

    def newline(self):
        append_text(self.filename, "\n")


class Base:
    """Line-search history bookkeeping (reference ``line_search/base.py``).

    Status codes: >0 finished, ==0 not finished, <0 failed.
    """

    def __init__(self, step_count_max=10, step_len_max=np.inf, path=".",
                 preserve_log=False):
        self.step_count_max = step_count_max
        self.step_len_max = step_len_max
        self.writer = Writer(path, preserve=preserve_log)
        self.func_vals = []
        self.step_lens = []
        self.gtg = []
        self.gtp = []
        self.step_count = 0

    def clear_history(self):
        self.func_vals = []
        self.step_lens = []
        self.gtg = []
        self.gtp = []

    def search_history(self, sort=True):
        i = self.step_count
        j = count_zeros(self.step_lens) - 1
        k = len(self.step_lens)
        x = np.array(self.step_lens[k - i - 1:k])
        f = np.array(self.func_vals[k - i - 1:k])
        if sort:
            f = f[abs(x).argsort()]
            x = x[abs(x).argsort()]
        return x, f, self.gtg, self.gtp, i, j

    def initialize(self, step_len, func_val, gtg, gtp):
        self.step_count = 0
        self.step_lens += [step_len]
        self.func_vals += [func_val]
        self.gtg += [gtg]
        self.gtp += [gtp]
        self.writer(step_len, func_val)
        return self.calculate_step()

    def update(self, step_len, func_val):
        self.step_count += 1
        self.step_lens += [step_len]
        self.func_vals += [func_val]
        self.writer(step_len, func_val)
        return self.calculate_step()

    def calculate_step(self):
        raise NotImplementedError


class Bracket(Base):
    """Bracketing line search (reference ``line_search/bracket.py``)."""

    @property
    def name(self):
        return "bracket"

    def calculate_step(self):
        x, f, gtg, gtp, step_count, update_count = self.search_history()

        # non-finite trials (e.g. a bounded model beyond the pinned
        # dt's CFL limit blowing the forward up) must never be accepted
        # or fed to the polynomial fits. If the LATEST trial blew up,
        # retry well below the smallest unstable step; otherwise drop
        # the blown-up rows and let the normal logic decide on the
        # finite subset (so a recovered finite trial CAN be accepted),
        # capping any proposal below the unstable region. Finite-path
        # behavior (and reference parity) is untouched.
        alpha_bad_min = None
        bad = ~np.isfinite(np.asarray(f))
        if step_count > 0 and bad.any():
            alpha_bad_min = float(np.asarray(x)[bad].min())
            if not np.isfinite(self.func_vals[-1]):
                if step_count <= self.step_count_max:
                    return 0.1 * alpha_bad_min, 0
                return 0, -1
            keep = ~bad
            x = np.asarray(x)[keep]
            f = np.asarray(f)[keep]

        if step_count == 0 and update_count == 0:
            # Dennis & Schnabel initial step
            alpha = gtg[-1] ** -1
            status = 0
        elif step_count == 0:
            # Nocedal & Wright 2ed, sec 3.5 first equation
            idx = np.argmin(self.func_vals[:-1])
            alpha = self.step_lens[idx] * gtp[-2] / gtp[-1]
            status = 0
        elif _check_bracket(x, f) and _good_enough(x, f):
            alpha = x[f.argmin()]
            status = 1
        elif _check_bracket(x, f):
            alpha = polyfit2(x, f)
            status = 0
        elif step_count <= self.step_count_max and all(f <= f[0]):
            # grow by the golden ratio
            alpha = 1.618034 * x[-1]
            status = 0
        elif step_count <= self.step_count_max:
            slope = gtp[-1] / gtg[-1]
            alpha = backtrack2(f[0], slope, x[1], f[1], b1=0.1, b2=0.5)
            status = 0
        else:
            alpha = 0
            status = -1

        # keep proposals below any known-unstable step (NaN region):
        # bisect between the largest finite trial and the unstable
        # boundary so a bracket can still form under the ceiling
        if alpha_bad_min is not None and status == 0 and \
                alpha >= alpha_bad_min:
            alpha = 0.5 * (float(x[-1]) + alpha_bad_min)

        # optional step-length safeguard
        if alpha > self.step_len_max and step_count == 0:
            alpha = 0.618034 * self.step_len_max
            status = 0
        elif alpha > self.step_len_max:
            alpha = self.step_len_max
            status = 1
        return alpha, status


class Backtrack(Bracket):
    """Backtracking line search (reference ``line_search/backtrack.py``)."""

    @property
    def name(self):
        return "backtrack"

    def calculate_step(self):
        x, f, gtg, gtp, step_count, update_count = self.search_history()

        # same non-finite-trial handling as Bracket (see there)
        alpha_bad_min = None
        bad = ~np.isfinite(np.asarray(f))
        if step_count > 0 and bad.any():
            alpha_bad_min = float(np.asarray(x)[bad].min())
            if not np.isfinite(self.func_vals[-1]):
                if step_count <= self.step_count_max:
                    return 0.1 * alpha_bad_min, 0
                return None, -1
            keep = ~bad
            x = np.asarray(x)[keep]
            f = np.asarray(f)[keep]

        if update_count == 0:
            # quasi-Newton direction not yet scaled: bracket instead
            alpha, status = super().calculate_step()
        elif step_count == 0:
            alpha = min(1.0, self.step_len_max)
            status = 0
        elif _check_decrease(x, f):
            alpha = x[f.argmin()]
            status = 1
        elif step_count <= self.step_count_max:
            slope = gtp[-1] / gtg[-1]
            alpha = backtrack2(f[0], slope, x[1], f[1], b1=0.1, b2=0.5)
            status = 0
        else:
            alpha = None
            status = -1
        if alpha_bad_min is not None and status == 0 and \
                alpha is not None and alpha >= alpha_bad_min:
            alpha = 0.5 * (float(x[-1]) + alpha_bad_min)
        return alpha, status


def _check_bracket(step_lens, func_vals):
    x, f = step_lens, func_vals
    imin, fmin = f.argmin(), f.min()
    return 1 if (fmin < f[0]) and any(f[imin:] > fmin) else 0


def _good_enough(step_lens, func_vals, thresh=np.log10(1.2)):
    x, f = step_lens, func_vals
    if not _check_bracket(x, f):
        return 0
    x0 = polyfit2(x, f)
    return 1 if any(np.abs(np.log10(x[1:] / x0)) < thresh) else 0


def _check_decrease(step_lens, func_vals, c=1.e-4):
    x, f = step_lens, func_vals
    return 1 if f.min() < f[0] else 0
