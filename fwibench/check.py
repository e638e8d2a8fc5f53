"""The comparison that decides ``correct``: the first iteration the timed
window ran (the objective and gradient at the starting model, the
line-search trials, the accepted model, the objective and gradient there)
against the plain reference following the same iteration from the same
inputs.

Readings, each a relative gap:

* ``f0``, ``f1``: |f - f_ref| / |f_ref| of the first and second gradient
  calls' objective;
* ``grad0``, ``grad1``: ||g - g_ref|| / ||g_ref|| of their gradients as
  the optimizer gets them (precondition and mask applied);
* ``trials``: the largest |f - f_ref| / |f_ref| over the trials both ran;
* ``step``: ||m1 - m1_ref|| / ||m1_ref - m0||, the accepted step;
* ``eager_calls``: calls of the window that left the kernel route
  (limit 0).
"""
from __future__ import annotations

import sys

import numpy as np

__all__ = ["readings", "judge", "report"]


def _rel(a, b):
    return abs(a - b) / abs(b)


def _norm_rel(a, b):
    return float(np.linalg.norm(a - b)) / float(np.linalg.norm(b))


def readings(prog, ref):
    """Readings of the program's first iteration ``prog`` ({"x": [m0, m1],
    "f": [...], "g": [...], "trials": [(m, f)]}) against the reference's
    (``reference.lbfgs.follow``)."""
    out = {"f0": _rel(prog["f"][0], ref["f"][0]),
           "grad0": _norm_rel(prog["g"][0], ref["g"][0])}
    n = min(len(prog["trials"]), len(ref["trials"]))
    if n:
        out["trials"] = max(_rel(prog["trials"][k][1], ref["trials"][k][1])
                            for k in range(n))
    m0, m1 = prog["x"]
    # a reference whose search failed stays at m0: then any step is wrong
    step = float(np.linalg.norm(ref["m1"] - m0))
    miss = float(np.linalg.norm(m1 - ref["m1"]))
    out["step"] = miss / step if step else float(miss > 0)
    out["f1"] = _rel(prog["f"][1], ref["f"][1])
    out["grad1"] = _norm_rel(prog["g"][1], ref["g"][1])
    return out


def judge(values, limits):
    """(correct, {name: {"value", "limit"}}): every reading at or under
    its limit, and every limit read."""
    table = {k: {"value": float(values[k]) if k in values else None,
                 "limit": float(v)} for k, v in limits.items()}
    ok = all(t["value"] is not None and np.isfinite(t["value"])
             and t["value"] <= t["limit"] for t in table.values())
    return ok, table


def report(table, stream=sys.stderr):
    """Each reading beside its limit, one a line."""
    for name, t in table.items():
        print(f"check {name}: {t['value']!r} limit {t['limit']!r}",
              file=stream)
