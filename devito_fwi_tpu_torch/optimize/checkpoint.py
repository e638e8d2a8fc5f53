"""Optimization-state checkpoint / resume.

The reference persists L-BFGS S/Y history in ``np.memmap`` files and dumps
model/gradient snapshots but has **no resume logic** (SURVEY.md §5). Here
the full inversion state — current model, initial misfit f0, iteration
counter, and the optimizer's direction-engine state (L-BFGS S/Y history,
NLCG conjugacy vectors, call counts) — is serialized to one ``.npz``
per checkpoint so an interrupted inversion continues bit-exactly.
"""
from __future__ import annotations

import os

import numpy as np

from .tools import count_file

__all__ = ["save_state", "load_state", "latest_checkpoint"]


def _optimizer_state(optimizer):
    state = {"opt_name": optimizer.name,
             "opt_restarted": optimizer.restarted}
    ls = optimizer.line_search
    # the bracket line search seeds each iteration's first trial step from
    # the previous iteration's history (line_search.py:112-130) — without
    # it a resumed run diverges from an uninterrupted one
    state.update(ls_step_lens=np.asarray(ls.step_lens, dtype=np.float64),
                 ls_func_vals=np.asarray(ls.func_vals, dtype=np.float64),
                 ls_gtg=np.asarray(ls.gtg, dtype=np.float64),
                 ls_gtp=np.asarray(ls.gtp, dtype=np.float64),
                 ls_step_count=ls.step_count,
                 ls_writer_iter=ls.writer.iter)
    if optimizer.name == "LBFGS":
        lb = optimizer.lbfgs
        state.update(lbfgs_call_count=lb.call_count,
                     lbfgs_memory_used=lb.memory_used)
        if lb.S is not None:
            state.update(lbfgs_S=lb.S, lbfgs_Y=lb.Y)
        if lb.g is not None:
            state.update(lbfgs_g=lb.g, lbfgs_m=lb.m)
    elif optimizer.name == "NLCG":
        cg = optimizer.nlcg
        state.update(nlcg_call_count=cg.call_count)
        for name in ("g_old", "g_new", "p_old", "p_new"):
            val = getattr(cg, name)
            if val is not None:
                state["nlcg_" + name] = val
    elif optimizer.name == "SteepestDescent":
        state.update(sd_call_count=optimizer.sd.call_count)
    return state


def _restore_optimizer(optimizer, data):
    optimizer.restarted = int(data["opt_restarted"])
    ls = optimizer.line_search
    ls.step_lens = list(data["ls_step_lens"])
    ls.func_vals = list(data["ls_func_vals"])
    ls.gtg = list(data["ls_gtg"])
    ls.gtp = list(data["ls_gtp"])
    ls.step_count = int(data["ls_step_count"])
    ls.writer.iter = int(data["ls_writer_iter"])
    if optimizer.name == "LBFGS":
        lb = optimizer.lbfgs
        lb.call_count = int(data["lbfgs_call_count"])
        lb.memory_used = int(data["lbfgs_memory_used"])
        if "lbfgs_S" in data:
            lb.S = data["lbfgs_S"]
            lb.Y = data["lbfgs_Y"]
        if "lbfgs_g" in data:
            lb.g = data["lbfgs_g"]
            lb.m = data["lbfgs_m"]
    elif optimizer.name == "NLCG":
        cg = optimizer.nlcg
        cg.call_count = int(data["nlcg_call_count"])
        for name in ("g_old", "g_new", "p_old", "p_new"):
            if "nlcg_" + name in data:
                setattr(cg, name, data["nlcg_" + name])
    elif optimizer.name == "SteepestDescent":
        optimizer.sd.call_count = int(data["sd_call_count"])


def save_state(path, iter_count, m, f0, optimizer):
    """Write one atomic checkpoint file ``ckpt_<iter>.npz`` under `path`."""
    os.makedirs(path, exist_ok=True)
    state = dict(iter_count=iter_count, m=np.asarray(m), f0=f0)
    state.update(_optimizer_state(optimizer))
    fname = os.path.join(path, "ckpt_%06d.npz" % iter_count)
    tmp = fname + ".tmp.npz"
    created = not os.path.exists(fname)
    np.savez(tmp, **state)
    os.replace(tmp, fname)
    count_file(os.path.getsize(fname), created)
    return fname


def latest_checkpoint(path):
    if not os.path.isdir(path):
        return None
    cands = sorted(f for f in os.listdir(path)
                   if f.startswith("ckpt_") and f.endswith(".npz")
                   and not f.endswith(".tmp.npz"))
    return os.path.join(path, cands[-1]) if cands else None


def load_state(fname, optimizer):
    """Restore optimizer state in place; returns (iter_count, m, f0)."""
    data = np.load(fname, allow_pickle=False)
    _restore_optimizer(optimizer, data)
    return int(data["iter_count"]), data["m"], float(data["f0"])
