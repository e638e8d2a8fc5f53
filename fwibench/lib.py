"""The benchmark's shared pieces: finding a cell, its configuration, its
family, metrics, roles and counts by name; the seed's acquisition and the
sizes the counts read; the wrapper that times the objective calls of the
window; the reading of the profiler's trace into spans and device
intervals, and the arithmetic the metric readers share.

Everything a cell or a metric brings is a file of its own in the
benchmark's folder, found by the name ``BENCHMARK.json`` or another file
gives it, so that a later cell or metric is added by files alone:

* a cell: ``workloads/<name>.json`` (its configuration's name, its
  ``"misfit"`` index, jitter, optimizer, trace and check limits);
* a configuration: ``configs/<name>.json``, whose ``"family"`` names the
  system under test, ``families/<family>.py`` (``setup``), and the plain
  reference's objective, ``reference/families/<family>.py``; the
  workload's misfit is ``reference/misfits/<name>.py``
  (``reference/objective.py`` says how);
* a metric: ``metrics/<name>.py`` with ``read(rec)``, None where it finds
  nothing to read;
* a count: ``counts/<name>.py`` with ``work(kind, sizes)``, the
  operations and bytes of one call at ``sizes()``; a family's count is
  named after the family;
* a role: ``roles/<name>.json`` with the ``"call"`` it times
  (``gradient`` or ``trial``), the ``"kernels"`` whose device time it
  takes inside that call and the ``"count"`` whose least time it divides
  (the family's where it names none); a roofline metric reads its role
  with ``role_share``."""
from __future__ import annotations

import importlib.util
import json
import math
import os
import re
from time import perf_counter

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

__all__ = ["load_json", "Bench", "sizes", "acquisition", "bounds",
           "follow_reference", "peaks", "WindowEnd", "InversionStuck",
           "Recorder", "read_trace", "union", "kernel_matches",
           "nearest_rank", "calls", "least_seconds", "role_share", "inside"]


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files of the benchmark's
    folder ``here`` (default: this folder)."""

    def __init__(self, root, here=HERE):
        self.root = root
        self.here = here
        self.spec = load_json(root, "BENCHMARK.json")

    def workload(self, name):
        return load_json(self.here, "workloads", name + ".json")

    def config(self, name):
        return load_json(self.here, "configs", name + ".json")

    def role(self, name):
        return load_json(self.here, "roles", name + ".json")

    def family(self, name):
        """The system under test of a configuration's family."""
        return _module(os.path.join(self.here, "families", name + ".py"),
                       "fwibench.families." + name)

    def count(self, name):
        return _module(os.path.join(self.here, "counts", name + ".py"))

    def metric(self, name):
        return _module(os.path.join(self.here, "metrics", name + ".py"))

    def metrics(self, cell, traced):
        """The names of the metrics a run of ``cell`` reports: the
        end-to-end ones, or with ``traced`` the per-layer ones, that list
        the cell or list no cells."""
        group = self.spec["per_layer" if traced else "end_to_end"]
        return [m["name"] for m in group
                if cell in m.get("workloads", [cell])]


def _module(path, name=None):
    """A module of the benchmark loaded from its file (names may hold
    dots); ``name``, where given, places it in a package of the benchmark,
    for its relative imports."""
    name = name or "fwibench._by_path." + os.path.relpath(
        path, HERE).replace(os.sep, "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sizes(config, nt, work):
    """What the counts read: shots, padded and physical cells, time
    samples, receivers and space order of a configuration; its W2 settings
    (``w2_num_steps``, ``w2_step_scale``, as the port's driver configuration
    takes them) and the workload's ``misfit`` index."""
    nx, nz = config["shape"]
    b = config["nbl"]
    return {"shots": config["shots"], "space_order": config["space_order"],
            "padded_cells": (nx + 2 * b) * (nz + 2 * b), "cells": nx * nz,
            "nt": nt, "nrec": nx,
            "w2_num_steps": config.get("w2_num_steps", 15),
            "w2_step_scale": config.get("w2_step_scale", 1.0),
            "misfit": work["misfit"]}


def acquisition(config, work, seed):
    """The seed's sources and the receivers of a cell: each shot moved
    along x uniformly within +-``jitter`` of the shot spacing, drawn once
    per run."""
    from fwibench.reference import grid
    rng = np.random.default_rng(seed)
    jitter = rng.uniform(-work["jitter"], work["jitter"], config["shots"])
    return grid.acquisition(config["shape"], config["spacing"],
                            config["shots"], config["depth_cells"], jitter)


def bounds(config):
    """The squared-slowness box of the configuration's vp bounds."""
    vmin, vmax = config["vp_bounds"]
    return [1.0 / vmax ** 2, 1.0 / vmin ** 2]


def follow_reference(objective, m0, config, work):
    """The reference's first iteration of the cell from ``m0``."""
    from fwibench.reference import lbfgs
    opt = work["optimizer"]
    return lbfgs.follow(objective, m0, bounds(config), opt["step_len_init"],
                        opt["step_len_max"], opt["max_ls"])


def peaks(device_name):
    """The card's published (f32 FLOP/s, bytes/s), or None."""
    for card in load_json(HERE, "peaks.json")["cards"]:
        if card["match"] in device_name:
            return card["f32_flops"], card["bytes_per_s"]
    return None


class WindowEnd(Exception):
    """Raised at the first gradient call due after the window's length."""


class InversionStuck(Exception):
    """Raised when a line search has failed twice on one direction: the
    inversion's retry repeats the same trials from then on."""


class Recorder:
    """The port's objective with the signature of ``fwi_loss``, timed call
    by call on the host clock (each call ends with its results on the host,
    so its time covers the device work). A gradient call opens an
    iteration. The window ends at the first gradient call due once
    ``seconds`` have passed since ``start()`` and the first two gradients
    are done: that call raises ``WindowEnd`` instead of running. The first
    two gradient calls' models and results and the trials between them are
    kept for the comparison. ``tracer(n_grad)``, if given, is told before
    each gradient call how many gradients came before it; ``span(name)``
    returns a context manager around each call. A trial call due after
    ``stuck_trials`` trials since the last gradient raises
    ``InversionStuck`` instead of running."""

    def __init__(self, loss, seconds, stuck_trials, tracer=None, span=None):
        self.loss = loss
        self.seconds = seconds
        self.stuck_trials = stuck_trials
        self.trials_since = 0
        self.tracer = tracer
        self.span = span
        self.calls = []
        self.first = {"x": [], "f": [], "g": [], "trials": []}
        self.t_start = self.t_end = None

    def start(self):
        self.t_start = perf_counter()

    def n_grad(self):
        return sum(1 for c in self.calls if c["grad"])

    def __call__(self, x, geometry, obs, misfit_func, direct_wave=None,
                 mask=None, precond=True, calc_grad=True, shot_indices=None):
        n = self.n_grad()
        if calc_grad:
            now = perf_counter()
            if n >= 2 and now - self.t_start >= self.seconds:
                self.t_end = now
                raise WindowEnd
            if self.tracer is not None:
                self.tracer(n)
            self.trials_since = 0
        elif self.trials_since >= self.stuck_trials:
            raise InversionStuck
        else:
            self.trials_since += 1
        name = "objective.gradient" if calc_grad else "objective.trial"
        t0 = perf_counter()
        if self.span is not None:
            with self.span(name):
                out = self.loss(x, geometry, obs, misfit_func, direct_wave,
                                mask, precond, calc_grad,
                                shot_indices=shot_indices)
        else:
            out = self.loss(x, geometry, obs, misfit_func, direct_wave,
                            mask, precond, calc_grad,
                            shot_indices=shot_indices)
        t1 = perf_counter()
        self.calls.append({"grad": bool(calc_grad), "t0": t0, "t1": t1,
                           "f": float(out[0])})
        if calc_grad and n < 2:
            self.first["x"].append(np.array(x, np.float64))
            self.first["f"].append(float(out[0]))
            self.first["g"].append(np.array(out[1], np.float64))
        elif not calc_grad and n == 1:
            self.first["trials"].append((np.array(x, np.float64),
                                         float(out[0])))
        return out


def read_trace(path):
    """(spans, device intervals) of a Chrome trace written by
    ``torch.profiler``: the harness's annotations as {name, ts, dur} and the
    kernels, copies and sets on the device as {name, cat, ts, dur}, times
    in microseconds on the trace's clock."""
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    spans, dev = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        item = {"name": e.get("name", ""), "ts": float(e["ts"]),
                "dur": float(e.get("dur", 0.0))}
        if cat == "user_annotation":
            spans.append(item)
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            item["cat"] = cat
            dev.append(item)
    return spans, dev


def union(intervals):
    """Merged (start, end) pairs of a list of intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def kernel_matches(name, patterns):
    return any(re.search(r"\b" + re.escape(p) + r"\b", name)
               for p in patterns)


def nearest_rank(values, q):
    """The nearest-rank q-quantile (0 < q <= 1) of ``values``."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def calls(rec, grad, profiled=None):
    """The window's calls of one kind; ``profiled`` False leaves out those
    the profiler watched (None keeps all)."""
    return [c for c in rec["calls"] if c["grad"] == grad
            and (profiled is None or c["profiled"] == profiled)]


def least_seconds(rec, kind, count=None):
    """The least time of one call of ``kind`` on the card by the count
    ``count`` (default: the family's): the larger of its operations over
    the float32 peak and its bytes over the memory peak; None on a card
    the peaks table does not know."""
    if rec["peaks"] is None:
        return None
    ops, nbytes = rec["bench"].count(count or rec["family"]).work(
        kind, rec["sizes"])
    flops, bw = rec["peaks"]
    return max(ops / flops, nbytes / bw)


def role_share(rec, role):
    """100 x the least time of the role's calls by the role's count over
    the device time of the role's kernels inside them, in the traced
    stretch; None where the trace holds none of them."""
    tr = rec.get("trace")
    if tr is None:
        return None
    spec = rec["bench"].role(role)
    span = "objective." + spec["call"]
    spans = [s for s in tr["spans"] if s["name"] == span]
    busy = sum(d["dur"] for s in spans for d in inside(tr["device"], s)
               if kernel_matches(d["name"], spec["kernels"]))
    least = least_seconds(rec, spec["call"], spec.get("count"))
    if not spans or busy <= 0 or least is None:
        return None
    return 100.0 * least * len(spans) / (busy * 1e-6)


def inside(device, span):
    """The device intervals that start inside a host span."""
    a, b = span["ts"], span["ts"] + span["dur"]
    return [d for d in device if a <= d["ts"] < b]
