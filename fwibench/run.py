"""Run one cell of the benchmark of ``devito_fwi_tpu_torch`` once.

    python3 -m fwibench.run --workload smarmn-l2-lbfgs --seed 7 \\
        --seconds 45 --trace 0

From the root of a checkout, on a machine with the cards the cell asks for.
Set-up builds the cell's inputs from the seed (the shots' positions), the
port's models, geometries and observed data as its Marmousi drivers do,
and warms up one gradient and one trial. The window then runs the port's
L-BFGS inversion (``optimize.minimize``) from the starting model through a
timed wrapper of its objective and ends at the first gradient call due
after ``--seconds``. ``--trace 1`` profiles whole iterations of the window
(the workload's ``trace`` entry) and reports the per-layer metrics;
``--trace 0`` the end-to-end ones. Once the window has closed and the
port's state is freed, the plain reference of ``fwibench/reference``
follows the window's first iteration from the same inputs and decides
``correct`` (``fwibench/check.py``). The last line of standard output is
the result as one JSON object.

Everything the run takes from a cell is found by name in files of the
benchmark's folder (``fwibench/lib.py`` lists them): the workload, its
configuration, the family's system under test, the reference's family
objective and the workload's misfit (``reference/objective.py``), the
metrics, their roles and counts. A cell of another family or misfit is
added as files. Where the reference has no module for the cell's family
or misfit, the run stops before the program's set-up, names the file it
looked for and prints no result.
"""
from time import perf_counter

T0 = perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import faulthandler  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

# one process with few threads: the host's share of a run (kernel
# launches, L-BFGS, dumps) steadier against the machine's other cores
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

FORBIDDEN = ("jax", "jaxlib", "flax", "devito_fwi_tpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def forbidden_modules():
    """Loaded modules whose top-level name is one the benchmark may not
    load, compared whole."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


class _Profiler:
    """``torch.profiler`` over the window's iterations skip+1 .. skip+n,
    with an ``iteration`` annotation from each gradient call to the next and
    one around each objective call."""

    def __init__(self, skip, n):
        self.skip, self.n = skip, n
        self.prof = self.iteration = None
        self.on = False

    def tracer(self, n_grad):
        import torch
        from torch.autograd.profiler import record_function
        self._close_iteration()
        if n_grad == self.skip and self.prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self.on = True
        elif n_grad == self.skip + self.n and self.on:
            self.stop()
        if self.on:
            self.iteration = record_function("iteration")
            self.iteration.__enter__()

    def warm(self):
        """A throwaway session, so that the profiler's one-time start-up
        lands in set-up and not in the window."""
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        cuda = torch.cuda.is_available()
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts):
            torch.ones(8, device="cuda" if cuda else "cpu").add_(1)
            if cuda:
                torch.cuda.synchronize()

    def perturbed(self, iteration):
        """Whether the profiler ran in, started in or stopped in the
        window's iteration ``iteration`` (1-based)."""
        return self.skip <= iteration <= self.skip + self.n

    def _close_iteration(self):
        if self.iteration is not None:
            self.iteration.__exit__(None, None, None)
            self.iteration = None

    def span(self, name):
        from torch.autograd.profiler import record_function
        return record_function(name) if self.on else contextlib.nullcontext()

    def stop(self):
        import torch
        if not self.on:
            return
        self._close_iteration()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        self.on = False


def _trace_record(path):
    """Spans, device intervals, the traced stretch and the device's busy
    time from the exported trace."""
    from fwibench import lib
    spans, dev = lib.read_trace(path)
    its = [s for s in spans if s["name"] == "iteration"]
    if not its:
        return None
    a = min(s["ts"] for s in its)
    b = max(s["ts"] + s["dur"] for s in its)
    busy = lib.union([(max(d["ts"], a), min(d["ts"] + d["dur"], b))
                      for d in dev if d["ts"] + d["dur"] > a and d["ts"] < b])
    busy_us = sum(y - x for x, y in busy)
    return {"spans": spans, "device": dev, "window_s": (b - a) * 1e-6,
            "busy_s": busy_us * 1e-6, "busy": busy, "stretch": (a, b)}


def _short(name):
    """A kernel's name without its return type, anonymous namespace and
    argument list."""
    name = name.replace("void ", "", 1).replace("(anonymous namespace)::",
                                                  "")
    return name.split("(")[0].strip() or name[:80]


def _idle_gaps(tr):
    """The device's idle time in the traced stretch, in seconds, by the
    innermost span the host was in (a program span, else an objective
    call, else ``driver``: ``spans.owners``)."""
    from fwibench import spans
    gaps = {}
    a, b = tr["stretch"]
    pieces = spans.owners(tr["spans"], a, b)
    edges = [a] + [x for iv in tr["busy"] for x in iv] + [b]
    j = 0
    for k in range(0, len(edges) - 1, 2):
        g0, g1 = edges[k], edges[k + 1]
        if g1 <= g0:
            continue
        while pieces[j][1] <= g0:
            j += 1
        for p0, p1, name in pieces[j:]:
            if p0 >= g1:
                break
            gaps[name] = gaps.get(name, 0.0) + (min(g1, p1)
                                                - max(g0, p0)) * 1e-6
    return gaps


def _breakdown(tr):
    """The device operations that took most time and the idle time by the
    span the host was in (``_idle_gaps``), ten of each, in seconds."""
    ops = {}
    for d in tr["device"]:
        name = _short(d["name"])
        ops[name] = ops.get(name, 0.0) + d["dur"] * 1e-6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:10]
    return {"device_ops": top(ops), "idle_gaps": top(_idle_gaps(tr))}


def _du(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(name, seed, seconds, trace, device="cuda", root=ROOT,
             here=None, data_dir=None, patch=None):
    """One run of cell ``name``; returns (result dict, the readings'
    table). ``patch(system)``, if given, may replace the system under test
    (the tests plant faults with it)."""
    import numpy as np
    import torch

    from fwibench import check, lib
    from fwibench.reference import grid, objective
    bench = lib.Bench(root, **({"here": here} if here else {}))
    work = bench.workload(name)
    config = bench.config(work["config"])
    # the reference's family and misfit first: a cell that cannot be
    # judged gets no set-up and no window
    objective.find(config, work, bench.here)
    data_dir = data_dir or os.path.join(root, "model_data")
    dev_cuda = device == "cuda"

    # set-up: the seed's acquisition, the port's inputs, one gradient and
    # one trial
    src, rec = lib.acquisition(config, work, seed)
    marks = [("imports", perf_counter())]
    system = bench.family(config["family"]).setup(config, work, src,
                                                  data_dir, device)
    marks.append(("models and data", perf_counter()))
    if patch is not None:
        system = patch(system)
    from devito_fwi_tpu_torch.optimize import LBFGS, minimize
    from devito_fwi_tpu_torch.optimize import checkpoint  # noqa: F401
    for grad in (True, False):
        system.loss(system.m0, system.geometry, *system.run_args,
                    calc_grad=grad)
        marks.append(("warm-up " + ("gradient" if grad else "trial"),
                      perf_counter()))
    opt = work["optimizer"]
    prof = _Profiler(work["trace"]["skip_iterations"],
                     work["trace"]["iterations"]) if trace else None
    if prof is not None:
        prof.warm()
    if dev_cuda:
        torch.cuda.synchronize()
    setup_s = perf_counter() - T0
    t = T0
    parts = []
    for label, m in marks:
        parts.append(f"{label} {m - t:.3f}")
        t = m
    print(f"fwibench: set-up {setup_s:.3f} s: {', '.join(parts)}",
          file=sys.stderr)

    # the window
    recorder = lib.Recorder(system.loss, seconds,
                            stuck_trials=2 * (opt["max_ls"] + 1),
                            tracer=prof.tracer if prof else None,
                            span=prof.span if prof else None)
    tmp = tempfile.mkdtemp(prefix="fwibench-")
    inversions = stuck = 0
    try:
        with open(os.path.join(tmp, "stdout"), "w") as out, \
                contextlib.redirect_stdout(out):
            eager0 = system.eager()
            recorder.start()
            while True:
                # one inversion of at most max_iterations from the start;
                # the window runs them one after another
                inversions += 1
                log_path = os.path.join(tmp, f"log{inversions}")
                optimizer = LBFGS(memory=opt["memory"],
                                  ls_method=opt["ls_method"],
                                  step_len_init=opt["step_len_init"],
                                  step_len_max=opt["step_len_max"],
                                  max_ls=opt["max_ls"], log_path=log_path)
                inversion = minimize(optimizer,
                                     maxIter=opt["max_iterations"],
                                     ftol=opt["ftol"], gtol=opt["gtol"],
                                     checkpoint_freq=opt["checkpoint_freq"],
                                     loss_fn=recorder, log_path=log_path)
                n_calls = len(recorder.calls)
                try:
                    inversion.run(system.m0.copy(), system.geometry,
                                  *system.run_args, system.bounds)
                except lib.WindowEnd:
                    break
                except lib.InversionStuck:
                    stuck += 1
                if len(recorder.calls) == n_calls:
                    recorder.t_end = perf_counter()
                    break
            eager = system.eager() - eager0
        if prof is not None:
            prof.stop()
        written = _du(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() if dev_cuda else 0
    print(f"fwibench: {name} seed {seed}: {len(recorder.calls)} calls in "
          f"{inversions} inversion(s), {stuck} stopped in a line search "
          f"that failed twice on one direction; {written} bytes of dumps "
          f"and checkpoints written", file=sys.stderr)

    calls = recorder.calls
    iterations = 0
    for c in calls:
        iterations += c["grad"]
        c["profiled"] = bool(prof and prof.perturbed(iterations))
    nt = grid.num_steps(config["tn"], float(system.geometry.dt))
    record = {"setup_s": setup_s, "window_s": recorder.t_end
              - recorder.t_start, "t_end": recorder.t_end,
              "iterations": iterations, "calls": calls, "trace": None,
              "sizes": lib.sizes(config, nt, work),
              "family": config["family"],
              "peaks": lib.peaks(torch.cuda.get_device_name(0))
              if dev_cuda else None, "bench": bench}
    breakdown = None
    if prof is not None and prof.prof is not None:
        runs = os.path.join(here or lib.HERE, "_runs")
        os.makedirs(runs, exist_ok=True)
        path = os.path.join(runs, f"{name}.trace.json")
        prof.prof.export_chrome_trace(path)
        record["trace"] = _trace_record(path)
        if record["trace"] is not None:
            breakdown = _breakdown(record["trace"])

    metrics = {}
    units = {m["name"]: m["unit"] for m in
             bench.spec["end_to_end"] + bench.spec["per_layer"]}
    for metric in bench.metrics(name, bool(trace)):
        value = bench.metric(metric).read(record)
        if value is not None:
            metrics[metric] = {"value": float(value), "unit": units[metric]}

    # free the program's state, then the reference follows the first
    # iteration from the same inputs
    first = recorder.first
    m0 = system.m0
    del system, recorder, inversion, optimizer
    gc.collect()
    if dev_cuda:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ref_obj = objective.build(config, work, src, rec, data_dir, device,
                              here=bench.here)
    ref = lib.follow_reference(ref_obj, m0, config, work)
    values = check.readings(first, ref)
    values["eager_calls"] = eager
    correct, table = check.judge(values, dict(work["check"]["limits"],
                                              eager_calls=0))
    failed = eager + stuck + sum(1 for c in calls
                                 if not np.isfinite(c["f"]))

    result = {"correct": bool(correct), "attempted": len(calls),
              "failed": int(failed), "metrics": metrics,
              "device": {"platform": "gpu" if dev_cuda else "cpu",
                         "kind": torch.cuda.get_device_name(0)
                         if dev_cuda else "cpu",
                         "count": work["chips"],
                         "memory_peak_bytes": int(peak)}}
    if record["trace"] is not None:
        result["device"]["busy_s"] = record["trace"]["busy_s"]
        result["device"]["window_s"] = record["trace"]["window_s"]
        result["breakdown"] = breakdown
    result["check"] = table
    return result, table


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # a run that is still going when its time is nearly out says where
    faulthandler.dump_traceback_later(330, exit=False)
    import torch
    torch.set_num_threads(1)

    from fwibench import check, lib
    from fwibench.reference.objective import Missing
    chips = lib.Bench(ROOT).workload(args.workload)["chips"]
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < chips:
        print(f"fwibench: the cell needs {chips} CUDA card(s); torch sees "
              f"{seen}", file=sys.stderr)
        return 2
    print(f"fwibench: card {_power_limit()}", file=sys.stderr)
    try:
        result, table = run_cell(args.workload, args.seed, args.seconds,
                                 args.trace)
    except Missing as e:
        print(f"fwibench: {e}; no result", file=sys.stderr)
        return 4
    bad = forbidden_modules()
    if bad:
        print(f"fwibench: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    faulthandler.cancel_dump_traceback_later()
    check.report(table)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
