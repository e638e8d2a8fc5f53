"""The program's spans and its count of what the inversion loop writes, on
the CPU, for the acoustic and the elastic family (41 x 41, three shots):

* with no profiler, ``profiling.span`` is one shared no-op context and
  builds no ``record_function``;
* under ``torch.profiler``, a gradient exports the six ``fwi.*`` spans
  and a trial four, properly nested and in the objective's order, and
  none of the names the benchmark's harness keeps for itself;
* two ``minimize`` iterations emit the four ``loop.*`` spans each, and
  ``optimize.tools.COUNTS`` equals the bytes and files under ``log_path``;
* the objective, the gradient and the model after ``minimize`` are
  bit-identical with the profiler on and off.
"""
import json
import os

import numpy as np
import pytest
import torch

from devito_fwi_tpu_torch import elastic_fwi, fwi
from devito_fwi_tpu_torch.misfit import least_square
from devito_fwi_tpu_torch.models.geometry import AcquisitionGeometry
from devito_fwi_tpu_torch.models.model import SeismicModel
from devito_fwi_tpu_torch.optimize import LBFGS, minimize
from devito_fwi_tpu_torch.optimize import tools
from devito_fwi_tpu_torch.utils import profiling

FWI = ["fwi.prepare", "fwi.forward", "fwi.misfit", "fwi.adjoint",
       "fwi.imaging", "fwi.finish"]
LOOP = {"loop.direction", "loop.search", "loop.dumps", "loop.checkpoint"}
SHAPE, SPACING = (41, 41), (30.0, 30.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _models():
    """A water layer over two rock layers (km/s) and its smoothed start."""
    nx, nz = SHAPE
    z = np.arange(nz)[None, :].repeat(nx, 0)
    true = np.where(z < 3, 1.5, np.where(z < 20, 2.2, 3.0))
    true[15:25, 25:32] = 2.6
    k = np.ones(9) / 9
    smooth = np.apply_along_axis(lambda c: np.convolve(
        np.pad(c, 4, mode="edge"), k, "valid"), 1, true)
    smooth[:, :3] = 1.5
    return true.astype(np.float32), smooth.astype(np.float32)


@pytest.fixture(scope="module", params=["acoustic", "elastic"])
def problem(request):
    """(family, loss with fwi_loss's signature, starting geometry, observed
    data, starting model in squared slowness)."""
    family = request.param
    true, smooth = _models()

    def model(vp, dt):
        kw = dict(origin=(0, 0), spacing=SPACING, shape=SHAPE,
                  space_order=8, vp=vp, nbl=10, fs=False, dt=dt)
        if family == "acoustic":
            return SeismicModel(bcs="damp", **kw), None, None
        vs = (vp / np.sqrt(3.0)).astype(np.float32)
        vs[:, :3] = 0.0
        rho = (0.31 * (1e3 * vp) ** 0.25).astype(np.float32)
        rho[:, :3] = 1.0
        return SeismicModel(vs=vs, b=1.0 / rho, bcs="mask", **kw), vs, rho

    # the elastic drivers' dt: stable up to the inversion's 5.2 km/s bound
    dt = 2.95 if family == "acoustic" else float(
        model(true, None)[0].critical_dt) * float(true.max()) / 5.2
    src = np.zeros((3, 2))
    src[:, 0] = np.linspace(0.0, 1200.0, 3)
    src[:, 1] = 60.0
    rec = np.zeros((41, 2))
    rec[:, 0] = np.linspace(30.0, 1170.0, 41)
    rec[:, 1] = 60.0
    (true_m, _, _), (start_m, vs, rho) = model(true, dt), model(smooth, dt)
    true_g, start_g = (AcquisitionGeometry(m, rec, src, 0.0, 300.0, f0=0.01,
                                           src_type="Ricker")
                       for m in (true_m, start_m))
    if family == "acoustic":
        obs = fwi.fm_multi(true_g, device="cpu")

        def loss(*args, **kw):
            return fwi.fwi_loss(*args, device="cpu", **kw)
    else:
        obs, _ = elastic_fwi.elastic_fm_multi(true_g, device="cpu")
        loss = elastic_fwi.ElasticFwiLoss(vs, rho, device="cpu")
    m0 = 1.0 / smooth.reshape(-1).astype(np.float64) ** 2
    return family, loss, start_g, obs, m0


def _profile(fn, path):
    """fn() under ``torch.profiler`` on the CPU: (its result, the host
    annotations of the exported trace as (name, start, end) in order)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation")
    return out, sorted(spans, key=lambda s: (s[1], -s[2]))


def _assert_nested(spans):
    """Any two spans are disjoint, or one holds the other."""
    for i, (_, a0, a1) in enumerate(spans):
        for _, b0, b1 in spans[i + 1:]:
            assert b0 >= a1 or b1 <= a1, (spans[i], (b0, b1))


def _no_harness_names(spans):
    assert not [n for n, _, _ in spans
                if n.startswith("objective.") or n == "iteration"]


def test_span_is_a_shared_null_context_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("fwi.prepare"), profiling.span("loop.dumps")
    assert a is b
    with a as entered:
        assert entered is None


@pytest.mark.parametrize("calc_grad", [True, False],
                         ids=["gradient", "trial"])
def test_objective_spans_and_results_on_and_off(problem, calc_grad,
                                                tmp_path):
    family, loss, geometry, obs, m0 = problem
    x = m0 * 1.02

    def call():
        return loss(x.copy(), geometry, obs, least_square, None, None,
                    True, calc_grad=calc_grad)

    f_off, g_off, _ = call()
    (f_on, g_on, _), spans = _profile(call, tmp_path / "trace.json")
    assert f_on == f_off
    if calc_grad:
        assert g_on.dtype == np.float64 and np.array_equal(g_on, g_off)
        assert np.abs(g_on).max() > 0
    _no_harness_names(spans)
    _assert_nested(spans)
    names = [n for n, _, _ in spans]
    first = sorted(set(names), key=names.index)
    want = FWI if calc_grad else ["fwi.prepare", "fwi.forward",
                                  "fwi.misfit", "fwi.finish"]
    assert first == want
    # one shot chunk: its spans between the last prepare and the first
    # finish
    last_prepare = max(s for n, s, _ in spans if n == "fwi.prepare")
    first_finish = min(s for n, s, _ in spans if n == "fwi.finish")
    assert all(last_prepare < s < first_finish
               for n, s, _ in spans if n in want[1:-1])


def _on_disk(path):
    sizes = [os.path.getsize(os.path.join(d, f))
             for d, _, fs in os.walk(path) for f in fs]
    return sum(sizes), len(sizes)


def _inversion(problem, log_path):
    """A two-iteration L-BFGS inversion of ``problem`` logging under
    ``log_path``: (the run, its minimize). Its optimizer's set-up writes
    the first line of ``step_count`` and then, as the reference's does,
    removes the file with the others of an earlier run."""
    family, loss, geometry, obs, m0 = problem
    opt = LBFGS(memory=10, ls_method="Bracket", step_len_init=0.1,
                step_len_max=0.5, max_ls=5, log_path=str(log_path))
    inv = minimize(opt, maxIter=2, ftol=1e-30, gtol=1e-10,
                   checkpoint_freq=1, loss_fn=loss, log_path=str(log_path))

    def run():
        return inv.run(m0.copy(), geometry, obs, least_square, None, None,
                       True, [1.0 / 5.2 ** 2, 1.0 / 1.5 ** 2])
    return run, inv


def test_minimize_loop_spans_and_write_counts(problem, tmp_path):
    m_off = _inversion(problem, tmp_path / "off")[0]()
    tools.reset_counters()
    run, _ = _inversion(problem, tmp_path / "on")
    nbytes0, nfiles0 = _on_disk(tmp_path / "on")
    assert tools.COUNTS == {"bytes_written": nbytes0 + len("%e\n" % 0),
                            "files_written": nfiles0 + 1}
    tools.reset_counters()
    m_on, spans = _profile(run, tmp_path / "trace.json")
    assert np.array_equal(m_on, m_off)
    assert not np.array_equal(m_on, problem[4])
    _no_harness_names(spans)
    _assert_nested(spans)
    # iteration k runs from its direction to the next one: its search,
    # its checkpoint, its closing dumps and the next gradient's dumps
    dirs = [s for n, s, _ in spans if n == "loop.direction"]
    assert len(dirs) == 2
    for a, b in zip(dirs, dirs[1:] + [float("inf")]):
        assert {n for n, s, _ in spans if a <= s < b and n in LOOP} == LOOP
    assert sum(n == "loop.checkpoint" for n, _, _ in spans) == 2
    # the trials run outside the search's spans
    search = [(s, e) for n, s, e in spans if n == "loop.search"]
    prepares = [s for n, s, _ in spans if n == "fwi.prepare"]
    assert prepares and not any(a <= p < b for p in prepares
                                for a, b in search)
    nbytes, nfiles = _on_disk(tmp_path / "on")
    assert tools.COUNTS == {"bytes_written": nbytes - nbytes0,
                            "files_written": nfiles - nfiles0}
    assert os.path.isdir(tmp_path / "on" / "residual" / "0")
    assert _on_disk(tmp_path / "off") == (nbytes, nfiles)


def test_counted_writes_add_a_file_only_when_they_create_it(tmp_path):
    tools.reset_counters()
    path = str(tmp_path / "log")
    tools.append_text(path, "1.0\n")
    tools.append_text(path, "2.5\n")
    tools.write_array(np.zeros(5, np.float32), str(tmp_path / "a"))
    tools.write_array(np.zeros(3, np.float64), str(tmp_path / "a"))
    assert tools.COUNTS == {"bytes_written": 8 + 20 + 24,
                            "files_written": 2}
    tools.reset_counters()
    assert tools.COUNTS == {"bytes_written": 0, "files_written": 0}
