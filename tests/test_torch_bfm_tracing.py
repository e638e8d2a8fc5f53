"""The batch BFM's spans and its count of solves, on the CPU:

* under ``torch.profiler``, a W2-2d trial of a 41 x 41 acoustic problem
  (three shots, two BFM steps) records one ``fwi.bfm`` span a solve inside
  the shot chunk's ``fwi.misfit``, and inside it two ``fwi.bfm.poisson``,
  four ``fwi.bfm.legendre`` and two ``fwi.bfm.push`` spans a step, all
  properly nested; the objective reads the same with the profiler on and
  off;
* ``COUNTS["solves"]`` counts one a ``bfm_batch`` call and
  ``reset_counts`` clears it with the other counts;
* ``bfm_batch``'s values and gradients are bit-identical with the
  profiler on and off, at float32 and float64.
"""
import importlib
import json

import numpy as np
import pytest
import torch

from devito_fwi_tpu_torch import fwi
from devito_fwi_tpu_torch.misfit import qWasserstein
from devito_fwi_tpu_torch.models.geometry import AcquisitionGeometry
from devito_fwi_tpu_torch.models.model import SeismicModel

# the module: the package exports the class ``bfm`` under the same name
T = importlib.import_module("devito_fwi_tpu_torch.misfit.bfm")

SHAPE, SPACING = (41, 41), (30.0, 30.0)
STEPS = 2
INNER = {"fwi.bfm.poisson": 2 * STEPS, "fwi.bfm.legendre": 4 * STEPS,
         "fwi.bfm.push": 2 * STEPS}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _profile(fn, path):
    """fn() under ``torch.profiler`` on the CPU: (its result, the host
    annotations of the exported trace as (name, start, end) in order)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
             for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    return out, sorted(spans, key=lambda s: (s[1], -s[2]))


def _inside(span, outer):
    return outer[1] <= span[1] and span[2] <= outer[2]


@pytest.fixture(scope="module")
def problem():
    """A trial of the W2-2d objective at a two-layer starting model."""
    nx, nz = SHAPE
    z = np.arange(nz)[None, :].repeat(nx, 0)
    true = np.where(z < 3, 1.5, np.where(z < 20, 2.2, 3.0)).astype(
        np.float32)
    start = np.where(z < 3, 1.5, 2.4).astype(np.float32)

    def geometry(vp):
        model = SeismicModel(origin=(0, 0), spacing=SPACING, shape=SHAPE,
                             space_order=8, vp=vp, nbl=10, fs=False,
                             dt=2.95, bcs="damp")
        src = np.zeros((3, 2))
        src[:, 0] = np.linspace(0.0, 1200.0, 3)
        src[:, 1] = 60.0
        rec = np.zeros((41, 2))
        rec[:, 0] = np.linspace(30.0, 1170.0, 41)
        rec[:, 1] = 60.0
        return AcquisitionGeometry(model, rec, src, 0.0, 300.0, f0=0.01,
                                   src_type="Ricker")

    obs = fwi.fm_multi(geometry(true), device="cpu")
    start_g = geometry(start)
    misfit = qWasserstein(gamma=1.01, method="2d", num_steps=STEPS)
    m0 = 1.0 / start.reshape(-1).astype(np.float64) ** 2

    def trial():
        return fwi.fwi_loss(m0.copy(), start_g, obs, misfit, None, None,
                            True, calc_grad=False, device="cpu")[0]
    return trial


def test_bfm_spans_nest_inside_the_misfit(problem, tmp_path):
    f_off = problem()
    T.reset_counts()
    f_on, spans = _profile(problem, tmp_path / "trace.json")
    assert f_on == f_off and np.isfinite(f_on) and f_on != 0
    for i, (_, a0, a1) in enumerate(spans):
        for _, b0, b1 in spans[i + 1:]:
            assert b0 >= a1 or b1 <= a1, (spans[i], (b0, b1))
    misfits = [s for s in spans if s[0] == "fwi.misfit"]
    solves = [s for s in spans if s[0] == "fwi.bfm"]
    assert len(solves) == T.COUNTS["solves"] == len(misfits) == 1
    assert _inside(solves[0], misfits[0])
    for name, count in INNER.items():
        inner = [s for s in spans if s[0] == name]
        assert len(inner) == count, name
        assert all(_inside(s, solves[0]) for s in inner), name
    assert T.COUNTS["push_slab"] + T.COUNTS["push_banded"] \
        + T.COUNTS["push_scatter"] == INNER["fwi.bfm.push"]


def _gathers(dtype, B=2, n2=64, n1=24, seed=5):
    g = torch.Generator().manual_seed(seed)
    f = torch.rand((B, n2, n1), generator=g, dtype=torch.float64) + 0.05
    h = torch.rand((B, n2, n1), generator=g, dtype=torch.float64) + 0.05
    return f.to(dtype), h.to(dtype)


def test_solves_are_counted_and_reset():
    f, g = _gathers(torch.float64)
    T.reset_counts()
    T.bfm_batch(f, g, num_steps=1)
    T.bfm_batch(f, g, num_steps=1)
    assert T.COUNTS["solves"] == 2
    assert T.COUNTS["push_slab"] + T.COUNTS["push_banded"] \
        + T.COUNTS["push_scatter"] == 4
    T.reset_counts()
    assert set(T.COUNTS.values()) == {0}
    assert "solves" in T.COUNTS


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_bfm_batch_reads_the_same_with_the_profiler_on(dtype, tmp_path):
    f, g = _gathers(dtype)
    loss_off, grad_off = T.bfm_batch(f, g, num_steps=3)
    (loss_on, grad_on), spans = _profile(
        lambda: T.bfm_batch(f, g, num_steps=3), tmp_path / "trace.json")
    assert torch.equal(loss_on, loss_off) and torch.equal(grad_on, grad_off)
    assert torch.isfinite(loss_on).all() and grad_on.abs().max() > 0
    assert [s[0] for s in spans].count("fwi.bfm") == 1
