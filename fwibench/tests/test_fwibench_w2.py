"""The plain W2-2d reference (``reference/misfits/w2_2d.py``) against the
port on the CPU at float64:

* the misfit of seeded random gathers (2 x 64 x 24, positive and signed,
  4 BFM steps) against ``qWasserstein(gamma=1.01, method="2d")
  .torch_batch``: value to 1e-12 and residual to 1e-11 of its norm (they
  read 5e-15 and 3e-14: the same arithmetic, summed in another order; the
  port's anchored Legendre transform and banded or scatter pushforward
  equal the reference's full transform and scatter where their
  certificates hold);
* the tiny acoustic cell under ``"misfit": 2`` (41 x 41, three shots, 15
  steps): the objective and gradient at the starting model and the whole
  first L-BFGS iteration (``reference/lbfgs.follow``) of the reference
  against the port's ``fwi_loss`` on the same inputs, to 1e-10 of the
  values and 1e-9 of the gradients' and the step's norms, the limits of
  the L2 comparison (they read 9e-13 and 1.3e-13);
* the pushforwards' count (``counts/bfm_push.py``) against values worked
  by hand at the SMARMN shapes and at one step of one 2 x 3 gather;
* the misfit layer's metric readers on a synthetic trace;
* the control of ``control_misfit``: the control's objective solves its
  misfit in the lowered precision, the reference's in float64; the
  reference's ``dtype`` reaches the solve.
"""
import importlib
import json
import os

import numpy as np
import pytest
import torch

from fwibench import lib
from fwibench.reference import lbfgs, objective
from fwibench.tests import tiny
from fwibench.tests.test_fwibench_reference import _port_models

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = lib.Bench(os.path.dirname(HERE))


def _reference():
    return objective._by_file("misfits", "w2_2d", HERE, "misfit 2")


@pytest.mark.parametrize("low", [0.05, -0.5], ids=["positive", "signed"])
def test_w2_2d_matches_the_port_at_float64(low, monkeypatch):
    from devito_fwi_tpu_torch.misfit import qWasserstein
    torch.set_num_threads(1)
    ref = _reference()
    monkeypatch.setattr(ref, "NUM_STEPS", 4)
    g = torch.Generator().manual_seed(2611)
    syn, obs, dw = (torch.rand((2, 64, 24), generator=g,
                               dtype=torch.float64) + low for _ in range(3))
    value, res = ref.misfit(syn, obs, dw)
    port = qWasserstein(gamma=1.01, method="2d", num_steps=4,
                        step_scale=1.0)
    values, grads = port.torch_batch(syn - dw, obs - dw)
    assert res.dtype == torch.float64 and value != 0
    assert abs(value - float(values.sum())) <= 1e-12 * abs(value)
    assert float((res - grads).norm()) <= 1e-11 * float(grads.norm())


def test_w2_2d_hands_back_the_traces_dtype():
    ref = _reference()
    g = torch.Generator().manual_seed(7)
    syn, obs = (torch.rand((1, 40, 12), generator=g) for _ in range(2))
    value, res = ref.misfit(syn, obs, torch.zeros_like(syn))
    assert isinstance(value, float) and res.dtype == torch.float32


@pytest.fixture(scope="module")
def w2_cell(tmp_path_factory):
    """The tiny acoustic cell under misfit 2, in a copy of the benchmark's
    folder."""
    torch.set_num_threads(1)
    root, here, data = tiny.make(str(tmp_path_factory.mktemp("fwibench")))
    work = json.load(open(os.path.join(here, "workloads",
                                       "tiny-acoustic.json")))
    work.update(name="tiny-acoustic-w2", misfit=2)
    with open(os.path.join(here, "workloads", "tiny-acoustic-w2.json"),
              "w") as f:
        json.dump(work, f)
    return root, here, data


def test_tiny_w2_cell_first_iteration_matches_the_port(w2_cell):
    from devito_fwi_tpu_torch import fwi
    from devito_fwi_tpu_torch.drivers import _marmousi_common as marm
    from devito_fwi_tpu_torch.models.geometry import AcquisitionGeometry
    from fwibench.families.common import driver_config
    root, here, data_dir = w2_cell
    bench = lib.Bench(root, here=here)
    work = bench.workload("tiny-acoustic-w2")
    cfg = bench.config(work["config"])
    src, rec = lib.acquisition(cfg, work, 2026101926)
    ref = objective.build(cfg, work, src, rec, data_dir, "cpu",
                          dtype=torch.float64, here=here)
    models, smooth, _ = _port_models(cfg, data_dir, ref.dt, False)
    geoms = [AcquisitionGeometry(m, rec, src, 0., cfg["tn"], f0=cfg["f0"],
                                 src_type="Ricker") for m in models]
    obs = fwi.fm_multi(geoms[0], device="cpu")
    dw = fwi.fm_multi(geoms[2], device="cpu")
    misfit = marm.misfits(driver_config(cfg))[2]
    assert (misfit.num_steps, misfit.step_scale) == (15, 1.0)
    mask = np.ones(cfg["shape"])
    mask[:, :cfg["water_rows"]] = 0

    def port(x, calc_grad):
        f, g, _ = fwi.fwi_loss(x.copy(), geoms[1], obs, misfit, dw, mask,
                               True, calc_grad=calc_grad, device="cpu")
        return f, (g if calc_grad else None)

    m0 = 1.0 / smooth.reshape(-1).astype(np.float64) ** 2
    opt = work["optimizer"]
    args = (m0, lib.bounds(cfg), opt["step_len_init"], opt["step_len_max"],
            opt["max_ls"])
    want, got = lbfgs.follow(ref, *args), lbfgs.follow(port, *args)
    assert len(got["trials"]) == len(want["trials"]) >= 1
    for a, b in zip(got["f"] + [t[1] for t in got["trials"]],
                    want["f"] + [t[1] for t in want["trials"]]):
        assert abs(a - b) <= 1e-10 * abs(b)
    for a, b in zip(got["g"], want["g"]):
        assert np.linalg.norm(a - b) <= 1e-9 * np.linalg.norm(b)
    assert np.linalg.norm(got["m1"] - want["m1"]) <= \
        1e-9 * np.linalg.norm(want["m1"] - m0)


def test_bfm_push_count_by_hand():
    # 2 * 15 steps * 29 shots = 870 pushforwards of a 1357 x 300 gather:
    # 10 * 1358 * 301 + 36 * 4 * 1357 * 300 = 62_709_980 operations and
    # 12 * 1357 * 300 = 4_885_200 bytes each; the bytes bound the time,
    # 4_250_124_000 / 3.35e12 s
    sizes = lib.sizes(json.load(open(os.path.join(
        HERE, "configs", "smarmn-w2.json"))), 1357, {"misfit": 2})
    for kind in ("trial", "gradient"):
        assert BENCH.count("bfm_push").work(kind, sizes) == (
            54_557_682_600, 4_250_124_000)
    rec = {"peaks": lib.peaks("NVIDIA H100 80GB HBM3"), "bench": BENCH,
           "family": "acoustic", "sizes": sizes}
    assert lib.least_seconds(rec, "trial", "bfm_push") * 1e3 == \
        pytest.approx(1.2686937, rel=1e-6)
    # one step, one shot of 2 x 3 cells: 2 pushforwards of 10 * 3 * 4 +
    # 36 * 4 * 6 = 984 operations and 72 bytes
    small = dict(sizes, nt=2, nrec=3, shots=1, w2_num_steps=1)
    assert BENCH.count("bfm_push").work("trial", small) == (1968, 144)


def _span(name, ts, dur):
    return {"name": name, "ts": float(ts), "dur": float(dur)}


def _kernel(name, ts, dur, cat="kernel"):
    return {"name": name, "ts": float(ts), "dur": float(dur), "cat": cat}


def _w2_record():
    """Two traced trials of 100 us, each one solve of 80 us holding a
    Legendre span of 20 us with a 15 us kernel and a push span of 10 us
    with a 5 us push_slabs kernel, and a 10 us copy in the first solve
    outside both; a gradient whose solve is left out of the per-trial
    readings."""
    spans, dev = [], []
    for t0 in (0.0, 100.0):
        spans += [_span("objective.trial", t0, 100),
                  _span("fwi.misfit", t0 + 10, 85),
                  _span("fwi.bfm", t0 + 10, 80),
                  _span("fwi.bfm.legendre", t0 + 20, 20),
                  _span("fwi.bfm.push", t0 + 50, 10)]
        dev += [_kernel("void legendre_max(float*)", t0 + 22, 15),
                _kernel("void push_slabs(int const*)", t0 + 51, 5)]
    dev.append(_kernel("Memcpy DtoD", 12.0, 10, cat="gpu_memcpy"))
    spans += [_span("objective.gradient", 200, 100),
              _span("fwi.bfm", 210, 80),
              _span("fwi.bfm.legendre", 220, 20)]
    dev.append(_kernel("void legendre_max(float*)", 222.0, 15))
    dev.sort(key=lambda d: d["ts"])
    busy = lib.union([(d["ts"], d["ts"] + d["dur"]) for d in dev])
    return {"trace": {"spans": spans, "device": dev, "busy": busy,
                      "stretch": (0.0, 300.0)},
            "bench": BENCH, "family": "acoustic",
            "peaks": (67.0e12, 3.35e12),
            "sizes": lib.sizes(json.load(open(os.path.join(
                HERE, "configs", "smarmn-w2.json"))), 1357,
                {"misfit": 2})}


def test_misfit_span_readers():
    rec = _w2_record()
    assert BENCH.metric("bfm_ms.trial").read(rec) == pytest.approx(0.080)
    assert BENCH.metric("legendre_ms.trial").read(rec) == \
        pytest.approx(0.015)
    # three solves, 240 us, busy 10 + 2 * (15 + 5) + 15 = 65 us
    assert BENCH.metric("bfm_idle_pct").read(rec) == \
        pytest.approx(100.0 * (240 - 65) / 240)
    # the count's least time of a trial over 5 us of push_slabs a trial
    least = lib.least_seconds(rec, "trial", "bfm_push")
    assert BENCH.metric("w2_push_roofline").read(rec) == \
        pytest.approx(100.0 * least / 5e-6)
    for name in ("bfm_ms.trial", "legendre_ms.trial", "bfm_idle_pct",
                 "w2_push_roofline"):
        assert BENCH.metric(name).read(dict(rec, trace=None)) is None


def test_misfit_readers_without_the_programs_spans():
    """A program without the BFM's spans (the parent of the change that
    added them) reads nothing, and does not raise."""
    rec = _w2_record()
    tr = rec["trace"]
    tr["spans"] = [s for s in tr["spans"] if not s["name"].startswith(
        "fwi.bfm")]
    for name in ("bfm_ms.trial", "legendre_ms.trial", "bfm_idle_pct"):
        assert BENCH.metric(name).read(rec) is None


def test_misfit_counter_readers(monkeypatch):
    bfm = importlib.import_module("devito_fwi_tpu_torch.misfit.bfm")
    counts = dict(bfm.COUNTS, push_slab=30, push_banded=0, push_scatter=0,
                  legendre_reads=120, legendre_fallbacks=3)
    monkeypatch.setattr(bfm, "COUNTS", counts)
    assert BENCH.metric("push_slab_pct").read({}) == 100.0
    assert BENCH.metric("legendre_fallback_pct").read({}) == 2.5
    counts.update(push_banded=10, legendre_fallbacks=0)
    assert BENCH.metric("push_slab_pct").read({}) == 75.0
    assert BENCH.metric("legendre_fallback_pct").read({}) == 0.0
    monkeypatch.setattr(bfm, "COUNTS", {})
    assert BENCH.metric("push_slab_pct").read({}) is None
    assert BENCH.metric("legendre_fallback_pct").read({}) is None


class _Obj:
    def __init__(self, kw):
        self.kw = kw
        self._misfit = lambda syn, obs, dw, dtype=torch.float64: dtype


def test_misfit_control_lowers_the_solve(monkeypatch):
    """``control_misfit`` hands the control's objective (the one built
    with lowered fields) a misfit solving in the lowered precision, and
    leaves the reference's alone."""
    from fwibench import control_misfit
    built = []

    def build(*args, **kw):
        built.append(_Obj(kw))
        return built[-1]

    monkeypatch.setattr(objective, "build", build)
    low = dict(hist_dtype=torch.bfloat16, trace_dtype=torch.bfloat16)
    with control_misfit.misfit_in(torch.bfloat16):
        ref = objective.build(hist_dtype=None, trace_dtype=None)
        ctl = objective.build(**low)
    assert objective.build is build
    assert ref._misfit(0, 0, 0) == torch.float64
    assert ctl._misfit(0, 0, 0) == torch.bfloat16 and ctl.kw == low


def test_w2_2d_solves_in_the_dtype_it_is_given():
    ref = _reference()
    g = torch.Generator().manual_seed(11)
    syn, obs = (torch.rand((1, 40, 12), generator=g, dtype=torch.float64)
                + 0.1 for _ in range(2))
    dw = torch.zeros_like(syn)
    v64, r64 = ref.misfit(syn, obs, dw)
    v32, r32 = ref.misfit(syn, obs, dw, dtype=torch.float32)
    assert r32.dtype == torch.float64 and v32 != v64
    # a float32 solve lies up to ~1e-2 from the float64 one
    assert abs(v32 - v64) <= 1e-2 * abs(v64)
