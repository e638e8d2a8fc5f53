"""The metric arithmetic on synthetic records: the window over the
iterations, the percentile rule, host time outside calls, the union of
device intervals, self time, roofline shares (a role by its own count,
added as files), the trace's reading and the breakdown of the idle time
by the innermost span."""
import json
import os

import numpy as np
import pytest

from fwibench import lib, run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = lib.Bench(ROOT)


def _call(grad, t0, t1, profiled=False):
    return {"grad": grad, "t0": t0, "t1": t1, "f": 1.0,
            "profiled": profiled}


def _record(**kw):
    # three iterations: gradient 1.0 s, two trials 0.5 s each, 0.25 s of
    # host loop; the window ends where the fourth gradient is due
    calls = []
    t = 10.0
    for it in range(3):
        calls.append(_call(True, t, t + 1.0, profiled=it == 1))
        calls.append(_call(False, t + 1.0, t + 1.5, profiled=it == 1))
        calls.append(_call(False, t + 1.5, t + 2.0, profiled=it == 1))
        t += 2.25
    rec = {"setup_s": 7.5, "window_s": t - 9.5, "t_end": t,
           "iterations": 3, "calls": calls, "trace": None,
           "family": "acoustic", "bench": BENCH,
           "peaks": (67.0e12, 3.35e12),
           "sizes": lib.sizes(json.load(open(os.path.join(
               ROOT, "fwibench", "configs", "smarmn-acoustic.json"))),
               1357, {"misfit": 0})}
    rec.update(kw)
    return rec


def read(name, rec):
    return BENCH.metric(name).read(rec)


def test_end_to_end_readers():
    rec = _record()
    assert read("iter_s", rec) == pytest.approx((16.75 - 9.5) / 3)
    assert read("gradient_ms", rec) == pytest.approx(1000.0)
    assert read("trial_ms", rec) == pytest.approx(500.0)
    assert read("setup_s", rec) == 7.5
    assert read("trials_per_iter", rec) == pytest.approx(2.0)
    # the profiled iteration is left out of the host loop and the mfu
    assert read("host_loop_ms", rec) == pytest.approx(250.0)
    assert read("gradient_mfu_pct", rec) == pytest.approx(
        100 * 222_189_648_000 / 67.0e12 / 1.0)


def test_percentile_is_nearest_rank():
    assert lib.nearest_rank(list(range(1, 101)), 0.9) == 90
    assert lib.nearest_rank(list(range(1, 11)), 0.9) == 9
    assert lib.nearest_rank([5.0], 0.9) == 5.0
    calls = [_call(True, 0.0, float(k)) for k in range(1, 21)]
    rec = _record(calls=calls)
    assert read("gradient_p90_ms", rec) == pytest.approx(18000.0)


def test_union_of_intervals():
    assert lib.union([(5, 6), (0, 2), (1, 3), (3, 4)]) == [[0, 4], [5, 6]]
    assert lib.union([]) == []


def _trace(tmp_path):
    """One iteration of 100 us: a gradient span 0-60 with two sweep
    kernels of 20 us and one copy of 5 us, a trial span 60-90 with one
    sweep kernel of 10 us and a misfit kernel of 5 us."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "iteration",
           "ts": 1000.0, "dur": 100.0},
          {"ph": "X", "cat": "user_annotation",
           "name": "objective.gradient", "ts": 1000.0, "dur": 60.0},
          {"ph": "X", "cat": "user_annotation", "name": "objective.trial",
           "ts": 1060.0, "dur": 30.0},
          {"ph": "X", "cat": "kernel", "ts": 1005.0, "dur": 20.0,
           "name": "void forward_tile<4, false, 3, 2>(float const*)"},
          {"ph": "X", "cat": "kernel", "ts": 1020.0, "dur": 20.0,
           "name": "void adjoint_tile<4, false>(float const*)"},
          {"ph": "X", "cat": "gpu_memcpy", "ts": 1050.0, "dur": 5.0,
           "name": "Memcpy DtoH"},
          {"ph": "X", "cat": "kernel", "ts": 1065.0, "dur": 10.0,
           "name": "void forward_tile<4, false, 1, 2>(float const*)"},
          {"ph": "X", "cat": "kernel", "ts": 1080.0, "dur": 5.0,
           "name": "elementwise_kernel"},
          {"ph": "X", "cat": "cpu_op", "ts": 1000.0, "dur": 1.0,
           "name": "aten::add"}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return run._trace_record(str(path))


def test_trace_reading_and_layer_metrics(tmp_path):
    tr = _trace(tmp_path)
    # busy: 1005-1040 (two overlapping kernels), 1050-1055, 1065-1075,
    # 1080-1085 = 35 + 5 + 10 + 5 = 55 us of 100
    assert tr["window_s"] == pytest.approx(100e-6)
    assert tr["busy_s"] == pytest.approx(55e-6)
    rec = _record(trace=tr)
    assert read("device_idle_pct", rec) == pytest.approx(45.0)
    # glue of the gradient: 60 us less the 40 us of sweep kernels
    assert read("glue_ms.gradient", rec) == pytest.approx(0.020)
    least_g = 222_189_648_000 / 67.0e12
    assert read("acoustic_gradient_roofline", rec) == \
        pytest.approx(100 * least_g / 40e-6)
    least_t = 99_985_341_600 / 67.0e12
    assert read("acoustic_trial_roofline", rec) == \
        pytest.approx(100 * least_t / 10e-6)
    # the elastic roles find no kernel of theirs: no reading, never 0
    assert read("elastic_trial_roofline", rec) is None
    bd = run._breakdown(tr)
    assert bd["device_ops"][0] == ["forward_tile<4, false, 3, 2>",
                                   pytest.approx(20e-6)]
    gaps = dict(bd["idle_gaps"])
    # idle: 1000-1005, 1040-1050, 1055-1060 in the gradient (20 us),
    # 1060-1065, 1075-1080, 1085-1090 in the trial (15), 1090-1100 (10)
    assert gaps["objective.gradient"] == pytest.approx(20e-6)
    assert gaps["objective.trial"] == pytest.approx(15e-6)
    assert gaps["driver"] == pytest.approx(10e-6)


def test_role_reads_with_its_own_count(tmp_path):
    from fwibench.tests import tiny
    root, here, _ = tiny.make(str(tmp_path / "copy"))
    with open(os.path.join(here, "counts", "fixed.py"), "w") as f:
        f.write('"""A count added as a file: 6.7 TFLOP, no bytes."""\n\n\n'
                "def work(kind, sizes):\n"
                "    assert sizes['misfit'] == 0\n"
                "    assert sizes['w2_num_steps'] == 15\n"
                "    return 6.7e12, 0\n")
    with open(os.path.join(here, "roles", "acoustic_fixed.json"), "w") as f:
        json.dump({"call": "gradient", "count": "fixed",
                   "kernels": ["forward_tile", "adjoint_tile"]}, f)
    rec = _record(trace=_trace(tmp_path), bench=lib.Bench(root, here=here))
    # 0.1 s on 67 TFLOP/s over the gradient's 40 us of sweep kernels
    assert lib.role_share(rec, "acoustic_fixed") == pytest.approx(
        100 * 0.1 / 40e-6)
    # the existing roles name their family's count and read as they did
    for role in ("acoustic_gradient", "acoustic_trial", "elastic_gradient",
                 "elastic_trial"):
        assert BENCH.role(role)["count"] == role.split("_")[0]
    least = lib.least_seconds(rec, "gradient")
    assert least == lib.least_seconds(rec, "gradient", "acoustic") == \
        222_189_648_000 / 67.0e12
    assert lib.role_share(rec, "acoustic_gradient") == \
        100.0 * least * 1 / (40.0 * 1e-6)


def test_breakdown_names_the_innermost_span(tmp_path):
    """An iteration of 100 us: a trial 10-60 with fwi.prepare 10-20 in it
    and a kernel 25-55, loop.checkpoint 70-90 outside every call."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": n,
           "ts": 1000.0 + a, "dur": d}
          for n, a, d in (("iteration", 0, 100), ("objective.trial", 10, 50),
                          ("fwi.prepare", 10, 10),
                          ("loop.checkpoint", 70, 20))]
    ev.append({"ph": "X", "cat": "kernel", "name": "forward_tile",
               "ts": 1025.0, "dur": 30.0})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    tr = run._trace_record(str(path))
    gaps = dict(run._breakdown(tr)["idle_gaps"])
    assert gaps == pytest.approx({"fwi.prepare": 10e-6,
                                  "objective.trial": 10e-6,
                                  "loop.checkpoint": 20e-6,
                                  "driver": 30e-6})
    # the same total as with the harness's spans alone (trial 20, driver
    # 50): only the names move
    path.write_text(json.dumps({"traceEvents": [
        e for e in ev if not e["name"].startswith(("fwi.", "loop."))]}))
    plain = dict(run._breakdown(run._trace_record(str(path)))["idle_gaps"])
    assert plain == pytest.approx({"objective.trial": 20e-6,
                                   "driver": 50e-6})
    assert sum(gaps.values()) == pytest.approx(sum(plain.values()))
    assert sum(gaps.values()) == pytest.approx(tr["window_s"] - tr["busy_s"])


def test_readers_without_a_trace_return_nothing():
    rec = _record()
    for name in ("device_idle_pct", "glue_ms.gradient",
                 "acoustic_trial_roofline"):
        assert read(name, rec) is None
    assert read("gradient_mfu_pct", _record(peaks=None)) is None


def test_recorder_ends_the_window_and_stuck_searches():
    def loss(x, *a, **k):
        return 1.0, x.copy(), None
    rec = lib.Recorder(loss, seconds=0.0, stuck_trials=3)
    rec.start()
    x = np.zeros(4)
    args = (None, None, None)
    rec(x, *args, calc_grad=True)
    for _ in range(3):
        rec(x + 1, *args, calc_grad=False)
    with pytest.raises(lib.InversionStuck):
        rec(x, *args, calc_grad=False)
    rec(x + 2, *args, calc_grad=True)
    # the window is over, but only once two gradients are done
    with pytest.raises(lib.WindowEnd):
        rec(x, *args, calc_grad=True)
    assert len(rec.calls) == 5
    assert [len(rec.first[k]) for k in ("x", "f", "g", "trials")] == \
        [2, 2, 2, 3]
