"""The readers of the program's own spans and write count: their
arithmetic on a hand-built trace (self time of nested spans, the device's
idle time inside a span, per-chunk spans, a gap outside every span, the
breakdown's idle time by the innermost span), no reading without a trace
or on a trace that holds only the harness's spans, and a traced tiny cell
that reports them on the CPU."""
import json
import os

import pytest
import torch

from fwibench import lib, run
from fwibench.tests import tiny
from fwibench.tests.test_fwibench_metrics import _record

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = lib.Bench(ROOT)
SPAN_TIMES = ("prepare_ms.gradient", "prepare_ms.trial", "loop_io_ms",
              "lbfgs_ms")
NEW = SPAN_TIMES + ("finish_ms.gradient", "idle_unattributed_pct",
                    "loop_write_mb")


def read(name, rec):
    return BENCH.metric(name).read(rec)


def _iteration(t):
    """One iteration of 200 us from ``t``, as ``minimize`` runs it: a
    gradient of two shot chunks (0-80), 5 us outside every span, the
    misfit log, the direction, the search (with its log row nested), a
    trial, the search, the checkpoint, the closing dumps, 10 us outside
    every span. (name, start, duration) of host spans and of kernels."""
    spans = [("iteration", 0, 200), ("objective.gradient", 0, 80),
             ("fwi.prepare", 0, 10),
             ("fwi.forward", 10, 20), ("fwi.misfit", 30, 5),
             ("fwi.adjoint", 35, 15), ("fwi.imaging", 50, 3),
             ("fwi.forward", 53, 7), ("fwi.misfit", 60, 2),
             ("fwi.adjoint", 62, 6), ("fwi.imaging", 68, 2),
             ("fwi.finish", 70, 10),
             ("loop.dumps", 85, 10), ("loop.direction", 95, 5),
             ("loop.search", 100, 4), ("loop.dumps", 101, 2),
             ("objective.trial", 104, 46), ("fwi.prepare", 104, 4),
             ("fwi.prepare", 108, 2), ("fwi.forward", 110, 30),
             ("fwi.misfit", 140, 5), ("fwi.finish", 145, 5),
             ("loop.search", 150, 6), ("loop.dumps", 152, 3),
             ("loop.checkpoint", 156, 24), ("loop.dumps", 180, 10)]
    kernels = [("kernel", "void forward_tile<4, false, 7, 2>()", 12, 18),
               ("kernel", "elementwise_kernel", 31, 3),
               ("kernel", "void adjoint_tile<4, false>()", 36, 14),
               ("kernel", "void forward_tile<4, false, 7, 2>()", 54, 6),
               ("kernel", "void adjoint_tile<4, false>()", 62, 6),
               ("gpu_memcpy", "Memcpy DtoH", 70, 3),
               ("kernel", "void forward_tile<4, false, 1, 2>()", 111, 29),
               ("kernel", "elementwise_kernel", 141, 3)]
    ev = [{"ph": "X", "cat": "user_annotation", "name": n,
           "ts": t + a, "dur": float(d)} for n, a, d in spans]
    ev += [{"ph": "X", "cat": c, "name": n, "ts": t + a, "dur": float(d)}
           for c, n, a, d in kernels]
    return ev


def _trace(tmp_path, keep=lambda e: True):
    ev = [e for t in (1000.0, 1200.0) for e in _iteration(t) if keep(e)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return run._trace_record(str(path))


def test_span_readers_on_a_hand_built_trace(tmp_path):
    rec = _record(trace=_trace(tmp_path))
    # one fwi.prepare of 10 us a gradient; two of 4 and 2 us a trial
    assert read("prepare_ms.gradient", rec) == pytest.approx(0.010)
    assert read("prepare_ms.trial", rec) == pytest.approx(0.006)
    # fwi.finish 70-80 less the copy 70-73
    assert read("finish_ms.gradient", rec) == pytest.approx(0.007)
    # dumps 10 + 2 + 3 + 10 (the nested rows out of the search's self
    # time), checkpoint 24, an iteration
    assert read("loop_io_ms", rec) == pytest.approx(0.049)
    # direction 5, search 4 - 2 and 6 - 3
    assert read("lbfgs_ms", rec) == pytest.approx(0.010)
    # idle 200 - 82 us an iteration; outside every program span 5 + 10
    assert read("idle_unattributed_pct", rec) == pytest.approx(
        100 * 15 / 118)
    # what the harness's readers read is unchanged by the program's spans
    plain = _record(trace=_trace(tmp_path, lambda e: not e["name"].startswith(
        ("fwi.", "loop."))))
    for name in ("glue_ms.gradient", "device_idle_pct",
                 "acoustic_gradient_roofline", "acoustic_trial_roofline"):
        assert read(name, rec) == pytest.approx(read(name, plain))
    # the breakdown keeps the device's operations and its idle total, and
    # names the idle time by the innermost program span (an iteration:
    # prepare 10 + 4 + 2, finish 7 + 5, dumps 10 + 2 + 3 + 10, checkpoint
    # 24, outside every span 5 + 10 ...)
    bd, bd_plain = run._breakdown(rec["trace"]), run._breakdown(
        plain["trace"])
    assert bd["device_ops"] == bd_plain["device_ops"]
    gaps = run._idle_gaps(rec["trace"])
    assert sum(gaps.values()) == pytest.approx(sum(run._idle_gaps(
        plain["trace"]).values()))
    assert gaps == pytest.approx({
        "fwi.prepare": 32e-6, "fwi.forward": 8e-6, "fwi.misfit": 12e-6,
        "fwi.adjoint": 2e-6, "fwi.imaging": 10e-6, "fwi.finish": 24e-6,
        "loop.dumps": 50e-6, "loop.direction": 10e-6, "loop.search": 10e-6,
        "loop.checkpoint": 48e-6, "driver": 30e-6})
    assert [k for k, _ in bd["idle_gaps"]][:3] == [
        "loop.dumps", "loop.checkpoint", "fwi.prepare"]
    assert len(bd["idle_gaps"]) == 10


def test_span_readers_without_program_spans_return_nothing(tmp_path):
    # the parent's traced run: the harness's spans alone
    plain = _record(trace=_trace(tmp_path, lambda e: not e["name"].startswith(
        ("fwi.", "loop."))))
    for name in NEW:
        if name != "loop_write_mb":
            assert read(name, _record()) is None, name
            assert read(name, plain) is None, name


def test_loop_write_mb_reads_the_program_counter(monkeypatch):
    from devito_fwi_tpu_torch.optimize import tools
    tools.reset_counters()
    tools.count_file(6_000_000, True)
    tools.count_file(1_500_000, False)
    assert read("loop_write_mb", _record()) == pytest.approx(2.5)
    assert read("loop_write_mb", _record(iterations=0)) is None
    # a program without the counter
    monkeypatch.delattr(tools, "COUNTS")
    assert read("loop_write_mb", _record()) is None


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The tiny cells, with the program's span metrics listing them."""
    torch.set_num_threads(1)
    root, here, data = tiny.make(str(tmp_path_factory.mktemp("fwibench")))
    path = os.path.join(root, "BENCHMARK.json")
    spec = json.load(open(path))
    for m in spec["per_layer"]:
        if m["name"] in NEW:
            m["workloads"] += list(tiny.CELLS)
    with open(path, "w") as f:
        json.dump(spec, f)
    return root, here, data


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_traced_tiny_cell_reports_the_span_metrics(tree, cell):
    from devito_fwi_tpu_torch.optimize import tools
    root, here, data = tree
    tools.reset_counters()
    result, _ = run.run_cell(cell, 2 ** 31 + 17, 4.0, 1, device="cpu",
                             root=root, here=here, data_dir=data)
    got = result["metrics"]
    assert set(NEW) <= set(got), sorted(got)
    for name in SPAN_TIMES + ("finish_ms.gradient", "loop_write_mb"):
        assert got[name]["value"] > 0, name
    assert 0 <= got["idle_unattributed_pct"]["value"] < 100
    assert result["correct"], result["check"]
