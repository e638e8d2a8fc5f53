"""The reader of ``legendre_kernel_pct`` (the anchored Legendre passes that
ran on the kernel over the certificate reads, ``misfit.bfm.COUNTS``) on
planted counts, as ``test_fwibench_w2.py`` holds the misfit layer's other
counter readers, and its entry in ``BENCHMARK.json``."""
import importlib
import json
import os

from fwibench import lib

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = lib.Bench(os.path.dirname(HERE))


def test_legendre_kernel_pct_reads_the_counts(monkeypatch):
    bfm = importlib.import_module("devito_fwi_tpu_torch.misfit.bfm")
    read = BENCH.metric("legendre_kernel_pct").read
    counts = dict(bfm.COUNTS, legendre_reads=120, legendre_kernel=120)
    monkeypatch.setattr(bfm, "COUNTS", counts)
    assert read({}) == 100.0
    counts.update(legendre_kernel=30)
    assert read({}) == 25.0
    # nothing read: no pass took the anchored route
    counts.update(legendre_reads=0, legendre_kernel=0)
    assert read({}) is None


def test_legendre_kernel_pct_without_the_counter(monkeypatch):
    """A program without the kernel's counter (the parent of the change
    that added it) reads nothing, and does not raise."""
    bfm = importlib.import_module("devito_fwi_tpu_torch.misfit.bfm")
    counts = {k: v for k, v in bfm.COUNTS.items() if k != "legendre_kernel"}
    counts.update(legendre_reads=120)
    monkeypatch.setattr(bfm, "COUNTS", counts)
    assert BENCH.metric("legendre_kernel_pct").read({}) is None
    monkeypatch.setattr(bfm, "COUNTS", {})
    assert BENCH.metric("legendre_kernel_pct").read({}) is None


def test_legendre_kernel_pct_is_a_misfit_metric_of_the_w2_cell():
    spec = json.load(open(os.path.join(os.path.dirname(HERE),
                                       "BENCHMARK.json")))
    entry, = [m for m in spec["per_layer"]
              if m["name"] == "legendre_kernel_pct"]
    fallback, = [m for m in spec["per_layer"]
                 if m["name"] == "legendre_fallback_pct"]
    assert entry["layer"] == fallback["layer"]
    assert entry["moves"] == "trial_ms" and entry["unit"] == "%"
    assert entry["workloads"] == ["smarmn-w2-lbfgs"]
    assert BENCH.metrics("smarmn-w2-lbfgs", True)[-1] == "legendre_kernel_pct"
