"""The harness finds a cell, a configuration, a metric and a role by
name from files of their own: a dummy cell, metric and role added as
files (and entries of BENCHMARK.json) in a copy are found without an edit
to any file there. So are a family (the system under test, the
reference's objective and a count) and a reference misfit: the reference
follows the workload's misfit by its file, and a workload whose misfit
has no file stops before the program's set-up. The last line a run
prints parses to the contract's keys, and a run without a card exits
non-zero and prints nothing."""
import json
import os
import subprocess
import sys

import pytest
import torch

from fwibench import run
from fwibench.tests import tiny


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    torch.set_num_threads(1)
    return tiny.make(str(tmp_path_factory.mktemp("fwibench")))


def test_added_files_are_found_without_an_edit(tree):
    root, here, data = tree
    with open(os.path.join(here, "metrics", "calls_seen.py"), "w") as f:
        f.write('"""calls_seen: the objective calls of the window."""\n\n\n'
                "def read(rec):\n    return len(rec['calls'])\n")
    with open(os.path.join(here, "roles", "acoustic_any.json"), "w") as f:
        json.dump({"call": "gradient", "count": "acoustic",
                   "kernels": ["forward_tile"]}, f)
    work = json.load(open(os.path.join(here, "workloads",
                                       "tiny-acoustic.json")))
    work.update(name="tiny-acoustic-b", jitter=0.25)
    with open(os.path.join(here, "workloads", "tiny-acoustic-b.json"),
              "w") as f:
        json.dump(work, f)
    path = os.path.join(root, "BENCHMARK.json")
    spec = json.load(open(path))
    spec["workloads"].append({"name": "tiny-acoustic-b",
                              "config": "tiny-acoustic",
                              "traffic": "tiny-acoustic-b", "chips": 1,
                              "why": "dummy"})
    spec["end_to_end"].append({"name": "calls_seen", "unit": "calls",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["tiny-acoustic-b"]})
    with open(path, "w") as f:
        json.dump(spec, f)
    result, _ = run.run_cell("tiny-acoustic-b", 3, 1.0, 0, device="cpu",
                             root=root, here=here, data_dir=data)
    assert result["metrics"]["calls_seen"]["value"] == result["attempted"]
    assert result["correct"], result["check"]
    from fwibench import lib
    assert lib.Bench(root, here=here).role("acoustic_any")["kernels"] == \
        ["forward_tile"]


def _write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def _twin_cell(root, here, misfit, family="acoustic_twin"):
    """A configuration of ``family`` and a cell of it under ``misfit``,
    added as files: copies of the tiny acoustic ones."""
    cfg = json.load(open(os.path.join(here, "configs",
                                      "tiny-acoustic.json")))
    cfg.update(name="tiny-twin", family=family)
    _write(os.path.join(here, "configs", "tiny-twin.json"), json.dumps(cfg))
    work = json.load(open(os.path.join(here, "workloads",
                                       "tiny-acoustic.json")))
    work.update(name="tiny-twin", config="tiny-twin", misfit=misfit)
    _write(os.path.join(here, "workloads", "tiny-twin.json"),
           json.dumps(work))
    path = os.path.join(root, "BENCHMARK.json")
    spec = json.load(open(path))
    spec["workloads"].append({"name": "tiny-twin", "config": "tiny-twin",
                              "traffic": "tiny-twin", "chips": 1,
                              "why": "a family and a misfit added as files"})
    _write(path, json.dumps(spec))


L2_STAND_IN = '''"""Misfit 1 added as a file: L2 under its name, counting
its calls."""
import torch

CALLS = []


def misfit(syn, obs, dw):
    CALLS.append(tuple(syn.shape))
    res = (syn - dw) - (obs - dw)
    return float(0.5 * torch.sum(res.double() ** 2)), res
'''


@pytest.fixture
def fresh(tmp_path):
    torch.set_num_threads(1)
    return tiny.make(str(tmp_path))


def _spy(monkeypatch):
    """The reference modules loaded by file, as (kind, name, module)."""
    from fwibench.reference import objective
    seen, orig = [], objective._by_file

    def spy(kind, name, here, what):
        mod = orig(kind, name, here, what)
        seen.append((kind, name, mod))
        return mod
    monkeypatch.setattr(objective, "_by_file", spy)
    return seen


def test_added_family_and_misfit_are_found_without_an_edit(fresh,
                                                           monkeypatch):
    from devito_fwi_tpu_torch.misfit import least_square
    root, here, data = fresh
    _twin_cell(root, here, misfit=1)
    _write(os.path.join(here, "families", "acoustic_twin.py"),
           '"""A family added as a file."""\n'
           "from fwibench.families.acoustic import setup  # noqa: F401\n")
    _write(os.path.join(here, "counts", "acoustic_twin.py"),
           '"""Its count."""\n'
           "from fwibench.counts.acoustic import work  # noqa: F401\n")
    _write(os.path.join(here, "reference", "families", "acoustic_twin.py"),
           '"""Its reference objective."""\n'
           "from .acoustic import Objective  # noqa: F401\n")
    _write(os.path.join(here, "reference", "misfits", "w2_1d.py"),
           L2_STAND_IN)
    seen = _spy(monkeypatch)

    def as_l2(system):
        # the port's misfit 1 swapped for L2, the stand-in's arithmetic
        obs, _, dw, mask, precond = system.run_args
        system.run_args = (obs, least_square, dw, mask, precond)
        return system
    result, _ = run.run_cell("tiny-twin", 11, 1.0, 0, device="cpu",
                             root=root, here=here, data_dir=data,
                             patch=as_l2)
    assert result["correct"], result["check"]
    assert {(k, n) for k, n, _ in seen} == {
        ("families", "acoustic_twin"), ("misfits", "w2_1d")}
    assert all(m.__file__.startswith(here) for _, _, m in seen)
    # the reference's objective ran the planted misfit: the data of three
    # shots, once a call of its iteration
    calls = [c for k, _, m in seen if k == "misfits" for c in m.CALLS]
    assert len(calls) >= 4 and calls[0][0] == 3


def test_misfit_1_is_judged_by_its_own_module(fresh, monkeypatch):
    root, here, data = fresh
    _twin_cell(root, here, misfit=1, family="acoustic")
    _write(os.path.join(here, "reference", "misfits", "w2_1d.py"),
           '"""Misfit 1, planted to raise."""\n\n\n'
           "class Planted(Exception):\n    pass\n\n\n"
           "def misfit(syn, obs, dw):\n"
           "    raise Planted('w2_1d of the reference')\n")
    windows = []

    def watch(system):
        windows.append(system.run_args[1])
        return system
    with pytest.raises(Exception, match="w2_1d of the reference") as e:
        run.run_cell("tiny-twin", 12, 1.0, 0, device="cpu", root=root,
                     here=here, data_dir=data, patch=watch)
    assert type(e.value).__name__ == "Planted"
    # the program ran its own W2-1d in the window; the raise came from the
    # reference's objective, through the planted module
    assert windows and windows[0].method == "1d"
    frames = [(os.path.basename(str(t.path)), t.name)
              for t in e.traceback]
    assert ("objective.py", "misfit") in frames
    assert frames[-1] == ("w2_1d.py", "misfit")


@pytest.mark.parametrize("misfit,named", [
    (2, os.path.join("reference", "misfits", "w2_2d.py")),
    (3, "--misfit numbering")])
def test_missing_misfit_stops_before_the_set_up(fresh, monkeypatch, misfit,
                                                named):
    from fwibench import lib
    from fwibench.reference import objective
    root, here, data = fresh
    _twin_cell(root, here, misfit=misfit, family="acoustic")
    setups = []
    monkeypatch.setattr(lib.Bench, "family",
                        lambda self, name: setups.append(name))
    with pytest.raises(objective.Missing, match=named):
        run.run_cell("tiny-twin", 13, 1.0, 0, device="cpu", root=root,
                     here=here, data_dir=data)
    assert setups == []


def test_last_line_has_the_contract_keys(tree):
    root, here, data = tree
    result, table = run.run_cell("tiny-acoustic", 2 ** 31 + 9, 1.0, 0,
                                 device="cpu", root=root, here=here,
                                 data_dir=data)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "check"
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert {"iter_s", "gradient_ms", "trial_ms", "setup_s"} <= \
        set(line["metrics"])
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for name, t in line["check"].items():
        assert set(t) == {"value", "limit"}, name


def test_traced_run_reports_per_layer_metrics(tree):
    root, here, data = tree
    result, _ = run.run_cell("tiny-acoustic", 5, 4.0, 1, device="cpu",
                             root=root, here=here, data_dir=data)
    assert {"host_loop_ms", "trials_per_iter"} <= set(result["metrics"])
    assert "iter_s" not in result["metrics"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = subprocess.run([sys.executable, "-m", "fwibench.run",
                          "--workload", "smarmn-l2-lbfgs", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
