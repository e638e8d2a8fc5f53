"""The harness finds a cell, a configuration, a metric and a role by
name from files of their own: a dummy cell, metric and role added as
files (and entries of BENCHMARK.json) in a copy are found without an edit
to any file there. The last line a run prints parses to the contract's
keys, and a run without a card exits non-zero and prints nothing."""
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
