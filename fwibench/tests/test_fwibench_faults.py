"""The comparison fails what it has to fail, on the tiny cells on the CPU:
a whole run with the timed path broken underneath comes out not correct
for each fault a one-card inversion cell can have (a step that leaves the
model unchanged; half of the shots left out and the mean taken over the
rest; an answer altered where it is produced), a sound run comes out
correct, and the bfloat16-storage control reads above the limits. (The
exchange between cards is a fault these one-card cells cannot have.)"""
import numpy as np
import pytest
import torch

from fwibench import check, control, lib, run
from fwibench.tests import tiny

CELLS = ["tiny-acoustic", "tiny-elastic"]
SEED = 4_294_967_311  # past 32 bits


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    torch.set_num_threads(1)
    return tiny.make(str(tmp_path_factory.mktemp("fwibench")))


def _run(tree, cell, patch=None):
    root, here, data = tree
    result, table = run.run_cell(cell, SEED, 1.0, 0, device="cpu",
                                 root=root, here=here, data_dir=data,
                                 patch=patch)
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tree, cell):
    result = _run(tree, cell)
    assert result["correct"], result["check"]
    assert result["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_unchanged_step_is_not_correct(tree, cell, monkeypatch):
    from devito_fwi_tpu_torch.optimize import optimizers
    orig = optimizers.base.update_search

    def accept_nothing(self, alpha, fval):
        alpha, status = orig(self, alpha, fval)
        return (0.0 if status > 0 else alpha), status
    monkeypatch.setattr(optimizers.base, "update_search", accept_nothing)
    result = _run(tree, cell)
    assert not result["correct"]
    assert result["check"]["step"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_shots_is_not_correct(tree, cell):
    def half(system):
        loss = system.loss
        nsrc = system.geometry.nsrc

        def halved(x, *a, shot_indices=None, **k):
            f, g, res = loss(x, *a, shot_indices=np.arange(0, nsrc, 2), **k)
            scale = nsrc / len(range(0, nsrc, 2))
            return f * scale, None if g is None else g * scale, res
        system.loss = halved
        return system
    result = _run(tree, cell, patch=half)
    assert not result["correct"]
    assert result["check"]["f0"]["value"] > result["check"]["f0"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_altered_traces_are_not_correct(tree, cell, monkeypatch):
    from devito_fwi_tpu_torch import elastic_fwi, fwi
    if cell == "tiny-acoustic":
        orig = fwi._traces_from_rows

        def altered(*a, **k):
            rec = orig(*a, **k)
            rec[0] = rec[0] * 1.001
            return rec
        monkeypatch.setattr(fwi, "_traces_from_rows", altered)
    else:
        orig = elastic_fwi._Tables.traces

        def altered(self, rows):
            rec = orig(self, rows)
            rec[0] = rec[0] * 1.001
            return rec
        monkeypatch.setattr(elastic_fwi._Tables, "traces", altered)
    result = _run(tree, cell)
    assert not result["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_bfloat16_control_is_not_correct(tree, cell):
    root, here, data = tree
    values = control.readings(cell, SEED, "cpu", root, here, data)
    work = lib.Bench(root, here=here).workload(cell)
    ok, table = check.judge(values, work["check"]["limits"])
    assert not ok, table
