"""The port's q-factor report (``tools/inversion_report.py``) on the
committed runs: on ``result_r5/`` (the JAX system's SMARMN inversions) it
gives the starting model's -14.88 dB, L2 200 iterations -22.39, L2 50
-14.27 and W2-2d -18.00 within 0.01 dB, each equal to the JAX package's
``optimize.math.q_factor`` on the same arrays; on ``result_torch/`` (the
port's runs on the card) it finds both runs with their logs, and their
final models reach the depth criteria."""
import os

import numpy as np
import pytest

from devito_fwi_tpu.models.presets import load_velocity as j_load
from devito_fwi_tpu.optimize.math import q_factor as j_q

from devito_fwi_tpu_torch.tools import inversion_report as rep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R5 = os.path.join(REPO, "result_r5")
TORCH = os.path.join(REPO, "result_torch")
SHAPE = (300, 106)
# q-factor (dB) of the committed JAX runs
WANT = {"start": -14.88, "result_r5/l2_200": -22.39,
        "result_r5/l2_50": -14.27, "result_r5/w2_50": -18.00}


@pytest.fixture(scope="module")
def r5():
    lines = []
    return rep.report([R5], out=lines.append), lines


@pytest.mark.parametrize("label", sorted(WANT))
def test_report_on_result_r5(r5, label):
    qs, _ = r5
    assert abs(qs[label] - WANT[label]) <= 0.01, (label, qs[label])


@pytest.mark.parametrize("label", sorted(WANT))
def test_report_equals_the_jax_q_factor(r5, label):
    qs, _ = r5
    base = os.path.join(REPO, "model_data", "SMARMN")
    vt = j_load(os.path.join(base, "vp.true"), SHAPE)
    if label == "start":
        v = j_load(os.path.join(base, "vp.smooth_20"), SHAPE)
    else:
        run = label.split("/")[1]
        k = 2 if run.startswith("w2") else 0
        v = j_load(os.path.join(R5, run, "marmousi_result_misfit_%d" % k),
                   SHAPE)
    want = float(j_q(1.0 / v.astype(np.float64) ** 2,
                     1.0 / vt.astype(np.float64) ** 2))
    assert abs(qs[label] - want) <= 1e-9 * abs(want)


def test_report_rows_carry_the_logs(r5):
    """Iterations and first and last misfit from each run's misfit log."""
    _, lines = r5
    row = {ln.split()[0]: ln.split() for ln in lines[2:] if "/" in
           ln.split()[0] and " - " not in ln}
    assert row["result_r5/l2_200"][1:5] == ["L2", "200", "1.987e+07",
                                            "1.874e+04"]
    assert row["result_r5/w2_50"][1:5] == ["W2-2d", "28", "4.226e-06",
                                           "1.100e-07"]


def test_find_runs_reads_the_driver_layout(tmp_path):
    """A run directory in the driver's layout is found, one without its
    log is not."""
    vt = np.full(SHAPE, 2.0, np.float32)
    for name, log in (("a", True), ("b", False)):
        d = tmp_path / name
        (d / "log2").mkdir(parents=True)
        vt.tofile(str(d / "marmousi_result_misfit_2"))
        if log:
            (d / "log2" / "misfit").write_text(" 1.0e+00  2.0e+00\n")
    runs = rep.find_runs(str(tmp_path))
    assert [(r.name, r.misfit, r.log.shape) for r in runs] == [
        ("a", 2, (1, 2))]


def test_port_depth_runs_reach_their_q_factors():
    """The port's committed SMARMN runs on the card: L2 (200 iterations)
    at -20.9 dB or better, W2-2d at -16.5 dB or better and better than the
    start, and the L2 run's first logged line equal to the JAX run's."""
    qs = rep.report([TORCH], out=lambda s: None)
    assert qs["result_torch/l2_200"] <= -20.9
    assert qs["result_torch/w2_50"] <= -16.5
    assert qs["result_torch/w2_50"] < qs["start"]
    runs = {r.name: r for r in rep.find_runs(TORCH)}
    assert runs["l2_200"].log.shape[0] == 200
    first = open(os.path.join(TORCH, "l2_200", "log0", "misfit")).readline()
    assert first == open(os.path.join(R5, "l2_200", "log0",
                                      "misfit")).readline()


def test_figures_draw_both_files(tmp_path):
    import matplotlib
    matplotlib.use("Agg")
    rep.figures([R5], str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["marmousi_models.png",
                                            "misfit_curves.png"]
