"""The port's gradient audit (``tools/audit_gradient.py``) on the CPU
twins at a cut SMARMN (3 shots, 600 ms: 205 steps): the gradient composed
from its pieces (row 2, the objective's glue, row 3) is ``torch.equal`` to
``fwi_obj_multi``'s and its objective equal, the checkpoint pair (rows 4 +
5) gives the same gradient, and the traffic table reads every piece."""
import numpy as np
import pytest
import torch

from devito_fwi_tpu_torch import fwi as tfwi
from devito_fwi_tpu_torch.tools import audit_gradient as audit

NSRC, TN = 3, 600.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def cut():
    geometry, obs, dw, mask = audit.build(NSRC, TN, device="cpu")
    f, g, _ = tfwi.fwi_obj_multi(geometry, obs, None, dw, mask, True,
                                 calc_grad=True, device="cpu")
    return geometry, obs, dw, mask, f, g


def test_cut_smarmn(cut):
    geometry = cut[0]
    assert geometry.nsrc == NSRC and geometry.nt == 205
    assert geometry.model.padded_shape == (380, 186)


def test_pieces_give_the_objective_gradient(cut):
    geometry, obs, dw, mask, f, g = cut
    fp, gp = audit.pieces(geometry, obs, dw, mask, device="cpu")
    assert fp == f
    assert torch.equal(torch.as_tensor(gp), torch.as_tensor(g))


def test_checkpoint_pair_gives_the_same_gradient(cut):
    geometry, obs, dw, mask, f, g = cut
    fc, gc = audit.checkpoint_gradient(geometry, obs, dw, mask,
                                       device="cpu")
    assert fc == f
    assert torch.equal(torch.as_tensor(gc), torch.as_tensor(g))


def test_report_reads_every_piece(cut):
    """The table of made-up times: one line a piece, the glue's share."""
    geometry = cut[0]
    st = tfwi._Setup(geometry, torch.device("cpu"))
    ms = {"whole objective": 80.0, "forward_dt2_segments": 30.0,
          "gradient_stream_segments": 28.0, "forward_rec_segments": 24.0,
          "checkpoint pair": 86.0}
    ms["glue"] = ms["whole objective"] - 58.0
    lines = []
    audit.report(ms, st, NSRC, out=lines.append)
    assert len(lines) == 1 + len(ms) + 2
    assert "27.5%" in lines[-2]
    field = NSRC * st.nz * st.nx * 4
    row2 = next(ln for ln in lines if ln.startswith("forward_dt2"))
    assert int(row2.split()[3]) == 4 * field


def test_main_on_cpu_checks_and_prints_no_time(capsys):
    out = audit.main(["--nsrc", "2", "--tn", "300", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "pieces equal the objective: True (f True), the checkpoint "\
        "pair: True" in text
    assert "not measured" in text and "ms" not in out
    assert np.isfinite(out["g"]).all()
