"""The port's remaining drivers against the JAX package's scripts, on the
CPU: ``circle_fwi`` (cut down), its ``--resume``, ``run_fm`` of
``marmousi_fm`` and ``test_misfit``.

The JAX scripts run through ``runpy.run_path(..., run_name="__main__")``
(``drivers/_marmousi_common.py`` by file), with ``sys.argv`` set; the port's
through their ``main`` / ``run_fm`` with ``--device cpu``. The circle cut:
the same 2000 m square at 20 m (101 x 101) with nbl 10, every other
constant the driver's (space order 6, tn 1000 ms, 201 receivers on x = 1980
m); both drivers' ``demo_model`` is patched to it.
"""
import importlib
import os
import runpy
import sys

import numpy as np
import pytest
import torch

import devito_fwi_tpu
from devito_fwi_tpu.models.presets import demo_model as j_demo_model

from devito_fwi_tpu_torch import fwi as tfwi
from devito_fwi_tpu_torch.drivers import _marmousi_common as t_marm
from devito_fwi_tpu_torch.drivers import circle_fwi as t_circle
from devito_fwi_tpu_torch.drivers import test_misfit as t_test_misfit
from devito_fwi_tpu_torch.models.presets import demo_model as t_demo_model
from test_torch_models import _cut_down_smarmn, _jax_marmousi_common

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVERS = os.path.join(REPO, "drivers")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this module runs: the suite runs several
    pytest workers on one machine, and torch's thread pool in each of them
    (as many threads as cores) oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cut(demo_model, shape=(101, 101), spacing=(20., 20.), nbl=10):
    """``demo_model`` with the circle's grid cut down."""
    def cut(preset, **kw):
        kw.update(shape=shape, spacing=spacing, nbl=nbl)
        return demo_model(preset, **kw)
    return cut


def _record_jax_objective(monkeypatch):
    """The JAX minimize loop's objective calls, (calc_grad, value) in
    order."""
    jmin = importlib.import_module("devito_fwi_tpu.optimize.minimize")
    calls = []
    jloss = jmin.fwi_loss

    def recorded(*a, **k):
        out = jloss(*a, **k)
        calls.append((bool(a[7] if len(a) > 7 else k.get("calc_grad",
                                                          True)), out[0]))
        return out

    monkeypatch.setattr(jmin, "fwi_loss", recorded)
    return calls


def test_circle_fwi_matches_the_jax_driver(tmp_path, monkeypatch):
    """The cut-down circle driver, L2, 2 shots, 2 L-BFGS iterations: the
    port's objective calls (the eager route, counted in ``fwi.EAGER``) are
    the JAX driver's, in order and kind, each value within 1e-5 relative
    (both float32; measured 7.4e-6), the misfit decreasing, and both write
    the same result files."""
    jcalls = _record_jax_objective(monkeypatch)
    monkeypatch.setattr(devito_fwi_tpu, "demo_model", _cut(j_demo_model))
    monkeypatch.setattr(t_circle, "demo_model", _cut(t_demo_model))
    argv = ["--misfit", "0", "--maxiter", "2", "--nsrc", "2"]
    monkeypatch.setattr(sys, "argv", ["circle_fwi"] + argv +
                        ["--odir", str(tmp_path / "jax")])
    runpy.run_path(os.path.join(DRIVERS, "circle_fwi.py"),
                   run_name="__main__")
    tfwi.reset_counters()
    _, stats = t_circle.main(argv + ["--odir", str(tmp_path / "port"),
                                     "--device", "cpu"])
    port = [(c[0], c[1]) for c in stats["calls"]]
    assert [c[0] for c in port] == [c[0] for c in jcalls]
    assert tfwi.EAGER["objective"] == len(port)
    ft = np.array([c[1] for c in port])
    fj = np.array([c[1] for c in jcalls])
    grads = [i for i, c in enumerate(port) if c[0]]
    assert len(grads) == 2 and ft[grads[1]] < ft[grads[0]]
    assert np.allclose(ft, fj, rtol=1e-5, atol=0)
    for rel in ("circle_result_misfit_0", "log0/misfit", "log0/optim_info"):
        assert (tmp_path / "port" / rel).exists(), rel
        assert (tmp_path / "jax" / rel).exists(), rel
    vj = np.fromfile(tmp_path / "jax" / "circle_result_misfit_0", np.float32)
    vt = np.fromfile(tmp_path / "port" / "circle_result_misfit_0",
                     np.float32)
    assert vt.shape == vj.shape == (101 * 101,)


def test_circle_fwi_resume_appends_logs(tmp_path, monkeypatch, capsys):
    """The port's form of ``tests/test_examples.py::
    test_driver_resume_appends_logs``, cut down (51 x 51 at 40 m, nbl 10, 2
    shots): a second run with ``--resume 1`` picks up the latest checkpoint,
    prints "Resumed from", runs iteration 2 and appends one line to
    ``log0/misfit`` and a row to ``optim_info``."""
    monkeypatch.setattr(t_circle, "demo_model", _cut(
        t_demo_model, shape=(51, 51), spacing=(40., 40.)))
    odir = tmp_path / "res"
    argv = ["--misfit", "0", "--nsrc", "2", "--odir", str(odir),
            "--device", "cpu"]
    t_circle.main(argv + ["--maxiter", "1"])
    misfit_log = odir / "log0" / "misfit"
    n1 = len(misfit_log.read_text().splitlines())
    assert (odir / "log0" / "checkpoint" / "ckpt_000001.npz").exists()
    capsys.readouterr()
    t_circle.main(argv + ["--maxiter", "2", "--resume", "1"])
    out = capsys.readouterr().out
    assert "Resumed from" in out
    assert "Starting iteration 2" in out
    assert len(misfit_log.read_text().splitlines()) == n1 + 1
    table = (odir / "log0" / "optim_info").read_text()
    assert "         1 " in table and "         2 " in table


def test_circle_fwi_flags_and_defaults_match_the_jax_driver():
    """Every flag of the JAX driver, with its default, plus ``--device``
    (default cuda)."""
    jax_parser = runpy.run_path(os.path.join(DRIVERS, "circle_fwi.py"),
                                run_name="circle_fwi")["parser"]
    jargs = vars(jax_parser.parse_args([]))
    targs = vars(t_circle.make_parser().parse_args([]))
    assert targs.pop("device") == "cuda"
    assert targs == jargs
    assert (targs["nsrc"], targs["maxiter"]) == (11, 50)


def test_run_fm_writes_the_jax_drivers_files(tmp_path, monkeypatch):
    """``run_fm`` on the cut-down SMARMN (30 x 11, nbl 8, space order 4, tn
    400 ms, the fm form's flags, 3 shots) writes the JAX driver's files,
    ``data/obs<i>``, ``data/syn<i>`` and ``data/dw<i>``, float32 of the JAX
    shape, each within 1e-5 of its max (the port's twin of row 1's kernel
    against the Pallas kernel in interpret mode); the fm parser defaults to
    21 shots and has no inversion flags."""
    monkeypatch.setenv("DEVITO_FWI_TPU_PALLAS", "1")
    monkeypatch.setenv("DEVITO_FWI_TPU_PALLAS_INTERPRET", "1")
    cfg = _cut_down_smarmn(tmp_path)
    jmc = _jax_marmousi_common()
    argv = ["--nsrc", "3", "--data-dir", str(tmp_path / "data")]
    monkeypatch.setattr(sys, "argv", ["marmousi_fm"] + argv +
                        ["--odir", str(tmp_path / "jax")])
    jmc.run_fm(cfg)
    t_marm.run_fm(cfg, argv + ["--odir", str(tmp_path / "port"),
                               "--device", "cpu"])
    nt = None
    for name in ("obs", "syn", "dw"):
        for i in range(3):
            j = np.fromfile(tmp_path / "jax" / "data" / f"{name}{i}",
                            np.float32)
            t = np.fromfile(tmp_path / "port" / "data" / f"{name}{i}",
                            np.float32)
            assert t.shape == j.shape
            nt = j.size // 30
            assert np.abs(t - j).max() <= 1e-5 * np.abs(j).max(), (name, i)
    assert nt == 137  # 400 ms at dt 2.95
    fm = vars(t_marm.make_parser(cfg, fm=True).parse_args([]))
    assert fm["nsrc"] == 21 and fm["device"] == "cuda"
    assert set(fm) == set(vars(jmc.make_parser(cfg, fm=True).parse_args(
        []))) | {"device"}


def test_test_misfit_matches_the_jax_driver(tmp_path, monkeypatch, capsys):
    """``test_misfit`` in a fresh directory (no saved gathers: the shifted
    Ricker wavelets) writes the JAX driver's ``result/grad1d`` within 5e-5
    and ``result/grad2d`` within 1e-4 of the JAX driver's max, and both
    losses within the same figures relative (the JAX driver prints them to
    7 digits)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["test_misfit"])
    runpy.run_path(os.path.join(DRIVERS, "test_misfit.py"),
                   run_name="__main__")
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("W2-1d loss")][0].split()
    jloss = (float(line[2]), float(line[5]))
    jg = {k: np.fromfile(tmp_path / "result" / k, np.float32)
          for k in ("grad1d", "grad2d")}
    (loss1, _), (loss2, _) = t_test_misfit.main(["--device", "cpu"])
    for (k, tol), jl, tl in zip((("grad1d", 5e-5), ("grad2d", 1e-4)), jloss,
                                (loss1, loss2)):
        t = np.fromfile(tmp_path / "result" / k, np.float32)
        assert t.shape == jg[k].shape == (410 * 101,)
        assert np.abs(t - jg[k]).max() <= tol * np.abs(jg[k]).max(), k
        assert abs(tl - jl) <= tol * abs(jl), k
