"""The port's numpy layers (devito_fwi_tpu_torch.models, utils.fd,
ops.interp, convert, the SMARMN driver setup) are the JAX package's,
array for array: every comparison here is ``np.array_equal``."""
import importlib
import importlib.util
import os
from types import SimpleNamespace

import numpy as np
import pytest

from devito_fwi_tpu.models.presets import demo_model as j_demo_model
from devito_fwi_tpu.models.geometry import AcquisitionGeometry as JGeometry
from devito_fwi_tpu.models.sources import ricker_wavelet as j_ricker
from devito_fwi_tpu.ops.interp import interp_table as j_interp
from devito_fwi_tpu.utils import fd as j_fd

from devito_fwi_tpu_torch.convert import model_from_numpy
from devito_fwi_tpu_torch.drivers import _marmousi_common as t_marm
from devito_fwi_tpu_torch.models.presets import demo_model as t_demo_model
from devito_fwi_tpu_torch.models.geometry import (AcquisitionGeometry as
                                                  TGeometry)
from devito_fwi_tpu_torch.models.sources import ricker_wavelet as t_ricker
from devito_fwi_tpu_torch.ops.interp import (interp_table as t_interp,
                                             valid_corners)
from devito_fwi_tpu_torch.utils import fd as t_fd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_marmousi_common():
    spec = importlib.util.spec_from_file_location(
        "jax_marmousi_common",
        os.path.join(REPO, "drivers", "_marmousi_common.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("space_order", [2, 4, 8, 16])
def test_fd_weights_and_cfl_equal(space_order):
    assert np.array_equal(t_fd.second_derivative_weights(space_order),
                          j_fd.second_derivative_weights(space_order))
    for ndim in (2, 3):
        assert t_fd.cfl_coefficient(space_order, ndim) == \
            j_fd.cfl_coefficient(space_order, ndim)


@pytest.mark.parametrize("fs", [False, True])
@pytest.mark.parametrize("abc_type", ["damp", "mask"])
def test_damping_profile_equal(fs, abc_type):
    pads = [(40, 40), (0 if fs else 40, 40)]
    shape = (380, 146 if fs else 186)
    args = (shape, pads, (30., 30.))
    assert np.array_equal(
        t_fd.damping_profile(*args, abc_type=abc_type, fs=fs),
        j_fd.damping_profile(*args, abc_type=abc_type, fs=fs))


def test_interp_table_equal_and_masked():
    rng = np.random.RandomState(0)
    # points inside, on the edge and outside a padded 81 x 61 grid
    coords = rng.uniform(-150., 900., size=(64, 2))
    origin, spacing = (-100., -100.), (10., 10.)
    ti, tw = t_interp(coords, origin, spacing)
    ji, jw = j_interp(coords, origin, spacing)
    assert np.array_equal(ti, ji) and np.array_equal(tw, jw)
    valid, cl = valid_corners(ti, (81, 61))
    assert ((cl >= 0) & (cl < np.array([81, 61]))).all()
    inside = ((ti >= 0) & (ti < np.array([81, 61]))).all(-1)
    assert np.array_equal(valid, inside)
    assert not valid.all() and valid.any()


@pytest.mark.parametrize("fs", [False, True])
def test_models_geometry_wavelet_equal(fs):
    kw = dict(vp_circle=3.0, vp_background=2.5, origin=(0., 0.),
              shape=(61, 51), spacing=(10., 12.), nbl=10, space_order=4,
              fs=fs)
    tm, jm = t_demo_model("circle-isotropic", **kw), \
        j_demo_model("circle-isotropic", **kw)
    assert np.array_equal(tm.vp, jm.vp) and np.array_equal(tm.damp, jm.damp)
    assert tm.critical_dt == jm.critical_dt
    assert tm.padded_shape == jm.padded_shape
    assert tm.origin_pml == jm.origin_pml
    src = np.array([[100., 20.], [300., 20.]])
    rec = np.stack([np.linspace(0., 600., 31), np.full(31, 24.)], 1)
    tg = TGeometry(tm, rec, src, 0., 300., f0=0.012, src_type="Ricker")
    jg = JGeometry(jm, rec, src, 0., 300., f0=0.012, src_type="Ricker")
    assert tg.nt == jg.nt
    assert np.array_equal(tg.time_axis.time_values, jg.time_axis.time_values)
    assert np.array_equal(tg.src.data, jg.src.data)
    t = jg.time_axis.time_values
    assert np.array_equal(t_ricker(t, 0.01), j_ricker(t, 0.01))


def test_model_from_numpy_reproduces_the_jax_model():
    jm = j_demo_model("layers-isotropic", shape=(41, 31), spacing=(10., 10.),
                      nbl=8, space_order=8, vp_top=1.5, vp_bottom=3.0)
    jm.vp[0, 0] = 3.1  # a padding cell that is not an edge replication
    tm = model_from_numpy(dict(
        vp=np.asarray(jm.vp), damp=jm.damp, origin=jm.origin,
        spacing=jm.spacing, shape=jm.shape, nbl=jm.nbl,
        space_order=jm.space_order, fs=jm.fs, dt=jm._dt))
    assert np.array_equal(tm.vp, jm.vp) and np.array_equal(tm.damp, jm.damp)
    assert tm.vp.dtype == jm.vp.dtype
    assert tm.critical_dt == jm.critical_dt
    assert tm.padsizes == jm.padsizes and tm.origin_pml == jm.origin_pml


def test_smarmn_setup_equal():
    """The port's SMARMN driver setup (vendored model_data/SMARMN) builds
    the JAX driver's models, geometries and bathy mask."""
    jmc = _jax_marmousi_common()
    args = SimpleNamespace(data_dir=t_marm.default_data_dir(), bathy=1,
                           filter=0)
    assert args.data_dir == jmc.default_data_dir()
    tmodels, tgeoms, tvps, tmask = t_marm.setup(t_marm.SMARMN, args, 29)
    jmodels, jgeoms, jvps, jmask = jmc.setup(jmc.SMARMN, args, 29)
    assert np.array_equal(tmask, jmask)
    for a, b in zip(tvps, jvps):
        assert np.array_equal(a, b)
    for tm, jm in zip(tmodels, jmodels):
        assert np.array_equal(tm.vp, jm.vp)
        assert np.array_equal(tm.damp, jm.damp)
        assert tm.critical_dt == jm.critical_dt
    for tg, jg in zip(tgeoms, jgeoms):
        assert tg.nt == jg.nt == 1357
        assert np.array_equal(tg.src_positions, jg.src_positions)
        assert np.array_equal(tg.rec_positions, jg.rec_positions)
        assert np.array_equal(tg.src.data, jg.src.data)
    # receivers on the padded z-planes 42 and 43
    ri, _ = t_interp(tgeoms[0].rec_positions, tmodels[0].origin_pml,
                     tmodels[0].spacing)
    assert set(np.unique(ri[..., 1])) == {42, 43}
    assert tmodels[0].padded_shape == (380, 186)


def test_smarmn_misfits_and_flags_match_the_jax_driver():
    """``--misfit 0/1/2`` pick the JAX driver's misfits (least_square, W2-1d
    and W2-2d with gamma 1.01 and the configuration's BFM steps and step
    scale; ``bfm_options`` reaches the W2-2d solver); ``--filter 1``
    high-passes the JAX driver's source wavelets, bitwise."""
    jmc = _jax_marmousi_common()
    cfg = t_marm.SMARMN
    assert (cfg.w2_num_steps, cfg.w2_step_scale) == (
        jmc.SMARMN.w2_num_steps, jmc.SMARMN.w2_step_scale)
    l2, w1, w2 = t_marm.misfits(cfg)
    assert l2 is t_marm.least_square
    for q, method in ((w1, "1d"), (w2, "2d")):
        assert (q.method, q.gamma, q.trans_type) == (method, 1.01, "linear")
    assert (w1.num_steps, w1.step_scale) == (10, 1.0)
    assert (w2.num_steps, w2.step_scale) == (15, 1.0)
    assert w2.bfm_options == {}
    banded = t_marm.misfits(cfg, {"legendre": "banded"})[2]
    assert banded.bfm_options == {"legendre": "banded"}
    parser = t_marm.make_parser(cfg)
    args = parser.parse_args(["--filter", "1", "--resample", "4"])
    assert (args.filter, args.resample) == (1, 4.0)
    args = SimpleNamespace(data_dir=t_marm.default_data_dir(), bathy=1,
                           filter=1)
    _, tgeoms, _, _ = t_marm.setup(cfg, args, 3)
    _, jgeoms, _, _ = jmc.setup(jmc.SMARMN, args, 3)
    for tg, jg in zip(tgeoms, jgeoms):
        assert np.array_equal(tg.src.data, jg.src.data)
    unfiltered = t_marm.setup(cfg, SimpleNamespace(
        data_dir=t_marm.default_data_dir(), bathy=1, filter=0), 3)[1]
    assert not np.array_equal(tgeoms[0].src.data, unfiltered[0].src.data)


def test_smarm2_elastic_setup_equal():
    """The port's SMARM2 configuration and elastic setup (vendored
    model_data/SMARM2) build the JAX driver's elastic models: lam, mu, b,
    the mask boundary, the dt pinned for the 5.2 km/s bound (3.1710 ms),
    the geometries (nt 1421, receivers on padded rows 42-43) and the
    smooth-model (vs, rho) the inversion pins."""
    jmc = _jax_marmousi_common()
    assert t_marm.SMARM2 == t_marm.MarmousiConfig(**vars(jmc.SMARM2))
    args = SimpleNamespace(data_dir=t_marm.default_data_dir(), bathy=1)
    tmodels, tgeoms, tfields, tmask = t_marm.setup_elastic(t_marm.SMARM2,
                                                           args, 31)
    jmodels, jgeoms, jfields, jmask = jmc.setup_elastic(jmc.SMARM2, args, 31)
    assert np.array_equal(tmask, jmask)
    for a, b in zip(tfields, jfields):
        assert np.array_equal(a, b)
    for tm, jm in zip(tmodels, jmodels):
        for name in ("lam", "mu", "b", "damp"):
            assert np.array_equal(getattr(tm, name), getattr(jm, name)), name
        assert tm.critical_dt == jm.critical_dt
    assert abs(tmodels[0].critical_dt - 3.1710) < 5e-5
    for tg, jg in zip(tgeoms, jgeoms):
        assert tg.nt == jg.nt == 1421
        assert np.array_equal(tg.src_positions, jg.src_positions)
        assert np.array_equal(tg.rec_positions, jg.rec_positions)
        assert np.array_equal(tg.src.data, jg.src.data)
    ri, _ = t_interp(tgeoms[0].rec_positions, tmodels[0].origin_pml,
                     tmodels[0].spacing)
    assert set(np.unique(ri[..., 1])) == {42, 43}
    assert tmodels[0].padded_shape == (420, 220)


def test_model_from_numpy_carries_qp():
    """A viscoacoustic JAX model's fields (vp, qp, b and the mask damp)
    carry across as numpy arrays, array for array."""
    jm = j_demo_model("layers-viscoacoustic", shape=(41, 31),
                      spacing=(10., 10.), nbl=8, space_order=4)
    jm.qp[0, 0] = 7.5  # a padding cell that is not an edge replication
    tm = model_from_numpy(dict(
        vp=np.asarray(jm.vp), qp=np.asarray(jm.qp), b=np.asarray(jm.b),
        damp=jm.damp, origin=jm.origin, spacing=jm.spacing, shape=jm.shape,
        nbl=jm.nbl, space_order=jm.space_order, fs=jm.fs, dt=jm._dt))
    for name in ("vp", "qp", "b", "damp"):
        assert np.array_equal(getattr(tm, name), getattr(jm, name)), name
    assert tm.critical_dt == jm.critical_dt
    assert tm._bcs_type == "mask"
    scalar_b = model_from_numpy(dict(
        vp=np.asarray(jm.vp), qp=np.asarray(jm.qp), b=0.5, damp=jm.damp,
        origin=jm.origin, spacing=jm.spacing, shape=jm.shape, nbl=jm.nbl,
        space_order=jm.space_order, fs=jm.fs, dt=jm._dt))
    assert scalar_b.b == np.float32(0.5)


def test_smarmn_visco_setup_equal():
    """The port's SMARMN viscoacoustic setup builds the JAX driver's
    models (vp, qp from Li's relation, Gardner b, the mask boundary, the
    true model's CFL dt 2.994 ms), geometries (nt 1338) and bathy mask."""
    jmc = _jax_marmousi_common()
    args = SimpleNamespace(data_dir=t_marm.default_data_dir(), bathy=1)
    tmodels, tgeoms, tvp, tmask = t_marm.setup_visco(t_marm.SMARMN, args, 29)
    jmodels, jgeoms, jvp, jmask = jmc.setup_visco(jmc.SMARMN, args, 29)
    assert np.array_equal(tmask, jmask) and np.array_equal(tvp, jvp)
    for tm, jm in zip(tmodels, jmodels):
        for name in ("vp", "qp", "b", "damp"):
            assert np.array_equal(getattr(tm, name), getattr(jm, name)), name
        assert tm.critical_dt == jm.critical_dt
    assert abs(tmodels[0].critical_dt - 2.994) < 5e-4
    for tg, jg in zip(tgeoms, jgeoms):
        assert tg.nt == jg.nt == 1338
        assert np.array_equal(tg.src.data, jg.src.data)
    qp = tmodels[0].qp
    assert 34.0 < qp.min() < qp.max() < 527.0


def _cut_down_smarmn(tmp_path):
    """SMARMN cut down for the CPU: the vendored models subsampled to 30 x 11
    (written under ``tmp_path``), nbl 8, space order 4, tn 400 ms."""
    import dataclasses
    full = t_marm.SMARMN
    true_vp, smooth_vp = t_marm.load_models(full, t_marm.default_data_dir())
    data = tmp_path / "data" / full.name
    data.mkdir(parents=True)
    for name, v in (("vp.true", true_vp), ("vp.smooth_20", smooth_vp)):
        (np.asarray(v[::10, ::10], np.float32) * 1000).tofile(data / name)
    return dataclasses.replace(full, shape=(30, 11), tn=400., nbl=8,
                               space_order=4, bathy_rows=1)


@pytest.mark.parametrize("flags", [["--filter", "1"], ["--resample", "4"]],
                         ids=["filter", "resample"])
def test_driver_flags_match_the_jax_driver(flags, tmp_path, monkeypatch):
    """The cut-down SMARMN L2 driver (2 shots, 2 L-BFGS iterations) with
    ``--filter 1`` makes the JAX driver's objective calls, each value within
    1e-5 (the port's f32 twins against the JAX f32 objective through its
    Pallas kernels in interpret mode; measured 3.8e-6); with
    ``--resample 4`` both drivers stop with the same error: the JAX driver
    sets the inverted geometry's dt, its objective is not asked to resample,
    and the 137 observed samples meet a 101-sample time axis."""
    import sys
    import torch
    jmin = importlib.import_module("devito_fwi_tpu.optimize.minimize")
    jcalls = []
    jloss = jmin.fwi_loss

    def recorded(*a, **k):
        out = jloss(*a, **k)
        jcalls.append((bool(a[7] if len(a) > 7 else k.get("calc_grad",
                                                          True)), out[0]))
        return out

    monkeypatch.setattr(jmin, "fwi_loss", recorded)
    monkeypatch.setenv("DEVITO_FWI_TPU_PALLAS", "1")
    monkeypatch.setenv("DEVITO_FWI_TPU_PALLAS_INTERPRET", "1")
    cfg = _cut_down_smarmn(tmp_path)
    jmc = _jax_marmousi_common()
    argv = ["--misfit", "0", "--maxiter", "2", "--nsrc", "2", "--data-dir",
            str(tmp_path / "data")] + flags
    monkeypatch.setattr(sys, "argv", ["marmousi_fwi"] + argv +
                        ["--odir", str(tmp_path / "jax")])
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for name, run in (("jax", lambda: jmc.run_fwi(cfg)),
                          ("port", lambda: t_marm.run_fwi(cfg, argv + [
                              "--odir", str(tmp_path / "port"), "--device",
                              "cpu"])[1]["calls"])):
            try:
                out[name] = run()
            except ValueError as e:
                out[name] = str(e)
    finally:
        torch.set_num_threads(saved)
    if flags[0] == "--resample":
        assert out["jax"] == out["port"]
        assert "137 time samples" in out["port"] and "has 101" in \
            out["port"]
        return
    port = [(c[0], c[1]) for c in out["port"]]
    assert [c[0] for c in port] == [c[0] for c in jcalls]
    ft = np.array([c[1] for c in port])
    fj = np.array([c[1] for c in jcalls])
    grads = [i for i, c in enumerate(port) if c[0]]
    assert len(grads) == 2 and ft[grads[1]] < ft[grads[0]]
    assert np.allclose(ft, fj, rtol=1e-5, atol=0)
