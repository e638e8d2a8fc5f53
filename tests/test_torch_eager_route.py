"""The port's eager objective route (``devito_fwi_tpu_torch.fwi``
``_eager_objective``: the eager ``ops.acoustic`` operators for the
geometries no kernel takes) against the JAX package's ``fwi_loss``, whose
CPU route (``_shots_fused``) runs the same ``forward_ckpt`` /
``gradient_from_ckpt`` pair, on the CPU:

* the camembert geometry of tests/test_torch_fwi.py (41 x 41, nbl 10, 3
  shots) with its 31 receivers on the vertical line x = 380 m, as
  ``drivers/circle_fwi.py`` places them;
* the small 3-D grid (24, 20, 16) of tests/test_torch_acoustic3d.py with
  8 receivers spread over depth (off one z-plane);
* the same 3-D grid with receivers the streamed kernels take, and
  ``stream=False`` (the 3-D checkpoint route);

at float64 within 1e-10 (objective relative, gradient of its max), at
float32 within the objective's 1e-5 and the gradient's 3e-5 of its max
(the frameworks round the same float32 operations in another order).
Each call counts one eager objective (``fwi.EAGER``) and leaves every
kernel and twin counter at 0; a 2-D geometry the kernels take still takes
them. The route warns once per reason.
"""
import warnings

import numpy as np
import pytest
import torch

from devito_fwi_tpu import AcquisitionGeometry
from devito_fwi_tpu import fwi as jfwi
from devito_fwi_tpu.misfit import least_square as j_least_square
from devito_fwi_tpu.models.presets import demo_model

from devito_fwi_tpu_torch import fwi as tfwi
from devito_fwi_tpu_torch.convert import (model_from_numpy,
                                          geometry_from_numpy)
from devito_fwi_tpu_torch.misfit import least_square as t_least_square
from devito_fwi_tpu_torch.models.sources import PointSource as TPointSource
from devito_fwi_tpu_torch.ops import cuda_acoustic as ca
from devito_fwi_tpu_torch.ops import cuda_acoustic3 as c3
from devito_fwi_tpu_torch.ops import cuda_acoustic3d as c3d

# objective (relative) and gradient (of its max) at each float type
TOL = {np.float64: (1e-10, 1e-10), np.float32: (1e-5, 3e-5)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this module runs: the suite runs several
    pytest workers on one machine, and torch's thread pool in each of them
    (as many threads as cores) oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _port_geometry(g):
    jm = g.model
    model = model_from_numpy(dict(
        vp=np.asarray(jm.vp), damp=jm.damp, origin=jm.origin,
        spacing=jm.spacing, shape=jm.shape, nbl=jm.nbl,
        space_order=jm.space_order, fs=jm.fs, dt=jm._dt))
    return geometry_from_numpy(model, dict(
        rec_positions=g.rec_positions, src_positions=g.src_positions,
        t0=g.t0, tn=g.tn, f0=g.f0, src_type=g.src_type))


def _port_shots(shots, geometry):
    out = []
    for s in shots:
        p = TPointSource(name="rec", time_range=geometry.time_axis,
                         coordinates=geometry.rec_positions,
                         dtype=geometry.model.dtype)
        p.data[:] = s.data
        out.append(p)
    return out


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / \
        max(np.abs(np.asarray(want)).max(), 1e-300)


def _camembert(dtype, vertical=True):
    """(true, initial) geometries: 3 shots at x = 20 m over depth and 31
    receivers on the line x = 380 m (``vertical``), or sources and
    receivers at z = 20 and 30 m as in tests/test_torch_fwi.py."""
    kw = dict(origin=(0., 0.), shape=(41, 41), spacing=(10., 10.), nbl=10,
              space_order=4, dtype=dtype)
    true = demo_model("circle-isotropic", vp_circle=3.0, vp_background=2.5,
                      r=8, **kw)
    kw["dt"] = float(true.critical_dt)
    init = demo_model("circle-isotropic", vp_circle=2.5, vp_background=2.5,
                      **kw)
    line = np.linspace(10., 390., 31)
    if vertical:
        src = np.stack([np.full(3, 20.), np.linspace(0., 400., 3)], 1)
        rec = np.stack([np.full(31, 380.), line], 1)
    else:
        src = np.stack([np.linspace(0., 400., 3), np.full(3, 20.)], 1)
        rec = np.stack([line, np.full(31, 30.)], 1)
    return [AcquisitionGeometry(m, rec, src, 0., 250., f0=0.012,
                                src_type="Ricker") for m in (true, init)]


def _geom3(dtype, nlayers, spread):
    """tests/test_torch_acoustic3d.py's small 3-D geometry: 2 shots, 12
    receivers between two z-planes, or (``spread``) 8 over depth 10-100 m."""
    kw = dict(shape=(24, 20, 16), spacing=(15., 15., 15.), space_order=4,
              nbl=8, dt=1.5, dtype=dtype)
    model = demo_model("layers-isotropic", nlayers=nlayers, **kw)
    ext, eyt = model.domain_size[0], model.domain_size[1]
    src = np.stack([np.linspace(0, ext, 2), np.linspace(eyt * 0.3,
                                                        eyt * 0.7, 2),
                    np.full(2, 30.0)], 1)
    if spread:
        rec = np.stack([np.linspace(0, ext, 8), np.full(8, eyt / 2),
                        np.linspace(10.0, 100.0, 8)], 1)
    else:
        rec = np.stack([np.linspace(0, ext, 12), np.linspace(0, eyt, 12),
                        np.full(12, 37.0)], 1)
    return AcquisitionGeometry(model, rec, src, 0.0, 120.0, f0=0.015,
                               src_type="Ricker")


CASES = {
    "camembert_vertical": lambda dtype: _camembert(dtype),
    "3d_off_one_plane": lambda dtype: [_geom3(dtype, n, True)
                                       for n in (3, 1)],
    "3d_stream_false": lambda dtype: [_geom3(dtype, n, False)
                                      for n in (3, 1)],
}


def _reset():
    tfwi.reset_counters()
    for mod in (ca, c3, c3d):
        mod.reset_counters()


def _kernel_counts():
    return sum(v for mod in (ca, c3, c3d)
               for d in (mod.LAUNCHES, mod.TWIN_CALLS) for v in d.values())


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_eager_route_matches_jax_fwi_loss(case, dtype):
    g1, g0 = CASES[case](dtype)
    obs = jfwi.fm_multi(g1)
    p0 = _port_geometry(g0)
    x = 1.0 / np.asarray(g0.model.vp_unpadded, np.float64).reshape(-1) ** 2
    stream = False if case == "3d_stream_false" else None
    fj, gj, _ = jfwi.fwi_loss(x.copy(), g0, obs, j_least_square,
                              precond=False)
    _reset()
    ft, gt, res = tfwi.fwi_loss(x.copy(), p0, _port_shots(obs, p0),
                                t_least_square, precond=False, device="cpu",
                                stream=stream)
    assert tfwi.EAGER == {"objective": 1, "fm_multi": 0, "saved_step": 0}
    assert _kernel_counts() == 0
    f_tol, g_tol = TOL[dtype]
    assert abs(ft - fj) <= f_tol * abs(fj)
    assert _rel(gt, gj) < g_tol
    assert len(res) == g0.nsrc and res[0].shape == obs[0].data.shape
    # the preconditioned gradient (the illumination through the same fix)
    fj, gj, _ = jfwi.fwi_loss(x.copy(), g0, obs, j_least_square)
    ft, gt, _ = tfwi.fwi_loss(x.copy(), p0, _port_shots(obs, p0),
                              t_least_square, device="cpu", stream=stream)
    assert _rel(gt, gj) < g_tol
    assert tfwi.EAGER["objective"] == 2


@pytest.mark.parametrize("case", sorted(CASES))
def test_eager_trials_and_modeling_match_jax(case):
    """Trials through the eager ``forward`` (the checkpoint route's
    ``stream=False`` is a gradient's: the 3-D trial there takes the
    streamed kernels' twin) and ``fm_multi`` at float64."""
    g1, g0 = CASES[case](np.float64)
    obs = jfwi.fm_multi(g1)
    p0, p1 = _port_geometry(g0), _port_geometry(g1)
    _reset()
    got = np.stack([s.data for s in tfwi.fm_multi(p1, device="cpu")])
    assert _rel(got, np.stack([s.data for s in obs])) < 1e-10
    eager = case != "3d_stream_false"
    assert tfwi.EAGER["fm_multi"] == int(eager)
    x = 1.0 / np.asarray(g0.model.vp_unpadded, np.float64).reshape(-1) ** 2
    fj, _, _ = jfwi.fwi_loss(x.copy(), g0, obs, j_least_square,
                             calc_grad=False)
    ft, _, _ = tfwi.fwi_loss(x.copy(), p0, _port_shots(obs, p0),
                             t_least_square, calc_grad=False, device="cpu",
                             stream=False)
    assert abs(ft - fj) <= 1e-10 * abs(fj)
    assert tfwi.EAGER["objective"] == int(eager)


def test_kernel_geometries_keep_their_routes():
    """A 2-D geometry the kernels take (receivers on one z-plane) runs the
    kernels' twins on the CPU and never the eager route."""
    _, g0 = _camembert(np.float32, vertical=False)
    p0 = _port_geometry(g0)
    _reset()
    obs = tfwi.fm_multi(p0, device="cpu")
    tfwi.fwi_loss(1.0 / np.asarray(g0.model.vp_unpadded,
                                   np.float64).reshape(-1) ** 2,
                  p0, obs, t_least_square, device="cpu")
    assert tfwi.EAGER == {"objective": 0, "fm_multi": 0, "saved_step": 0}
    assert ca.TWIN_CALLS["forward_rec_segments"] == 1
    assert ca.TWIN_CALLS["gradient_stream_segments"] == 1


def test_eager_route_warns_once_per_reason(monkeypatch):
    monkeypatch.setattr(tfwi._eager_warn, "seen", set())
    _, g0 = _camembert(np.float32)
    p0 = _port_geometry(g0)
    with pytest.warns(UserWarning, match="adjacent z-planes"):
        obs = tfwi.fm_multi(p0, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tfwi.fwi_obj_multi(p0, obs, t_least_square, device="cpu")


def test_saved_and_checkpoint_routes_cannot_both_be_asked():
    g = _port_geometry(_geom3(np.float32, 1, False))
    obs = tfwi.fm_multi(g, device="cpu")
    with pytest.raises(ValueError, match="two different gradient routes"):
        tfwi.fwi_obj_multi(g, obs, None, calc_grad=True, device="cpu",
                           stream=False, saved3=True)
