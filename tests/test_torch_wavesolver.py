"""The port's eager acoustic operators (devito_fwi_tpu_torch.ops.acoustic),
``AcousticWaveSolver``, ``fwi_obj_single`` and the camembert example
against the JAX package, on the CPU:

* ``forward`` (OT2 and OT4, with and without the free surface, with DRP
  weights through ``w_override``), ``adjoint``, ``gradient``,
  ``forward_ckpt`` (receivers, segment starts, illumination),
  ``gradient_from_ckpt``, ``gradient_checkpointed`` and ``born`` against
  ``devito_fwi_tpu.ops.acoustic`` at float64 within 1e-12 of the max, on
  2-D grids and a small 3-D grid; a bfloat16 history (``save_dtype``)
  equal to the float64 history cast, and to the JAX one up to XLA's flush
  of subnormal values to zero;
* the dot tests (forward/adjoint, born/gradient, OT2 and OT4: 1e-11
  relative) and the Born linearisation order (slope > 1.85), at
  tests/test_acoustic.py's tolerances, through the port's solver; the
  checkpointed gradient equal to the saved one (OT4, with and without the
  free surface, 1e-12 of the max);
* ``AcousticWaveSolver`` against the JAX solver on every method (the
  checkpointed gradient, the OT4 dt, the Inc accumulation into ``grad``
  and a Born perturbation at the model's shape included) at float64 within
  1e-12; tests/test_drp.py's DRP dispersion check through the port's
  solver;
* ``fwi_obj_single`` against the JAX one, with and without
  ``resample_dt``, at float64 (1e-10);
* the camembert goldens (examples/inversion_fwi.py, float32, atol 10):
  39113 / -821 / 2442 after one gradient, 3828 after 5 iterations
  (``slow``); the BASELINE.md forward norms 369.955 (3-D, free surface,
  float32) and 459.1678 (3-D, float64, ``slow``, as the JAX test is).

The port's models and geometries are built from the JAX objects' numpy
fields through ``devito_fwi_tpu_torch.convert``.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from devito_fwi_tpu import AcousticWaveSolver as JSolver
from devito_fwi_tpu import AcquisitionGeometry as JGeometry
from devito_fwi_tpu import fwi as jfwi
from devito_fwi_tpu.misfit import least_square as j_least_square
from devito_fwi_tpu.models.geometry import setup_geometry as j_setup
from devito_fwi_tpu.models.presets import demo_model as j_demo
from devito_fwi_tpu.ops import acoustic as jac
from devito_fwi_tpu.ops.interp import interp_table

from devito_fwi_tpu_torch import AcousticWaveSolver as TSolver
from devito_fwi_tpu_torch import fwi as tfwi
from devito_fwi_tpu_torch.convert import (model_from_numpy,
                                          geometry_from_numpy)
from devito_fwi_tpu_torch.examples import inversion_fwi as ex
from devito_fwi_tpu_torch.misfit import least_square as t_least_square
from devito_fwi_tpu_torch.models.geometry import setup_geometry
from devito_fwi_tpu_torch.models.presets import demo_model
from devito_fwi_tpu_torch.models.sources import PointSource as TPointSource
from devito_fwi_tpu_torch.ops import acoustic as tac
from devito_fwi_tpu_torch.utils.fd import (drp_second_derivative_weights,
                                           second_derivative_weights)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this module runs: the suite runs several
    pytest workers on one machine, and torch's thread pool in each of them
    (as many threads as cores) oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _port_model(jm):
    return model_from_numpy(dict(
        vp=np.asarray(jm.vp), damp=jm.damp, origin=jm.origin,
        spacing=jm.spacing, shape=jm.shape, nbl=jm.nbl,
        space_order=jm.space_order, fs=jm.fs, dt=jm._dt))


def _port_geometry(g, model=None):
    model = _port_model(g.model) if model is None else model
    return geometry_from_numpy(model, dict(
        rec_positions=g.rec_positions, src_positions=g.src_positions,
        t0=g.t0, tn=g.tn, f0=g.f0, src_type=g.src_type))


# ---------------------------------------------------------------------------
# the eager operators against ops.acoustic at float64
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _case(dim, fs, so=4):
    """One shot on a small layered grid (41 x 41, or 16 x 14 x 12): the
    operands of ops.acoustic as numpy arrays, a seeded residual and a
    seeded interior perturbation."""
    shape = (41, 41) if dim == 2 else (16, 14, 12)
    model = j_demo("layers-isotropic", space_order=so, shape=shape,
                   nbl=8 if dim == 2 else 4, dtype=np.float64,
                   spacing=(15.,) * dim, fs=fs)
    geom = j_setup(model, 300. if dim == 2 else 150.)
    s_idx, s_w = interp_table(geom.src_positions, model.origin_pml,
                              model.spacing, dtype=np.float64)
    r_idx, r_w = interp_table(geom.rec_positions, model.origin_pml,
                              model.spacing, dtype=np.float64)
    rng = np.random.default_rng(dim + 2 * fs)
    nt = geom.nt
    dm = np.zeros(model.padded_shape)
    inner = tuple(slice(4, n - 4) for n in model.padded_shape)
    dm[inner] = rng.standard_normal(dm[inner].shape)
    return dict(vp=np.asarray(model.vp), damp=np.asarray(model.damp),
                wav=np.asarray(geom.src.data), s_idx=s_idx, s_w=s_w,
                r_idx=r_idx, r_w=r_w, dt=float(model.critical_dt),
                kw=dict(nt=nt, spacing=model.spacing, space_order=so,
                        fs=fs),
                res=rng.standard_normal((nt, r_idx.shape[0])), dm=dm)


def _j(c):
    return (jnp.asarray(c["vp"]), jnp.asarray(c["damp"]))


def _t(c):
    return (torch.as_tensor(c["vp"]), torch.as_tensor(c["damp"]))


OPS_CASES = [(2, False, "OT2"), (2, True, "OT2"), (2, False, "OT4"),
             (2, True, "OT4"), (3, False, "OT2"), (3, True, "OT4")]
OPS_IDS = [f"{d}d-fs{int(fs)}-{k}" for d, fs, k in OPS_CASES]


@pytest.mark.parametrize("dim,fs,kernel", OPS_CASES, ids=OPS_IDS)
def test_forward_matches_jax(dim, fs, kernel):
    c = _case(dim, fs)
    args = (c["s_idx"], c["s_w"], c["r_idx"], c["r_w"], c["dt"])
    want = jac.forward(*_j(c), jnp.asarray(c["wav"]), *args, save=True,
                       kernel=kernel, **c["kw"])
    got = tac.forward(*_t(c), torch.as_tensor(c["wav"]), *args, save=True,
                      kernel=kernel, **c["kw"])
    assert _rel(got[0], want[0]) < 1e-12
    assert _rel(got[1], want[1]) < 1e-12


@pytest.mark.parametrize("fs", [False, True])
def test_forward_drp_weights_match_jax(fs):
    """``w_override`` (DRP weights, devito's coefficients='symbolic')."""
    c = _case(2, fs)
    w = tuple(float(v) for v in drp_second_derivative_weights(4, 2.0))
    args = (c["s_idx"], c["s_w"], c["r_idx"], c["r_w"], c["dt"])
    want = jac.forward(*_j(c), jnp.asarray(c["wav"]), *args, w_override=w,
                       **c["kw"])
    got = tac.forward(*_t(c), torch.as_tensor(c["wav"]), *args,
                      w_override=w, **c["kw"])
    taylor = tac.forward(*_t(c), torch.as_tensor(c["wav"]), *args,
                         **c["kw"])
    assert _rel(got[0], want[0]) < 1e-12
    assert _rel(got[1], want[1]) < 1e-12
    assert _rel(got[0], taylor[0]) > 1e-6


def test_save_dtype_bfloat16_history():
    """A bfloat16 history is the float64 history cast, step by step, and
    the JAX one; the receivers stay the float64 ones."""
    c = _case(2, False)
    args = (c["s_idx"], c["s_w"], c["r_idx"], c["r_w"], c["dt"])
    full = tac.forward(*_t(c), torch.as_tensor(c["wav"]), *args, save=True,
                       **c["kw"])
    half = tac.forward(*_t(c), torch.as_tensor(c["wav"]), *args, save=True,
                       save_dtype="bfloat16", **c["kw"])
    want = jac.forward(*_j(c), jnp.asarray(c["wav"]), *args, save=True,
                       save_dtype="bfloat16", **c["kw"])
    assert half[1].dtype == torch.bfloat16
    assert torch.equal(half[1], full[1].to(torch.bfloat16))
    assert torch.equal(half[0], full[0])
    # XLA flushes subnormal values to zero in the cast; torch keeps them
    np.testing.assert_allclose(half[1].float().numpy(),
                               np.asarray(want[1], np.float32), rtol=0,
                               atol=np.finfo(np.float32).tiny)
    # the gradient upcasts each bfloat16 slice to the model's type
    gargs = (torch.as_tensor(c["res"]), c["r_idx"], c["r_w"], c["dt"])
    got = tac.gradient(*_t(c), half[1], *gargs, **c["kw"])[0]
    ref = tac.gradient(*_t(c), half[1].to(torch.float64), *gargs,
                       **c["kw"])[0]
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dim,fs,kernel", OPS_CASES, ids=OPS_IDS)
def test_adjoint_matches_jax(dim, fs, kernel):
    c = _case(dim, fs)
    want = jac.adjoint(*_j(c), jnp.asarray(c["res"]), c["r_idx"], c["r_w"],
                       c["s_idx"], c["s_w"], c["dt"], kernel=kernel,
                       **c["kw"])
    got = tac.adjoint(*_t(c), torch.as_tensor(c["res"]), c["r_idx"],
                      c["r_w"], c["s_idx"], c["s_w"], c["dt"],
                      kernel=kernel, **c["kw"])
    assert _rel(got[0], want[0]) < 1e-12
    assert _rel(got[1], want[1]) < 1e-12


@pytest.mark.parametrize("dim,fs,kernel", OPS_CASES, ids=OPS_IDS)
def test_gradient_matches_jax(dim, fs, kernel):
    c = _case(dim, fs)
    args = (c["s_idx"], c["s_w"], c["r_idx"], c["r_w"], c["dt"])
    _, u = jac.forward(*_j(c), jnp.asarray(c["wav"]), *args, save=True,
                       kernel=kernel, **c["kw"])
    want = jac.gradient(*_j(c), u, jnp.asarray(c["res"]), c["r_idx"],
                        c["r_w"], c["dt"], kernel=kernel, **c["kw"])
    got = tac.gradient(*_t(c), torch.as_tensor(np.asarray(u)),
                       torch.as_tensor(c["res"]), c["r_idx"], c["r_w"],
                       c["dt"], kernel=kernel, **c["kw"])
    assert _rel(got[0], want[0]) < 1e-12
    assert _rel(got[1], want[1]) < 1e-12


@pytest.mark.parametrize("dim,fs,kernel", OPS_CASES, ids=OPS_IDS)
def test_checkpoint_pair_matches_jax(dim, fs, kernel):
    """``forward_ckpt`` (receivers, segment starts, illumination),
    ``gradient_from_ckpt`` on the JAX segment starts and
    ``gradient_checkpointed``, at a checkpoint count whose last segment
    has a padded tail."""
    c = _case(dim, fs)
    args = (c["s_idx"], c["s_w"], c["r_idx"], c["r_w"], c["dt"])
    nt = c["kw"]["nt"]
    nck = next(n for n in range(5, 20)
               if np.prod(tac._ckpt_layout(nt, n)[1:]) > nt - 2)
    kw = dict(c["kw"], kernel=kernel, n_checkpoints=nck)
    want = jac.forward_ckpt(*_j(c), jnp.asarray(c["wav"]), *args, **kw)
    got = tac.forward_ckpt(*_t(c), torch.as_tensor(c["wav"]), *args, **kw)
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-12
    gargs = (c["r_idx"], c["r_w"], c["dt"])
    want_g = jac.gradient_from_ckpt(
        *_j(c), jnp.asarray(c["wav"]), c["s_idx"], c["s_w"], want[1],
        jnp.asarray(c["res"]), *gargs, **kw)
    got_g = tac.gradient_from_ckpt(
        *_t(c), torch.as_tensor(c["wav"]), c["s_idx"], c["s_w"],
        torch.as_tensor(np.asarray(want[1])), torch.as_tensor(c["res"]),
        *gargs, **kw)
    assert _rel(got_g[0], want_g[0]) < 1e-12
    assert _rel(got_g[1], want_g[1]) < 1e-12
    got_c = tac.gradient_checkpointed(
        *_t(c), torch.as_tensor(c["wav"]), c["s_idx"], c["s_w"],
        torch.as_tensor(c["res"]), *gargs, **kw)
    assert _rel(got_c[0], want_g[0]) < 1e-12


@pytest.mark.parametrize("dim,fs,kernel", OPS_CASES, ids=OPS_IDS)
def test_born_matches_jax(dim, fs, kernel):
    c = _case(dim, fs)
    args = (c["s_idx"], c["s_w"], c["r_idx"], c["r_w"], c["dt"])
    want = jac.born(*_j(c), jnp.asarray(c["dm"]), jnp.asarray(c["wav"]),
                    *args, kernel=kernel, **c["kw"])
    got = tac.born(*_t(c), torch.as_tensor(c["dm"]),
                   torch.as_tensor(c["wav"]), *args, kernel=kernel,
                   **c["kw"])
    assert _rel(got, want) < 1e-12


def test_ot4_never_takes_the_step_kernel():
    c = _case(3, False)
    args = (c["s_idx"], c["s_w"], c["r_idx"], c["r_w"], c["dt"])
    vp, damp = _t(c)
    with pytest.raises(ValueError, match="OT4"):
        tac.forward(vp.float(), damp.float(),
                    torch.as_tensor(c["wav"]).float(), *args, kernel="OT4",
                    step3=True, **dict(c["kw"], fs=False))


# ---------------------------------------------------------------------------
# the port's solver: dot tests, linearisation, checkpointed == saved
# ---------------------------------------------------------------------------

def _solver(shape=(41, 41), spacing=(15., 15.), tn=300., nbl=10,
            space_order=4, kernel="OT2", fs=False, dtype=np.float64,
            preset="layers-isotropic", **kwargs):
    model = demo_model(preset, space_order=space_order, shape=shape, nbl=nbl,
                       dtype=dtype, spacing=spacing, fs=fs, **kwargs)
    geometry = setup_geometry(model, tn)
    return TSolver(model, geometry, kernel=kernel, space_order=space_order,
                   device="cpu")


@pytest.mark.parametrize("kernel", ["OT2", "OT4"])
def test_forward_adjoint_dot(kernel):
    solver = _solver(kernel=kernel)
    src = solver.geometry.src
    rec, _, _ = solver.forward(src=src)
    rng = np.random.default_rng(0)
    rec_in = solver.geometry.rec
    rec_in.data[:] = rng.normal(size=rec_in.data.shape)
    srca, _, _ = solver.adjoint(rec_in)
    term1 = np.dot(rec.data.ravel(), rec_in.data.ravel())
    term2 = np.dot(src.data.ravel(), srca.data.ravel())
    assert abs(term1 - term2) / abs(term1) < 1e-11


@pytest.mark.parametrize("kernel", ["OT2", "OT4"])
def test_born_gradient_dot(kernel):
    solver = _solver(kernel=kernel)
    model = solver.model
    rng = np.random.default_rng(1)
    dm = rng.normal(size=model.padded_shape)
    dm_phys = np.zeros_like(dm)
    nbl = model.nbl
    dm_phys[nbl:-nbl, nbl:-nbl] = dm[nbl:-nbl, nbl:-nbl]
    rec_lin, _ = solver.jacobian(dm_phys)
    rec_res = solver.geometry.rec
    rec_res.data[:] = rng.normal(size=rec_res.data.shape)
    _, u0, _ = solver.forward(save=True)
    grad, _ = solver.jacobian_adjoint(rec_res, u0)
    term1 = np.dot(rec_lin.data.ravel(), rec_res.data.ravel())
    term2 = np.dot(dm_phys.ravel(), np.asarray(grad).ravel())
    assert abs(term1 - term2) / abs(term1) < 1e-11


@pytest.mark.parametrize("kernel", ["OT2", "OT4"])
def test_born_linearization(kernel):
    solver = _solver(preset="constant-isotropic", vp=2.0, kernel=kernel)
    model = solver.model
    vp0 = np.asarray(model.vp, dtype=np.float64)
    m0 = 1.0 / vp0 ** 2
    x = np.linspace(-1, 1, model.padded_shape[0])[:, None]
    z = np.linspace(-1, 1, model.padded_shape[1])[None, :]
    dm = 0.05 * np.exp(-((x / 0.3) ** 2 + (z / 0.3) ** 2))
    rec0, _, _ = solver.forward(vp=vp0)
    rec0 = rec0.data.copy()
    rec_lin, _ = solver.jacobian(dm, vp=vp0)
    hs = [0.5 ** i for i in range(3, 7)]
    errs = []
    for h in hs:
        rec_h, _, _ = solver.forward(vp=1.0 / np.sqrt(m0 + h * dm),
                                     rec=solver.geometry.rec)
        errs.append(np.linalg.norm(rec_h.data - rec0 - h * rec_lin.data))
    slope = np.polyfit(np.log(hs), np.log(errs), 1)[0]
    assert slope > 1.85


@pytest.mark.parametrize("fs", [False, True])
def test_ot4_checkpointed_gradient_matches_saved(fs):
    solver = _solver(kernel="OT4", fs=fs, spacing=(10., 10.), tn=400.)
    rng = np.random.default_rng(2)
    rec_res = solver.geometry.rec
    rec_res.data[:] = rng.normal(size=rec_res.data.shape)
    _, u0, _ = solver.forward(save=True)
    g_saved, _ = solver.jacobian_adjoint(rec_res, u0)
    g_ck, _ = solver.jacobian_adjoint(rec_res, None, checkpointing=True,
                                      n_checkpoints=9)
    scale = np.abs(g_saved).max()
    assert np.abs(g_ck - g_saved).max() < 1e-12 * scale


# ---------------------------------------------------------------------------
# AcousticWaveSolver against the JAX solver
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _solvers(kernel):
    model = j_demo("layers-isotropic", space_order=4, shape=(41, 41),
                   nbl=10, dtype=np.float64, spacing=(15., 15.))
    geom = j_setup(model, 300.)
    js = JSolver(model, geom, kernel=kernel, space_order=4)
    ts = TSolver(_port_model(model), _port_geometry(geom), kernel=kernel,
                 space_order=4, device="cpu")
    return js, ts


SOLVER_METHODS = ["forward", "forward_save", "adjoint", "jacobian",
                  "jacobian_dmin_unpadded", "jacobian_adjoint",
                  "jacobian_adjoint_checkpointing",
                  "jacobian_adjoint_accumulates"]


@pytest.mark.parametrize("kernel", ["OT2", "OT4"])
@pytest.mark.parametrize("method", SOLVER_METHODS)
def test_solver_matches_jax(method, kernel):
    js, ts = _solvers(kernel)
    assert ts.dt == js.dt and type(ts.dt) is type(js.dt)
    rng = np.random.default_rng(5)
    res = rng.standard_normal((js.nt, js.geometry.nrec))
    j_res, t_res = js.geometry.rec, ts.geometry.rec
    j_res.data[:] = res
    t_res.data[:] = res
    if method in ("forward", "forward_save"):
        save = method == "forward_save"
        jr, ju, _ = js.forward(save=save)
        tr, tu, _ = ts.forward(save=save)
        assert _rel(tr.data, jr.data) < 1e-12
        assert isinstance(tu.data, torch.Tensor)
        assert _rel(tu.data, ju.data) < 1e-12
    elif method == "adjoint":
        jsa, jv, _ = js.adjoint(j_res)
        tsa, tv, _ = ts.adjoint(t_res)
        assert _rel(tsa.data, jsa.data) < 1e-12
        assert _rel(tv.data, jv.data) < 1e-12
    elif method.startswith("jacobian_dmin"):
        dm = rng.standard_normal(js.model.shape)
        jr, _ = js.jacobian(dm)
        tr, _ = ts.jacobian(dm)
        assert _rel(tr.data, jr.data) < 1e-12
    elif method == "jacobian":
        dm = rng.standard_normal(js.model.padded_shape)
        jr, _ = js.born(dm)
        tr, _ = ts.born(dm)
        assert _rel(tr.data, jr.data) < 1e-12
    else:
        _, ju, _ = js.forward(save=True)
        _, tu, _ = ts.forward(save=True)
        kw = dict(checkpointing=True, n_checkpoints=7) \
            if method.endswith("checkpointing") else {}
        jg, _ = js.jacobian_adjoint(j_res, ju, **kw)
        tg, _ = ts.gradient(t_res, tu.data if kw else tu, **kw)
        assert isinstance(tg, np.ndarray)
        assert _rel(tg, jg) < 1e-12
        if method.endswith("accumulates"):
            base = rng.standard_normal(js.model.padded_shape)
            jacc, tacc = base.copy(), base.copy()
            js.jacobian_adjoint(j_res, ju, grad=jacc)
            out, _ = ts.jacobian_adjoint(t_res, tu, grad=tacc)
            assert out is tacc
            assert _rel(tacc, jacc) < 1e-12


def test_drp_modeling_less_dispersion():
    """tests/test_drp.py's check through the port's solver: coarse-grid
    (5 points/wavelength) wholespace propagation over 10 wavelengths, the
    DRP stencil's trace error against the analytic Hankel solution below
    0.7 of the Taylor stencil's of the same width."""
    from scipy.special import hankel2
    from devito_fwi_tpu_torch.models.geometry import AcquisitionGeometry
    from devito_fwi_tpu_torch.models.model import SeismicModel

    so = 10
    shape, spacing = (161, 161), (20.0, 20.0)
    vp, f0, dt_ms, tn = 1.5, 0.015, 1.0, 1100.0
    offset = 1000.0
    nt = int(tn / dt_ms) + 1
    t = np.arange(nt) * dt_ms / 1000.0
    srcw = (1 - 2 * (np.pi * f0 * 1000 * (t - 1.0 / (f0 * 1000))) ** 2) * \
        np.exp(-(np.pi * f0 * 1000 * (t - 1.0 / (f0 * 1000))) ** 2)
    S = np.fft.rfft(srcw)
    freq = np.fft.rfftfreq(nt, dt_ms / 1000.0)
    k = 2 * np.pi * freq / (vp * 1000)
    G = np.zeros(len(freq), complex)
    G[1:] = -1j * np.pi * hankel2(0, k[1:] * offset) / 4.0
    ref = np.fft.irfft(S * G, nt)

    model = SeismicModel(origin=(0., 0.), spacing=spacing, shape=shape,
                         space_order=so, vp=np.full(shape, vp), nbl=60,
                         bcs="damp", dt=dt_ms, dtype=np.float64)
    src = np.array([[600.0, 1600.0]])
    rec = np.array([[600.0 + offset, 1600.0]])
    geom = AcquisitionGeometry(model, rec, src, 0., tn, f0=f0,
                               src_type="Ricker")
    solver = TSolver(model, geom, space_order=so, device="cpu")

    def err(w_override):
        trace, _, _ = solver.forward(w_override=w_override)
        num = np.asarray(trace.data)[:, 0]
        return np.linalg.norm(num / np.abs(num).max()
                              - ref / np.abs(ref).max())

    e_taylor = err(None)
    e_drp = err(drp_second_derivative_weights(so, 2.0))
    assert e_drp < 0.7 * e_taylor
    assert len(second_derivative_weights(so)) == 2 * (so // 2) + 1


# ---------------------------------------------------------------------------
# fwi_obj_single
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("resample", [False, True])
def test_fwi_obj_single_matches_jax(resample):
    kw = dict(origin=(0., 0.), shape=(41, 41), spacing=(10., 10.), nbl=10,
              space_order=4, dtype=np.float64)
    true = j_demo("circle-isotropic", vp_circle=3.0, vp_background=2.5,
                  r=8, **kw)
    kw["dt"] = float(true.critical_dt)
    init = j_demo("circle-isotropic", vp_circle=2.5, vp_background=2.5,
                  **kw)
    rec = np.stack([np.linspace(0., 400., 31), np.full(31, 30.)], 1)
    g1, g0 = (JGeometry(m, rec, np.array([[200., 20.]]), 0.,
                                       250., f0=0.012, src_type="Ricker")
              for m in (true, init))
    obs, _ = jfwi.fm_single(g1)
    rdt = 2.0 * g0.dt if resample else None
    want = jfwi.fwi_obj_single(g0, obs, j_least_square, resample_dt=rdt,
                               calc_grad=True)
    tg0 = _port_geometry(g0)
    tobs = TPointSource(name="rec", time_range=tg0.time_axis,
                        coordinates=tg0.rec_positions, dtype=np.float64)
    tobs.data[:] = obs.data
    got = tfwi.fwi_obj_single(tg0, tobs, t_least_square, resample_dt=rdt,
                              calc_grad=True, device="cpu")
    assert abs(got[0] - want[0]) <= 1e-10 * abs(want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == np.shape(w)
        assert _rel(g, w) < 1e-10
    f_only = tfwi.fwi_obj_single(tg0, tobs, t_least_square,
                                 resample_dt=rdt, device="cpu")
    assert f_only[0] == got[0] and f_only[1] is None and f_only[3] is None


# ---------------------------------------------------------------------------
# goldens
# ---------------------------------------------------------------------------

def test_camembert_iteration1_golden():
    """examples/inversion_fwi.py's first gradient through the port's
    solver at float32: 39113 / -821 / 2442 (atol 10)."""
    history, gmin, gmax, ff = ex.main(device="cpu", iterations=0)
    assert len(history) == 0
    assert np.isclose(ff, 39113, atol=1e1, rtol=0), ff
    assert np.isclose(gmin, -821, atol=1e1, rtol=0), gmin
    assert np.isclose(gmax, 2442, atol=1e1, rtol=0), gmax


@pytest.mark.slow
def test_camembert_5_iterations_golden():
    """The example's misfit after 5 gradient-descent iterations with
    alpha = .05/max(g) and the box [2.0, 3.5]: 3828 (atol 10)."""
    history, _, _, ff = ex.main(device="cpu")
    assert history[0] == ff
    assert np.isclose(history[-1], 3828, atol=1e1, rtol=0), history


def test_acoustic_forward_norm_fs_f32():
    """BASELINE.md, reference acoustic_example.py:75-79: 3-D, fs=True,
    float32, norm(rec) 369.955 (rtol 1e-3)."""
    model = demo_model("layers-isotropic", space_order=4, shape=(50, 50, 50),
                       nbl=40, dtype=np.float32, spacing=(20., 20., 20.),
                       fs=True)
    geometry = setup_geometry(model, 1000.0)
    solver = TSolver(model, geometry, kernel="OT2", space_order=4,
                     device="cpu")
    rec, _, _ = solver.forward()
    assert np.isclose(np.linalg.norm(rec.data), 369.955, rtol=1e-3, atol=0)


@pytest.mark.slow
def test_acoustic_forward_norm_f64():
    """BASELINE.md: 3-D, fs=False, float64, norm(rec) 459.1678."""
    model = demo_model("layers-isotropic", space_order=4, shape=(50, 50, 50),
                       nbl=40, dtype=np.float64, spacing=(20., 20., 20.),
                       fs=False)
    geometry = setup_geometry(model, 1000.0)
    solver = TSolver(model, geometry, kernel="OT2", space_order=4,
                     device="cpu")
    rec, _, _ = solver.forward()
    assert np.isclose(np.linalg.norm(rec.data), 459.1678, rtol=1e-3, atol=0)
