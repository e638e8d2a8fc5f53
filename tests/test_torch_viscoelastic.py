"""The port's SLS viscoelastic family on the CPU: ``ViscoelasticWaveSolver``
against the reference goldens, ``staggered.viscoelastic_forward`` /
``viscoelastic_forward_seg`` and ``staggered_grad.viscoelastic_forward_hist``
/ ``viscoelastic_adjoint_from_hist`` / ``viscoelastic_value_and_grad``
against the JAX functions at float64 within 1e-10 of each output's max on
the (41, 36) set-up of ``tests/test_visco_grad.py``, and the central
finite-difference check of the five-parameter gradient."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from devito_fwi_tpu import AcquisitionGeometry as JGeometry
from devito_fwi_tpu import SeismicModel as JModel
from devito_fwi_tpu.misfit.w2 import least_square_jax
from devito_fwi_tpu.ops import staggered as jst
from devito_fwi_tpu.ops import staggered_grad as jsg

from devito_fwi_tpu_torch.misfit import least_square_torch
from devito_fwi_tpu_torch.models.geometry import setup_geometry
from devito_fwi_tpu_torch.models.presets import demo_model
from devito_fwi_tpu_torch.ops import staggered as st
from devito_fwi_tpu_torch.ops import staggered_grad as sg
from devito_fwi_tpu_torch.ops.elastic_wavesolver import (
    ViscoelasticWaveSolver)
from devito_fwi_tpu_torch.ops.interp import interp_table

TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this module runs: the suite runs several
    pytest workers on one machine, and torch's thread pool in each of them
    (as many threads as cores) oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_viscoelastic_golden():
    """The reference example (``viscoelastic_example.py:38-43``): rec1 norm
    12.28040 and rec2 norm 0.312461, atol 1e-3, float32; the geometry is
    built before the solver scales dt by 0.9, as in the reference."""
    model = demo_model("layers-viscoelastic", space_order=4, shape=(50, 50),
                       nbl=40, dtype=np.float32, spacing=(20., 20.))
    geometry = setup_geometry(model, 1000.)
    solver = ViscoelasticWaveSolver(model, geometry, space_order=4,
                                    device="cpu")
    assert model.dt_scale == .9
    rec1, rec2, _, _, summary = solver.forward()
    assert np.isclose(np.linalg.norm(rec1.data), 12.28040, atol=1e-3, rtol=0)
    assert np.isclose(np.linalg.norm(rec2.data), 0.312461, atol=1e-3, rtol=0)
    assert summary.elapsed > 0


def test_viscoelastic_stability():
    model = demo_model("layers-viscoelastic", space_order=4, shape=(11, 11),
                       nbl=0, dtype=np.float32, spacing=(20., 20.))
    geometry = setup_geometry(model, 20000.)
    solver = ViscoelasticWaveSolver(model, geometry, space_order=4,
                                    device="cpu")
    rec1, _, _, _, _ = solver.forward()
    assert np.isfinite(np.linalg.norm(rec1.data))


def test_solver_rejects_rec2_elsewhere():
    model = demo_model("layers-viscoelastic", space_order=4, shape=(21, 21),
                       nbl=4, spacing=(20., 20.))
    geometry = setup_geometry(model, 100.)
    solver = ViscoelasticWaveSolver(model, geometry, device="cpu")
    rec2 = geometry.new_rec(name="rec2")
    rec2.coordinates = rec2.coordinates + np.array([0., 20.])
    with pytest.raises(ValueError, match="share coordinates"):
        solver.forward(rec2=rec2)


@pytest.fixture(scope="module")
def case():
    """The (41, 36) float64 set-up of ``tests/test_visco_grad.py``: vp 2.0 /
    2.4, vs = vp/2, Gardner rho, qp 60, qs 40, nbl 8, the mask boundary, dt
    1 ms, one source at (200, 20) m, 21 receivers at 30 m, tn 140 ms; the
    padded physical fields, the tables and a seeded residual."""
    shape, dtype = (41, 36), np.float64
    vp = np.full(shape, 2.0, dtype)
    vp[:, 18:] = 2.4
    vs = vp / 2
    rho = 0.31 * (1e3 * vp) ** 0.25
    qp = np.full(shape, 60.0, dtype)
    qs = np.full(shape, 40.0, dtype)
    model = JModel(origin=(0., 0.), spacing=(10., 10.), shape=shape,
                   space_order=4, vp=vp, vs=vs, b=(1.0 / rho), qp=qp, qs=qs,
                   nbl=8, bcs="mask", dtype=dtype, dt=1.0)
    geom = JGeometry(model, np.stack([np.linspace(0., 400., 21),
                                      np.full(21, 30.0)], 1),
                     np.array([[200., 20.0]]), 0., 140., f0=0.015,
                     src_type="Ricker")
    s_idx, s_w = interp_table(geom.src_positions, model.origin_pml,
                              model.spacing, dtype=dtype)
    r_idx, r_w = interp_table(geom.rec_positions, model.origin_pml,
                              model.spacing, dtype=dtype)
    pads = tuple(tuple(p) for p in model.padsizes)
    phys = [np.pad(x, pads, mode="edge") for x in (vp, vs, rho, qp, qs)]
    return dict(
        phys=phys, damp=np.asarray(model.damp, dtype),
        fields=[np.asarray(getattr(model, n), dtype)
                for n in ("lam", "mu", "b", "qp", "qs")],
        wav=np.asarray(geom.src.data, dtype), s_idx=s_idx, s_w=s_w,
        r_idx=r_idx, r_w=r_w, dt=float(model.critical_dt), f0=geom.f0,
        kw=dict(nt=geom.nt, spacing=model.spacing, space_order=4),
        res=np.random.RandomState(0).randn(geom.nt, 21))


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(got.detach().numpy() - want).max() / np.abs(want).max()


def _tables(c, jax=False):
    conv = jnp.asarray if jax else (lambda a: a)
    return [conv(c[k]) for k in ("s_idx", "s_w", "r_idx", "r_w")]


def test_forwards_match_the_jax_functions(case):
    """``viscoelastic_forward`` (rec1 and rec2) and
    ``viscoelastic_forward_seg`` (rec1, rec2 and the illumination) within
    1e-10 of the JAX functions' (measured 1.5e-15)."""
    c = case
    J, T = jnp.asarray, torch.as_tensor
    jf = [J(a) for a in c["fields"]] + [J(c["damp"]), c["f0"], J(c["wav"])]
    tf = [T(a) for a in c["fields"]] + [T(c["damp"]), c["f0"], T(c["wav"])]
    jr1, jr2 = jst.viscoelastic_forward(*jf, *_tables(c, True), c["dt"],
                                        **c["kw"])
    tr1, tr2 = st.viscoelastic_forward(*tf, *_tables(c), c["dt"], **c["kw"])
    assert _rel(tr1, jr1) <= TOL and _rel(tr2, jr2) <= TOL
    assert not tr1[-1].any() and tr1[1:-1].abs().max() > 0
    jr1s, jr2s, jil = jst.viscoelastic_forward_seg(
        *jf, *_tables(c, True), c["dt"], n_checkpoints=5, **c["kw"])
    tr1s, tr2s, til = st.viscoelastic_forward_seg(
        *tf, *_tables(c), c["dt"], n_checkpoints=5, **c["kw"])
    for got, want in ((tr1s, jr1s), (tr2s, jr2s), (til, jil)):
        assert _rel(got, want) <= TOL
    assert torch.equal(tr1s, tr1)


def test_hist_and_adjoint_match_the_jax_functions(case):
    """``viscoelastic_forward_hist`` (rec1, illumination and the 7 history
    fields), ``viscoelastic_adjoint_from_hist`` (the five gradients of
    ``sum_t <res[t], rec1[t]>``) and ``viscoelastic_value_and_grad`` (L2)
    within 1e-10 of the JAX functions' (measured 1.9e-14)."""
    c = case
    J, T = jnp.asarray, torch.as_tensor
    pj = [J(a) for a in c["phys"]]
    pt = [T(a) for a in c["phys"]]
    jvp, jvs, jrho, jqp, jqs = pj
    tvp, tvs, trho, tqp, tqs = pt
    common_j = (J(c["damp"]), c["f0"], J(c["wav"]), *_tables(c, True))
    common_t = (T(c["damp"]), c["f0"], T(c["wav"]), *_tables(c))
    jrec, jil, jh = jsg.viscoelastic_forward_hist(
        jrho * (jvp * jvp - 2.0 * jvs * jvs), jrho * jvs * jvs, 1.0 / jrho,
        jqp, jqs, *common_j, c["dt"], **c["kw"])
    trec, til, th = sg.viscoelastic_forward_hist(
        trho * (tvp * tvp - 2.0 * tvs * tvs), trho * tvs * tvs, 1.0 / trho,
        tqp, tqs, *common_t, c["dt"], **c["kw"])
    assert len(th) == len(jh) == 7
    assert _rel(trec, jrec) <= TOL and _rel(til, jil) <= TOL
    for got, want in zip(th, jh):
        assert got.shape == want.shape and _rel(got, want) <= TOL
    gj = jsg.viscoelastic_adjoint_from_hist(
        *pj, J(c["damp"]), c["f0"], J(c["r_idx"]), J(c["r_w"]),
        J(c["res"]), jh, c["dt"], **c["kw"])
    gt = sg.viscoelastic_adjoint_from_hist(
        *pt, T(c["damp"]), c["f0"], c["r_idx"], c["r_w"], T(c["res"]), th,
        c["dt"], **c["kw"])
    for name, got, want in zip(("vp", "vs", "rho", "qp", "qs"), gt, gj):
        assert _rel(got, want) <= TOL, name

    obs = 0.9 * np.asarray(jrec)
    fj, gj, _, rj = jsg.viscoelastic_value_and_grad(
        *pj, *common_j, J(obs), jnp.zeros_like(J(obs)), c["dt"],
        least_square_jax, **c["kw"])
    ft, gt, _, rt = sg.viscoelastic_value_and_grad(
        *pt, *common_t, T(obs), torch.zeros(obs.shape, dtype=torch.float64),
        c["dt"], least_square_torch, **c["kw"])
    assert abs(float(ft) - float(fj)) <= TOL * abs(float(fj))
    assert _rel(rt, rj) <= TOL
    for name, got, want in zip(("vp", "vs", "rho", "qp", "qs"), gt, gj):
        assert _rel(got, want) <= TOL, name


def test_five_parameter_gradient_matches_finite_differences(case):
    """The saved-history gradient of ``0.5 sum rec1^2`` against central
    differences along a smooth seeded perturbation of each of vp, vs, rho,
    qp and qs (1e-3 of the field's mean, float64): within 5e-5 relative,
    the JAX test's limit, and non-zero."""
    from scipy.ndimage import gaussian_filter
    c = case
    T = torch.as_tensor
    common = (T(c["damp"]), c["f0"], T(c["wav"]), *_tables(c))
    zeros = torch.zeros((c["kw"]["nt"], 21), dtype=torch.float64)
    base = [T(a) for a in c["phys"]]

    def loss(params):
        vp, vs, rho, qp, qs = params
        rec1, _ = st.viscoelastic_forward(
            rho * (vp * vp - 2.0 * vs * vs), rho * vs * vs, 1.0 / rho, qp,
            qs, *common, c["dt"], **c["kw"])
        return 0.5 * float(torch.sum(rec1 * rec1))

    f, grads, _, _ = sg.viscoelastic_value_and_grad(
        *base, *common, zeros, zeros, c["dt"], least_square_torch,
        **c["kw"])
    assert abs(float(f) - loss(base)) <= 1e-12 * abs(float(f))
    rng = np.random.RandomState(17)
    for i, name in enumerate(("vp", "vs", "rho", "qp", "qs")):
        bx = c["phys"][i]
        d = gaussian_filter(rng.randn(*bx.shape), 3)
        d *= 1e-3 * np.abs(bx).mean() / np.abs(d).max()
        plus, minus = list(base), list(base)
        plus[i] = T(bx + d)
        minus[i] = T(bx - d)
        fd = (loss(plus) - loss(minus)) / 2.0
        an = float(torch.sum(grads[i] * T(d)))
        assert abs(fd - an) <= 5e-5 * max(abs(fd), abs(an), 1e-16), \
            (name, fd, an)
        assert abs(an) > 0, name
