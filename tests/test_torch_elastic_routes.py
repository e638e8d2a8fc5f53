"""The port's elastic objective on every route, its checkpointed
differentiable forwards and its Born modeling, against the JAX package on
the CPU (the gates of tests/test_elastic_grad.py at their sizes):

* ``elastic_forward_seg`` and ``viscoelastic_forward_seg`` equal the plain
  forwards bitwise for any ``n_checkpoints``, and the autograd gradient
  through them does not change with the checkpoint count or ``hoist``
  (f64, 1e-12 of the max) and equals ``jax.grad`` of the JAX function;
* ``elastic_fwi_obj_multi``'s "saved" and "vjp" routes against the JAX
  objective's same routes (f64 1e-10; f32 1e-5 relative objective, 3e-5
  of the max gradient), saved equal to vjp (f64, 1e-12 of the max) in 2-D
  and 3-D, a 3-D central difference of the auto route's gradient;
* "auto" on a geometry the kernels do not take (receivers on a vertical
  line) runs "saved", counts ``EAGER["objective"]`` and warns once;
  ``elastic_fm_multi`` models it shot by shot (``EAGER["fm_multi"]``);
  "pallas" on it raises;
* ``elastic_born`` against ``jax.jvp``'s Born (f64, 1e-12), its O(h^2)
  slopes and its dot test against ``elastic_adjoint_from_hist`` (1e-11);
* the grid fields a step of the forward saves for autograd, against the
  figures ``_eager_bytes_per_shot`` sizes the vjp route's chunks with.

Small case (as tests/test_torch_elastic.py): a two-layer 41 x 36 model at
10 m, nbl 8, space order 4, dt 1 ms, tn 100-140 ms, 1-2 shots, 21
receivers; in 3-D 17 x 15 x 13, nbl 4, tn 60 ms.
"""
import functools
import warnings
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from devito_fwi_tpu import AcquisitionGeometry, SeismicModel
from devito_fwi_tpu import elastic_fwi as jel
from devito_fwi_tpu.misfit import least_square as j_least_square
from devito_fwi_tpu.ops import staggered as jst
from devito_fwi_tpu.ops import staggered_grad as jsg
from devito_fwi_tpu.ops.interp import interp_table

from devito_fwi_tpu_torch import elastic_fwi as tel
from devito_fwi_tpu_torch import fwi as tfwi
from devito_fwi_tpu_torch.misfit import least_square as t_least_square
from devito_fwi_tpu_torch.ops import staggered as tst
from devito_fwi_tpu_torch.ops import staggered_grad as tsg
from test_torch_elastic import (_jax_geometry, _port_geometry, _port_shots,
                                _rel)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this module runs: the suite runs several
    pytest workers on one machine, and torch's thread pool in each of them
    (as many threads as cores) oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _ops_case(dtype, tn=100.):
    """(geometry, padded lam, mu, b, damp, wavelet tensors, the tables of
    shot 0, op keywords, dt)."""
    g = _jax_geometry(dtype, tn=tn, nsrc=1)
    m = g.model
    s_idx, s_w = interp_table(g.src_positions, m.origin_pml, m.spacing,
                              dtype=m.dtype)
    r_idx, r_w = interp_table(g.rec_positions, m.origin_pml, m.spacing,
                              dtype=m.dtype)
    T = torch.as_tensor
    fields = [T(np.asarray(x, m.dtype)) for x in (m.lam, m.mu, m.b)]
    fields.append(torch.ones(m.padded_shape, dtype=fields[0].dtype))
    kw = dict(nt=g.nt, spacing=m.spacing, space_order=4)
    return g, fields, T(g.src.data), (s_idx, s_w, r_idx, r_w), kw, \
        float(m.critical_dt)


def _jnp(*xs):
    return [jnp.asarray(x.numpy() if torch.is_tensor(x) else x) for x in xs]


# ---------------------------------------------------------------------------
# the checkpointed differentiable forwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_checkpoints", [0, 1, 5, 13])
def test_seg_forward_matches_plain(n_checkpoints):
    """The same steps in segments: bitwise the plain forward's traces; the
    illumination equals the JAX one (f32, 1e-6 of its max)."""
    g, fields, wav, tables, kw, dt = _ops_case(np.float32)
    r1, r2 = tst.elastic_forward(*fields, wav, *tables, dt, **kw)
    s1, s2, illum = tst.elastic_forward_seg(*fields, wav, *tables, dt,
                                            n_checkpoints=n_checkpoints,
                                            **kw)
    assert torch.equal(r1, s1) and torch.equal(r2, s2)
    _, _, jil = jst.elastic_forward_seg(*_jnp(*fields, wav, *tables), dt,
                                        n_checkpoints=n_checkpoints, **kw)
    assert _rel(illum.numpy(), jil) < 1e-6
    assert illum.min() >= 0 and illum.max() > 0


def test_viscoelastic_seg_forward_matches_plain():
    g, (lam, mu, b, damp), wav, tables, kw, dt = _ops_case(np.float64)
    qp = torch.full_like(lam, 60.)
    qs = torch.full_like(lam, 40.)
    args = (lam, mu, b, qp, qs, damp, 0.015, wav, *tables, dt)
    r1, r2 = tst.viscoelastic_forward(*args, **kw)
    s1, s2, illum = tst.viscoelastic_forward_seg(*args, n_checkpoints=4,
                                                 **kw)
    assert torch.equal(r1, s1) and torch.equal(r2, s2)
    _, _, jil = jst.viscoelastic_forward_seg(
        *_jnp(lam, mu, b, qp, qs, damp), 0.015, *_jnp(wav, *tables), dt,
        n_checkpoints=4, **kw)
    assert _rel(illum.numpy(), jil) < 1e-12


def test_gradient_invariant_to_checkpoint_count():
    """Autograd through the segments: the lam gradient of 0.5 |rec1|^2 is
    the same for 1, 5 and 13 segments and with the averages formed in the
    step (f64, 1e-12 of the max), and equals jax.grad of the JAX
    function (1e-12)."""
    g, (lam, mu, b, damp), wav, tables, kw, dt = _ops_case(np.float64)

    def grad_with(nck, hoist=None):
        x = lam.clone().requires_grad_(True)
        rec1, _, _ = tst.elastic_forward_seg(x, mu, b, damp, wav, *tables,
                                             dt, n_checkpoints=nck,
                                             hoist=hoist, **kw)
        (0.5 * torch.sum(rec1 * rec1)).backward()
        return x.grad.numpy()

    g1 = grad_with(1)
    scale = np.abs(g1).max()
    for got in (grad_with(5), grad_with(13), grad_with(5, hoist=False)):
        assert np.abs(got - g1).max() <= 1e-12 * scale
    jargs = _jnp(mu, b, damp, wav, *tables)

    def loss(x):
        rec1, _, _ = jst.elastic_forward_seg(x, *jargs, dt, n_checkpoints=5,
                                             **kw)
        return 0.5 * jnp.sum(rec1 * rec1)

    want = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(lam.numpy())))
    assert _rel(g1, want) < 1e-12


def _held(refs):
    """Bytes of the distinct storages of the saved tensors still alive
    (those of graph nodes the forward freed on the way do not count)."""
    live = {}
    for r in refs:
        t = r()
        if t is not None:
            live[t.untyped_storage().data_ptr()] = \
                t.untyped_storage().nbytes()
    return sum(live.values())


@pytest.mark.parametrize("ndim", [2, 3])
def test_graph_fields_per_step(ndim):
    """The grid fields autograd saves a step of the forward (distinct
    storages alive after the forward, counted with saved_tensors_hooks
    over 6 and 12 steps) is
    what ``GRAPH_FIELDS_PER_STEP`` says, rounded up."""
    shape = (24,) * ndim
    src, rec = np.full((1, ndim), 80.), np.full((2, ndim), 60.)
    rec[1, 0] = 150.
    s_idx, s_w = interp_table(src, (0.,) * ndim, (10.,) * ndim)
    r_idx, r_w = interp_table(rec, (0.,) * ndim, (10.,) * ndim)
    wav = torch.randn(16, 1)
    saved = {}
    for n in (6, 12):
        refs = []

        def pack(t):
            refs.append(weakref.ref(t))
            return t

        leaves = [torch.full(shape, v, requires_grad=True)
                  for v in (4.0, 1.0, 1.0)]
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = tst.elastic_forward(*leaves, torch.ones(shape), wav, s_idx,
                                      s_w, r_idx, r_w, 1.0, nt=n + 1,
                                      spacing=(10.,) * ndim, space_order=4)
        saved[n] = _held(refs)
        del out
    per_step = (saved[12] - saved[6]) / 6 / (np.prod(shape) * 4)
    assert tel.GRAPH_FIELDS_PER_STEP[ndim] == int(np.ceil(per_step))


# ---------------------------------------------------------------------------
# the objective's routes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _obs(dtype, tn=140.):
    g = _jax_geometry(dtype, tn=tn)
    return g, jel.elastic_fm_multi(g)[0]


def _vp0(g):
    crop = tuple(slice(lo, lo + n) for (lo, _), n in
                 zip(g.model.padsizes, g.model.shape))
    return np.asarray(jel.model_vp_vs_rho(g.model)[0])[crop] * 1.02


# limits by dtype: objective (relative), gradients (of their max)
TOL = {np.float64: (1e-10, 1e-10), np.float32: (1e-5, 3e-5)}


@pytest.mark.parametrize("route", ["saved", "vjp"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_route_matches_jax(route, dtype):
    """Each route against the JAX objective's same route, with the
    illumination fix, precondition and 4 segments; a trial on the route
    gives the gradient call's objective."""
    g0, obs = _obs(dtype)
    p0 = _port_geometry(g0)
    common = dict(calc_grad=True, vp=_vp0(g0), grad_route=route,
                  n_checkpoints=4)
    fj, gj, _ = jel.elastic_fwi_obj_multi(g0, obs, j_least_square, **common)
    shots = _port_shots(obs, p0)
    ft, gt, res = tel.elastic_fwi_obj_multi(p0, shots, t_least_square,
                                            device="cpu", **common)
    f_tol, g_tol = TOL[dtype]
    assert abs(ft - fj) <= f_tol * abs(fj)
    for k in ("vp", "vs", "rho"):
        assert gt[k].shape == g0.model.shape
        assert _rel(gt[k], gj[k]) < g_tol, k
    assert len(res) == 2
    f_try, g_try, _ = tel.elastic_fwi_obj_multi(
        p0, shots, t_least_square, device="cpu", vp=_vp0(g0),
        grad_route=route)
    assert abs(f_try - ft) <= 1e-12 * ft and g_try is None


def test_saved_equals_vjp_f64():
    """The hand-written adjoint and autograd through the checkpointed
    forward: objective and the three gradients within 1e-12 (of the max),
    no illumination fix or precondition, shot chunks of 1 on one route."""
    g0, obs = _obs(np.float64)
    p0 = _port_geometry(g0)
    common = dict(calc_grad=True, vp=_vp0(g0), precond=False,
                  illum_fix=False, n_checkpoints=6, device="cpu")
    shots = _port_shots(obs, p0)
    f_v, g_v, _ = tel.elastic_fwi_obj_multi(p0, shots, grad_route="vjp",
                                            shot_chunk=1, **common)
    f_s, g_s, _ = tel.elastic_fwi_obj_multi(p0, shots, grad_route="saved",
                                            **common)
    assert abs(f_v - f_s) <= 1e-12 * abs(f_v)
    for k in ("vp", "vs", "rho"):
        assert np.abs(g_v[k] - g_s[k]).max() <= \
            1e-12 * np.abs(g_v[k]).max(), k


@functools.lru_cache(maxsize=None)
def _geometry_3d():
    shape = (17, 15, 13)
    dtype = np.float64
    vp = np.full(shape, 2.0, dtype)
    vp[:, :, 6:] = 2.3
    vs = (vp / 2.0).astype(dtype)
    rho = np.ones(shape, dtype)
    model = SeismicModel(origin=(0., 0., 0.), spacing=(10., 10., 10.),
                         shape=shape, space_order=4, vp=vp, vs=vs,
                         b=1.0 / rho, nbl=4, bcs="mask", dtype=dtype,
                         dt=1.0)
    src = np.array([[80.0, 70.0, 20.0], [60.0, 50.0, 20.0]])
    rec = np.stack([np.linspace(0., 160., 9), np.full(9, 70.0),
                    np.full(9, 30.0)], 1)
    g = AcquisitionGeometry(model, rec, src, 0., 60., f0=0.02,
                            src_type="Ricker")
    return g, jel.elastic_fm_multi(g)[0]


def test_3d_routes_match_jax_and_each_other():
    """3-D, f64, with the illumination fix and precondition: the port's
    "saved", "vjp" and "auto" against the JAX routes (1e-10), saved equal
    to vjp (1e-12 of the max); auto runs saved and counts one eager call;
    ``elastic_fm_multi`` equals the JAX forward (1e-12) and counts one."""
    g0, obs = _geometry_3d()
    p0 = _port_geometry(g0)
    tel.reset_counters()
    got = tel.elastic_fm_multi(p0, device="cpu")[0]
    assert _rel(np.stack([s.data for s in got]),
                np.stack([s.data for s in obs])) < 1e-12
    assert tel.EAGER == {"objective": 0, "fm_multi": 1}
    common = dict(calc_grad=True, vp=_vp0(g0), n_checkpoints=4)
    shots = _port_shots(obs, p0)
    out = {}
    for route in ("saved", "vjp"):
        fj, gj, _ = jel.elastic_fwi_obj_multi(g0, obs, j_least_square,
                                              grad_route=route, **common)
        out[route] = tel.elastic_fwi_obj_multi(
            p0, shots, t_least_square, grad_route=route, device="cpu",
            **common)
        assert abs(out[route][0] - fj) <= 1e-10 * abs(fj)
        for k in ("vp", "vs", "rho"):
            assert _rel(out[route][1][k], gj[k]) < 1e-10, (route, k)
    assert tel.EAGER == {"objective": 0, "fm_multi": 1}
    tfwi._eager_warn.seen.clear()
    with pytest.warns(UserWarning, match="kernels are 2-D"):
        out["auto"] = tel.elastic_fwi_obj_multi(p0, shots, device="cpu",
                                                **common)
    assert tel.EAGER == {"objective": 1, "fm_multi": 1}
    assert out["auto"][0] == out["saved"][0]
    for k in ("vp", "vs", "rho"):
        assert np.array_equal(out["auto"][1][k], out["saved"][1][k])
        assert np.abs(out["vjp"][1][k] - out["saved"][1][k]).max() <= \
            1e-12 * np.abs(out["vjp"][1][k]).max(), k


def test_3d_gradient_matches_finite_differences():
    """A central difference of the 3-D objective along a smooth vp
    perturbation against <grad, d> (f64, no fix or precondition; 5e-5, as
    tests/test_elastic_grad.py's 3-D gate)."""
    from scipy.ndimage import gaussian_filter
    g0, obs = _geometry_3d()
    p0 = _port_geometry(g0)
    shots = _port_shots(obs, p0)
    vp0 = _vp0(g0)
    kw = dict(device="cpu", precond=False, illum_fix=False,
              shot_indices=[0], grad_route="saved")
    _, grads, _ = tel.elastic_fwi_obj_multi(p0, shots, calc_grad=True,
                                            vp=vp0, **kw)
    d = gaussian_filter(np.random.RandomState(5).randn(*vp0.shape), 2)
    d *= 1e-3 * vp0.mean() / np.abs(d).max()
    fp = tel.elastic_fwi_obj_multi(p0, shots, vp=vp0 + d, **kw)[0]
    fm = tel.elastic_fwi_obj_multi(p0, shots, vp=vp0 - d, **kw)[0]
    fd = (fp - fm) / 2.0
    an = float(np.sum(grads["vp"] * d))
    assert abs(fd - an) <= 5e-5 * max(abs(fd), abs(an)), (fd, an)


def _vertical_line(dtype):
    """The small 2-D model with its receivers on the vertical line x = 300
    m (off two adjacent z-planes: the kernels do not take it)."""
    g = _jax_geometry(dtype)
    rec = np.stack([np.full(15, 300.), np.linspace(20., 340., 15)], 1)
    return AcquisitionGeometry(g.model, rec, g.src_positions, 0., g.tn,
                               f0=g.f0, src_type="Ricker")


def test_auto_takes_the_saved_route_off_the_kernels():
    """f32, receivers on a vertical line: ``elastic_fm_multi`` and the
    objective run the eager route, counted and warned once per reason; the
    objective equals the JAX objective (whose auto runs its saved route)
    within 1e-5 and 3e-5 of the max; "pallas" raises."""
    g = _vertical_line(np.float32)
    obs = jel.elastic_fm_multi(g)[0]
    p = _port_geometry(g)
    tel.reset_counters()
    tfwi._eager_warn.seen.clear()
    with pytest.warns(UserWarning, match="adjacent z-planes"):
        got = tel.elastic_fm_multi(p, device="cpu")[0]
    assert _rel(np.stack([s.data for s in got]),
                np.stack([s.data for s in obs])) < 1e-5
    shots = _port_shots(obs, p)
    common = dict(calc_grad=True, vp=_vp0(g))
    fj, gj, _ = jel.elastic_fwi_obj_multi(g, obs, j_least_square, **common)
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # warned once, by elastic_fm_multi
        ft, gt, _ = tel.elastic_fwi_obj_multi(p, shots, t_least_square,
                                              device="cpu", **common)
    assert tel.EAGER == {"objective": 1, "fm_multi": 1}
    assert abs(ft - fj) <= 1e-5 * abs(fj)
    for k in ("vp", "vs", "rho"):
        assert _rel(gt[k], gj[k]) < 3e-5, k
    with pytest.raises(ValueError, match="adjacent z-planes"):
        tel.elastic_fwi_obj_multi(p, shots, calc_grad=True,
                                  grad_route="pallas", device="cpu")
    with pytest.raises(ValueError, match="grad_route='bfgs'"):
        tel.elastic_fwi_obj_multi(p, shots, grad_route="bfgs", device="cpu")
    assert tel.EAGER == {"objective": 1, "fm_multi": 1}


def test_kernel_geometry_takes_no_eager_route():
    """On a geometry the kernels take, auto runs them: no count, no
    warning."""
    g0, obs = _obs(np.float32)
    p0 = _port_geometry(g0)
    tel.reset_counters()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tel.elastic_fm_multi(p0, device="cpu")
        tel.elastic_fwi_obj_multi(p0, _port_shots(obs, p0), device="cpu",
                                  calc_grad=True, shot_indices=[0])
    assert tel.EAGER == {"objective": 0, "fm_multi": 0}


# ---------------------------------------------------------------------------
# Born
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _born_case():
    from scipy.ndimage import gaussian_filter
    g, (lam, mu, b, damp), wav, tables, kw, dt = _ops_case(np.float64,
                                                           tn=140.)
    vp, vs, rho = (torch.as_tensor(x) for x in
                   jel.model_vp_vs_rho(g.model))
    rng = np.random.RandomState(9)
    dvp = gaussian_filter(rng.randn(*vp.shape), 3)
    dvp *= 1e-2 * float(vp.abs().mean()) / np.abs(dvp).max()
    dvs = gaussian_filter(rng.randn(*vp.shape), 3)
    dvs *= 1e-2 * float(vs.abs().mean()) / np.abs(dvs).max()
    return (vp, vs, rho, torch.as_tensor(dvp), torch.as_tensor(dvs), damp,
            wav, tables, kw, dt)


def test_born_matches_jax_f64():
    """Primal and tangent traces (rec1 and rec2) against ``jax.jvp``'s
    Born within 1e-12; the primal is bitwise the plain forward's."""
    vp, vs, rho, dvp, dvs, damp, wav, tables, kw, dt = _born_case()
    prim, tang = tsg.elastic_born(vp, vs, rho, dvp, dvs, None, damp, wav,
                                  *tables, dt, **kw)
    jprim, jtang = jsg.elastic_born(*_jnp(vp, vs, rho, dvp, dvs), None,
                                    *_jnp(damp, wav, *tables), dt, **kw)
    for a, b in zip(prim + tang, jprim + jtang):
        assert _rel(a.numpy(), b) < 1e-12
    lam = rho * (vp * vp - 2.0 * vs * vs)
    plain = tst.elastic_forward(lam, rho * vs * vs, 1.0 / rho, damp, wav,
                                *tables, dt, **kw)
    assert torch.equal(prim[0], plain[0]) and torch.equal(prim[1], plain[1])


def test_born_slopes_and_adjoint_dot():
    """|F(m + h dm) - F(m) - h J dm| falls as h^2 (slopes within 1.8-2.2),
    and <J dm, dr> equals <dm, J^T dr> with J^T the saved-history adjoint
    sweep and the chain rule to vp (1e-11)."""
    vp, vs, rho, dvp, _, damp, wav, tables, kw, dt = _born_case()
    (rec1, _), (drec1, _) = tsg.elastic_born(vp, vs, rho, dvp, None, None,
                                             damp, wav, *tables, dt, **kw)
    mu, b = rho * vs * vs, 1.0 / rho

    def fwd(vp_):
        lam_ = rho * (vp_ * vp_ - 2.0 * vs * vs)
        return tst.elastic_forward(lam_, mu, b, damp, wav, *tables, dt,
                                   **kw)[0]

    errs = [float(torch.linalg.norm(fwd(vp + h * dvp) - rec1 - h * drec1))
            for h in (1.0, 0.5, 0.25)]
    slopes = [np.log2(errs[i] / errs[i + 1]) for i in range(2)]
    assert all(1.8 < s < 2.2 for s in slopes), (slopes, errs)
    dr = torch.as_tensor(np.random.RandomState(2).randn(*rec1.shape))
    lam = rho * (vp * vp - 2.0 * vs * vs)
    _, _, hist = tsg.elastic_forward_hist(lam, mu, b, damp, wav, *tables,
                                          dt, **kw)
    glam, _, _ = tsg.elastic_adjoint_from_hist(lam, mu, b, damp, tables[2],
                                               tables[3], dr, hist, dt,
                                               **kw)
    lhs = float(torch.sum(drec1 * dr))
    rhs = float(torch.sum(2.0 * rho * vp * glam * dvp))
    assert abs(lhs - rhs) <= 1e-11 * max(abs(lhs), abs(rhs))
