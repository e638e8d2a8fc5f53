"""The port's viscoacoustic objective for all six kernels and every route,
its checkpointed differentiable forward and its Born modeling, against the
JAX package on the CPU (the gates of tests/test_visco_grad.py at their
sizes):

* ``viscoacoustic.forward_seg`` equals the plain ``forward`` bitwise for
  each kernel, its illumination the JAX one (1e-12 at f64), and the
  autograd gradient through it does not change with the checkpoint count
  (f64, 1e-12 of the max);
* ``visco_fwi_obj_multi``'s "vjp" route against the JAX "vjp" for each
  kernel (f64, 1e-10; f32 1e-5 relative objective, 3e-5 of the max
  gradient), "saved" against JAX's "saved" at f32, saved equal to vjp for
  sls/2 (f64, 1e-12 of the max);
* ``visco_fm_multi`` of the five kernels other than sls/2 against the JAX
  one; "auto" for them runs "vjp" and for sls/2 off the kernels "saved",
  counted in ``EAGER`` and warned once; "saved" on another kernel and
  "pallas" off the kernels raise;
* ``visco_born`` against ``jax.jvp``'s Born for each kernel (f64, 1e-12),
  its O(h^2) slopes and its dot test against the saved-history adjoint
  (sls/2, 1e-11);
* the grid fields a step of each kernel saves for autograd, against
  ``GRAPH_FIELDS_PER_STEP``.

Small case (as tests/test_torch_visco.py): a two-layer 41 x 36 model at 10
m with qp 60/90, Gardner density, nbl 8, space order 4, dt 1 ms, tn 100-140
ms, 1-2 shots, 21 receivers.
"""
import functools
import warnings
import weakref

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from devito_fwi_tpu import AcquisitionGeometry
from devito_fwi_tpu import visco_fwi as jvf
from devito_fwi_tpu.misfit import least_square as j_least_square
from devito_fwi_tpu.ops import visco_grad as jvg
from devito_fwi_tpu.ops import viscoacoustic as jva
from devito_fwi_tpu.ops.interp import interp_table

from devito_fwi_tpu_torch import fwi as tfwi
from devito_fwi_tpu_torch import visco_fwi as tvf
from devito_fwi_tpu_torch.misfit import least_square as t_least_square
from devito_fwi_tpu_torch.ops import visco_grad as tvg
from devito_fwi_tpu_torch.ops import viscoacoustic as tva
from test_torch_visco import (_jax_geometry, _port_geometry, _port_shots,
                              _rel, _vp0)

KINDS = sorted(tva.KERNELS)
OTHERS = [k for k in KINDS if k != ("sls", 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this module runs: the suite runs several
    pytest workers on one machine, and torch's thread pool in each of them
    (as many threads as cores) oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@functools.lru_cache(maxsize=None)
def _ops_case(dtype, tn=100.):
    """(geometry, padded vp, b, qp, damp tensors, the wavelet, the tables of
    shot 0, dt, f0)."""
    g = _jax_geometry(dtype, tn=tn, nsrc=1)
    m = g.model
    s_idx, s_w = interp_table(g.src_positions, m.origin_pml, m.spacing,
                              dtype=m.dtype)
    r_idx, r_w = interp_table(g.rec_positions, m.origin_pml, m.spacing,
                              dtype=m.dtype)
    fields = tuple(torch.as_tensor(np.asarray(getattr(m, n), m.dtype))
                   for n in ("vp", "b", "qp", "damp"))
    return (g, fields, torch.as_tensor(g.src.data),
            (s_idx, s_w, r_idx, r_w), float(m.critical_dt), g.f0)


def _jnp(*xs):
    return [jnp.asarray(x.numpy() if torch.is_tensor(x) else x) for x in xs]


def _kw(g, kind):
    return dict(kernel=kind[0], time_order=kind[1], nt=g.nt,
                spacing=g.model.spacing, space_order=4)


# ---------------------------------------------------------------------------
# the checkpointed differentiable forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS, ids=lambda k: f"{k[0]}{k[1]}")
def test_forward_seg_matches_plain(kind):
    """Each kernel's steps in 5 segments: bitwise the plain forward's
    traces; the illumination equals the JAX ``forward_seg``'s (f64,
    1e-12)."""
    g, fields, wav, tables, dt, f0 = _ops_case(np.float64)
    kw = _kw(g, kind)
    rec, _ = tva.forward(*fields, wav, *tables, dt, f0, **kw)
    rec_s, illum = tva.forward_seg(*fields, wav, *tables, dt, f0,
                                   n_checkpoints=5, **kw)
    assert torch.equal(rec, rec_s)
    _, jil = jva.forward_seg(*_jnp(*fields, wav, *tables), dt, f0,
                             n_checkpoints=5, **kw)
    assert _rel(illum.numpy(), jil) < 1e-12 and illum.max() > 0


@pytest.mark.parametrize("kind", [("sls", 2), ("ren", 1)],
                         ids=lambda k: f"{k[0]}{k[1]}")
def test_gradient_invariant_to_checkpoint_count(kind):
    """The (vp, qp) gradient of 0.5 |rec|^2 through ``forward_seg`` is the
    same for 1, 4 and 11 segments (f64, 1e-12 of the max)."""
    g, (vp, b, qp, damp), wav, tables, dt, f0 = _ops_case(np.float64)

    def grad_with(nck):
        x = [vp.clone().requires_grad_(True), qp.clone().requires_grad_(True)]
        rec, _ = tva.forward_seg(x[0], b, x[1], damp, wav, *tables, dt, f0,
                                 n_checkpoints=nck, **_kw(g, kind))
        (0.5 * torch.sum(rec * rec)).backward()
        return [t.grad.numpy() for t in x]

    base = grad_with(1)
    for nck in (4, 11):
        for got, want in zip(grad_with(nck), base):
            assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


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


@pytest.mark.parametrize("kind", KINDS, ids=lambda k: f"{k[0]}{k[1]}")
def test_graph_fields_per_step(kind):
    """The grid fields autograd saves a step of the kernel (distinct
    storages alive after the forward, counted with saved_tensors_hooks
    over 6 and 12 steps) is
    what ``GRAPH_FIELDS_PER_STEP`` says, rounded up."""
    shape = (24, 24)
    s_idx, s_w = interp_table(np.array([[80., 80.]]), (0., 0.), (10., 10.))
    r_idx, r_w = interp_table(np.array([[60., 60.], [150., 60.]]), (0., 0.),
                              (10., 10.))
    wav = torch.randn(20, 1)
    saved = {}
    for n in (6, 12):
        refs = []

        def pack(t):
            refs.append(weakref.ref(t))
            return t

        vp = torch.full(shape, 2.0, requires_grad=True)
        qp = torch.full(shape, 50.0, requires_grad=True)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = tva.forward(vp, torch.ones(shape), qp, torch.ones(shape),
                              wav, s_idx, s_w, r_idx, r_w, 1.0, 0.015,
                              kernel=kind[0], time_order=kind[1], nt=n + 2,
                              spacing=(10., 10.), space_order=4)
        saved[n] = _held(refs)
        del out
    per_step = (saved[12] - saved[6]) / 6 / (np.prod(shape) * 4)
    assert tvf.GRAPH_FIELDS_PER_STEP[kind] == int(np.ceil(per_step))


# ---------------------------------------------------------------------------
# the objective
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _obs(dtype, kind, tn=100.):
    g = _jax_geometry(dtype, tn=tn)
    return g, jvf.visco_fm_multi(g, *kind)


# limits by dtype: objective (relative), gradients (of their max)
TOL = {np.float64: (1e-10, 1e-10), np.float32: (1e-5, 3e-5)}


def _against_jax(dtype, kind, route, **extra):
    g0, obs = _obs(dtype, kind)
    p0 = _port_geometry(g0)
    common = dict(calc_grad=True, vp=_vp0(g0), kernel=kind[0],
                  time_order=kind[1], grad_route=route, n_checkpoints=4,
                  **extra)
    fj, gj, _ = jvf.visco_fwi_obj_multi(g0, obs, j_least_square, **common)
    ft, gt, _ = tvf.visco_fwi_obj_multi(p0, _port_shots(obs, p0),
                                        t_least_square, device="cpu",
                                        **common)
    f_tol, g_tol = TOL[dtype]
    assert abs(ft - fj) <= f_tol * abs(fj)
    for k in ("vp", "qp"):
        assert gt[k].shape == g0.model.shape
        assert _rel(gt[k], gj[k]) < g_tol, k
    return ft, gt


@pytest.mark.parametrize("kind", KINDS, ids=lambda k: f"{k[0]}{k[1]}")
def test_vjp_matches_jax_f64(kind):
    """Every kernel's vjp route against the JAX vjp route, with the
    illumination fix and precondition, within 1e-10."""
    _against_jax(np.float64, kind, "vjp")


@pytest.mark.parametrize("kind,route", [(("sls", 2), "vjp"),
                                        (("sls", 2), "saved"),
                                        (("deng_mcmechan", 1), "vjp")],
                         ids=["sls2-vjp", "sls2-saved", "deng1-vjp"])
def test_routes_match_jax_f32(kind, route):
    """f32: the route against the JAX route, 1e-5 (objective) and 3e-5 of
    the max (gradients)."""
    _against_jax(np.float32, kind, route, precond=False)


def test_saved_equals_vjp_f64():
    """sls/2: the hand-written adjoint and autograd through the
    checkpointed forward, objective and both gradients within 1e-12 (of
    the max), shot chunks of 1 on the vjp route, tn 140 ms."""
    g0, obs = _obs(np.float64, ("sls", 2), tn=140.)
    p0 = _port_geometry(g0)
    shots = _port_shots(obs, p0)
    common = dict(calc_grad=True, vp=_vp0(g0), precond=False, device="cpu")
    f_v, g_v, _ = tvf.visco_fwi_obj_multi(p0, shots, grad_route="vjp",
                                          shot_chunk=1, **common)
    f_s, g_s, _ = tvf.visco_fwi_obj_multi(p0, shots, grad_route="saved",
                                          **common)
    assert abs(f_v - f_s) <= 1e-12 * abs(f_v)
    for k in ("vp", "qp"):
        assert np.abs(g_v[k] - g_s[k]).max() <= \
            1e-12 * np.abs(g_v[k]).max(), k


@pytest.mark.parametrize("kind", OTHERS, ids=lambda k: f"{k[0]}{k[1]}")
def test_other_kernels_run_auto_on_vjp(kind):
    """f32, the kernels other than sls/2: ``visco_fm_multi`` (eager, shot
    by shot) against the JAX one (1e-5 of the max) and the objective's
    auto against the JAX auto (which runs vjp); each counted once; a trial
    through the eager forward gives the gradient call's objective."""
    g0, obs = _obs(np.float32, kind)
    p0 = _port_geometry(g0)
    tvf.reset_counters()
    got = tvf.visco_fm_multi(p0, *kind, device="cpu")
    assert _rel(np.stack([s.data for s in got]),
                np.stack([s.data for s in obs])) < 1e-5
    assert tvf.EAGER == {"objective": 0, "fm_multi": 1}
    ft, _ = _against_jax(np.float32, kind, None, precond=False)
    assert tvf.EAGER == {"objective": 1, "fm_multi": 1}
    f_try, g_try, _ = tvf.visco_fwi_obj_multi(
        p0, _port_shots(obs, p0), kernel=kind[0], time_order=kind[1],
        vp=_vp0(g0), device="cpu")
    assert f_try == ft and g_try is None


def _vertical_line(dtype):
    g = _jax_geometry(dtype)
    rec = np.stack([np.full(15, 300.), np.linspace(20., 340., 15)], 1)
    return AcquisitionGeometry(g.model, rec, g.src_positions, 0., g.tn,
                               f0=g.f0, src_type="Ricker")


def test_auto_takes_the_saved_route_off_the_kernels():
    """sls/2, f32, receivers on a vertical line: ``visco_fm_multi`` and the
    objective's auto run the eager operators ("saved"), counted, warned
    once per reason; the objective equals the JAX auto (its saved route)
    within 1e-5 / 3e-5; "pallas" raises."""
    g = _vertical_line(np.float32)
    obs = jvf.visco_fm_multi(g)
    p = _port_geometry(g)
    tvf.reset_counters()
    tfwi._eager_warn.seen.clear()
    with pytest.warns(UserWarning, match="adjacent z-planes"):
        got = tvf.visco_fm_multi(p, device="cpu")
    assert _rel(np.stack([s.data for s in got]),
                np.stack([s.data for s in obs])) < 1e-5
    shots = _port_shots(obs, p)
    fj, gj, _ = jvf.visco_fwi_obj_multi(g, obs, j_least_square,
                                        calc_grad=True, vp=_vp0(g))
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # warned once, by visco_fm_multi
        ft, gt, _ = tvf.visco_fwi_obj_multi(p, shots, t_least_square,
                                            calc_grad=True, vp=_vp0(g),
                                            device="cpu")
    assert tvf.EAGER == {"objective": 1, "fm_multi": 1}
    assert abs(ft - fj) <= 1e-5 * abs(fj)
    for k in ("vp", "qp"):
        assert _rel(gt[k], gj[k]) < 3e-5, k
    with pytest.raises(ValueError, match="adjacent z-planes"):
        tvf.visco_fwi_obj_multi(p, shots, calc_grad=True,
                                grad_route="pallas", device="cpu")


@pytest.mark.parametrize("route", ["saved", "pallas"])
def test_saved_and_kernels_refuse_other_kernels(route):
    g0, obs = _obs(np.float32, ("ren", 2))
    p0 = _port_geometry(g0)
    with pytest.raises(ValueError, match="sls/2 kernel only"):
        tvf.visco_fwi_obj_multi(p0, _port_shots(obs, p0), calc_grad=True,
                                kernel="ren", time_order=2,
                                grad_route=route, device="cpu")
    with pytest.raises(ValueError, match="expected one of"):
        tvf.visco_fm_multi(p0, "ren", 3, device="cpu")


# ---------------------------------------------------------------------------
# Born
# ---------------------------------------------------------------------------

def _perturbations(vp, qp):
    from scipy.ndimage import gaussian_filter
    rng = np.random.RandomState(4)
    out = []
    for f in (vp, qp):
        d = gaussian_filter(rng.randn(*f.shape), 3)
        out.append(torch.as_tensor(
            d * 1e-2 * float(f.abs().mean()) / np.abs(d).max()))
    return out


@pytest.mark.parametrize("kind", KINDS, ids=lambda k: f"{k[0]}{k[1]}")
def test_born_matches_jax_f64(kind):
    """Each kernel's (rec, drec) against ``jax.jvp``'s Born within 1e-12;
    the primal is bitwise the plain forward's."""
    g, (vp, b, qp, damp), wav, tables, dt, f0 = _ops_case(np.float64)
    dvp, dqp = _perturbations(vp, qp)
    kw = _kw(g, kind)
    rec, drec = tvg.visco_born(vp, b, qp, dvp, dqp, damp, wav, *tables, dt,
                               f0, **kw)
    jrec, jdrec = jvg.visco_born(*_jnp(vp, b, qp, dvp, dqp, damp, wav,
                                       *tables), dt, f0, **kw)
    assert _rel(rec.numpy(), jrec) < 1e-12
    assert _rel(drec.numpy(), jdrec) < 1e-12
    assert torch.equal(rec, tva.forward(vp, b, qp, damp, wav, *tables, dt,
                                        f0, **kw)[0])


def test_born_slopes_and_adjoint_dot():
    """sls/2, tn 140 ms: |F(m + h dm) - F(m) - h J dm| falls as h^2
    (slopes within 1.8-2.2), and <J dm, dr> equals <dm, J^T dr> with J^T
    the saved-history adjoint sweep (1e-11)."""
    g, (vp, b, qp, damp), wav, tables, dt, f0 = _ops_case(np.float64,
                                                         tn=140.)
    dvp, dqp = _perturbations(vp, qp)
    kw = _kw(g, ("sls", 2))
    rec, drec = tvg.visco_born(vp, b, qp, dvp, dqp, damp, wav, *tables, dt,
                               f0, **kw)
    errs = []
    for h in (1.0, 0.5, 0.25):
        pert, _ = tva.forward(vp + h * dvp, b, qp + h * dqp, damp, wav,
                              *tables, dt, f0, **kw)
        errs.append(float(torch.linalg.norm(pert - rec - h * drec)))
    slopes = [np.log2(errs[i] / errs[i + 1]) for i in range(2)]
    assert all(1.8 < s < 2.2 for s in slopes), (slopes, errs)
    dr = torch.as_tensor(np.random.RandomState(6).randn(*rec.shape))
    okw = dict(nt=g.nt, spacing=g.model.spacing, space_order=4)
    _, _, hist = tvg.visco_sls2_forward_hist(vp, b, qp, damp, wav, *tables,
                                             dt, f0, **okw)
    g_vp, g_qp = tvg.visco_sls2_adjoint_from_hist(
        vp, b, qp, damp, wav, *tables, dr, hist, dt, f0, **okw)
    lhs = float(torch.sum(drec * dr))
    rhs = float(torch.sum(g_vp * dvp) + torch.sum(g_qp * dqp))
    assert abs(lhs - rhs) <= 1e-11 * max(abs(lhs), abs(rhs))
