"""The port's elastic path (devito_fwi_tpu_torch.ops.staggered,
ops.staggered_grad, ops.cuda_staggered, ops.elastic_wavesolver,
elastic_fwi and convert) against the JAX package, on the CPU:

* ``staggered_weights``, ``avg_to`` and ``pad_fold`` equal the JAX ones
  (``np.array_equal``); ``avg_to_T`` and ``pad_fold`` are exact transposes;
* the eager ``elastic_forward`` (and ``elastic_forward_seg``'s
  illumination) meets the JAX XLA forward to 1e-12 relative at f64; the
  port's ``ElasticWaveSolver`` on the CPU reproduces the reference goldens
  19.25636 / 0.627606 (atol 1e-3);
* each of the three plain twins of ``ops.cuda_staggered`` against its
  Pallas kernel in interpret mode at f32 (receiver rows and history 1e-5
  of the max, images 1e-4 of the max), and at f64 against the JAX saved
  route (``staggered_grad.elastic_forward_hist`` /
  ``elastic_adjoint_from_hist``) to 1e-10;
* ``elastic_fwi_obj_multi`` (objective and the three gradients) against
  the JAX objective, with L2 and W2-1d: at f32 against its Pallas route in
  interpret mode (1e-5 relative objective, 1e-4 of the max gradient), at
  f64 against its saved route (1e-10); a trial equal to the gradient
  call's objective; the shot chunks the card's memory allows;
* the kernels' geometry gates against the JAX ones;
* two L-BFGS iterations of ``ElasticFwiLoss`` match the JAX history;
* an f64 central-difference check of the vp gradient;
* the fused forward step's launch helper against a block's shared memory,
  and its source operand (the pattern's non-zero cells) against the
  pattern;
* a torch replay of the fused reverse step's order (ping-pong state, the
  derived stress-adjoint fields formed again from the stored ones) equal
  to the adjoint twin bitwise at f32, and the reverse step's launch helper
  against a block's shared memory and the launch grid's limits.

Small case (as tests/test_elastic_grad.py): a two-layer 41 x 36 model at
10 m, nbl 8, space order 4, dt 1 ms, 2 shots, 21 receivers. The port's
models are built from the JAX models' numpy fields through
``devito_fwi_tpu_torch.convert``.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from devito_fwi_tpu import AcquisitionGeometry, SeismicModel
from devito_fwi_tpu import elastic_fwi as jel
from devito_fwi_tpu.fwi import _batched_tables
from devito_fwi_tpu.misfit import least_square as j_least_square
from devito_fwi_tpu.misfit import qWasserstein as JqW
from devito_fwi_tpu.ops import pallas_staggered as jps
from devito_fwi_tpu.ops import self_adjoint as jsa
from devito_fwi_tpu.ops import staggered as jst
from devito_fwi_tpu.ops import staggered_grad as jsg
from devito_fwi_tpu.optimize import LBFGS as JLBFGS, minimize as jminimize

from devito_fwi_tpu_torch import elastic_fwi as tel
from devito_fwi_tpu_torch.convert import (geometry_from_numpy,
                                          model_from_numpy)
from devito_fwi_tpu_torch.misfit import least_square as t_least_square
from devito_fwi_tpu_torch.misfit import qWasserstein as TqW
from devito_fwi_tpu_torch.models.geometry import setup_geometry
from devito_fwi_tpu_torch.models.presets import demo_model
from devito_fwi_tpu_torch.models.sources import PointSource as TPointSource
from devito_fwi_tpu_torch.ops import cuda_staggered as cs
from devito_fwi_tpu_torch.ops import self_adjoint as tsa
from devito_fwi_tpu_torch.ops import staggered as tst
from devito_fwi_tpu_torch.ops import staggered_grad as tsg
from devito_fwi_tpu_torch.ops.elastic_wavesolver import ElasticWaveSolver
from devito_fwi_tpu_torch.optimize import (LBFGS as TLBFGS,
                                           minimize as tminimize)

SEG = 16  # history segment of the kernel tests: 100 steps -> 7 x 16, padded


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
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _jax_geometry(dtype, vp_scale=1.0, tn=100., nsrc=2):
    shape = (41, 36)
    vp = np.full(shape, 2.0, dtype) * vp_scale
    vp[:, 18:] = 2.4 * vp_scale
    vs = (vp / 2.0).astype(dtype)
    rho = (0.31 * (1e3 * vp) ** 0.25).astype(dtype)
    model = SeismicModel(origin=(0., 0.), spacing=(10., 10.), shape=shape,
                         space_order=4, vp=vp, vs=vs, b=(1.0 / rho), nbl=8,
                         bcs="mask", dtype=dtype, dt=1.0)
    src = np.stack([np.linspace(80., 320., nsrc), np.full(nsrc, 20.0)], 1)
    rec = np.stack([np.linspace(0., 400., 21), np.full(21, 30.0)], 1)
    return AcquisitionGeometry(model, rec, src, 0., tn, f0=0.015,
                               src_type="Ricker")


def _port_geometry(g):
    jm = g.model
    model = model_from_numpy(dict(
        lam=np.asarray(jm.lam), mu=np.asarray(jm.mu), b=np.asarray(jm.b),
        damp=jm.damp, origin=jm.origin, spacing=jm.spacing, shape=jm.shape,
        nbl=jm.nbl, space_order=jm.space_order, fs=jm.fs, dt=jm._dt))
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


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("space_order", [2, 4, 8, 12])
def test_staggered_weights_equal_jax(space_order):
    for got, want in zip(tsa.staggered_weights(space_order),
                         jsa.staggered_weights(space_order)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("dims", [(0,), (1,), (0, 1)])
def test_avg_to_equals_jax(dims):
    x = np.random.default_rng(1).standard_normal((9, 11))
    assert np.array_equal(tst.avg_to(torch.as_tensor(x), dims, 2).numpy(),
                          np.asarray(jst.avg_to(jnp.asarray(x), dims, 2)))
    assert np.array_equal(tsg.avg_to_T(torch.as_tensor(x), dims, 2).numpy(),
                          np.asarray(jsg.avg_to_T(jnp.asarray(x), dims, 2)))


def test_pad_fold_equals_jax():
    g = np.random.default_rng(2).standard_normal((3, 14, 16))
    pads = ((3, 2), (1, 4))
    want = np.stack([np.asarray(jsg.pad_fold(jnp.asarray(gi), pads))
                     for gi in g])
    assert np.array_equal(tsg.pad_fold(torch.as_tensor(g), pads).numpy(),
                          want)


def test_avg_to_T_and_pad_fold_are_exact_transposes():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((9, 11)))
    y = torch.as_tensor(rng.standard_normal((9, 11)))
    for dims in ((0,), (1,), (0, 1)):
        lhs = float(torch.sum(tst.avg_to(x, dims, 2) * y))
        rhs = float(torch.sum(x * tsg.avg_to_T(y, dims, 2)))
        assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0), dims
    pads = ((3, 2), (1, 4))
    xp = torch.as_tensor(rng.standard_normal((9, 11)))
    yp = torch.as_tensor(rng.standard_normal((14, 16)))
    lhs = float(torch.sum(tel._pad_edge(xp, pads) * yp))
    rhs = float(torch.sum(xp * tsg.pad_fold(yp, pads)))
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)
    assert np.array_equal(tel._pad_edge(xp, pads).numpy(),
                          np.pad(xp.numpy(), pads, mode="edge"))


def test_convert_carries_the_elastic_fields():
    g = _jax_geometry(np.float32)
    jm, pm = g.model, _port_geometry(g).model
    for name in ("lam", "mu", "b", "damp"):
        assert np.array_equal(getattr(pm, name), np.asarray(getattr(jm,
                                                                    name)))
    assert pm.critical_dt == jm.critical_dt
    vp, vs, rho = tel.model_vp_vs_rho(pm)
    for got, want in zip((vp, vs, rho), jel.model_vp_vs_rho(jm)):
        assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# eager forward, solver goldens
# ---------------------------------------------------------------------------

def _jax_inputs(g):
    m = g.model
    s_idx, s_w, r_idx, r_w, wav = _batched_tables(g)
    damp = np.asarray(m.damp, m.dtype)
    return m, s_idx, s_w, r_idx, r_w, wav, damp


def test_eager_forward_matches_jax_f64():
    g = _jax_geometry(np.float64)
    m, s_idx, s_w, r_idx, r_w, wav, damp = _jax_inputs(g)
    fields = (np.asarray(m.lam), np.asarray(m.mu), np.asarray(m.b), damp)
    kw = dict(nt=g.nt, spacing=m.spacing, space_order=4)
    dt = float(m.critical_dt)
    want = jst.elastic_forward(*(jnp.asarray(f) for f in fields),
                               jnp.asarray(wav), jnp.asarray(s_idx[1]),
                               jnp.asarray(s_w[1]), jnp.asarray(r_idx),
                               jnp.asarray(r_w), dt, **kw)
    got = tst.elastic_forward(*(torch.as_tensor(f) for f in fields),
                              torch.as_tensor(wav), s_idx[1], s_w[1], r_idx,
                              r_w, dt, **kw)
    for a, b in zip(got, want):
        assert _rel(a.numpy(), b) < 1e-12
    _, _, il = tst.elastic_forward_seg(*(torch.as_tensor(f) for f in fields),
                                       torch.as_tensor(wav), s_idx[1],
                                       s_w[1], r_idx, r_w, dt, **kw)
    _, _, jil = jst.elastic_forward_seg(*(jnp.asarray(f) for f in fields),
                                        jnp.asarray(wav),
                                        jnp.asarray(s_idx[1]),
                                        jnp.asarray(s_w[1]),
                                        jnp.asarray(r_idx), jnp.asarray(r_w),
                                        dt, **kw)
    assert _rel(il.numpy(), jil) < 1e-12


def test_elastic_solver_golden_on_cpu():
    """The reference elastic example (layers-elastic 50 x 50, nbl 40, space
    order 4, tn 1000): |rec1| = 19.25636, |rec2| = 0.627606."""
    model = demo_model("layers-elastic", space_order=4, shape=(50, 50),
                       nbl=40, dtype=np.float32, spacing=(20., 20.))
    geometry = setup_geometry(model, 1000.)
    solver = ElasticWaveSolver(model, geometry, space_order=4, device="cpu")
    rec1, rec2, _, _, _ = solver.forward()
    assert np.isclose(np.linalg.norm(rec1.data), 19.25636, atol=1e-3, rtol=0)
    assert np.isclose(np.linalg.norm(rec2.data), 0.627606, atol=1e-3, rtol=0)


# ---------------------------------------------------------------------------
# the three kernels' twins
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _kernel_case(dtype):
    """Port operands and the three twins' outputs on the small case."""
    g = _jax_geometry(dtype)
    m, s_idx, s_w, r_idx, r_w, wav, damp = _jax_inputs(g)
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    nx, nz = m.padded_shape
    nt = g.nt
    nsteps = nt - 1
    dt = float(m.critical_dt)
    z0 = int(r_idx[..., 1].min())
    T = torch.as_tensor
    prm = cs.stagger_params(T(np.asarray(m.lam)), T(np.asarray(m.mu)),
                            T(np.asarray(m.b)), T(damp))
    inj = cs.source_pattern(s_idx, s_w, dt, (nx, nz), tdt, "cpu")
    injT = inj.transpose(1, 2).contiguous()
    # the Pallas modeling kernel steps its padded 32-step layout; the
    # twin's one segment is its first nsteps steps
    seg10, nseg10 = jps.seg_layout(nsteps)
    nseg = -(-nsteps // SEG)
    wav10 = cs.pad_wavelet(T(wav), nsteps, seg10 * nseg10)
    wav9 = cs.pad_wavelet(T(wav), nsteps, SEG * nseg)
    kw = dict(nt=nt, nx=nx, nz=nz, space_order=4, spacing=m.spacing, z0=z0)
    rows10 = cs.elastic_segments_plain(*prm, injT, wav10[:nsteps], dt, **kw)
    rows, hist, illum = cs.elastic_fwd_hist_plain(*prm, injT, wav9, dt,
                                                  seg=SEG, **kw)
    res = T(np.random.default_rng(0).standard_normal(
        (2, nseg, SEG, 2, nx)), dtype=tdt)
    imgs = cs.elastic_grad_stream_plain(*prm, hist, res, dt, seg=SEG, **kw)
    return dict(g=g, prm=prm, injT=injT, wav10=wav10, wav9=wav9, kw=kw,
                dt=dt, rows10=rows10, rows=rows, hist=hist, illum=illum,
                res=res, imgs=imgs, tables=(s_idx, s_w, r_idx, r_w, wav),
                damp=damp)


def _j(t):
    return jnp.asarray(t.numpy())


def test_modeling_twin_matches_pallas_f32():
    c = _kernel_case(np.float32)
    jprm = [_j(p) for p in c["prm"]]
    want = np.stack([np.asarray(jps._elastic_segments(
        *jprm, _j(c["injT"][i]), _j(c["wav10"]), c["dt"], interpret=True,
        **c["kw"])) for i in range(2)])
    got = c["rows10"].numpy()
    nsteps = c["kw"]["nt"] - 1
    assert got.shape == (2, 1, nsteps) + want.shape[3:]
    for o in range(2):   # tau_zz rows, div v rows
        a = got[:, 0, :, o]
        b = want[:, :, :, o].reshape(2, -1, 2, got.shape[-1])[:, :nsteps]
        assert _rel(a, b) < 1e-5, o


def test_history_forward_twin_matches_pallas_f32():
    c = _kernel_case(np.float32)
    want = jps.elastic_fwd_hist_segments(
        *(_j(p) for p in c["prm"]), _j(c["injT"]), _j(c["wav9"]), c["dt"],
        seg=SEG, hist_dtype="float32", interpret=True, **c["kw"])
    for got, w, tol in zip((c["rows"], c["hist"], c["illum"]), want,
                           (1e-5, 1e-5, 1e-4)):
        assert got.shape == w.shape
        assert _rel(got.numpy(), w) < tol
    # the modeling twin's tau_zz rows are the same steps, bitwise
    nsteps = c["kw"]["nt"] - 1
    nx = c["kw"]["nx"]
    a = c["rows10"][:, :, :, 0].reshape(2, -1, 2, nx)[:, :nsteps]
    assert torch.equal(a, c["rows"].reshape(2, -1, 2, nx)[:, :nsteps])


def test_adjoint_twin_matches_pallas_f32():
    c = _kernel_case(np.float32)
    want = jps.elastic_grad_stream_segments(
        *(_j(p) for p in c["prm"]), _j(c["hist"]), _j(c["res"]), c["dt"],
        seg=SEG, interpret=True, **c["kw"])
    for got, w in zip(c["imgs"], want):
        assert _rel(got.numpy(), w) < 1e-4


def test_twins_match_the_saved_route_f64():
    """At f64 the twins meet the JAX XLA forward and saved route: traces,
    history and illumination of each shot, and the (lam, mu, b) gradients
    of the twins' images after avg_to_T, to 1e-10."""
    c = _kernel_case(np.float64)
    s_idx, s_w, r_idx, r_w, wav = c["tables"]
    m = c["g"].model
    kw = c["kw"]
    nt, nx, nz, z0 = kw["nt"], kw["nx"], kw["nz"], kw["z0"]
    nsteps = nt - 1
    fields = [jnp.asarray(np.asarray(f, np.float64))
              for f in (m.lam, m.mu, m.b, c["damp"])]
    jkw = dict(nt=nt, spacing=m.spacing, space_order=4)
    W = cs.zplane_weight_matrix(r_idx, torch.as_tensor(r_w), nx, z0)
    for i in range(2):
        src = (jnp.asarray(wav), jnp.asarray(s_idx[i]), jnp.asarray(s_w[i]),
               jnp.asarray(r_idx), jnp.asarray(r_w))
        r1, r2 = jst.elastic_forward(*fields, *src, c["dt"], **jkw)
        rows10 = c["rows10"][i].reshape(-1, 2, 2 * nx)[:nsteps]
        assert _rel((rows10[:, 0] @ W).numpy(), np.asarray(r1)[:nsteps]) \
            < 1e-10
        assert _rel((rows10[:, 1] @ W).numpy(), np.asarray(r2)[:nsteps]) \
            < 1e-10
        rec1, illum, hist = jsg.elastic_forward_hist(*fields, *src, c["dt"],
                                                     **jkw)
        assert _rel(c["illum"][i].numpy().T, illum) < 1e-10
        h = c["hist"][i].reshape(-1, 4, nz, nx)[:nsteps]
        for k in range(4):
            assert _rel(h[:, k].transpose(1, 2).numpy(), hist[k]) < 1e-10
        # the twin's reverse with the residual rows of a trace residual
        res = c["res"][i].reshape(-1, 2 * nx)[:nsteps] @ W
        res_full = np.zeros((nt, r_idx.shape[0]))
        res_full[:nsteps] = res.numpy()
        rows = torch.zeros((1, c["res"].shape[1] * SEG, 2 * nx),
                           dtype=torch.float64)
        rows[0, :nsteps] = res @ W.T
        imgs = cs.elastic_grad_stream_plain(
            *c["prm"], c["hist"][i:i + 1], rows.reshape(c["res"][:1].shape),
            c["dt"], seg=SEG, **kw)
        glam, gmun, gmup, gb0, gb1 = (g[0].T for g in imgs)
        g_mu = gmun + tsg.avg_to_T(gmup, (0, 1), 2)
        g_b = tsg.avg_to_T(gb0, (0,), 2) + tsg.avg_to_T(gb1, (1,), 2)
        want = jsg.elastic_adjoint_from_hist(
            *fields, jnp.asarray(r_idx), jnp.asarray(r_w),
            jnp.asarray(res_full), hist, c["dt"], **jkw)
        for got, w in zip((glam, g_mu, g_b), want):
            assert _rel(got.numpy(), w) < 1e-10


def test_eager_saved_route_matches_jax_f64():
    c = _kernel_case(np.float64)
    s_idx, s_w, r_idx, r_w, wav = c["tables"]
    m = c["g"].model
    fields = (np.asarray(m.lam), np.asarray(m.mu), np.asarray(m.b),
              c["damp"])
    kw = dict(nt=c["kw"]["nt"], spacing=m.spacing, space_order=4)
    res = np.random.default_rng(3).standard_normal((kw["nt"],
                                                    r_idx.shape[0]))
    got = tsg.elastic_forward_hist(*(torch.as_tensor(f) for f in fields),
                                   torch.as_tensor(wav), s_idx[0], s_w[0],
                                   r_idx, r_w, c["dt"], **kw)
    want = jsg.elastic_forward_hist(*(jnp.asarray(f) for f in fields),
                                    jnp.asarray(wav), jnp.asarray(s_idx[0]),
                                    jnp.asarray(s_w[0]), jnp.asarray(r_idx),
                                    jnp.asarray(r_w), c["dt"], **kw)
    assert _rel(got[0].numpy(), want[0]) < 1e-12
    assert _rel(got[1].numpy(), want[1]) < 1e-12
    grads = tsg.elastic_adjoint_from_hist(
        *(torch.as_tensor(f) for f in fields), r_idx, r_w,
        torch.as_tensor(res), got[2], c["dt"], **kw)
    jgrads = jsg.elastic_adjoint_from_hist(
        *(jnp.asarray(f) for f in fields), jnp.asarray(r_idx),
        jnp.asarray(r_w), jnp.asarray(res), want[2], c["dt"], **kw)
    for a, b in zip(grads, jgrads):
        assert _rel(a.numpy(), b) < 1e-12


# ---------------------------------------------------------------------------
# objective
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _obs(dtype):
    g1 = _jax_geometry(dtype, vp_scale=1.0)
    g0 = _jax_geometry(dtype, vp_scale=1.0)
    obs, _ = jel.elastic_fm_multi(g1)
    return g0, obs


def _vp0(g):
    vp, vs, rho = jel.model_vp_vs_rho(g.model)
    crop = tuple(slice(lo, lo + n) for (lo, _), n in
                 zip(g.model.padsizes, g.model.shape))
    return np.asarray(vp)[crop] * 1.02, vs, rho


def test_fm_multi_matches_jax_f32():
    g1 = _jax_geometry(np.float32)
    want = jel.elastic_fm_multi(g1)
    got = tel.elastic_fm_multi(_port_geometry(g1), device="cpu")
    for a, b in zip(got, want):
        assert _rel(np.stack([s.data for s in a]),
                    np.stack([s.data for s in b])) < 1e-5


def _misfits(name):
    if name == "l2":
        return j_least_square, t_least_square
    kw = dict(gamma=1.01, method="1d")
    return JqW(**kw), TqW(**kw)


# objective limits: L2 1e-5 (measured 2.0e-7); W2-1d 5e-5 (measured
# 1.2e-5), the limit tests/test_torch_w2.py holds w2_1d_torch to against
# w2_1d_jax, whose cumulative sums round in another order
@pytest.mark.parametrize("misfit,f_tol", [("l2", 1e-5), ("w2_1d", 5e-5)])
def test_obj_multi_matches_jax_f32(misfit, f_tol, monkeypatch):
    """f32: the port's twins against the JAX Pallas route in interpret
    mode, with the illumination fix and no precondition; gradients within
    1e-4 of their max (measured 8.6e-7 with L2, 1.6e-5 with W2-1d)."""
    monkeypatch.setenv("DEVITO_FWI_TPU_HIST", "f32")
    g0, obs = _obs(np.float32)
    jm, tm = _misfits(misfit)
    vp0, _, _ = _vp0(g0)
    common = dict(precond=False, calc_grad=True, vp=vp0)
    fj, gj, _ = jel.elastic_fwi_obj_multi(g0, obs, jm, grad_route="pallas",
                                          shot_chunk=2, **common)
    p0 = _port_geometry(g0)
    ft, gt, res = tel.elastic_fwi_obj_multi(p0, _port_shots(obs, p0), tm,
                                            device="cpu", **common)
    assert abs(ft - fj) <= f_tol * abs(fj)
    for k in ("vp", "vs", "rho"):
        assert gt[k].shape == g0.model.shape
        assert _rel(gt[k], gj[k]) < 1e-4, k
    assert len(res) == 2
    # a line-search trial (the modeling kernel) gives the same objective
    f_try, g_try, _ = tel.elastic_fwi_obj_multi(
        p0, _port_shots(obs, p0), tm, device="cpu", precond=False,
        calc_grad=False, vp=vp0)
    assert f_try == ft and g_try is None


@pytest.mark.parametrize("misfit", ["l2", "w2_1d"])
def test_obj_multi_matches_jax_f64(misfit):
    """f64, with direct wave, precondition, mask and a shot subset: the
    port's twins against the JAX saved route."""
    g0, obs = _obs(np.float64)
    g2 = _jax_geometry(np.float64, vp_scale=0.9)
    dw, _ = jel.elastic_fm_multi(g2)
    jm, tm = _misfits(misfit)
    vp0, vs, rho = _vp0(g0)
    mask = np.ones(g0.model.shape)
    mask[:, :3] = 0.
    common = dict(mask=mask, calc_grad=True, vp=vp0, shot_indices=[1])
    fj, gj, _ = jel.elastic_fwi_obj_multi(g0, obs, jm, dw,
                                          grad_route="saved", **common)
    p0 = _port_geometry(g0)
    shots = (_port_shots(obs, p0), tm, _port_shots(dw, p0))
    ft, gt, _ = tel.elastic_fwi_obj_multi(p0, *shots, device="cpu",
                                          **common)
    assert abs(ft - fj) <= 1e-10 * abs(fj)
    for k in ("vp", "vs", "rho"):
        assert _rel(gt[k], gj[k]) < 1e-10, k


@pytest.mark.parametrize("route", ["pallas", "bfgs"])
def test_obj_multi_refusals_raise(route):
    """What the objective still refuses, as the JAX one does: "pallas" on a
    geometry the kernels do not take (receivers on a vertical line) and a
    route it does not know."""
    g0 = _jax_geometry(np.float32)
    rec = np.stack([np.full(9, 300.), np.linspace(20., 340., 9)], 1)
    p = _port_geometry(AcquisitionGeometry(g0.model, rec, g0.src_positions,
                                           0., g0.tn, f0=g0.f0,
                                           src_type="Ricker"))
    obs = tel.elastic_fm_multi(p, device="cpu")[0]
    with pytest.raises(ValueError, match=f"grad_route='{route}'"):
        tel.elastic_fwi_obj_multi(p, obs, calc_grad=True, grad_route=route,
                                  device="cpu")


def test_geometry_gates_match_jax():
    """The kernels' gates take what the JAX Pallas gates take (minus the
    TPU's on-chip memory budget) and name what they refuse."""
    g = _jax_geometry(np.float32)
    s_idx, s_w, r_idx, r_w, wav = _batched_tables(g)
    p = _port_geometry(g).model
    assert cs.elastic_supported(p, s_idx[0], r_idx) == \
        jps.elastic_supported(g.model, s_idx[0], r_idx) is True
    assert cs.elastic_grad_stream_supported(p, s_idx, r_idx, wav) == \
        jps.elastic_grad_stream_supported(g.model, s_idx, r_idx, wav) is True
    off_planes = r_idx.copy()
    off_planes[3, :, 1] += 3
    assert not cs.elastic_supported(p, s_idx[0], off_planes)
    assert "adjacent z-planes" in cs.unsupported_reason(p, s_idx[0],
                                                        off_planes)
    two = np.concatenate([s_idx[0], s_idx[1]])
    assert "one source point" in cs.unsupported_reason(p, two, r_idx)
    p64 = _port_geometry(_jax_geometry(np.float64)).model
    assert "float32" in cs.unsupported_reason(p64, s_idx[0], r_idx)


def test_lbfgs_two_iterations_match_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("DEVITO_FWI_TPU_HIST", "f32")
    g1 = _jax_geometry(np.float32, tn=80.)
    g0 = _jax_geometry(np.float32, vp_scale=0.97, tn=80.)
    obs, _ = jel.elastic_fm_multi(g1)
    p0 = _port_geometry(g0)
    _, vs, rho = jel.model_vp_vs_rho(g0.model)
    crop = tuple(slice(lo, lo + n) for (lo, _), n in
                 zip(g0.model.padsizes, g0.model.shape))
    vs, rho = np.asarray(vs)[crop], np.asarray(rho)[crop]
    vp0, _, _ = _vp0(g0)
    x0 = 1.0 / (vp0 / 1.02).astype(np.float64).reshape(-1) ** 2
    bounds = [1.0 / 3.0 ** 2, 1.0 / 1.8 ** 2]
    hist = {}
    for name, opt, mini, loss, geom, shots, misfit in (
            ("jax", JLBFGS, jminimize, jel.ElasticFwiLoss(vs, rho),
             g0, obs, j_least_square),
            ("port", TLBFGS, tminimize,
             tel.ElasticFwiLoss(vs, rho, device="cpu"), p0,
             _port_shots(obs, p0), t_least_square)):
        log = str(tmp_path / name)
        optimizer = opt(memory=5, ls_method="Bracket", step_len_init=0.05,
                        max_ls=5, log_path=log)
        m = mini(optimizer, maxIter=2, ftol=1e-12, log_path=log,
                 loss_fn=loss).run(x0.copy(), geom, shots, misfit, None,
                                   None, True, bounds)
        hist[name] = (np.loadtxt(tmp_path / name / "misfit")[:, 0], m)
    fj, mj = hist["jax"]
    ft, mt = hist["port"]
    assert len(ft) == len(fj) == 2 and ft[1] < ft[0]
    assert np.allclose(ft, fj, rtol=1e-5, atol=0)
    # the JAX objective on the CPU is its XLA saved route (f32 history):
    # measured 3.1e-6
    assert _rel(mt, mj) < 1e-5


def test_vp_gradient_matches_finite_differences_f64():
    """Central differences of the objective along a smooth vp perturbation
    against <grad, dvp>, f64, no illumination fix or precondition."""
    from scipy.ndimage import gaussian_filter
    g0, obs = _obs(np.float64)
    p0 = _port_geometry(g0)
    shots = _port_shots(obs, p0)
    vp0, _, _ = _vp0(g0)
    d = gaussian_filter(np.random.default_rng(7).standard_normal(
        vp0.shape), 3)
    d *= 1e-4 * np.abs(vp0).mean() / np.abs(d).max()
    kw = dict(device="cpu", precond=False, illum_fix=False)
    _, g, _ = tel.elastic_fwi_obj_multi(p0, shots, calc_grad=True, vp=vp0,
                                        **kw)
    fp, _, _ = tel.elastic_fwi_obj_multi(p0, shots, vp=vp0 + d, **kw)
    fm, _, _ = tel.elastic_fwi_obj_multi(p0, shots, vp=vp0 - d, **kw)
    fd = (fp - fm) / 2.0
    an = float(np.sum(g["vp"] * d))
    # measured 1.0e-7 (the O(d^2) truncation of the central difference)
    assert abs(fd - an) <= 1e-6 * max(abs(fd), abs(an))


def test_chunks_follow_the_largest_allocation(monkeypatch):
    """On the card the shot chunks, the elastic objective's as the acoustic
    one's, are what 80% of the largest block the allocator can hand out
    holds (SMARM2: 2.133 GB per shot), made as even as possible. That block
    is the free memory plus the cached segments no live tensor holds, or the
    largest unused block of a segment a live tensor pins."""
    from devito_fwi_tpu_torch import fwi as tfwi
    card = torch.device("cuda", 0)
    per = 2_133_000_000
    GB = 1_000_000_000
    mem = {}
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (mem["free"], 85 * GB))
    monkeypatch.setattr(torch.cuda, "memory_snapshot",
                        lambda: mem["segments"])

    def segment(*blocks, device=0):
        return dict(device=device, total_size=sum(b for b, _ in blocks),
                    blocks=[dict(size=b, state=st) for b, st in blocks])

    def chunk(free, segments=(), shot_chunk=None):
        mem.update(free=free, segments=list(segments))
        return tfwi._shots_per_batch(31, shot_chunk, per,
                                     tfwi._device_budget(card))

    live, unused = "active_allocated", "inactive"
    assert chunk(84_500_000_000) == 31   # 66.1 GB fit 80% of 84.5 GB
    # a 60 GB cached block pinned by a 2 MB tensor: that block, not the
    # cached total (80% of 60 GB holds 22 shots: 16 + 15)
    assert chunk(20 * GB, [segment((2 ** 21, live), (60 * GB, unused))]) \
        == 16
    # a cached segment no tensor holds goes back to the card: 20 + 40 GB
    assert chunk(20 * GB, [segment((40 * GB, unused))]) == 16
    # another card's segments count nothing: 80% of 20 GB holds 7 shots
    assert chunk(20 * GB, [segment((40 * GB, unused), device=1)]) == 7
    assert chunk(84_500_000_000, shot_chunk=8) == 8
    assert chunk(GB) == 1
    # on the CPU every shot in one batch unless asked otherwise
    assert tfwi._shots_per_batch(31, None, per, None) == 31
    assert tfwi._shots_per_batch(31, 10, per, None) == 8


def test_forward_launch_fits_shared_memory():
    """The forward march's launch at the SMARM2 main path (31 shots, 220 x
    420 padded, space order 8): 8 strips of 56 columns, 5 segments of 44
    rows, 1240 blocks for the H100's 132 SMs at 10 blocks each; at the
    largest radius the kernel takes it fits a block's 232,448 bytes;
    beyond the radius it refuses."""
    main = cs.forward_launch(31, 220, 420, 4)
    assert main.smem == 2_176 and main.grid == (8, 5, 31)
    assert (main.strip, main.seg) == (56, 44)
    assert main.threads == 64
    assert cs.forward_launch(31, 220, 420, 8).smem == 2_304 <= 232_448
    for r in (0, 9):
        with pytest.raises(ValueError):
            cs.forward_launch(31, 220, 420, r)
    with pytest.raises(ValueError):
        cs.forward_launch(0, 220, 420, 4)


def _march_block(nz, nx, r, launch, x0, zs, written, bad):
    """Replay one march block of csrc/elastic2d.cu forward_step at row
    granularity: its four register queues (the rows they hold), its two
    sets of shared rows (the row and the columns each holds), its barriers.
    Adds one to ``written[k, z, x]`` for every new velocity (k 0) and
    stress (k 1) the block writes to the grid; appends to ``bad`` every
    read of a queue or a shared row that holds another row, of a velocity
    the block never computed, of a shared column no thread wrote, and every
    set of shared rows written and read between the same two barriers.
    Returns the shared-memory bytes the rows take."""
    R, W, ncol = r, launch.strip, launch.threads
    PS, PV = ncol + 2 * R, ncol             # stress and velocity rows
    ze = min(zs + launch.seg, nz)
    x_of = [x0 - R + col for col in range(ncol)]
    own = [col for col in range(ncol) if R <= col < R + W and
           0 <= x_of[col] < nx]
    halo = [col if col < R else PS - 2 * R + col for col in range(2 * R)]
    stress_cols = {col + R for col in range(ncol)} | set(halo)
    sets = [{}, {}]                         # field -> (row, columns)
    qs = [None] + list(range(zs - 2 * R, zs))   # tau_zz, tau_xz queues
    qv = [None] * (2 * R + 1)               # vx, vz queues
    touched = []                            # (interval, set, "r" | "w")
    interval = 0

    def read(k, field, row, cols, what):
        held = sets[k].get(field)
        touched.append((interval, k, "r"))
        if held is None or held[0] != row or not cols <= held[1]:
            bad.append((what, x0, zs, row, held and held[0]))

    for i in range(ze - zs + 2 * R):
        v, z = zs - R + i, zs - 2 * R + i
        qs = qs[1:] + [v + R]               # the front, fetched ahead
        k = i & 1
        sets[k] = {"txx": (v, stress_cols), "txz": (qs[R], stress_cols),
                   "vx": (qv[R + 1], set(range(PV))),
                   "vz": (qv[R + 1], set(range(PV)))}
        touched.append((interval, k, "w"))
        interval += 1                       # the barrier
        if qs != list(range(v - R, v + R + 1)):
            bad.append(("stress queue", x0, zs, v, qs))
        for col in range(ncol):
            read(k, "txx", v, set(range(col + 1, col + 2 * R + 1)),
                 "velocity reads tau_xx")
            read(k, "txz", v, set(range(col, col + 2 * R)),
                 "velocity reads tau_xz")
        if zs <= v < ze:
            for col in own:
                written[0, v, x_of[col]] += 1
        # a velocity outside the grid is its zero padding
        qv = qv[1:] + [v if 0 <= v < nz else ("pad", v)]
        if not zs <= z < ze:
            continue
        rows = [row if isinstance(row, int) else row[1] for row in qv]
        if rows != list(range(z - R, z + R + 1)):
            bad.append(("velocity queue", x0, zs, z, qv))
        if qs[0] != z:
            bad.append(("old stress", x0, zs, z, qs[0]))
        for col in own:
            for f in ("vx", "vz"):
                read(k, f, z, set(range(col - R, col + R + 1)),
                     "stress reads " + f)
            written[1, z, x_of[col]] += 1
    for n in range(interval + 1):
        w = {k for m, k, a in touched if m == n and a == "w"}
        r_ = {k for m, k, a in touched if m == n and a == "r"}
        if w & r_:
            bad.append(("race", x0, zs, n))
    return 4 * len(sets) * (2 * PS + 2 * PV)


@pytest.mark.parametrize("B,nz,nx,r", [
    (31, 220, 420, 4), (3, 220, 420, 4),
    *[(1, 41, 41, r) for r in range(1, 9)],
    (1, 5, 300, 2), (1, 300, 7, 4), (31, 223, 130, 4)])
def test_forward_march_covers_the_grid(B, nz, nx, r):
    """A row-level replay of the forward march over its launch's blocks:
    every cell's new velocity and stress is written by exactly one block;
    every z tap finds its row in the thread's queue, a velocity the block
    computed or the grid's zero padding; every x tap finds its row and
    column in the shared rows written before the last barrier, and no set
    of rows is written and read between two barriers; the rows take the
    launch's shared-memory bytes."""
    launch = cs.forward_launch(B, nz, nx, r)
    nstrip, nseg, shots = launch.grid
    assert shots == B and nstrip * launch.strip >= nx
    assert (nseg - 1) * launch.seg < nz <= nseg * launch.seg
    if (nz, nx) == (223, 130):
        assert nz % launch.seg, "a last segment shorter than the others"
    src = (cs.cuda_build.CSRC_DIR / "elastic2d.cu").read_text()
    assert f"constexpr int kMarchCols = {launch.threads};" in src
    assert launch.strip == launch.threads - 2 * r
    written = np.zeros((2, nz, nx), np.int64)
    bad = []
    for i in range(nstrip):
        for g in range(nseg):
            smem = _march_block(nz, nx, r, launch, i * launch.strip,
                                g * launch.seg, written, bad)
            assert smem == launch.smem
    assert bad == []
    assert (written == 1).all()


def test_source_list_holds_the_pattern():
    """The forward kernel's source operand: each shot's non-zero cells of
    the dense pattern, padded with -1, rebuild the pattern exactly."""
    rng = np.random.default_rng(7)
    inj = np.zeros((3, 12, 20), np.float32)
    for b, n in enumerate((4, 1, 2)):
        cells = rng.choice(12 * 20, n, replace=False)
        inj[b].reshape(-1)[cells] = rng.standard_normal(n)
    cells, vals, K = cs._source_list(torch.as_tensor(inj))
    assert K == 4 and cells.dtype == torch.int32
    assert tuple(cells.shape) == tuple(vals.shape) == (3, 4)
    back = np.zeros((3, 12 * 20), np.float32)
    for b in range(3):
        for c, v in zip(cells[b].tolist(), vals[b].tolist()):
            if c >= 0:
                back[b, c] = v
            else:
                assert v == 0.0
    assert np.array_equal(back.reshape(inj.shape), inj)
    assert (cells >= 0).sum().item() == 7


def _fused_adjoint_replay(prm, hist, res, *, st, nsteps, z0):
    """A torch replay of the card's fused reverse step (csrc/elastic2d.cu
    adjoint_step) in its order: the adjoint state (vxb, vzb, txxb, tzzb,
    txzb) in two buffers, read from one and written to the other every
    step; the derived fields (s lam) sum + (2 s mu) th_i and (s mu01) th_xz
    not carried but formed at the start of each step from the stored stress
    adjoints (zeros at the first); the velocity adjoints, then the images,
    then the stress adjoints from (s b) vh, with the kernel's
    association."""
    lam, mu, b0, b1, damp, d0, d1, mu01, d01 = prm
    B, total, _, nz, nx = hist.shape
    sd = cs._make_sd(st)
    P, M, s, two_s = st.P, st.M, st.s, st.two_s
    bufs = [hist.new_zeros((5, B, nz, nx)), hist.new_zeros((5, B, nz, nx))]
    imgs = hist.new_zeros((5, B, nz, nx))
    for k, t in enumerate(range(nsteps - 1, -1, -1)):
        vxb, vzb, txxb, tzzb, txzb = bufs[k & 1]
        nxt = bufs[(k & 1) ^ 1]
        # 1. the derived fields from the stored stress adjoints
        thx = damp * txxb
        thz = damp * tzzb
        tho = d01 * txzb
        sthd = thx + thz
        s_lam = s * lam
        two_s_mu = two_s * mu
        dvbx = s_lam * sthd + two_s_mu * thx
        dvbz = s_lam * sthd + two_s_mu * thz
        gbs = (s * mu01) * tho
        # 2. the velocity adjoints and the images
        vhx = d0 * ((vxb - sd(dvbx, P, 0)) - sd(gbs, M, 1))
        vhz = d1 * ((vzb - sd(dvbz, P, 1)) - sd(gbs, M, 0))
        vnx, vnz, dtx, dtz = hist[:, t].unbind(1)
        dvx = sd(vnx, M, 0)
        dvz = sd(vnz, M, 1)
        g = sd(vnx, P, 1) + sd(vnz, P, 0)
        imgs[0] = imgs[0] + (s * (dvx + dvz)) * sthd
        imgs[1] = imgs[1] + two_s * (dvx * thx + dvz * thz)
        imgs[2] = imgs[2] + (s * g) * tho
        imgs[3] = imgs[3] + (s * dtx) * vhx
        imgs[4] = imgs[4] + (s * dtz) * vhz
        # 3. the stress adjoints from (s b) vh, the residual rows
        sbx = (s * b0) * vhx
        sbz = (s * b1) * vhz
        tzzb_n = thz - sd(sbz, M, 1)
        tzzb_n[:, z0:z0 + 2] = tzzb_n[:, z0:z0 + 2] + res[:, t]
        nxt[0], nxt[1] = vhx, vhz
        nxt[2] = thx - sd(sbx, M, 0)
        nxt[3] = tzzb_n
        nxt[4] = (tho - sd(sbx, P, 1)) - sd(sbz, P, 0)
    return tuple(imgs)


def test_fused_adjoint_order_equals_twin_bitwise():
    """The fused reverse step's order (ping-pong state, the derived fields
    formed again from the stored stress adjoints, the images between the
    velocity and the stress adjoints) gives the plain twin's five images
    bit for bit at float32 on the small case."""
    c = _kernel_case(np.float32)
    kw = c["kw"]
    nsteps = kw["nt"] - 1
    B, nseg, seg = c["res"].shape[:3]
    st = cs._stencils(4, kw["spacing"], c["dt"], torch.float32)
    hist = c["hist"].reshape(B, nseg * seg, 4, kw["nz"], kw["nx"])
    res = c["res"].reshape(B, nseg * seg, 2, kw["nx"])
    got = _fused_adjoint_replay(c["prm"], hist, res, st=st, nsteps=nsteps,
                                z0=kw["z0"])
    for g, w in zip(got, c["imgs"]):
        assert torch.equal(g, w)
        assert float(w.abs().max()) > 0


@pytest.mark.parametrize("B,nz,nx,r,smem,grid", [
    (31, 220, 420, 4, 65_536, (31, 14, 7)),     # the SMARM2 main path
    (31, 220, 420, 8, 98_304, (31, 14, 7)),
    (1, 1, 1, 1, 46_336, (1, 1, 1)),
])
def test_adjoint_launch_fits_shared_memory(B, nz, nx, r, smem, grid):
    """The fused reverse step's launch at the SMARM2 main path (31 shots,
    220 x 420 padded, space order 8), at the largest radius the kernel
    takes and at the smallest case fits a block's 232,448 bytes."""
    launch = cs.adjoint_launch(B, nz, nx, r)
    assert launch.smem == smem <= cs.SMEM_LIMIT
    assert launch.grid == grid
    assert launch.tile == (32, 32) and launch.threads == 512


@pytest.mark.parametrize("args", [
    (31, 220, 420, 0), (31, 220, 420, 9), (0, 220, 420, 4),
    (31, 0, 420, 4), (31, 220, 0, 4), (1, 2 ** 16, 2 ** 15, 4),
    (1, 1, 32 * 2 ** 16, 4), (2 ** 31, 1, 1, 4)])
def test_adjoint_launch_refuses_what_the_kernel_does_not_take(args):
    """Beyond radius 8, an empty grid, 2^31 cells, 65,536 tiles along an
    axis or 2^31 shots: the helper raises, so the wrapper launches
    nothing."""
    with pytest.raises(ValueError):
        cs.adjoint_launch(*args)


def test_tile_launch_refuses_shared_memory_past_a_block():
    with pytest.raises(ValueError, match="shared memory"):
        cs.tile_launch("probe", 1, 32, 32, 4, (32, 32), 512,
                       cs.SMEM_LIMIT + 4, shots_first=True)
    assert cs.tile_launch("probe", 1, 32, 32, 4, (32, 32), 512,
                          cs.SMEM_LIMIT, shots_first=True).grid == (1, 1, 1)
