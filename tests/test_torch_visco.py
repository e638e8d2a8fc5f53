"""The port's viscoacoustic path (devito_fwi_tpu_torch.ops.self_adjoint's
laplacian_sa, ops.viscoacoustic, ops.visco_grad, ops.cuda_visco,
ops.viscoacoustic_wavesolver, visco_fwi, convert and the driver) against the
JAX package, on the CPU:

* ``laplacian_sa`` and the six kernels' eager ``forward`` / ``adjoint``
  against the JAX functions at f64 (1e-10 relative), and the port's own f64
  dot test of each kernel (1e-10);
* the six ``ViscoacousticWaveSolver`` goldens 684.385 / 18.774 / 677.673 /
  17.995 / 673.041 / 18.488 (atol 1e-2) on the CPU;
* each of the three plain twins of ``ops.cuda_visco`` against its Pallas
  kernel in interpret mode at f32 (receiver rows and final field 1e-5 of
  the max, history, illumination and images 1e-4 of the max), and at f64
  against the XLA ``visco_sls2_forward_hist`` / ``adjoint_from_hist``
  (1e-10); the port's eager saved route against the JAX one at f64; the
  card's fused reverse step order replayed in torch at f32, bitwise the
  twin, and its launch helper against a block's shared memory; the fused
  forward step's order with the source at the pattern's non-zero cells,
  bitwise the dense-pattern twins, and its launch helper likewise;
* ``visco_fwi_obj_multi`` (objective, vp and qp gradients) with L2 and
  W2-1d: at f32 against the JAX Pallas route in interpret mode (objective
  1e-5, W2-1d 1e-4; gradients 1e-4 of their max, no precondition), at f64
  against the JAX saved route, through the port's kernel and saved routes
  (1e-10); a trial equal to the gradient call's objective;
* an f64 central difference of the vp and qp gradients (5e-5);
* two L-BFGS iterations of ``ViscoFwiLoss`` against the JAX history;
* the driver with ``--physics viscoacoustic`` on ``--device cpu``.

Small case (as tests/test_visco_grad.py): a two-layer 41 x 36 model at 10 m
with qp 60/90, Gardner density, nbl 8, space order 4, dt 1 ms, tn 140 ms,
2 shots, 21 receivers. The port's models are built from the JAX models'
numpy fields through ``devito_fwi_tpu_torch.convert``.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from devito_fwi_tpu import AcquisitionGeometry, SeismicModel
from devito_fwi_tpu import visco_fwi as jvf
from devito_fwi_tpu.fwi import _batched_tables
from devito_fwi_tpu.misfit import least_square as j_least_square
from devito_fwi_tpu.misfit import qWasserstein as JqW
from devito_fwi_tpu.ops import pallas_staggered as jps
from devito_fwi_tpu.ops import self_adjoint as jsa
from devito_fwi_tpu.ops import visco_grad as jvg
from devito_fwi_tpu.ops import viscoacoustic as jva
from devito_fwi_tpu.optimize import LBFGS as JLBFGS, minimize as jminimize

from devito_fwi_tpu_torch import fwi as tfwi
from devito_fwi_tpu_torch import visco_fwi as tvf
from devito_fwi_tpu_torch.convert import (geometry_from_numpy,
                                          model_from_numpy)
from devito_fwi_tpu_torch.misfit import least_square as t_least_square
from devito_fwi_tpu_torch.misfit import least_square_torch
from devito_fwi_tpu_torch.misfit import qWasserstein as TqW
from devito_fwi_tpu_torch.models.geometry import setup_geometry
from devito_fwi_tpu_torch.models.presets import demo_model
from devito_fwi_tpu_torch.models.sources import PointSource as TPointSource
from devito_fwi_tpu_torch.ops import cuda_staggered as cs
from devito_fwi_tpu_torch.ops import cuda_visco as cv
from devito_fwi_tpu_torch.ops import self_adjoint as tsa
from devito_fwi_tpu_torch.ops import visco_grad as tvg
from devito_fwi_tpu_torch.ops import viscoacoustic as tva
from devito_fwi_tpu_torch.ops.staggered import _wgt
from devito_fwi_tpu_torch.ops.viscoacoustic_wavesolver import (
    ViscoacousticWaveSolver)
from devito_fwi_tpu_torch.optimize import (LBFGS as TLBFGS,
                                           minimize as tminimize)

SEG = 16  # history segment of the kernel tests: 139 steps -> 9 x 16, padded
KINDS = sorted(tva.KERNELS)


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


def _jax_geometry(dtype, vp_scale=1.0, tn=140., nsrc=2):
    shape = (41, 36)
    vp = np.full(shape, 2.0, dtype) * vp_scale
    vp[:, 18:] = 2.4 * vp_scale
    qp = np.full(shape, 60.0, dtype)
    qp[:, 18:] = 90.0
    rho = (0.31 * (1e3 * vp) ** 0.25).astype(dtype)
    model = SeismicModel(origin=(0., 0.), spacing=(10., 10.), shape=shape,
                         space_order=4, vp=vp, qp=qp, b=(1.0 / rho), nbl=8,
                         bcs="mask", dtype=dtype, dt=1.0)
    src = np.stack([np.linspace(80., 320., nsrc), np.full(nsrc, 20.0)], 1)
    rec = np.stack([np.linspace(0., 400., 21), np.full(21, 30.0)], 1)
    return AcquisitionGeometry(model, rec, src, 0., tn, f0=0.015,
                               src_type="Ricker")


def _port_geometry(g):
    jm = g.model
    model = model_from_numpy(dict(
        vp=np.asarray(jm.vp), qp=np.asarray(jm.qp), b=np.asarray(jm.b),
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


def _fields(m):
    return tuple(np.asarray(getattr(m, n), m.dtype)
                 for n in ("vp", "b", "qp", "damp"))


# ---------------------------------------------------------------------------
# building blocks, eager propagators, solver goldens
# ---------------------------------------------------------------------------

def test_laplacian_sa_matches_jax_f64():
    rng = np.random.default_rng(5)
    u = rng.standard_normal((3, 23, 19))
    b = rng.uniform(0.3, 0.7, (23, 19))
    for so in (4, 8):
        wp, op, wm, om = _wgt(so, torch.float64)
        inv_h = [1.0 / 10.0, 1.0 / 12.5]
        got = tsa.laplacian_sa(torch.as_tensor(u), torch.as_tensor(b), wp,
                               op, wm, om,
                               [torch.tensor(h, dtype=torch.float64)
                                for h in inv_h])
        jw = jsa.staggered_weights(so)
        want = jsa.laplacian_sa(jnp.asarray(u), jnp.asarray(b),
                                jnp.asarray(jw[0]), jw[1],
                                jnp.asarray(jw[2]), jw[3],
                                [jnp.asarray(h) for h in inv_h])
        assert _rel(got.numpy(), want) < 1e-12


@functools.lru_cache(maxsize=None)
def _eager_case():
    g = _jax_geometry(np.float64, tn=100., nsrc=1)
    m = g.model
    s_idx, s_w, r_idx, r_w, wav = _batched_tables(g)
    res = np.random.default_rng(7).standard_normal((g.nt, r_idx.shape[0]))
    return g, s_idx[0], s_w[0], r_idx, r_w, wav, res


@pytest.mark.parametrize("kernel,to", KINDS)
def test_eager_forward_adjoint_match_jax_f64(kernel, to):
    """The port's eager forward and adjoint of each kernel against the JAX
    functions at f64 (1e-10; measured ~1e-15), and the port's own dot test
    <F s, r> = <s, F^T r> (1e-10)."""
    g, s_idx, s_w, r_idx, r_w, wav, res = _eager_case()
    m = g.model
    flds = _fields(m)
    dt = float(m.critical_dt)
    kw = dict(kernel=kernel, time_order=to, nt=g.nt, spacing=m.spacing,
              space_order=4)
    T = torch.as_tensor
    rec, p = tva.forward(*(T(f) for f in flds), T(wav), s_idx, s_w, r_idx,
                         r_w, dt, g.f0, **kw)
    jrec, jp = jva.forward(*(jnp.asarray(f) for f in flds), jnp.asarray(wav),
                           s_idx, s_w, r_idx, r_w, dt, g.f0, **kw)
    assert _rel(rec.numpy(), jrec) < 1e-10
    assert _rel(p.numpy(), jp) < 1e-10
    srca, pa = tva.adjoint(*(T(f) for f in flds), T(res), r_idx, r_w, s_idx,
                           s_w, dt, g.f0, **kw)
    jsrca, jpa = jva.adjoint(*(jnp.asarray(f) for f in flds),
                             jnp.asarray(res), r_idx, r_w, s_idx, s_w, dt,
                             g.f0, **kw)
    assert _rel(srca.numpy(), jsrca) < 1e-10
    assert _rel(pa.numpy(), jpa) < 1e-10
    lhs = float(torch.sum(rec * T(res)))
    rhs = float(torch.sum(T(wav) * srca))
    assert abs(lhs - rhs) <= 1e-10 * abs(lhs)


def test_eager_save_and_forward_seg():
    g, s_idx, s_w, r_idx, r_w, wav, _ = _eager_case()
    m = g.model
    T = torch.as_tensor
    kw = dict(nt=g.nt, spacing=m.spacing, space_order=4)
    args = (*(T(f) for f in _fields(m)), T(wav), s_idx, s_w, r_idx, r_w,
            float(m.critical_dt), g.f0)
    rec, hist = tva.forward(*args, save=True, **kw)
    rec2, p = tva.forward(*args, **kw)
    assert hist.shape == (g.nt,) + m.padded_shape
    assert torch.equal(rec, rec2) and torch.equal(hist[-1], p)
    rec3, illum = tva.forward_seg(*args, n_checkpoints=3, **kw)
    assert torch.equal(rec3, rec)
    assert torch.allclose(illum, torch.sum(hist[2:] ** 2, dim=0),
                          rtol=1e-12, atol=0)
    vp, b, qp, damp = args[:4]
    rec4, drec = tvg.visco_born(vp, b, qp, torch.zeros_like(vp), None, damp,
                                *args[4:], **kw)
    assert torch.equal(rec4, rec) and not drec.any()


VA_GOLDEN = [("sls", 2, 684.385), ("sls", 1, 18.774), ("ren", 2, 677.673),
             ("ren", 1, 17.995), ("deng_mcmechan", 2, 673.041),
             ("deng_mcmechan", 1, 18.488)]


@pytest.mark.parametrize("kernel,time_order,normrec", VA_GOLDEN)
def test_solver_golden_on_cpu(kernel, time_order, normrec):
    """The reference viscoacoustic example (layers-viscoacoustic 50 x 50,
    nbl 40, space order 4, tn 1000) through the port's solver on the CPU
    (tests/test_physics_families.py:78-96)."""
    model = demo_model("layers-viscoacoustic", space_order=4, shape=(50, 50),
                       nbl=40, dtype=np.float32, spacing=(20., 20.))
    geometry = setup_geometry(model, 1000.)
    solver = ViscoacousticWaveSolver(model, geometry, space_order=4,
                                     kernel=kernel, time_order=time_order,
                                     device="cpu")
    rec, _, _, _ = solver.forward()
    assert np.isclose(np.linalg.norm(rec.data), normrec, atol=1e-2, rtol=0)
    if (kernel, time_order) == ("sls", 2):
        srca, _, _, _ = solver.adjoint(rec)
        assert np.isfinite(srca.data).all() and np.abs(srca.data).max() > 0


# ---------------------------------------------------------------------------
# the three kernels' twins
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _kernel_case(dtype):
    """Port operands and the three twins' outputs on the small case."""
    g = _jax_geometry(dtype)
    m = g.model
    s_idx, s_w, r_idx, r_w, wav = _batched_tables(g)
    T = torch.as_tensor
    vp, b, qp, damp = (T(f) for f in _fields(m))
    nx, nz = m.padded_shape
    nt = g.nt
    nsteps = nt - 2
    dt = float(m.critical_dt)
    z0 = int(r_idx[..., 1].min())
    prm, vp2 = cv.operands(vp, b, qp, damp, dt, g.f0)
    inj, injw = cv.source_patterns(s_idx, s_w, vp2, dt)
    injT = inj.transpose(1, 2).contiguous()
    injwT = injw.transpose(1, 2).contiguous()
    # the Pallas modeling kernel steps its padded 32-step layout; the
    # twin's one segment is its first nsteps steps
    seg12, nseg12 = jps.seg_layout(nsteps)
    nseg = -(-nsteps // SEG)
    wav12 = cv.pad_wavelet(T(wav), nt, seg12 * nseg12)
    wav11 = cv.pad_wavelet(T(wav), nt, SEG * nseg)
    s = T(dt, dtype=vp.dtype)
    wavs2 = wav11 * (s * s)
    kw = dict(nt=nt, nx=nx, nz=nz, space_order=4, spacing=m.spacing, z0=z0)
    rows12, pout = cv.visco_sls2_plain(*prm, injT, wav12[:nsteps], dt, **kw)
    rows, hist, illum = cv.visco_fwd_hist_plain(*prm, injT, wav11, dt,
                                                seg=SEG, **kw)
    res = T(np.random.default_rng(0).standard_normal(
        (2, nseg, SEG, 2, nx)), dtype=vp.dtype)
    imgs = cv.visco_grad_stream_plain(*prm, injwT, hist, res, wavs2, dt,
                                      seg=SEG, **kw)
    return dict(g=g, prm=prm, injT=injT, injwT=injwT, wav12=wav12,
                wav11=wav11, wavs2=wavs2, kw=kw, dt=dt, rows12=rows12,
                pout=pout, rows=rows, hist=hist, illum=illum, res=res,
                imgs=imgs, tables=(s_idx, s_w, r_idx, r_w, wav),
                fields=(vp, b, qp, damp))


def _j(t):
    return jnp.asarray(t.numpy())


def test_modeling_twin_matches_pallas_f32():
    c = _kernel_case(np.float32)
    nsteps = c["kw"]["nt"] - 2
    jprm = [_j(p) for p in c["prm"]]
    got = c["rows12"].numpy()
    assert got.shape == (2, 1, nsteps, 2, c["kw"]["nx"])
    for i in range(2):
        rows, pout = jps._visco_sls2_segments(
            *jprm, _j(c["injT"][i]), _j(c["wav12"]), c["dt"], interpret=True,
            **c["kw"])
        rows = np.asarray(rows).reshape(-1, 2, got.shape[-1])[:nsteps]
        assert _rel(got[i, 0], rows) < 1e-5
        assert _rel(c["pout"][i].numpy(), pout) < 1e-5
    # the history forward records the same rows, bitwise
    nx = c["kw"]["nx"]
    assert torch.equal(c["rows12"][:, 0],
                       c["rows"].reshape(2, -1, 2, nx)[:, :nsteps])


def test_history_forward_twin_matches_pallas_f32():
    c = _kernel_case(np.float32)
    want = jps.visco_fwd_hist_segments(
        *(_j(p) for p in c["prm"]), _j(c["injT"]), _j(c["wav11"]), c["dt"],
        seg=SEG, hist_dtype="float32", interpret=True, **c["kw"])
    for got, w, tol in zip((c["rows"], c["hist"], c["illum"]), want,
                           (1e-5, 1e-4, 1e-4)):
        assert got.shape == w.shape
        assert _rel(got.numpy(), w) < tol


def test_adjoint_twin_matches_pallas_f32():
    c = _kernel_case(np.float32)
    want = jps.visco_grad_stream_segments(
        *(_j(p) for p in c["prm"]), _j(c["injwT"]), _j(c["hist"]),
        _j(c["res"]), _j(c["wavs2"]), c["dt"], seg=SEG, interpret=True,
        **c["kw"])
    for got, w in zip(c["imgs"], want):
        assert _rel(got.numpy(), w) < 1e-4


def _fused_adjoint_replay(prm, injw, hist, res, wavs2, *, st, nsteps, z0):
    """A torch replay of the card's fused reverse step (csrc/visco2d.cu
    adjoint_step) in its order: lp and lr in two buffers swapped every
    step; lpp and pendR not carried but formed from the state the previous
    step read, (-damp) (damp lp) and damp (lr - D (damp lp)), zero at the
    first step; gsrc added only at injw's non-zero cells
    (``cuda_staggered._source_list``)."""
    damp, b, A, Bc, C, D = prm
    B, total, _, nz, nx = hist.shape
    lsa = cv._lsa(cs._make_sd(st), st, b)
    cells, vals, _ = cs._source_list(injw)
    shot, slot = (cells >= 0).nonzero(as_tuple=True)
    cell = cells[shot, slot].long()
    z = hist.new_zeros((B, nz, nx))
    cur, prev = (z, z), None
    ga1 = ga2 = ga3 = ga4 = z
    gsrc = z.reshape(B, -1).clone()
    for t in range(nsteps - 1, -1, -1):
        lp, lr = cur
        L, rn = hist[:, t, 0], hist[:, t, 1]
        P = damp * lp
        R = damp * (lr - D * P)
        if prev is None:
            lpp = pend = z
        else:
            po = damp * prev[0]
            lpp = (-damp) * po
            pend = damp * (prev[1] - D * po)
        ga3 = ga3 + L * P
        ga4 = ga4 - rn * P
        ga1 = ga1 + L * R
        ga2 = ga2 - rn * pend
        gsrc[shot, cell] = gsrc[shot, cell] + (
            wavs2[t] * vals[shot, slot]) * lp.reshape(B, -1)[shot, cell]
        lp_new = 2.0 * P + lsa(C * P) + lsa(A * R) + lpp
        lp_new[:, z0:z0 + 2] = lp_new[:, z0:z0 + 2] + res[:, t]
        prev, cur = cur, (lp_new, R - Bc * R)
    return ga1, ga2, ga3, ga4, gsrc.reshape(B, nz, nx)


def test_fused_adjoint_order_equals_twin_bitwise():
    """The fused reverse step's order (ping-pong lp, lr; lpp and pendR
    recomputed from the previous state; the source at its cells) gives the
    plain twin's five images bit for bit at float32 on the small case."""
    c = _kernel_case(np.float32)
    kw = c["kw"]
    nsteps = kw["nt"] - 2
    B, nseg, seg = c["res"].shape[:3]
    st = cs._stencils(4, kw["spacing"], c["dt"], torch.float32)
    hist = c["hist"].reshape(B, nseg * seg, 2, kw["nz"], kw["nx"])
    res = c["res"].reshape(B, nseg * seg, 2, kw["nx"])
    got = _fused_adjoint_replay(c["prm"], c["injwT"], hist, res,
                                c["wavs2"], st=st, nsteps=nsteps,
                                z0=kw["z0"])
    for g, w in zip(got, c["imgs"]):
        assert torch.equal(g, w)
    assert float(c["imgs"][4].abs().max()) > 0


def test_adjoint_launch_fits_shared_memory():
    """The fused reverse step's launch at the SMARMN main path (29 shots,
    186 x 380 padded, space order 8) and at the largest radius the kernel
    takes fits a block's 232,448 bytes; beyond the radius, and for empty
    or oversized grids, it refuses."""
    main = cv.adjoint_launch(29, 186, 380, 4)
    assert main.smem == 47_104 and main.grid == (29, 12, 6)
    assert main.threads == 512 and 4 * main.smem <= 232_448
    assert cv.adjoint_launch(29, 186, 380, 8).smem == 65_536 <= 232_448
    assert cv.adjoint_launch(1, 1, 1, 1).smem == 35_968
    for args in ((29, 186, 380, 0), (29, 186, 380, 9), (0, 186, 380, 4),
                 (29, 0, 380, 4), (29, 186, 0, 4), (1, 2 ** 16, 2 ** 15, 4),
                 (1, 1, 32 * 2 ** 16, 4)):
        with pytest.raises(ValueError):
            cv.adjoint_launch(*args)


def _fused_forward_replay(prm, wav_pad, inj, *, st, nsteps, z0, hist):
    """A torch replay of the card's fused forward step (csrc/visco2d.cu
    forward_step) in its order: L from the two fluxes b D+ p, rn over r and
    pn over pp in place, then p and pp swap; the source added only at
    inj's non-zero cells (``cuda_staggered._source_list``), where the twin
    adds wav[t] * inj everywhere."""
    damp, b, A, Bc, C, D = prm
    B, nz, nx = inj.shape
    total = wav_pad.shape[0]
    lsa = cv._lsa(cs._make_sd(st), st, b)
    cells, vals, _ = cs._source_list(inj)
    shot, slot = (cells >= 0).nonzero(as_tuple=True)
    cell = cells[shot, slot].long()
    p, pp, r = inj.new_zeros((3, B, nz, nx))
    rec = inj.new_empty((B, total, 2, nx))
    H = inj.new_empty((B, total, 2, nz, nx))
    illum = inj.new_zeros((B, nz, nx))
    pout = None
    for t in range(total):
        rec[:, t] = p[:, z0:z0 + 2]
        L = lsa(p)
        r.copy_(damp * ((r + A * L) - Bc * r))
        pn = damp * ((((2.0 * p) - damp * pp) + C * L) - D * r)
        flat = pn.reshape(B, -1)
        flat[shot, cell] = flat[shot, cell] + wav_pad[t] * vals[shot, slot]
        pp.copy_(pn)
        H[:, t, 0] = L
        H[:, t, 1] = r
        if t < nsteps:
            illum = illum + pp * pp
        p, pp = pp, p
        if t == nsteps - 1:
            pout = p.clone()
    if hist:
        return rec, H, illum
    return rec, pout


def test_fused_forward_source_list_equals_twin_bitwise():
    """The fused forward step's order, with the source added at inj's
    non-zero cells only, gives the dense-pattern twin's outputs bit for bit
    at float32 on the small case: the modeling sweep's rows and final p,
    the history sweep's rows, history and illumination."""
    c = _kernel_case(np.float32)
    kw = c["kw"]
    nsteps = kw["nt"] - 2
    st = cs._stencils(4, kw["spacing"], c["dt"], torch.float32)
    got = _fused_forward_replay(c["prm"], c["wav12"][:nsteps], c["injT"],
                                st=st, nsteps=nsteps, z0=kw["z0"],
                                hist=False)
    assert torch.equal(got[0].reshape(c["rows12"].shape), c["rows12"])
    assert torch.equal(got[1], c["pout"])
    got = _fused_forward_replay(c["prm"], c["wav11"], c["injT"], st=st,
                                nsteps=nsteps, z0=kw["z0"], hist=True)
    want = (c["rows"], c["hist"], c["illum"])
    for g, w in zip(got, want):
        assert torch.equal(g.reshape(w.shape), w)
    assert float(c["illum"].abs().max()) > 0
    # the list holds the bilinear corners: at most four cells a shot
    cells = cs._source_list(c["injT"])[0]
    assert int((cells >= 0).sum()) <= 4 * cells.shape[0]


@pytest.mark.parametrize("B,nz,nx,r,smem,grid", [
    (29, 186, 380, 4, 19_456, (29, 12, 6)),     # the SMARMN main path
    (29, 186, 380, 8, 28_672, (29, 12, 6)),
    (1, 1, 1, 1, 13_888, (1, 1, 1)),
])
def test_forward_launch_fits_shared_memory(B, nz, nx, r, smem, grid):
    """The fused forward step's launch at the SMARMN main path (29 shots,
    186 x 380 padded, space order 8), at the largest radius the kernel
    takes and at the smallest case fits a block's 232,448 bytes."""
    launch = cv.forward_launch(B, nz, nx, r)
    assert launch.smem == smem <= cs.SMEM_LIMIT
    assert launch.grid == grid
    assert launch.tile == (32, 32) and launch.threads == 512


@pytest.mark.parametrize("args", [
    (29, 186, 380, 0), (29, 186, 380, 9), (0, 186, 380, 4),
    (29, 0, 380, 4), (29, 186, 0, 4), (1, 2 ** 16, 2 ** 15, 4),
    (1, 1, 32 * 2 ** 16, 4), (1, 32 * 2 ** 16, 1, 4)])
def test_forward_launch_refuses_what_the_kernel_does_not_take(args):
    """Beyond radius 8, an empty grid, 2^31 cells or 65,536 tiles along an
    axis: the helper raises, so the wrapper launches nothing."""
    with pytest.raises(ValueError):
        cv.forward_launch(*args)


def test_twins_match_the_saved_route_f64():
    """At f64 the twins meet the JAX XLA history forward and saved adjoint:
    traces, history and illumination of the second shot, and the (vp, qp)
    gradients of the twins' images after the coefficient VJP, to 1e-10
    (measured 4e-16 to 1.4e-14)."""
    c = _kernel_case(np.float64)
    s_idx, s_w, r_idx, r_w, wav = c["tables"]
    m = c["g"].model
    kw = c["kw"]
    nt, nx, nz, z0 = kw["nt"], kw["nx"], kw["nz"], kw["z0"]
    nsteps = nt - 2
    vp, b, qp, damp = c["fields"]
    jf = [jnp.asarray(f.numpy()) for f in c["fields"]]
    jkw = dict(nt=nt, spacing=m.spacing, space_order=4)
    W = cs.zplane_weight_matrix(r_idx, torch.as_tensor(r_w), nx, z0)
    traces = tfwi._traces_from_rows(c["rows"], W, nt, nsteps)
    traces12 = tfwi._traces_from_rows(c["rows12"], W, nt, nsteps)
    res_full = torch.zeros((2, nt, r_idx.shape[0]), dtype=torch.float64)
    res_full[:, 1:nt - 1] = c["res"].reshape(2, -1, 2 * nx)[:, :nsteps] @ W
    rows = cv.residual_rows(res_full, W, SEG)
    imgs = cv.visco_grad_stream_plain(*c["prm"], c["injwT"], c["hist"], rows,
                                      c["wavs2"], c["dt"], seg=SEG, **kw)
    g_vp, g_qp = tvg.coefficient_vjp(vp, qp, b, c["dt"], c["g"].f0, tuple(
        g.transpose(1, 2) for g in imgs))
    i = 1
    rec, illum, hist = jvg.visco_sls2_forward_hist(
        *jf, jnp.asarray(wav), jnp.asarray(s_idx[i]),
        jnp.asarray(s_w[i]), jnp.asarray(r_idx), jnp.asarray(r_w),
        c["dt"], c["g"].f0, **jkw)
    assert _rel(traces[i].numpy(), rec) < 1e-10
    assert _rel(traces12[i].numpy(), rec) < 1e-10
    assert _rel(c["illum"][i].numpy().T, illum) < 1e-10
    h = c["hist"][i].reshape(-1, 2, nz, nx)[:nsteps]
    for k in range(2):
        assert _rel(h[:, k].transpose(1, 2).numpy(), hist[k]) < 1e-10
    want = jvg.visco_sls2_adjoint_from_hist(
        *jf, jnp.asarray(wav), jnp.asarray(s_idx[i]),
        jnp.asarray(s_w[i]), jnp.asarray(r_idx), jnp.asarray(r_w),
        jnp.asarray(res_full[i].numpy()), hist, c["dt"], c["g"].f0,
        **jkw)
    assert _rel(g_vp[i].numpy(), want[0]) < 1e-10
    assert _rel(g_qp[i].numpy(), want[1]) < 1e-10


def test_eager_saved_route_matches_jax_f64():
    c = _kernel_case(np.float64)
    s_idx, s_w, r_idx, r_w, wav = c["tables"]
    m = c["g"].model
    kw = dict(nt=c["kw"]["nt"], spacing=m.spacing, space_order=4)
    res = np.random.default_rng(3).standard_normal((kw["nt"],
                                                    r_idx.shape[0]))
    jf = [jnp.asarray(f.numpy()) for f in c["fields"]]
    got = tvg.visco_sls2_forward_hist(*c["fields"], torch.as_tensor(wav),
                                      s_idx[0], s_w[0], r_idx, r_w, c["dt"],
                                      c["g"].f0, **kw)
    want = jvg.visco_sls2_forward_hist(*jf, jnp.asarray(wav),
                                       jnp.asarray(s_idx[0]),
                                       jnp.asarray(s_w[0]),
                                       jnp.asarray(r_idx), jnp.asarray(r_w),
                                       c["dt"], c["g"].f0, **kw)
    assert _rel(got[0].numpy(), want[0]) < 1e-12
    assert _rel(got[1].numpy(), want[1]) < 1e-12
    grads = tvg.visco_sls2_adjoint_from_hist(
        *c["fields"], torch.as_tensor(wav), s_idx[0], s_w[0], r_idx, r_w,
        torch.as_tensor(res), got[2], c["dt"], c["g"].f0, **kw)
    jgrads = jvg.visco_sls2_adjoint_from_hist(
        *jf, jnp.asarray(wav), jnp.asarray(s_idx[0]), jnp.asarray(s_w[0]),
        jnp.asarray(r_idx), jnp.asarray(r_w), jnp.asarray(res), want[2],
        c["dt"], c["g"].f0, **kw)
    for a, b in zip(grads, jgrads):
        assert _rel(a.numpy(), b) < 1e-12


# ---------------------------------------------------------------------------
# objective
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _obs(dtype):
    g = _jax_geometry(dtype)
    return g, jvf.visco_fm_multi(g)


def _vp0(g):
    crop = tuple(slice(lo, lo + n) for (lo, _), n in
                 zip(g.model.padsizes, g.model.shape))
    return np.asarray(g.model.vp)[crop] * 1.02


def _misfits(name):
    if name == "l2":
        return j_least_square, t_least_square
    kw = dict(gamma=1.01, method="1d")
    return JqW(**kw), TqW(**kw)


def test_fm_multi_matches_jax_f32():
    g, want = _obs(np.float32)
    got = tvf.visco_fm_multi(_port_geometry(g), device="cpu")
    assert _rel(np.stack([s.data for s in got]),
                np.stack([s.data for s in want])) < 1e-5


# objective limits: L2 1e-5; W2-1d 1e-4, the W2-1d misfit's own f32
# difference (its cumulative sums round in another order)
@pytest.mark.parametrize("misfit,f_tol", [("l2", 1e-5), ("w2_1d", 1e-4)])
def test_obj_multi_matches_jax_f32(misfit, f_tol, monkeypatch):
    """f32: the port's twins against the JAX Pallas route in interpret
    mode, with the illumination fix and no precondition; vp and qp
    gradients within 1e-4 of their max."""
    monkeypatch.setenv("DEVITO_FWI_TPU_HIST", "f32")
    g0, obs = _obs(np.float32)
    jm, tm = _misfits(misfit)
    common = dict(precond=False, calc_grad=True, vp=_vp0(g0))
    fj, gj, _ = jvf.visco_fwi_obj_multi(g0, obs, jm, grad_route="pallas",
                                        shot_chunk=2, **common)
    p0 = _port_geometry(g0)
    ft, gt, res = tvf.visco_fwi_obj_multi(p0, _port_shots(obs, p0), tm,
                                          device="cpu", **common)
    assert abs(ft - fj) <= f_tol * abs(fj)
    for k in ("vp", "qp"):
        assert gt[k].shape == g0.model.shape
        assert _rel(gt[k], gj[k]) < 1e-4, k
    assert len(res) == 2
    # a line-search trial (the modeling kernel) gives the same objective
    f_try, g_try, _ = tvf.visco_fwi_obj_multi(
        p0, _port_shots(obs, p0), tm, device="cpu", precond=False,
        calc_grad=False, vp=_vp0(g0))
    assert f_try == ft and g_try is None


@pytest.mark.parametrize("route", ["pallas", "saved"])
@pytest.mark.parametrize("misfit", ["l2", "w2_1d"])
def test_obj_multi_matches_jax_f64(misfit, route):
    """f64, with direct wave, precondition, mask and a shot subset: the
    port's kernel route (twins) and eager saved route against the JAX
    saved route, 1e-10."""
    g0, obs = _obs(np.float64)
    g2 = _jax_geometry(np.float64, vp_scale=0.9)
    dw = jvf.visco_fm_multi(g2)
    jm, tm = _misfits(misfit)
    mask = np.ones(g0.model.shape)
    mask[:, :3] = 0.
    common = dict(mask=mask, calc_grad=True, vp=_vp0(g0), shot_indices=[1])
    fj, gj, _ = jvf.visco_fwi_obj_multi(g0, obs, jm, dw, grad_route="saved",
                                        **common)
    p0 = _port_geometry(g0)
    shots = (_port_shots(obs, p0), tm, _port_shots(dw, p0))
    ft, gt, _ = tvf.visco_fwi_obj_multi(p0, *shots, device="cpu",
                                        grad_route=route, **common)
    assert abs(ft - fj) <= 1e-10 * abs(fj)
    for k in ("vp", "qp"):
        assert _rel(gt[k], gj[k]) < 1e-10, k


@pytest.mark.parametrize("route,kind", [("saved", ("ren", 2)),
                                        ("pallas", ("sls", 1)),
                                        ("bfgs", ("sls", 2))])
def test_obj_multi_refusals_raise(route, kind):
    """What the objective still refuses, as the JAX one does: the
    saved-history route and the kernels on a kernel other than sls/2, and
    a route it does not know."""
    g0, obs = _obs(np.float32)
    p0 = _port_geometry(g0)
    with pytest.raises(ValueError, match=f"grad_route='{route}'"):
        tvf.visco_fwi_obj_multi(p0, _port_shots(obs, p0), calc_grad=True,
                                grad_route=route, kernel=kind[0],
                                time_order=kind[1], device="cpu")


def test_gradients_match_finite_differences_f64():
    """Central differences of the objective along smooth vp and qp
    perturbations against <grad, d>, f64, no illumination fix or
    precondition (tests/test_visco_grad.py:71-102)."""
    from scipy.ndimage import gaussian_filter
    g0, obs = _obs(np.float64)
    p0 = _port_geometry(g0)
    shots = _port_shots(obs, p0)
    crop = tuple(slice(lo, lo + n) for (lo, _), n in
                 zip(g0.model.padsizes, g0.model.shape))
    base = dict(vp=_vp0(g0), qp=np.asarray(g0.model.qp)[crop])
    kw = dict(device="cpu", precond=False, illum_fix=False)
    _, g, _ = tvf.visco_fwi_obj_multi(p0, shots, calc_grad=True, **base,
                                      **kw)
    rng = np.random.default_rng(9)
    for name in ("vp", "qp"):
        d = gaussian_filter(rng.standard_normal(base[name].shape), 3)
        d *= 1e-3 * np.abs(base[name]).mean() / np.abs(d).max()
        fs = []
        for sign in (1.0, -1.0):
            pert = dict(base)
            pert[name] = base[name] + sign * d
            fs.append(tvf.visco_fwi_obj_multi(p0, shots, **pert, **kw)[0])
        fd = (fs[0] - fs[1]) / 2.0
        an = float(np.sum(g[name] * d))
        assert abs(an) > 0, name
        assert abs(fd - an) <= 5e-5 * max(abs(fd), abs(an)), (name, fd, an)


def test_lbfgs_two_iterations_match_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("DEVITO_FWI_TPU_HIST", "f32")
    g1 = _jax_geometry(np.float32, tn=100.)
    g0 = _jax_geometry(np.float32, vp_scale=0.97, tn=100.)
    obs = jvf.visco_fm_multi(g1)
    p0 = _port_geometry(g0)
    x0 = 1.0 / (_vp0(g0) / 1.02).astype(np.float64).reshape(-1) ** 2
    bounds = [1.0 / 3.0 ** 2, 1.0 / 1.8 ** 2]
    hist = {}
    for name, opt, mini, loss, geom, shots, misfit in (
            ("jax", JLBFGS, jminimize, jvf.ViscoFwiLoss(shot_chunk=2),
             g0, obs, j_least_square),
            ("port", TLBFGS, tminimize, tvf.ViscoFwiLoss(device="cpu"), p0,
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
    assert _rel(mt, mj) < 1e-5


def test_value_and_grad_takes_a_torch_misfit():
    c = _kernel_case(np.float64)
    s_idx, s_w, r_idx, r_w, wav = c["tables"]
    m = c["g"].model
    kw = dict(nt=c["kw"]["nt"], spacing=m.spacing, space_order=4)
    obs = torch.zeros((kw["nt"], r_idx.shape[0]), dtype=torch.float64)
    f, (g_vp, g_qp), illum, res = tvg.visco_sls2_value_and_grad(
        *c["fields"], torch.as_tensor(wav), s_idx[0], s_w[0], r_idx, r_w,
        obs, 0.0, c["dt"], c["g"].f0, least_square_torch, **kw)
    assert float(f) == pytest.approx(0.5 * float(torch.sum(res * res)))
    assert g_vp.shape == g_qp.shape == m.padded_shape
    assert float(g_vp.abs().max()) > 0 and float(illum.max()) > 0


def test_driver_runs_viscoacoustic_on_cpu(tmp_path):
    """``--physics viscoacoustic`` on ``--device cpu``: 1 L-BFGS iteration of
    a cut-down SMARMN configuration (the vendored models subsampled to
    30 x 11, nbl 8, space order 4, tn 400 ms, 2 shots) runs and lowers the
    misfit."""
    import dataclasses
    from devito_fwi_tpu_torch.drivers import _marmousi_common as marm
    full = marm.SMARMN
    true_vp, smooth_vp = marm.load_models(full, marm.default_data_dir())
    data = tmp_path / "data" / full.name
    data.mkdir(parents=True)
    for name, v in (("vp.true", true_vp), ("vp.smooth_20", smooth_vp)):
        (np.asarray(v[::10, ::10], np.float32) * 1000).tofile(data / name)
    cfg = dataclasses.replace(full, shape=(30, 11), tn=400., nbl=8,
                              space_order=4, bathy_rows=1)
    m, stats = marm.run_fwi(cfg, [
        "--physics", "viscoacoustic", "--misfit", "0", "--maxiter", "1",
        "--nsrc", "2", "--device", "cpu", "--data-dir",
        str(tmp_path / "data"), "--odir", str(tmp_path / "out")])
    f = [c[1] for c in stats["calls"]]
    assert m.shape == (30 * 11,) and np.isfinite(m).all()
    assert np.isfinite(f).all() and min(f[1:]) < f[0]
