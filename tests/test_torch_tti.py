"""The port's 2-D/3-D TTI path (devito_fwi_tpu_torch.ops.tti, ops.cuda_tti,
ops.tti_wavesolver, ops.wavesolver and convert) against the JAX package, on
the CPU:

* the eager ``ops.tti`` functions (forward with and without ``save``,
  adjoint, born, jacobian_adjoint, forward_ckpt with the illumination,
  jacobian_adjoint_from_ckpt, forward_staggered) against
  ``devito_fwi_tpu.ops.tti`` at f64 on layers-tti, 2-D at space order 4 and
  8 and one small 3-D case with phi: within 1e-12 of the max (measured
  ~5e-14);
* the port solver's F and J dot tests at f64 (1e-11, the JAX tests');
* zero anisotropy: the TTI twin's receiver rows against twice the acoustic
  twin's (u = v = the acoustic field; measured 5e-7, limit 1e-4 of the max);
* the four plain twins of ``ops.cuda_tti`` against the Pallas kernels in
  interpret mode at f32 on the ``tests/test_pallas_tti.py`` geometry
  (layers-tti 60 x 50, nbl 10, 7 segments), space order 4 and 8, with the
  same operands and residual rows: receiver rows within 1e-5 of the max;
  segment starts and d2/dt2 histories within 1e-4 (measured 1.3e-5 to
  4.7e-5: the second difference cancels most digits, and the interpreter's
  own history is 2.5e-5 of its max away from the f64 twin's); gradients
  within 2e-5 (the JAX test's limit) on the residual rows of 0.3 x the
  recorded traces;
* the streamed twin gradient equal to the checkpoint-route one bitwise;
* ``tti_gradient_batched`` / ``tti_gradient_residual_batched`` against the
  JAX ``*_batched_pallas`` in interpret mode (2e-5);
* ``AnisotropicWaveSolver(device="cpu")`` against the JAX solver (f64
  1e-12; the checkpointed gradient at f32 2e-5), and on a geometry the
  kernels do not take the eager checkpoint pair;
* ``model_from_numpy`` carrying epsilon, delta, theta (and phi).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from devito_fwi_tpu.models.geometry import AcquisitionGeometry
from devito_fwi_tpu.models.geometry import setup_geometry as j_setup_geometry
from devito_fwi_tpu.models.presets import demo_model as j_demo_model
from devito_fwi_tpu.ops import pallas_tti as jpt
from devito_fwi_tpu.ops import tti as jtti
from devito_fwi_tpu.ops.interp import interp_table
from devito_fwi_tpu.ops.pallas_acoustic import residual_rows as j_rows
from devito_fwi_tpu.ops.tti_wavesolver import (
    AnisotropicWaveSolver as JSolver)

from devito_fwi_tpu_torch.convert import (geometry_from_numpy,
                                          model_from_numpy)
from devito_fwi_tpu_torch.models.geometry import setup_geometry
from devito_fwi_tpu_torch.models.model import SeismicModel
from devito_fwi_tpu_torch.models.presets import demo_model
from devito_fwi_tpu_torch.ops import cuda_acoustic as ca
from devito_fwi_tpu_torch.ops import cuda_tti as ct
from devito_fwi_tpu_torch.ops import tti as ttti
from devito_fwi_tpu_torch.ops.acoustic import _ckpt_layout
from devito_fwi_tpu_torch.ops.tti_wavesolver import AnisotropicWaveSolver
from devito_fwi_tpu_torch.ops.wavesolver import PerfSummary, Wavefield

FIELDS = ("vp", "damp", "epsilon", "delta", "theta")
NCK = 7


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


def _tables(model, positions):
    return interp_table(positions, model.origin_pml, model.spacing,
                        dtype=model.dtype)


# ---------------------------------------------------------------------------
# the eager operators at f64
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _f64_case(ndim, so):
    """layers-tti at f64 (2-D 30 x 28, nbl 8, tn 150 ms; 3-D 13 x 11 x 12
    with phi, nbl 4, tn 60 ms): (jax operands, torch operands, tables,
    wavelet, dt, keywords)."""
    if ndim == 2:
        model = j_demo_model("layers-tti", shape=(30, 28),
                             spacing=(10., 10.), nbl=8, space_order=so,
                             dtype=np.float64)
        geom = j_setup_geometry(model, 150.)
    else:
        model = j_demo_model("layers-tti", shape=(13, 11, 12),
                             spacing=(15., 15., 15.), nbl=4, space_order=so,
                             dtype=np.float64)
        geom = j_setup_geometry(model, 60.)
    names = FIELDS + (("phi",) if ndim == 3 else ())
    fj = [jnp.asarray(getattr(model, n)) for n in names]
    ft = [torch.as_tensor(np.asarray(getattr(model, n))) for n in names]
    if ndim == 2:
        fj.append(None)
        ft.append(None)
    s_idx, s_w = _tables(model, geom.src_positions)
    r_idx, r_w = _tables(model, geom.rec_positions)
    kw = dict(nt=geom.nt, spacing=model.spacing, space_order=so)
    return (model, tuple(fj), tuple(ft), (s_idx, s_w, r_idx, r_w),
            geom.src.data, float(model.critical_dt), kw)


def _eager_pair(name, ndim, so):
    """(port output, JAX output) of one eager function on ``_f64_case``."""
    model, fj, ft, (s_idx, s_w, r_idx, r_w), wav, dt, kw = _f64_case(ndim,
                                                                      so)
    rng = np.random.default_rng(3)
    data = rng.standard_normal((kw["nt"], r_idx.shape[0]))
    if name == "forward":
        return (ttti.forward(*ft, wav, s_idx, s_w, r_idx, r_w, dt,
                             save=True, **kw),
                jtti.forward(*fj, jnp.asarray(wav), s_idx, s_w, r_idx, r_w,
                             dt, save=True, **kw))
    if name == "forward_final":
        return (ttti.forward(*ft, wav, s_idx, s_w, r_idx, r_w, dt, **kw),
                jtti.forward(*fj, jnp.asarray(wav), s_idx, s_w, r_idx, r_w,
                             dt, **kw))
    if name == "adjoint":
        return (ttti.adjoint(*ft, data, r_idx, r_w, s_idx, s_w, dt, **kw),
                jtti.adjoint(*fj, jnp.asarray(data), r_idx, r_w, s_idx, s_w,
                             dt, **kw))
    if name == "born":
        dm = 0.01 * rng.standard_normal(model.padded_shape)
        return (ttti.born(*ft, dm, wav, s_idx, s_w, r_idx, r_w, dt, **kw),
                jtti.born(*fj, jnp.asarray(dm), jnp.asarray(wav), s_idx,
                          s_w, r_idx, r_w, dt, **kw))
    if name == "jacobian_adjoint":
        _, u, v = jtti.forward(*fj, jnp.asarray(wav), s_idx, s_w, r_idx,
                               r_w, dt, save=True, **kw)
        return (ttti.jacobian_adjoint(*ft, np.asarray(u), np.asarray(v),
                                      data, r_idx, r_w, dt, **kw),
                jtti.jacobian_adjoint(*fj, u, v, jnp.asarray(data), r_idx,
                                      r_w, dt, **kw))
    if name == "forward_ckpt":
        return (ttti.forward_ckpt(*ft, wav, s_idx, s_w, r_idx, r_w, dt,
                                  n_checkpoints=NCK, with_illum=True, **kw),
                jtti.forward_ckpt(*fj, jnp.asarray(wav), s_idx, s_w, r_idx,
                                  r_w, dt, n_checkpoints=NCK,
                                  with_illum=True, **kw))
    if name == "jacobian_adjoint_from_ckpt":
        _, starts = jtti.forward_ckpt(*fj, jnp.asarray(wav), s_idx, s_w,
                                      r_idx, r_w, dt, n_checkpoints=NCK,
                                      **kw)
        return (ttti.jacobian_adjoint_from_ckpt(
                    *ft, wav, s_idx, s_w, np.asarray(starts), data, r_idx,
                    r_w, dt, n_checkpoints=NCK, **kw),
                jtti.jacobian_adjoint_from_ckpt(
                    *fj, jnp.asarray(wav), s_idx, s_w, starts,
                    jnp.asarray(data), r_idx, r_w, dt, n_checkpoints=NCK,
                    **kw))
    assert name == "forward_staggered"
    return ((ttti.forward_staggered(*ft, wav, s_idx, s_w, r_idx, r_w, dt,
                                    **kw),),
            (jtti.forward_staggered(*fj, jnp.asarray(wav), s_idx, s_w,
                                    r_idx, r_w, dt, **kw),))


EAGER = ("forward", "forward_final", "adjoint", "born", "jacobian_adjoint",
         "forward_ckpt", "jacobian_adjoint_from_ckpt", "forward_staggered")


@pytest.mark.parametrize("so", [4, 8])
@pytest.mark.parametrize("name", EAGER)
def test_eager_tti_matches_jax_f64(name, so):
    got, want = _eager_pair(name, 2, so)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-12, (name, _rel(g, w))


@pytest.mark.parametrize("name", ["forward", "adjoint", "born",
                                  "jacobian_adjoint"])
def test_eager_tti_3d_matches_jax_f64(name):
    """3-D layers-tti with phi (the azimuthal branch), space order 4."""
    got, want = _eager_pair(name, 3, 4)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-12, (name, _rel(g, w))


# ---------------------------------------------------------------------------
# dot tests and the isotropic limit
# ---------------------------------------------------------------------------

def _dot_solver():
    model = demo_model("layers-tti", shape=(41, 41), spacing=(10., 10.),
                       nbl=10, space_order=8, dtype=np.float64)
    return AnisotropicWaveSolver(model, setup_geometry(model, 250.),
                                 space_order=8, device="cpu")


def test_tti_adjoint_F():
    solver = _dot_solver()
    rng = np.random.default_rng(0)
    src1 = solver.geometry.src
    rec1 = solver.geometry.new_rec()
    rec1.data[:] = rng.random(rec1.data.shape)
    rec2, _, _, summary = solver.forward(src1)
    srca, _, _, _ = solver.adjoint(rec1)
    sum_s = np.dot(src1.data.ravel(), srca.data.ravel())
    sum_r = np.dot(rec1.data.ravel(), rec2.data.ravel())
    assert np.isclose((sum_s - sum_r) / (sum_s + sum_r), 0.0, atol=1e-11)
    assert isinstance(summary, PerfSummary) and summary.elapsed > 0


def test_tti_adjoint_J():
    solver = _dot_solver()
    rng = np.random.default_rng(0)
    model = solver.model
    dm1 = np.zeros(model.padded_shape)
    c = [n // 2 for n in model.padded_shape]
    dm1[c[0] - 5:c[0] + 6, c[1] - 5:c[1] + 6] = \
        -1 + 2 * rng.random((11, 11))
    rec1 = solver.geometry.new_rec()
    rec1.data[:] = rng.random(rec1.data.shape)
    rec2, *_ = solver.jacobian(dm1)
    _, u0, v0, _ = solver.forward(save=True)
    assert isinstance(u0, Wavefield) and u0.data.shape[0] == solver.nt
    dm2, _ = solver.jacobian_adjoint(rec1, u0, v0)
    sum_m = np.dot(dm1.ravel(), dm2.ravel())
    sum_d = np.dot(rec1.data.ravel(), rec2.data.ravel())
    assert np.isclose((sum_m - sum_d) / (sum_m + sum_d), 0.0, atol=1e-11)


def test_zero_anisotropy_rows_are_twice_the_acoustic():
    """eps = delta = theta = 0: eh = dh = 1 exactly, u and v step alike and
    gxx(u) + gzz(u) is the Laplacian, so the TTI twin records twice the
    acoustic twin's field at the same dt (measured 5e-7 of the max over 811
    steps; limit 1e-4)."""
    shape = (61, 40)
    vp = np.full(shape, 2.0, np.float32)
    vp[:, 20:] = 2.8
    z = np.zeros(shape, np.float32)
    model = SeismicModel(origin=(0., 0.), spacing=(10., 10.), shape=shape,
                         space_order=8, vp=vp, nbl=12, bcs="damp",
                         epsilon=z, delta=z, theta=z)
    src = np.stack([np.linspace(100., 500., 2), np.full(2, 40.)], 1)
    rec = np.stack([np.linspace(0., 600., 61), np.full(61, 40.)], 1)
    from devito_fwi_tpu_torch.models.geometry import (
        AcquisitionGeometry as TGeometry)
    g = TGeometry(model, rec, src, 0., 800., f0=0.012, src_type="Ricker")
    s_idx, s_w = _tables(model, g.src_positions)
    r_idx, _ = _tables(model, g.rec_positions)
    dt = float(model.critical_dt)
    T = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    m, ops = ct.operands(*(T(getattr(model, n)) for n in FIELDS), dt)
    injT = ca.source_pattern(s_idx[:, None], s_w[:, None], m,
                             dt ** 2).transpose(1, 2).contiguous()
    nx, nz = model.padded_shape
    kw = dict(nt=g.nt, nx=nx, nz=nz, space_order=8, spacing=model.spacing,
              z0=int(r_idx[..., 1].min()), n_checkpoints=1)
    wav = T(g.src.data)
    rows_tti, _ = ct.tti_forward_ckpt_plain(
        *ops, injT, ct.pack_wavelet(wav, dt ** 2, g.nt, g.nt - 2), dt, **kw)
    rows_ac = ca.forward_rec_plain(ops[0], ops[1],
                                   ca.pad_wavelet(wav, g.nt, g.nt - 2),
                                   injT, dt, **kw)
    assert _rel(rows_tti, 2 * rows_ac) <= 1e-4


# ---------------------------------------------------------------------------
# the plain twins against the Pallas kernels (interpret mode, f32)
# ---------------------------------------------------------------------------

def _pallas_geometry(so, nsrc=2):
    model = j_demo_model("layers-tti", shape=(60, 50), spacing=(10., 10.),
                         nbl=10, space_order=so, dtype=np.float32)
    srcs = np.stack([np.linspace(100, 400, nsrc), np.full(nsrc, 20.0)], 1)
    rec = np.stack([np.linspace(0, model.domain_size[0], 40),
                    np.full(40, 20.0)], 1)
    return model, AcquisitionGeometry(model, rec, srcs, 0.0, 250.0,
                                      f0=0.012, src_type="Ricker")


@functools.lru_cache(maxsize=None)
def _twin_case(so):
    """Every output of the four Pallas kernels (interpret mode) and of the
    four twins on the same operands, wavelet and residual rows."""
    import os
    saved = os.environ.get("DEVITO_FWI_TPU_PALLAS_INTERPRET")
    os.environ["DEVITO_FWI_TPU_PALLAS_INTERPRET"] = "1"
    try:
        model, geom = _pallas_geometry(so)
        s_idx, s_w = _tables(model, geom.src_positions)
        r_idx, r_w = _tables(model, geom.rec_positions)
        fj = [jnp.asarray(getattr(model, n)) for n in FIELDS]
        dt = float(model.critical_dt)
        nt = geom.nt
        wav = geom.src.data[:, :1]
        m, s2, (nsteps, seg, nseg), ops, z0, kw = jpt._tti_operands(
            *fj, jnp.asarray(s_idx)[:, None], jnp.asarray(s_w)[:, None],
            r_idx, dt, nt=nt, spacing=model.spacing, space_order=so,
            n_checkpoints=NCK, interpret=True)
        j_ck = jpt.forward_ckpt_pallas(*ops, jnp.asarray(wav), dt, **kw)
        j_dt2 = jpt.forward_dt2_pallas(*ops, jnp.asarray(wav), dt, **kw)
        from devito_fwi_tpu.fwi import _traces_from_rows
        rec = _traces_from_rows(j_dt2[0], jnp.asarray(r_idx),
                                jnp.asarray(r_w), z0, nt, nsteps,
                                jnp.float32)
        rows = j_rows(0.3 * rec, jnp.asarray(r_idx), jnp.asarray(r_w), m,
                      s2, z0, nsteps, seg, nseg)
        j_gs = jpt.gradient_stream_pallas(*ops[:6], j_dt2[1], j_dt2[2], rows,
                                          dt, **kw)
        j_ja = jpt.jacobian_adjoint_pallas(*ops, jnp.asarray(wav), j_ck[1],
                                           rows, dt, **kw)
    finally:
        if saved is None:
            del os.environ["DEVITO_FWI_TPU_PALLAS_INTERPRET"]
        else:
            os.environ["DEVITO_FWI_TPU_PALLAS_INTERPRET"] = saved
    T = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    tops = [T(o) for o in ops]
    tkw = dict(nt=nt, nx=kw["nx"], nz=kw["nz"], space_order=so,
               spacing=model.spacing, z0=z0, n_checkpoints=NCK)
    twav = ct.pack_wavelet(T(wav), s2, nt, nseg * seg)
    ct.reset_counters()
    t_ck = ct.tti_forward_ckpt_segments(*tops, twav, dt, **tkw)
    t_dt2 = ct.tti_forward_dt2_segments(*tops, twav, dt, **tkw)
    t_gs = ct.tti_gradient_stream_segments(*tops[:6], t_dt2[1], t_dt2[2],
                                           T(rows), dt, **tkw)
    t_ja = ct.tti_jacobian_adjoint_segments(*tops, twav, t_ck[1], T(rows),
                                            dt, **tkw)
    assert all(n == 1 for n in ct.TWIN_CALLS.values())
    assert sum(ct.LAUNCHES.values()) == 0
    return {"tti_forward_ckpt_segments": (t_ck, j_ck),
            "tti_forward_dt2_segments": (t_dt2, j_dt2),
            "tti_gradient_stream_segments": ((t_gs,), (j_gs,)),
            "tti_jacobian_adjoint_segments": ((t_ja,), (j_ja,))}


# per output: the limit of max|twin - pallas| / max|pallas|
LIMITS = {"tti_forward_ckpt_segments": (1e-5, 1e-4),
          "tti_forward_dt2_segments": (1e-5, 1e-4, 1e-4),
          "tti_gradient_stream_segments": (2e-5,),
          "tti_jacobian_adjoint_segments": (2e-5,)}


@pytest.mark.parametrize("so", [4, 8])
@pytest.mark.parametrize("kernel", ct.KERNELS)
def test_twin_matches_pallas_interpret(kernel, so):
    got, want = _twin_case(so)[kernel]
    for g, w, limit in zip(got, want, LIMITS[kernel]):
        assert g.dtype == torch.float32
        assert tuple(g.shape) == tuple(w.shape)
        assert _rel(g, w) <= limit, (kernel, _rel(g, w))


@pytest.mark.parametrize("so", [4, 8])
def test_streamed_twin_gradient_equals_the_recompute_one(so):
    case = _twin_case(so)
    (g_s,), _ = case["tti_gradient_stream_segments"]
    (g_c,), _ = case["tti_jacobian_adjoint_segments"]
    assert torch.equal(g_s, g_c)
    (rows_ck, _), _ = case["tti_forward_ckpt_segments"]
    (rows_dt2, _, _), _ = case["tti_forward_dt2_segments"]
    assert torch.equal(rows_ck, rows_dt2)


# ---------------------------------------------------------------------------
# the card's fused steps (csrc/tti2d.cu forward_fused, adjoint_fused),
# replayed
# ---------------------------------------------------------------------------

def _fused_operators(f, g, sth, cth, *, st, tile):
    """gxx(f) = lap(f) - gzz(f) and gzz(g) in the card's fused order, tile
    by tile: f and g on the tile and an r ring (zero beyond the grid; the
    ring's corners deeper than r1 = r//2 NaN, as the kernel leaves them
    unwritten), the products sin th gz and cos th gz of both on the tile
    and an r1 ring along their axis (zero at ring cells beyond the grid;
    sin th and cos th NaN beyond it, where the kernel never reads them),
    then at the tile's cells both operators from those arrays only.
    Returns both on the (B, nz, nx) grid."""
    nz, nx = f.shape[-2:]
    r, r1 = st.r, st.r1
    tx, tz = tile
    NZ, NX = -(-nz // tz) * tz + 2 * r, -(-nx // tx) * tx + 2 * r

    def padded(a, fill=0.0):
        """a on the tiles' index space, r cells of ``fill`` around."""
        out = a.new_full(a.shape[:-2] + (NZ, NX), fill)
        out[..., r:r + nz, r:r + nx] = a
        return out

    inside = padded(torch.ones((nz, nx), dtype=torch.bool), False)
    lz = torch.arange(tz + 2 * r)[:, None]
    lx = torch.arange(tx + 2 * r)[None, :]
    ox = torch.where(lx < r, r - lx, (lx - (r + tx - 1)).clamp(min=0))
    oz = torch.where(lz < r, r - lz, (lz - (r + tz - 1)).clamp(min=0))
    unread = (ox > 0) & (oz > 0) & ((ox > r1) | (oz > r1))
    S, C = padded(sth, float("nan")), padded(cth, float("nan"))

    def d1(a, z, x, h, w, along_x):
        """D1 at the h x w cells from (z, x) of the last two axes: the
        non-zero weights in tap order from the first, times 1/h."""
        acc = None
        for k, wk in enumerate(st.w1):
            if wk == 0.0:
                continue
            o = k - r1
            zz, xx = (z, x + o) if along_x else (z + o, x)
            term = wk * a[..., zz:zz + h, xx:xx + w]
            acc = term if acc is None else acc + term
        return acc * (st.ihx if along_x else st.ihz)

    def d2(a, along_x):
        """D2 at the tile's cells of a local array: w0 a + sum_k wk (a[+k]
        + a[-k]), times (1/h)^2."""
        def at(o):
            zz, xx = (r, r + o) if along_x else (r + o, r)
            return a[..., zz:zz + tz, xx:xx + tx]
        acc = st.w2[0] * at(0)
        for k in range(1, r + 1):
            acc = acc + st.w2[k] * (at(k) + at(-k))
        return acc * (st.ihx2 if along_x else st.ihz2)

    def products(al, sl, cl, il):
        """(sin th gz on the tile's rows and an r1 ring in x, cos th gz on
        its columns and an r1 ring in z) of the local array al."""
        out = []
        for z, x, h, w, tr in ((r, r - r1, tz, tx + 2 * r1, sl),
                               (r - r1, r, tz + 2 * r1, tx, cl)):
            gz = -(sl[z:z + h, x:x + w] * d1(al, z, x, h, w, True)
                   + cl[z:z + h, x:x + w] * d1(al, z, x, h, w, False))
            out.append(torch.where(il[z:z + h, x:x + w],
                                   tr[z:z + h, x:x + w] * gz, 0.0))
        return out

    def gzz(ps, pc):
        return -(d1(ps, 0, r1, tz, tx, True) + d1(pc, r1, 0, tz, tx, False))

    F, G = padded(f), padded(g)
    gxx_f, gzz_g = torch.empty_like(F), torch.empty_like(G)
    for zt in range(0, NZ - 2 * r, tz):
        for xt in range(0, NX - 2 * r, tx):
            win = (slice(zt, zt + tz + 2 * r), slice(xt, xt + tx + 2 * r))
            lf, lg = F[(...,) + win].clone(), G[(...,) + win].clone()
            lf[..., unread] = float("nan")
            lg[..., unread] = float("nan")
            sl, cl, il = S[win], C[win], inside[win]
            psf, pcf = products(lf, sl, cl, il)
            psg, pcg = products(lg, sl, cl, il)
            own = (..., slice(zt + r, zt + r + tz), slice(xt + r, xt + r + tx))
            gxx_f[own] = (d2(lf, True) + d2(lf, False)) - gzz(psf, pcf)
            gzz_g[own] = gzz(psg, pcg)
    cut = (..., slice(r, r + nz), slice(r, r + nx))
    return gxx_f[cut], gzz_g[cut]


def _fused_adjoint_replay(prm, udt2, vdt2, res, *, st, nsteps, z0, tile):
    """A torch replay of the card's fused reverse step in its order: the
    gradient term, a = eh du + dh dv and b = dh du + dv formed once a cell,
    gxx(a) and gzz(b) by ``_fused_operators``, then the update cell by
    cell and the residual rows."""
    m, tm, im, eh, dh, sth, cth = prm
    B, _, nz, nx = udt2.shape
    zero = udt2.new_zeros((B, nz, nx))
    du = dun = dv = dvn = grad = zero
    for t in range(nsteps - 1, -1, -1):
        grad = grad + udt2[:, t] * du + vdt2[:, t] * dv
        h0, hz = _fused_operators(eh * du + dh * dv, dh * du + dv, sth, cth,
                                  st=st, tile=tile)
        dup = (st.s2 * h0 + tm * du - m * dun) * im
        dvp = (st.s2 * hz + tm * dv - m * dvn) * im
        dup[:, z0:z0 + 2] = dup[:, z0:z0 + 2] + res[:, t]
        dvp[:, z0:z0 + 2] = dvp[:, z0:z0 + 2] + res[:, t]
        dun, du, dvn, dv = du, dup, dv, dvp
    return grad


def _fused_forward_replay(prm, wav, inj, *, st, seg, z0, hist, tile):
    """A torch replay of the card's fused forward step in its order: the
    receiver rows of u + v and the segment starts from the tile's fields,
    gxx(u) and gzz(v) by ``_fused_operators``, the update cell by cell,
    the source added only at the shot's listed cells
    (``cuda_acoustic._source_list``), then the histories."""
    m, tm, im, eh, dh, sth, cth = prm
    B, nz, nx = inj.shape
    total = wav.shape[0] - 1
    s2 = wav[0]
    cells, vals, K = ca._source_list(inj)
    u = up = v = vp = inj.new_zeros((B, nz, nx))
    rec = inj.new_empty((B, total, 2, nx))
    udt2, vdt2 = inj.new_empty((2, B, total, nz, nx))
    starts = inj.new_empty((B, total // seg, 4, nz, nx))
    for t in range(total):
        rec[:, t] = u[:, z0:z0 + 2] + v[:, z0:z0 + 2]
        if not hist and t % seg == 0:
            starts[:, t // seg] = torch.stack([u, up, v, vp], 1)
        gxx_u, gzz_v = _fused_operators(u, v, sth, cth, st=st, tile=tile)
        un = ((s2 * (eh * gxx_u + dh * gzz_v) + tm * u) - m * up) * im
        vn = ((s2 * (dh * gxx_u + gzz_v) + tm * v) - m * vp) * im
        uf, vf = un.view(B, -1), vn.view(B, -1)
        for b in range(B):
            for j in range(K):
                c = int(cells[b, j])
                if c >= 0:
                    uf[b, c] = uf[b, c] + wav[t + 1] * vals[b, j]
                    vf[b, c] = vf[b, c] + wav[t + 1] * vals[b, j]
        if hist:
            udt2[:, t] = (un - 2.0 * u) + up
            vdt2[:, t] = (vn - 2.0 * v) + vp
        up, u, vp, v = u, un, v, vn
    return (rec, udt2, vdt2) if hist else (rec, starts)


@functools.lru_cache(maxsize=None)
def _fused_case(so):
    """2 shots on layers-tti 20 x 4 (nbl 10: padded 40 x 24), the twin's
    coefficient operands, seeded histories and residual rows of 12 steps
    on rows 7 and 8 (across the z-tiles of the 16 x 8 replay)."""
    model = demo_model("layers-tti", shape=(20, 4), spacing=(10., 10.),
                       nbl=10, space_order=so, dtype=np.float32)
    dt = float(model.critical_dt)
    _, coeffs = ct.operands(*(torch.as_tensor(np.asarray(getattr(model, n)))
                              for n in FIELDS), dt)
    mT, hdT, ehT, dhT, stT, ctT = coeffs
    prm = (mT, 2.0 * mT + hdT, 1.0 / (mT + hdT), ehT, dhT, stT, ctT)
    nz, nx = mT.shape
    nsteps = 12
    rng = np.random.default_rng(13)
    T = lambda *shape: torch.as_tensor(  # noqa: E731
        rng.standard_normal(shape), dtype=torch.float32)
    st = ct._statics(so, model.spacing, dt, torch.float32)
    return prm, T(2, nsteps, nz, nx), T(2, nsteps, nz, nx), \
        T(2, nsteps, 2, nx), st


@pytest.mark.parametrize("tile", [(32, 16), (16, 8)])
@pytest.mark.parametrize("so", [4, 8])
def test_fused_adjoint_order_equals_twin_bitwise(so, tile):
    """The fused reverse step's order (a and b once a cell on the tile and
    an r ring, the unread corners NaN; the products on an r1 ring, zero
    beyond the grid) gives the plain twin's gradient bit for bit at
    float32, at the kernel's 32 x 16 tile (the 40 x 24 grid cuts its tiles
    at both edges) and at 16 x 8 tiles (the receiver rows 7 and 8 on two
    z-tiles, each in the other's ring)."""
    prm, udt2, vdt2, res, st = _fused_case(so)
    nz, nx = prm[0].shape
    assert (nz, nx) == (24, 40)
    kw = dict(st=st, nsteps=udt2.shape[1], z0=7)
    want = ct._adjoint_plain(prm, udt2, vdt2, res, **kw)
    got = _fused_adjoint_replay(prm, udt2, vdt2, res, tile=tile, **kw)
    assert torch.equal(got, want)
    assert float(want.abs().max()) > 0 and bool(want.isfinite().all())


def test_adjoint_launch_fits_shared_memory():
    """The fused reverse step's launch at bench config 4 (8 shots, 186 x
    380 padded, space order 8): 32 x 16 tiles, 512 threads (one cell a
    thread), the shots the fastest grid axis; its shared memory within a
    static launch's 48 KB up to radius 8."""
    main = ct.adjoint_launch(8, 186, 380, 4)
    assert main.grid == (8, 12, 12) and main.smem == 17_408
    assert main.tile == (32, 16) and main.threads == 512
    assert ct.adjoint_launch(8, 186, 380, 8).smem == 23_552 <= 48 * 1024
    assert ct.adjoint_launch(1, 2, 1, 2).smem == 14_720


@pytest.mark.parametrize("args", [
    (8, 186, 380, 1), (8, 186, 380, 9), (0, 186, 380, 4), (8, 0, 380, 4),
    (8, 186, 0, 4), (1, 2 ** 16, 2 ** 15, 4), (1, 2, 32 * 2 ** 16, 4),
    (1, 32 * 2 ** 16, 1, 4)])
def test_adjoint_launch_refuses_what_the_kernel_does_not_take(args):
    """Outside radius 2 .. 8, an empty grid, 2^31 cells or 65,536 tiles
    along x or z: the helper raises."""
    with pytest.raises(ValueError):
        ct.adjoint_launch(*args)


@pytest.mark.parametrize("route", ["stream", "checkpoint"])
def test_adjoint_refuses_before_it_builds(route):
    """Both reverse sweeps ask the launch helper before they build or
    allocate anything: a grid of 65,536 x tiles raises ValueError here,
    where building the library would raise RuntimeError (no nvcc)."""
    B, nz, nx = 1, 2, 32 * 2 ** 16
    st = ct._statics(8, (10., 10.), 1.0, torch.float32)
    big = torch.zeros(()).expand
    with pytest.raises(ValueError, match="tti adjoint"):
        if route == "stream":
            ct._adjoint_cuda(None, big(B, 1, nz, nx), None, None, st=st,
                             nsteps=1, z0=0)
        else:
            ct._jacobian_adjoint_cuda(None, None, None,
                                      big(B, 1, 4, nz, nx), None, st=st,
                                      nsteps=1, z0=0)


@functools.lru_cache(maxsize=None)
def _fused_forward_case(so):
    """2 shots on layers-tti 20 x 4 (nbl 10: padded 40 x 24), the twin's
    coefficient operands, a seeded source pattern of five cells a shot
    (two on the edges of a 16 x 8 tile, one on the grid's edge) and a
    seeded wavelet of 12 steps in 3 segments; receivers on rows 7, 8."""
    model = demo_model("layers-tti", shape=(20, 4), spacing=(10., 10.),
                       nbl=10, space_order=so, dtype=np.float32)
    dt = float(model.critical_dt)
    _, coeffs = ct.operands(*(torch.as_tensor(np.asarray(getattr(model, n)))
                              for n in FIELDS), dt)
    mT, hdT, ehT, dhT, stT, ctT = coeffs
    prm = (mT, 2.0 * mT + hdT, 1.0 / (mT + hdT), ehT, dhT, stT, ctT)
    nz, nx = mT.shape
    rng = np.random.default_rng(14)
    inj = torch.zeros((2, nz, nx))
    for b, cells in enumerate((((7, 15), (8, 16), (12, 31), (0, 39),
                                (23, 5)),
                               ((3, 3), (15, 16), (16, 15), (20, 32),
                                (9, 0)))):
        for z, x in cells:
            inj[b, z, x] = float(rng.uniform(0.5, 2.0))
    st = ct._statics(so, model.spacing, dt, torch.float32)
    wav = torch.as_tensor(rng.standard_normal(13), dtype=torch.float32)
    wav[0] = st.s2
    return prm, wav, inj, st


@pytest.mark.parametrize("tile", [(32, 16), (16, 8)])
@pytest.mark.parametrize("hist", [True, False])
@pytest.mark.parametrize("so", [4, 8])
def test_fused_forward_order_equals_twin_bitwise(so, hist, tile):
    """The fused forward step's order (u and v on the tile and an r ring,
    the unread corners NaN; the products on an r1 ring, zero beyond the
    grid; the coefficients NaN beyond the grid; the source only at the
    listed cells) gives every output of the plain twin bit for bit at
    float32, with the histories and with the segment starts, at the
    kernel's 32 x 16 tile (the 40 x 24 grid cuts its tiles at both edges)
    and at 16 x 8 tiles."""
    prm, wav, inj, st = _fused_forward_case(so)
    kw = dict(st=st, seg=4, z0=7, hist=hist)
    want = ct._forward_plain(prm, wav, inj, **kw)
    got = _fused_forward_replay(prm, wav, inj, tile=tile, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
        assert bool(w.isfinite().all())
    assert float(want[-1].abs().max()) > 0


def test_forward_launch_fits_shared_memory():
    """The fused forward step's launch at bench config 4 (8 shots, 186 x
    380 padded, space order 8) is the reverse step's: 32 x 16 tiles, 512
    threads (one cell a thread), the shots the fastest grid axis, its
    shared memory within a static launch's 48 KB up to radius 8."""
    main = ct.forward_launch(8, 186, 380, 4)
    assert main.grid == (8, 12, 12) and main.smem == 17_408
    assert main.tile == (32, 16) and main.threads == 512
    assert ct.forward_launch(8, 186, 380, 8).smem == 23_552 <= 48 * 1024
    assert vars(main) == vars(ct.adjoint_launch(8, 186, 380, 4))


@pytest.mark.parametrize("args", [
    (8, 186, 380, 1), (8, 186, 380, 9), (0, 186, 380, 4), (8, 0, 380, 4),
    (8, 186, 0, 4), (1, 2 ** 16, 2 ** 15, 4), (1, 2, 32 * 2 ** 16, 4),
    (1, 16 * 2 ** 16, 1, 4)])
def test_forward_launch_refuses_what_the_kernel_does_not_take(args):
    """Outside radius 2 .. 8, an empty grid, 2^31 cells or 65,536 tiles
    along x or z: the helper raises, naming the forward."""
    with pytest.raises(ValueError, match="tti forward"):
        ct.forward_launch(*args)


@pytest.mark.parametrize("route", ["dt2", "ckpt"])
def test_forward_refuses_before_it_builds(route):
    """Both forwards ask the launch helper before they build or allocate
    anything: a grid of 65,536 x tiles raises ValueError here, where
    building the library would raise RuntimeError (no nvcc)."""
    B, nz, nx = 1, 2, 32 * 2 ** 16
    st = ct._statics(8, (10., 10.), 1.0, torch.float32)
    big = torch.zeros(()).expand
    with pytest.raises(ValueError, match="tti forward"):
        ct._forward_cuda(None, big(5), big(B, nz, nx), st=st, seg=4, z0=0,
                         hist=route == "dt2")


# ---------------------------------------------------------------------------
# the batched entry points and the solver
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _batched_case():
    """The JAX test_pallas_tti gradient case: per-shot gradients of the XLA
    checkpointed pair with res = 0.3 rec, its recorded traces, and the
    operands in both packages."""
    model, geom = _pallas_geometry(4)
    s_idx, s_w = _tables(model, geom.src_positions)
    r_idx, r_w = _tables(model, geom.rec_positions)
    fj = [jnp.asarray(getattr(model, n)) for n in FIELDS]
    wav = geom.src.data[:, :1]
    dt = float(model.critical_dt)
    kw = dict(nt=geom.nt, spacing=model.spacing, space_order=4,
              n_checkpoints=NCK)

    def per(a, b):
        rec0, starts = jtti.forward_ckpt(*fj, None, jnp.asarray(wav), a, b,
                                         jnp.asarray(r_idx),
                                         jnp.asarray(r_w), dt, **kw)
        g, _ = jtti.jacobian_adjoint_from_ckpt(
            *fj, None, jnp.asarray(wav), a, b, starts, rec0 * 0.3,
            jnp.asarray(r_idx), jnp.asarray(r_w), dt, **kw)
        return g, rec0

    g_ref, rec = jax.vmap(per)(jnp.asarray(s_idx)[:, None],
                               jnp.asarray(s_w)[:, None])
    ft = [torch.as_tensor(np.asarray(getattr(model, n))) for n in FIELDS]
    return (model, fj, ft, (s_idx[:, None], s_w[:, None], r_idx, r_w), wav,
            dt, kw, np.asarray(g_ref), np.asarray(rec))


@pytest.mark.parametrize("residual", [False, True])
def test_batched_gradient_matches_jax_pallas(residual, monkeypatch):
    """``tti_gradient_batched`` (obs = 0.7 rec) and
    ``tti_gradient_residual_batched`` (res = 0.3 rec) against the JAX
    ``*_batched_pallas`` in interpret mode and the XLA pair (2e-5)."""
    monkeypatch.setenv("DEVITO_FWI_TPU_PALLAS_INTERPRET", "1")
    model, fj, ft, (s_idx, s_w, r_idx, r_w), wav, dt, kw, g_ref, rec = \
        _batched_case()
    jt = (jnp.asarray(s_idx), jnp.asarray(s_w), jnp.asarray(r_idx),
          jnp.asarray(r_w))
    if residual:
        g_j = jpt.tti_gradient_residual_batched_pallas(
            *fj, jnp.asarray(wav), *jt, jnp.asarray(0.3 * rec), dt,
            interpret=True, **kw)
        g_t = ct.tti_gradient_residual_batched(
            *ft, torch.as_tensor(wav), s_idx, s_w, r_idx, r_w,
            torch.as_tensor(0.3 * rec), dt, **kw)
    else:
        g_j = jpt.tti_gradient_batched_pallas(
            *fj, jnp.asarray(wav), *jt, jnp.asarray(0.7 * rec), dt,
            interpret=True, **kw)
        g_t = ct.tti_gradient_batched(
            *ft, torch.as_tensor(wav), s_idx, s_w, r_idx, r_w,
            torch.as_tensor(0.7 * rec), dt, **kw)
    assert tuple(g_t.shape) == g_ref.shape
    assert _rel(g_t, g_j) <= 2e-5
    assert _rel(g_t, g_ref) <= 2e-5


def test_batched_routes_agree_bitwise():
    """stream=True (one segment of nt-2 steps) and stream=False (the
    caller's 7 segments) give the same twin gradient, bit for bit, and
    ``tti_forward_batched`` the traces of the JAX XLA forward."""
    model, fj, ft, (s_idx, s_w, r_idx, r_w), wav, dt, kw, g_ref, rec = \
        _batched_case()
    obs = torch.as_tensor(0.7 * rec)
    out = {}
    ct.reset_counters()
    for stream in (True, False):
        out[stream] = ct.tti_gradient_batched(
            *ft, torch.as_tensor(wav), s_idx, s_w, r_idx, r_w, obs, dt,
            stream=stream, **kw)
    assert torch.equal(out[True], out[False])
    assert ct.TWIN_CALLS["tti_forward_dt2_segments"] == 1
    assert ct.TWIN_CALLS["tti_jacobian_adjoint_segments"] == 1
    traces = ct.tti_forward_batched(*ft, torch.as_tensor(wav), s_idx, s_w,
                                    r_idx, r_w, dt, **kw)
    assert _rel(traces, rec) <= 1e-5


def test_batched_rejects_more_than_one_source_point():
    model, fj, ft, (s_idx, s_w, r_idx, r_w), wav, dt, kw, g_ref, rec = \
        _batched_case()
    two = np.concatenate([s_idx, s_idx], 1)
    with pytest.raises(ValueError, match="one source point"):
        ct.tti_gradient_batched(*ft, torch.as_tensor(wav), two,
                                np.concatenate([s_w, s_w], 1), r_idx, r_w,
                                torch.as_tensor(rec), dt, **kw)


def _port_model(jm):
    names = ("epsilon", "delta", "theta") + (("phi",) if jm.dim == 3
                                             else ())
    return model_from_numpy(dict(
        vp=np.asarray(jm.vp), damp=jm.damp, origin=jm.origin,
        spacing=jm.spacing, shape=jm.shape, nbl=jm.nbl,
        space_order=jm.space_order, fs=jm.fs, dt=jm._dt,
        **{n: np.asarray(getattr(jm, n)) for n in names}))


def _port_solver(jsolver, device="cpu"):
    g = jsolver.geometry
    model = _port_model(jsolver.model)
    geom = geometry_from_numpy(model, dict(
        rec_positions=g.rec_positions, src_positions=g.src_positions,
        t0=g.t0, tn=g.tn, f0=g.f0, src_type=g.src_type))
    return AnisotropicWaveSolver(model, geom,
                                 space_order=jsolver.space_order,
                                 device=device)


def test_model_from_numpy_carries_the_tti_fields():
    for shape, kw in (((30, 28), {}), ((13, 11, 12), {})):
        jm = j_demo_model("layers-tti", shape=shape,
                          spacing=(10.,) * len(shape), nbl=4,
                          space_order=4, **kw)
        pm = _port_model(jm)
        names = ("vp", "damp", "epsilon", "delta", "theta") + \
            (("phi",) if len(shape) == 3 else ())
        for n in names:
            assert np.array_equal(np.asarray(getattr(pm, n)),
                                  np.asarray(getattr(jm, n))), n
        assert pm.critical_dt == jm.critical_dt


@pytest.mark.parametrize("kernel", ["centered", "staggered"])
def test_solver_matches_jax_solver_f64(kernel):
    """forward, adjoint, jacobian and jacobian_adjoint of the port solver
    against the JAX solver at f64 (1e-12)."""
    jm = j_demo_model("layers-tti", shape=(30, 28), spacing=(10., 10.),
                      nbl=8, space_order=8, dtype=np.float64)
    js = JSolver(jm, j_setup_geometry(jm, 150.), space_order=8)
    ps = _port_solver(js)
    rj = js.forward(kernel=kernel)[0].data.copy()
    rp = ps.forward(kernel=kernel)[0].data.copy()
    assert _rel(rp, rj) <= 1e-12
    if kernel == "staggered":
        return
    rng = np.random.default_rng(2)
    data = rng.random(rj.shape)
    rec_j, rec_p = js.geometry.new_rec(), ps.geometry.new_rec()
    rec_j.data[:] = data
    rec_p.data[:] = data
    sj = js.adjoint(rec_j)[0].data
    sp = ps.adjoint(rec_p)[0].data
    assert _rel(sp, sj) <= 1e-12
    dm = 0.01 * rng.standard_normal(jm.padded_shape)
    assert _rel(ps.jacobian(dm)[0].data, js.jacobian(dm)[0].data) <= 1e-12
    _, u0, v0, _ = js.forward(save=True)
    gj, _ = js.jacobian_adjoint(rec_j, u0, v0)
    _, u0p, v0p, _ = ps.forward(save=True)
    gp, _ = ps.jacobian_adjoint(rec_p, u0p, v0p)
    assert _rel(gp, gj) <= 1e-12


def test_solver_gradient_checkpointed_matches_jax(monkeypatch):
    """The port solver's checkpointed gradient (the twins on the CPU)
    against the JAX solver's Pallas route in interpret mode (f32, 2e-5),
    the test_pallas_tti geometry; a receiver line off two adjacent planes
    runs the eager pair on the CPU, against the JAX XLA pair."""
    monkeypatch.setenv("DEVITO_FWI_TPU_PALLAS_INTERPRET", "1")
    jm = j_demo_model("layers-tti", shape=(40, 36), spacing=(15., 15.),
                      nbl=10, space_order=4, dtype=np.float32)
    js = JSolver(jm, j_setup_geometry(jm, 200.0), space_order=4)
    rec_j, _, _, _ = js.forward()
    rec_j.data[:] = 0.3 * rec_j.data
    ps = _port_solver(js)
    rec_p = ps.geometry.new_rec()
    rec_p.data[:] = rec_j.data
    ct.reset_counters()
    g_j, _ = js.gradient_checkpointed(rec_j, n_checkpoints=6)
    g_p, summary = ps.gradient_checkpointed(rec_p, n_checkpoints=6)
    assert ct.TWIN_CALLS["tti_gradient_stream_segments"] == 1
    assert _rel(g_p, g_j) <= 2e-5
    assert isinstance(summary, PerfSummary)

    # receivers on a slanted line: not the kernels' geometry
    rec = np.stack([np.linspace(0., 500., 21), np.linspace(20., 300., 21)],
                   1)
    jg = AcquisitionGeometry(jm, rec, js.geometry.src_positions, 0., 200.,
                             f0=js.geometry.f0, src_type="Ricker")
    js2 = JSolver(jm, jg, space_order=4)
    r_j, _, _, _ = js2.forward()
    ps2 = _port_solver(js2)
    r_p = ps2.geometry.new_rec()
    r_p.data[:] = r_j.data
    ct.reset_counters()
    monkeypatch.setenv("DEVITO_FWI_TPU_PALLAS_TTI", "0")
    g_j2, _ = js2.gradient_checkpointed(r_j, n_checkpoints=6)
    g_p2, _ = ps2.gradient_checkpointed(r_p, n_checkpoints=6)
    assert sum(ct.TWIN_CALLS.values()) == 0
    assert _rel(g_p2, g_j2) <= 2e-5


def test_supported_reason():
    m2 = demo_model("layers-tti", shape=(30, 28), spacing=(10., 10.),
                    nbl=4, space_order=4)
    r_idx, _ = _tables(m2, np.stack([np.linspace(0., 290., 11),
                                     np.full(11, 20.)], 1))
    assert ct.supported_reason(m2, r_idx) is None
    bad, _ = _tables(m2, np.stack([np.linspace(0., 290., 11),
                                   np.linspace(20., 200., 11)], 1))
    assert "adjacent z-planes" in ct.supported_reason(m2, bad)
    m64 = demo_model("layers-tti", shape=(30, 28), spacing=(10., 10.),
                     nbl=4, space_order=4, dtype=np.float64)
    assert "float32" in ct.supported_reason(m64, r_idx)
    m3 = demo_model("layers-tti", shape=(9, 8, 7), spacing=(10.,) * 3,
                    nbl=2, space_order=4)
    assert "2-D" in ct.supported_reason(m3, r_idx)
