"""The port's 3-D acoustic slice against the JAX package, on the same
inputs, on the CPU:

* the plain torch twins of the three streamed sweeps
  (``ops.cuda_acoustic3d``) at float32 against the Pallas kernels of
  ``pallas_acoustic3d`` run in interpret mode, with and without the free
  surface, receivers at 37 and 107 m, space orders 4 and 8, at the JAX
  test's tolerances (tests/test_pallas3d.py: receiver slabs and traces
  1e-5 of the max, illumination 1e-4, gradient 1e-5; the dt2 history 1e-4,
  as for the 2-D twins);
* the twin of the step kernel (``ops.cuda_acoustic3.step3_plain``) against
  ``pallas_acoustic3.step3`` in interpret mode at 1e-6 of the max, and the
  step hook of the eager operators, which is numerically invisible;
* the eager ``adjoint`` and ``gradient`` (scatter and slab injection, with
  the illumination) against ``devito_fwi_tpu.ops.acoustic`` at float64 to
  1e-12, in 2-D and 3-D, and the 3-D adjoint dot test;
* the 3-D ``fm_multi`` and ``fwi_obj_multi`` on both routes (the streamed
  kernels and ``saved3=True``) against the JAX objective: at float32 (the
  JAX Pallas route in interpret mode) objective 1e-5 relative and gradient
  1e-4 of the max; at float64 (the JAX XLA route) 1e-10; the two routes
  inside the port at float64;
* the 3-D illumination fix against ``_fix_illum_jax``; the routing helpers
  ``geometry_supported3``, ``unsupported_reason`` and ``pick_xb``;
* (tests/test_torch_cuda_kernels.py holds the four CUDA kernels against
  their twins on the card.)

Sizes are the JAX tests' small 3-D ones: (24, 20, 16) and (32, 28, 24),
nbl 8, space orders 4 and 8.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from devito_fwi_tpu import AcquisitionGeometry
from devito_fwi_tpu import fwi as jfwi
from devito_fwi_tpu.fwi import _batched_tables, _solver_dt
from devito_fwi_tpu.misfit import least_square as j_least_square
from devito_fwi_tpu.models.presets import demo_model
from devito_fwi_tpu.ops import acoustic as jac
from devito_fwi_tpu.ops import pallas_acoustic3 as p3
from devito_fwi_tpu.ops import pallas_acoustic3d as p3d

from devito_fwi_tpu_torch import fwi as tfwi
from devito_fwi_tpu_torch.convert import (model_from_numpy,
                                          geometry_from_numpy)
from devito_fwi_tpu_torch.models.sources import PointSource as TPointSource
from devito_fwi_tpu_torch.ops import acoustic as tac
from devito_fwi_tpu_torch.ops import cuda_acoustic3 as c3
from devito_fwi_tpu_torch.ops import cuda_acoustic3d as c3d

TN = 120.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this module runs: the suite runs several
    pytest workers on one machine, and torch's thread pool in each of them
    (as many threads as cores) oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Route the JAX f32 3-D objective through its streamed Pallas kernels
    (interpret mode on the CPU)."""
    monkeypatch.setenv("DEVITO_FWI_TPU_PALLAS_INTERPRET", "1")
    jax.clear_caches()
    jfwi.invalidate_device_caches()
    yield
    jax.clear_caches()
    jfwi.invalidate_device_caches()


def _geom3(fs=False, so=4, rec_depth=37.0, dtype=np.float32, nlayers=3,
           shape=(24, 20, 16), rec_y=None):
    """tests/test_pallas3d.py's geometry: 2 shots, 12 receivers off the
    grid nodes in z (two planes), spread in y unless ``rec_y`` pins them."""
    kw = dict(shape=shape, spacing=(15., 15., 15.), space_order=so, nbl=8,
              dt=1.5, dtype=dtype, fs=fs)
    model = demo_model("layers-isotropic", nlayers=nlayers, **kw)
    ext, eyt = model.domain_size[0], model.domain_size[1]
    src = np.stack([np.linspace(0, ext, 2),
                    np.linspace(eyt * 0.3, eyt * 0.7, 2),
                    np.full(2, 30.0)], 1)
    ry = np.linspace(0, eyt, 12) if rec_y is None else np.full(12, rec_y)
    rec = np.stack([np.linspace(0, ext, 12), ry, np.full(12, rec_depth)], 1)
    return AcquisitionGeometry(model, rec, src, 0.0, TN, f0=0.015,
                               src_type="Ricker")


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
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


# ---------------------------------------------------------------------------
# the streamed sweeps (B13): twins against the Pallas kernels
# ---------------------------------------------------------------------------

STREAM_CASES = [(False, 4, 37.0), (True, 4, 37.0), (False, 8, 107.0),
                (True, 8, 107.0)]


@functools.lru_cache(maxsize=None)
def _stream_case(fs, so, rec_depth):
    """The JAX streamed kernels (interpret mode, y-blocks of 8) and the
    port's twins on the same operands; the JAX outputs cropped to the real
    grid."""
    geom = _geom3(fs, so, rec_depth)
    model = geom.model
    s_idx, s_w, r_idx, r_w, wav = _batched_tables(geom)
    dt, nt = float(_solver_dt(geom)), geom.nt
    nsteps, s2, R = nt - 2, dt * dt, 8
    nx, ny, nz = model.padded_shape
    vp, damp = jnp.asarray(model.vp), jnp.asarray(model.damp)
    m = 1.0 / (vp * vp)
    nyp = -(-ny // R) * R
    nzp, nxp = p3d.pad_shape3(nz, nx)
    pads = ((0, nyp - ny), (0, nzp - nz), (0, nxp - nx))
    m3 = jnp.pad(m.transpose(1, 2, 0), pads, constant_values=1.0)
    hd = jnp.broadcast_to(dt * damp, vp.shape).transpose(1, 2, 0)
    injp, iy = p3d.source_planes3(jnp.asarray(s_idx), jnp.asarray(s_w), m,
                                  s2)
    wav_b = jnp.broadcast_to(jnp.asarray(wav)[1:nt - 1, 0], (2, nsteps))
    z0 = int(np.asarray(r_idx)[..., 2].min())
    kw = dict(nt=nt, ny=ny, nz=nz, nx=nx, space_order=so,
              spacing=model.spacing, z0=z0, R=R, fs=fs, interpret=True)
    rec_slab, dt2, illum = p3d.forward_dt2_stream3(
        m3, jnp.pad(hd, pads), wav_b, injp, iy, dt, **kw)
    traces = p3d.traces_from_slabs3(rec_slab, jnp.asarray(r_idx),
                                    jnp.asarray(r_w), m, z0, nt, nsteps,
                                    jnp.float32)
    rng = np.random.RandomState(0)
    res = (np.asarray(traces) * 0.1 + 0.01 * rng.randn(
        *traces.shape)).astype(np.float32)
    res_slab = p3d.residual_slabs3(jnp.asarray(res), jnp.asarray(r_idx),
                                   jnp.asarray(r_w), m, s2, z0, nsteps, nyp)
    grad = p3d.gradient_stream3(m3, jnp.pad(hd, pads), dt2, res_slab, dt,
                                **kw)
    jax_out = dict(
        rec=np.asarray(rec_slab)[:, :, :ny, :, :nx],
        dt2=np.asarray(dt2)[:, :, :ny, :nz, :nx],
        illum=np.asarray(illum)[:, :ny, :nz, :nx], traces=np.asarray(traces),
        res_slab=np.asarray(res_slab)[:, :, :ny, :, :nx],
        grad=np.asarray(grad)[:, :ny, :nz, :nx], injp=np.asarray(
            injp)[:, :, :nz, :nx], iy=np.asarray(iy))

    mt = 1.0 / torch.as_tensor(np.asarray(model.vp)) ** 2
    m3t = mt.permute(1, 2, 0).contiguous()
    hd3t = torch.as_tensor(np.array(hd))
    injt, iyt = c3d.source_planes3(s_idx, s_w, mt, s2)
    wavt = torch.as_tensor(np.array(wav_b))
    tkw = dict(nt=nt, space_order=so, spacing=model.spacing, z0=z0, fs=fs)
    rec_t, dt2_t, illum_t = c3d.forward_dt2_stream3(m3t, hd3t, wavt, injt,
                                                    iyt, dt, **tkw)
    r_wt = torch.as_tensor(r_w)
    slab_t = c3d.residual_slabs3(torch.as_tensor(res), r_idx, r_wt, mt, s2,
                                 z0, nsteps)
    port = dict(
        rec=rec_t.numpy(), dt2=dt2_t.numpy(), illum=illum_t.numpy(),
        traces=c3d.traces_from_slabs3(rec_t, r_idx, r_wt, mt, z0,
                                      nt).numpy(),
        res_slab=slab_t.numpy(),
        grad=c3d.gradient_stream3(m3t, hd3t, dt2_t, slab_t, dt,
                                  **tkw).numpy(),
        injp=injt.numpy(), iy=iyt.numpy(),
        rec_only=c3d.forward_rec3(m3t, hd3t, wavt, injt, iyt, dt,
                                  **tkw).numpy())
    return jax_out, port


@pytest.mark.parametrize("fs,so,rec_depth", STREAM_CASES)
@pytest.mark.parametrize("out,limit", [("rec", 1e-5), ("traces", 1e-5),
                                       ("dt2", 1e-4), ("illum", 1e-4),
                                       ("grad", 1e-5)])
def test_stream_twins_match_pallas(fs, so, rec_depth, out, limit):
    want, got = _stream_case(fs, so, rec_depth)
    assert got[out].shape == want[out].shape
    assert _rel(got[out], want[out]) < limit


@pytest.mark.parametrize("fs,so,rec_depth", STREAM_CASES[:2])
def test_stream_operands_and_rec_only(fs, so, rec_depth):
    """The source planes and residual slabs equal the JAX builders' (the
    trilinear weights and s^2/m products are the same operations), and
    ``forward_rec3`` records what ``forward_dt2_stream3`` does, bitwise."""
    want, got = _stream_case(fs, so, rec_depth)
    np.testing.assert_array_equal(got["iy"], want["iy"])
    np.testing.assert_array_equal(got["injp"], want["injp"])
    assert _rel(got["res_slab"], want["res_slab"]) < 1e-6
    np.testing.assert_array_equal(got["rec_only"], got["rec"])


def test_stream_wrappers_count_and_check():
    """The CPU wrappers run the twins (counted as twin calls, no launch)
    and refuse operands the kernels do not take."""
    c3d.reset_counters()
    m3 = torch.ones((6, 8, 10))
    wav = torch.zeros((1, 4))
    injp = torch.zeros((1, 2, 8, 10))
    iy = torch.zeros(1, dtype=torch.int32)
    kw = dict(nt=6, space_order=4, spacing=(10., 10., 10.), z0=2)
    c3d.forward_rec3(m3, m3 * 0, wav, injp, iy, 1.0, **kw)
    assert c3d.TWIN_CALLS["forward_rec3"] == 1
    assert sum(c3d.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="source planes"):
        c3d.forward_rec3(m3, m3 * 0, wav, injp, iy + 6, 1.0, **kw)
    with pytest.raises(ValueError, match="receiver rows"):
        c3d.forward_rec3(m3, m3 * 0, wav, injp, iy, 1.0,
                         **dict(kw, z0=7))
    with pytest.raises(ValueError, match="shape"):
        c3d.forward_rec3(m3, m3 * 0, wav[:, :3], injp, iy, 1.0, **kw)
    t = torch.zeros((6, 8, 10), device="meta")
    with pytest.raises(ValueError, match="meta"):
        c3d.gradient_stream3(t, t, torch.zeros((1, 4, 6, 8, 10),
                                               device="meta"),
                             torch.zeros((1, 4, 6, 2, 10), device="meta"),
                             1.0, **kw)


# ---------------------------------------------------------------------------
# the card's y march (csrc/acoustic3d.cu forward_march), replayed
# ---------------------------------------------------------------------------

def _window_lap(c, window, w, ih2, fs):
    """The march's Laplacian of plane c: the y term from the window of the
    2r + 1 planes around it, the x and z terms from c (the odd mirror on
    rows 0..r under a free surface), x then y then z."""
    r = len(w) - 1
    ih2x, ih2y, ih2z = ih2

    def d2(k_of):
        acc = w[0] * c
        for k in range(1, r + 1):
            acc = acc + w[k] * (k_of(k) + k_of(-k))
        return acc

    accx = d2(lambda k: tac.shift(c, k, -1))
    accy = d2(lambda k: window[r + k])
    accz = d2(lambda k: tac.shift(c, k, -2))
    if fs:
        rows = []
        for z in range(r + 1):
            acc = w[0] * c[:, z]
            for k in range(1, r + 1):
                acc = acc + w[k] * c[:, z + k]
                if z - k > 0:
                    acc = acc + w[k] * c[:, z - k]
                elif z - k < 0:
                    acc = acc - w[k] * c[:, k - z]
            rows.append(acc)
        accz = torch.cat([torch.stack(rows, 1), accz[:, r + 1:]], 1)
    return accx * ih2x + accy * ih2y + accz * ih2z


def _march_replay(m3, two_m_hd, denom, wav, injp, iy, *, w, ih2, nsteps,
                  z0, fs, hist, ylen):
    """A torch replay of the card's march in its order: each step walks
    y in chunks of ``ylen`` planes, each chunk from a rolling window of the
    2r + 1 planes of u around the current one (its r-plane lead-ins on each
    side loaded first, zero beyond the grid); the y term from the window,
    the x and z terms from the current plane (the odd mirror on rows
    0..r under a free surface), x then y then z; up overwritten in place
    plane by plane; the source planes added at y = iy[b], iy[b] + 1."""
    B = injp.shape[0]
    ny, nz, nx = m3.shape
    r = len(w) - 1
    zero = injp.new_zeros((B, nz, nx))
    u = injp.new_zeros((B, ny, nz, nx))
    up = injp.new_zeros((B, ny, nz, nx))
    rec = injp.new_empty((B, nsteps, ny, 2, nx))
    dt2 = injp.new_empty((B, nsteps, ny, nz, nx)) if hist else None
    illum = injp.new_zeros((B, ny, nz, nx)) if hist else None
    bi = torch.arange(B)

    def plane(y):
        return u[:, y] if 0 <= y < ny else zero

    for t in range(nsteps):
        for y0 in range(0, ny, ylen):
            window = [plane(y) for y in range(y0 - r - 1, y0 + r)]
            for y in range(y0, min(y0 + ylen, ny)):
                window = window[1:] + [plane(y + r)]
                c = window[r]
                lap = _window_lap(c, window, w, ih2, fs)
                upc = up[:, y]
                un = (lap + two_m_hd[y] * c - m3[y] * upc) * denom[y]
                for p in range(2):
                    hit = (iy.long() + p == y)
                    if hit.any():
                        un[hit] = un[hit] + wav[hit, t, None, None] \
                            * injp[bi[hit], p]
                rec[:, t, y] = c[:, z0:z0 + 2]
                if hist:
                    dt2[:, t, y] = un - 2.0 * c + upc
                    illum[:, y] = illum[:, y] + un * un
                up[:, y] = un
        u, up = up, u
    return rec, dt2, illum


@functools.lru_cache(maxsize=None)
def _march_operands(fs, so):
    """The port's streamed operands on the (40, 36, 32) padded grid (fs:
    nz 24), the first 24 steps of both shots."""
    geom = _port_geometry(_geom3(fs, so))
    st = tfwi._Setup3(geom, torch.device("cpu"))
    wav, injp, iy = st.planes(0, 2)
    nsteps = 24
    w, ih2, _ = c3d._stencil_constants3(so, st.kw["spacing"], st.dt)
    m3, hd3 = st.m3, st.hd3
    ops = (m3, 2.0 * m3 + hd3, 1.0 / (m3 + hd3),
           wav[:, :nsteps].contiguous(), injp, iy)
    return ops, dict(w=w, ih2=ih2, nsteps=nsteps, z0=st.z0, fs=fs)


@pytest.mark.parametrize("fs", [False, True])
@pytest.mark.parametrize("so", [4, 8])
def test_march_replay_equals_twin_bitwise(fs, so):
    """The march's order (the y term from a rolling window of 2r + 1
    planes, y cut into the launch helper's chunks with r-plane lead-ins,
    up overwritten plane by plane) gives the twin's records, history and
    illumination bit for bit at float32 on the (40, 36, 32) padded grid,
    with and without the free surface."""
    ops, kw = _march_operands(fs, so)
    m3 = ops[0]
    ny, nz, nx = m3.shape
    assert (nx, ny) == (40, 36) and nz == (24 if fs else 32)
    launch = c3d.march_launch(2, ny, nz, nx, so // 2)
    assert launch.chunks == 2 and launch.ylen == 18
    got = _march_replay(*ops, hist=True, ylen=launch.ylen, **kw)
    want = c3d._forward_plain(*ops, hist=True, **kw)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
        assert float(w_.abs().max()) > 0
    # a chunk of 5 planes: lead-ins cut across the source and receivers
    rec = _march_replay(*ops, hist=False, ylen=5, **kw)[0]
    assert torch.equal(rec, want[0])


def _reverse_march_replay(m3, two_m_hd, denom, dt2, res, *, w, ih2,
                          nsteps, z0, fs, neg_inv_s2, ylen):
    """A torch replay of the card's reverse march in its order: t from
    the last step down, each step walking y in chunks of ``ylen`` planes
    from a rolling window of v (the chunk's r-plane lead-ins first, zero
    beyond the grid); at each plane grad += dt2[t] v, the new v over
    v_prev, the residual rows added on z0, z0 + 1; the scale at the
    end."""
    B = dt2.shape[0]
    ny, nz, nx = m3.shape
    r = len(w) - 1
    zero = dt2.new_zeros((B, nz, nx))
    v = dt2.new_zeros((B, ny, nz, nx))
    vn = torch.zeros_like(v)
    grad = torch.zeros_like(v)

    def plane(y):
        return v[:, y] if 0 <= y < ny else zero

    for t in range(nsteps - 1, -1, -1):
        for y0 in range(0, ny, ylen):
            window = [plane(y) for y in range(y0 - r - 1, y0 + r)]
            for y in range(y0, min(y0 + ylen, ny)):
                window = window[1:] + [plane(y + r)]
                c = window[r]
                grad[:, y] = grad[:, y] + dt2[:, t, y] * c
                lap = _window_lap(c, window, w, ih2, fs)
                new = (lap + two_m_hd[y] * c - m3[y] * vn[:, y]) * denom[y]
                new[:, z0:z0 + 2] = new[:, z0:z0 + 2] + res[:, t, y]
                vn[:, y] = new
        v, vn = vn, v
    return grad * neg_inv_s2


@pytest.mark.parametrize("fs", [False, True])
@pytest.mark.parametrize("so", [4, 8])
def test_reverse_march_replay_equals_twin_bitwise(fs, so):
    """The reverse march's order (v from a rolling window of 2r + 1
    planes, y cut into the launch helper's chunks with r-plane lead-ins,
    v_prev overwritten plane by plane, grad summed plane by plane) gives
    the twin's gradient bit for bit at float32 on the (40, 36, 32) padded
    grid over the twin's own history, with and without the free surface,
    at the helper's 18-plane chunks and at chunks of 5 planes."""
    ops, kw = _march_operands(fs, so)
    m3, two_m_hd, denom = ops[:3]
    ny, nz, nx = m3.shape
    dt2 = c3d._forward_plain(*ops, hist=True, **kw)[1]
    res = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (2, kw["nsteps"], ny, 2, nx)), dtype=torch.float32)
    gkw = dict(w=kw["w"], ih2=kw["ih2"], nsteps=kw["nsteps"], z0=kw["z0"],
               fs=fs, neg_inv_s2=-1.0 / 1.7)
    want = c3d._gradient_plain(m3, two_m_hd, denom, dt2, res, **gkw)
    assert float(want.abs().max()) > 0 and bool(want.isfinite().all())
    launch = c3d.march_launch(2, ny, nz, nx, so // 2, reverse=True)
    assert launch.ylen == 18
    for ylen in (launch.ylen, 5):
        got = _reverse_march_replay(m3, two_m_hd, denom, dt2, res,
                                    ylen=ylen, **gkw)
        assert torch.equal(got, want)


@pytest.mark.parametrize("space_order,shape", [
    (18, (1, 6, 8, 10)), (4, (1, 1, 2, 32 * 2 ** 16)),
    (4, (1, 1, 16 * 2 ** 16, 1)), (4, (0, 6, 8, 10))])
def test_reverse_march_refuses_before_it_builds(space_order, shape):
    """The reverse sweep asks the march's launch helper before it builds
    or allocates anything: radius 9, 65,536 tiles along x or z, or no
    shots raise ValueError here, where building the library would raise
    RuntimeError (no nvcc)."""
    B, ny, nz, nx = shape
    w, ih2, s2 = c3d._stencil_constants3(space_order, (10., 10., 10.), 1.0)
    big = torch.zeros(()).expand
    with pytest.raises(ValueError, match="acoustic3d march"):
        c3d._gradient_cuda(big(ny, nz, nx), None, None,
                           big(B, 1, ny, nz, nx), None, w=w, ih2=ih2,
                           nsteps=1, z0=0, fs=False, neg_inv_s2=-1.0 / s2)


@pytest.mark.parametrize("B,ny,nz,nx,r,smem,grid,chunks,ylen", [
    # bench config 5 (4 shots of 128^3, space order 8), its 3-shot gate
    (4, 128, 128, 128, 4, 7_680, (4, 4, 24), 3, 43),
    (3, 128, 128, 128, 4, 7_680, (3, 4, 32), 4, 32),
    (4, 128, 128, 128, 8, 12_288, (4, 4, 24), 3, 43),
    (2, 36, 32, 40, 4, 7_680, (2, 2, 4), 2, 18),     # the card tests' grid
    (1, 1, 2, 1, 1, 4_896, (1, 1, 1), 1, 1),
])
def test_march_launch_fits_shared_memory(B, ny, nz, nx, r, smem, grid,
                                         chunks, ylen):
    """The march's launch: 32 x 16 tiles, 512 threads, the shots the
    fastest grid axis, the y-chunks as many as the card holds at once at
    three blocks an SM (none shorter than 16 planes), two planes of the
    tile and an r halo within a static launch's 48 KB."""
    launch = c3d.march_launch(B, ny, nz, nx, r)
    assert launch.smem == smem <= 48 * 1024
    assert launch.grid == grid
    assert (launch.chunks, launch.ylen) == (chunks, ylen)
    assert launch.tile == (32, 16) and launch.threads == 512
    assert (launch.chunks - 1) * launch.ylen < ny <= chunks * ylen


@pytest.mark.parametrize("B,ny,nz,nx,r,grid,chunks,ylen", [
    # bench config 5 (4 shots of 128^3, space order 8), its 3-shot gate
    (4, 128, 128, 128, 4, (4, 4, 32), 4, 32),
    (3, 128, 128, 128, 4, (3, 4, 40), 5, 26),
    (2, 36, 32, 40, 4, (2, 2, 4), 2, 18),     # the card tests' grid
    (1, 1, 2, 1, 1, (1, 1, 1), 1, 1),
])
def test_reverse_march_launch_takes_two_waves(B, ny, nz, nx, r, grid,
                                              chunks, ylen):
    """The reverse march's launch: the forwards' tile, threads and shared
    memory, its y-chunks as many as two waves of two blocks an SM take
    (528 blocks), none shorter than 16 planes."""
    launch = c3d.march_launch(B, ny, nz, nx, r, reverse=True)
    forward = c3d.march_launch(B, ny, nz, nx, r)
    assert (launch.tile, launch.threads, launch.smem) == \
        (forward.tile, forward.threads, forward.smem)
    assert launch.grid == grid
    assert (launch.chunks, launch.ylen) == (chunks, ylen)
    assert (launch.chunks - 1) * launch.ylen < ny <= chunks * ylen


@pytest.mark.parametrize("args", [
    (4, 128, 128, 128, 0), (4, 128, 128, 128, 9), (0, 128, 128, 128, 4),
    (4, 0, 128, 128, 4), (4, 128, 0, 128, 4), (4, 128, 128, 0, 4),
    (1, 1, 2 ** 16, 2 ** 15, 4), (1, 1, 1, 32 * 2 ** 16, 4),
    (1, 1, 16 * 2 ** 16, 1, 4)])
def test_march_launch_refuses_what_the_kernel_does_not_take(args):
    """Beyond radius 8, an empty grid, 2^31 cells a plane or 65,536 tiles
    along x or z: the helper raises, so the wrapper launches nothing."""
    with pytest.raises(ValueError):
        c3d.march_launch(*args)


# ---------------------------------------------------------------------------
# the step kernel (B14) and the step hook
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("so", [4, 8])
def test_step3_twin_matches_pallas(so):
    """tests/test_pallas3.py's fields: the twin against the Pallas step in
    interpret mode (XB a valid blocking), 1e-6 of the max."""
    rng = np.random.RandomState(0)
    nx, ny, nz = 48, 20, 36
    u, up = (rng.randn(nx, ny, nz).astype(np.float32) for _ in range(2))
    vp = (1.5 + rng.rand(nx, ny, nz)).astype(np.float32)
    hd = (0.05 * rng.rand(nx, ny, nz)).astype(np.float32)
    spacing = (10.0, 12.0, 14.0)
    w = tuple(float(x) for x in np.asarray(
        jac.second_derivative_weights(so)[so // 2:], np.float32))
    ih = tuple(float(1.0 / h ** 2) for h in spacing)
    s2 = np.float32(1.1 * 1.1)
    m = 1.0 / (jnp.asarray(vp) * jnp.asarray(vp))
    want = np.asarray(p3.step3(jnp.asarray(u), jnp.asarray(up), m,
                               jnp.asarray(hd), s2, w=w, inv_h2=ih,
                               XB=p3.pick_xb(nx, so // 2), interpret=True))
    mt = 1.0 / (torch.as_tensor(vp) * torch.as_tensor(vp))
    c3.reset_counters()
    got = c3.step3(torch.as_tensor(u), torch.as_tensor(up), mt,
                   torch.as_tensor(hd), float(s2), w=w, inv_h2=ih).numpy()
    assert c3.TWIN_CALLS["step3"] == 1 and c3.LAUNCHES["step3"] == 0
    assert _rel(got, want) < 1e-6


def test_pick_xb_and_step3_gate():
    assert c3.pick_xb(96, 4) == p3.pick_xb(96, 4) == 16
    assert c3.pick_xb(128, 4) == 16          # bench config 5, padded
    assert c3.pick_xb(97, 4) is None
    for nx in range(8, 140):
        for r in (1, 2, 4):
            assert c3.pick_xb(nx, r) == p3.pick_xb(nx, r)
    ok = c3.unsupported_reason
    assert ok((128, 128, 128), 8, False, torch.float32) is None
    assert "free surface" in ok((128, 128, 128), 8, True, torch.float32)
    assert "float32" in ok((128, 128, 128), 8, False, torch.float64)
    assert "pick_xb" in ok((97, 128, 128), 8, False, torch.float32)
    assert "2-D" in ok((128, 128), 8, False, torch.float32)


def _fwd_case(dtype, so=4, fs=False, dim=3):
    """Operands of the eager operators: a 3-D (or 2-D) layered geometry."""
    if dim == 3:
        geom = _geom3(fs, so, 37.0, dtype, shape=(32, 28, 24),
                      rec_y=210.0)
    else:
        model = demo_model("layers-isotropic", nlayers=3, shape=(41, 31),
                           spacing=(10., 10.), space_order=so, nbl=8,
                           dtype=dtype, fs=fs)
        rec = np.stack([np.linspace(0., 400., 21), np.full(21, 35.)], 1)
        geom = AcquisitionGeometry(model, rec, np.array([[200., 20.]]), 0.,
                                   TN, f0=0.015, src_type="Ricker")
    model = geom.model
    s_idx, s_w, r_idx, r_w, wav = _batched_tables(geom)
    return dict(geom=geom, vp=np.asarray(model.vp),
                damp=np.asarray(model.damp), wav=np.asarray(wav),
                s_idx=s_idx[0], s_w=s_w[0], r_idx=r_idx, r_w=r_w,
                dt=float(_solver_dt(geom)), nt=geom.nt,
                kw=dict(spacing=model.spacing, space_order=so, fs=fs))


def test_step_hook_is_invisible():
    """The eager forward with the step kernel's twin (``step3=True``)
    equals the eager update bitwise at float32, and the hook ran."""
    c = _fwd_case(np.float32)
    args = (torch.as_tensor(c["vp"]), torch.as_tensor(c["damp"]),
            torch.as_tensor(c["wav"]), c["s_idx"], c["s_w"], c["r_idx"],
            c["r_w"], c["dt"])
    c3.reset_counters()
    rec_k, u_k = tac.forward(*args, nt=c["nt"], step3=True, **c["kw"])
    assert c3.TWIN_CALLS["step3"] == c["nt"] - 2
    rec_e, u_e = tac.forward(*args, nt=c["nt"], step3=False, **c["kw"])
    assert torch.equal(rec_k, rec_e) and torch.equal(u_k, u_e)
    # None means "on cuda where it applies": the CPU keeps the eager update
    c3.reset_counters()
    tac.forward(*args, nt=c["nt"], **c["kw"])
    assert c3.TWIN_CALLS["step3"] == 0
    with pytest.raises(ValueError, match="free surface"):
        tac.forward(*args, nt=c["nt"], step3=True,
                    **dict(c["kw"], fs=True))


# ---------------------------------------------------------------------------
# eager adjoint and gradient against the JAX operators at float64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim,fs", [(2, False), (2, True), (3, False),
                                    (3, True)])
def test_adjoint_and_gradient_match_jax_f64(dim, fs):
    c = _fwd_case(np.float64, fs=fs, dim=dim)
    nt, dt = c["nt"], c["dt"]
    st = dict(nt=nt, **c["kw"])
    jargs = [jnp.asarray(c[k]) for k in ("vp", "damp")]
    rec_j, u_j = jac.forward(*jargs, jnp.asarray(c["wav"]),
                             jnp.asarray(c["s_idx"]), jnp.asarray(c["s_w"]),
                             jnp.asarray(c["r_idx"]), jnp.asarray(c["r_w"]),
                             dt, save=True, **st)
    rng = np.random.RandomState(1)
    res = np.asarray(rec_j) * 0.5 + 0.1 * rng.randn(*rec_j.shape) * \
        np.abs(np.asarray(rec_j)).max()
    srca_j, v_j = jac.adjoint(*jargs, jnp.asarray(res),
                              jnp.asarray(c["r_idx"]), jnp.asarray(c["r_w"]),
                              jnp.asarray(c["s_idx"]), jnp.asarray(c["s_w"]),
                              dt, **st)
    g_j, _, il_j = jac.gradient(*jargs, u_j, jnp.asarray(res),
                                jnp.asarray(c["r_idx"]),
                                jnp.asarray(c["r_w"]), dt, with_illum=True,
                                **st)

    targs = [torch.as_tensor(c[k]) for k in ("vp", "damp")]
    rec_t, u_t = tac.forward(*targs, torch.as_tensor(c["wav"]), c["s_idx"],
                             c["s_w"], c["r_idx"], c["r_w"], dt, save=True,
                             **st)
    assert _rel(rec_t.numpy(), rec_j) < 1e-12
    assert _rel(u_t.numpy(), u_j) < 1e-12
    srca_t, v_t = tac.adjoint(*targs, torch.as_tensor(res), c["r_idx"],
                              c["r_w"], c["s_idx"], c["s_w"], dt, **st)
    assert _rel(srca_t.numpy(), srca_j) < 1e-12
    assert _rel(v_t.numpy(), v_j) < 1e-12
    g_t, _, il_t = tac.gradient(*targs, u_t, torch.as_tensor(res),
                                c["r_idx"], c["r_w"], dt, with_illum=True,
                                **st)
    assert _rel(g_t.numpy(), g_j) < 1e-12
    assert _rel(il_t.numpy(), il_j) < 1e-12
    # the slab injection gives the scatter's gradient (the receivers sit
    # between two planes in every trailing axis of this geometry: in 3-D
    # pinned at one y)
    box = tfwi._rec_box(c["r_idx"], c["geom"].model.padded_shape)
    if box is not None:
        g_b, _ = tac.gradient(*targs, u_t, torch.as_tensor(res), c["r_idx"],
                              c["r_w"], dt, rec_box=box, **st)
        assert _rel(g_b.numpy(), g_t.numpy()) < 1e-12


def test_rec_slabs_match_jax_f32():
    """The slab injection at float32 against the JAX saved route's own
    (``gradient(rec_box=...)``), receivers pinned to one y (a box)."""
    geom = _geom3(False, 4, 37.0, np.float32, shape=(32, 28, 24),
                  rec_y=210.0)
    model = geom.model
    s_idx, s_w, r_idx, r_w, wav = _batched_tables(geom)
    dt, nt = float(_solver_dt(geom)), geom.nt
    box = tfwi._rec_box(r_idx, model.padded_shape)
    assert box is not None
    st = dict(nt=nt, spacing=model.spacing, space_order=4, fs=False)
    jv = [jnp.asarray(np.asarray(a)) for a in (model.vp, model.damp)]
    _, u_j = jac.forward(*jv, jnp.asarray(wav), jnp.asarray(s_idx[0]),
                         jnp.asarray(s_w[0]), jnp.asarray(r_idx),
                         jnp.asarray(r_w), dt, save=True, **st)
    res = np.random.RandomState(2).randn(nt, r_idx.shape[0]).astype(
        np.float32)
    g_j, _ = jac.gradient(*jv, u_j, jnp.asarray(res), jnp.asarray(r_idx),
                          jnp.asarray(r_w), dt, rec_box=box, **st)
    tv = [torch.as_tensor(np.asarray(a)) for a in (model.vp, model.damp)]
    g_t, _ = tac.gradient(*tv, torch.as_tensor(np.asarray(u_j)),
                          torch.as_tensor(res), r_idx, r_w, dt, rec_box=box,
                          **st)
    assert _rel(g_t.numpy(), g_j) < 1e-5


def test_adjoint_dot_3d():
    """tests/test_acoustic.py::test_adjoint_dot_3d on the port's eager
    forward and adjoint (float64, 21^3, space order 4)."""
    from devito_fwi_tpu_torch.models.model import SeismicModel
    from devito_fwi_tpu_torch.models.geometry import setup_geometry
    from devito_fwi_tpu_torch.ops.interp import interp_table
    shape = (21, 21, 21)
    model = SeismicModel(origin=(0., 0., 0.), spacing=(10., 10., 10.),
                         shape=shape, space_order=4, vp=np.full(shape, 2.0),
                         nbl=8, bcs="damp", dtype=np.float64)
    geometry = setup_geometry(model, 150.)
    s_idx, s_w = interp_table(geometry.src_positions, model.origin_pml,
                              model.spacing, dtype=model.dtype)
    r_idx, r_w = interp_table(geometry.rec_positions, model.origin_pml,
                              model.spacing, dtype=model.dtype)
    kw = dict(nt=geometry.nt, spacing=model.spacing, space_order=4)
    vp = torch.as_tensor(np.asarray(model.vp))
    damp = torch.as_tensor(np.asarray(model.damp))
    dt = float(model.critical_dt)
    np.random.seed(0)
    src = np.asarray(geometry.src.data)
    rec1 = np.random.rand(geometry.nt, r_idx.shape[0])
    rec2, _ = tac.forward(vp, damp, torch.as_tensor(src), s_idx, s_w, r_idx,
                          r_w, dt, **kw)
    srca, _ = tac.adjoint(vp, damp, torch.as_tensor(rec1), r_idx, r_w, s_idx,
                          s_w, dt, **kw)
    sum_s = np.dot(src.ravel(), srca.numpy().ravel())
    sum_r = np.dot(rec1.ravel(), rec2.numpy().ravel())
    assert np.isclose((sum_s - sum_r) / (sum_s + sum_r), 0.0, atol=1e-11)


# ---------------------------------------------------------------------------
# the 3-D objective against the JAX objective
# ---------------------------------------------------------------------------

def _fwi_case(dtype, shape=(24, 20, 16), so=4):
    kw = dict(so=so, dtype=dtype, shape=shape, rec_y=None)
    g1 = _geom3(nlayers=3, **kw)
    g0 = _geom3(nlayers=1, **kw)
    return g1, g0


def test_fm_multi_matches_jax_f32(pallas_interpret):
    g1, _ = _fwi_case(np.float32)
    assert jfwi._pallas3_route(g1, "OT2", calc_grad=False)[0] is not None
    want = np.stack([s.data for s in jfwi.fm_multi(g1)])
    got = np.stack([s.data for s in tfwi.fm_multi(_port_geometry(g1),
                                                  device="cpu")])
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("saved3", [False, True])
def test_fwi_obj_multi_3d_matches_jax_f32(saved3, pallas_interpret):
    """Unpreconditioned objective and gradient against the JAX streamed
    route (interpret mode): objective 1e-5 relative, gradient 1e-4 of the
    max."""
    g1, g0 = _fwi_case(np.float32)
    obs = jfwi.fm_multi(g1)
    f_j, g_j, _ = jfwi.fwi_obj_multi(g0, obs, j_least_square, None, None,
                                     False, calc_grad=True)
    p0 = _port_geometry(g0)
    c3.reset_counters()
    c3d.reset_counters()
    f_t, g_t, _ = tfwi.fwi_obj_multi(p0, _port_shots(obs, p0), None, None,
                                     None, False, calc_grad=True,
                                     device="cpu", saved3=saved3)
    assert abs(f_t - f_j) < 1e-5 * abs(f_j)
    assert _rel(g_t, g_j) < 1e-4
    if saved3:
        assert c3.TWIN_CALLS["step3"] > 0
        assert c3d.TWIN_CALLS["gradient_stream3"] == 0
    else:
        assert c3d.TWIN_CALLS["forward_dt2_stream3"] == 1
        assert c3d.TWIN_CALLS["gradient_stream3"] == 1


@pytest.mark.parametrize("saved3", [False, True])
def test_fwi_loss_3d_matches_jax_f64(saved3):
    """``fwi_loss`` with illumination precondition, a mask and a shot
    subset against the JAX XLA route at float64, to 1e-10. On the small
    grid, where the layers' reflections reach the receivers within TN (the
    residual is 19% of the traces; on (32, 28, 24) it is 4e-5 of them, and
    the misfit then measures cancellation: traces that agree to 2e-15 give
    objectives 8e-11 apart)."""
    g1, g0 = _fwi_case(np.float64, so=8)
    obs = jfwi.fm_multi(g1)
    mask = np.ones(g0.model.shape)
    mask[:, :, :3] = 0.0
    x0 = 1.0 / np.asarray(g0.model.vp_unpadded, np.float64).reshape(-1) ** 2
    f_j, g_j, _ = jfwi.fwi_loss(x0.copy(), g0, obs, j_least_square, None,
                                mask, True, shot_indices=[1])
    p0 = _port_geometry(g0)
    f_t, g_t, _ = tfwi.fwi_loss(x0.copy(), p0, _port_shots(obs, p0), None,
                                None, mask, True, shot_indices=[1],
                                device="cpu", saved3=saved3)
    assert abs(f_t - f_j) < 1e-10 * abs(f_j)
    assert _rel(g_t, g_j) < 1e-10
    # trials run the streamed forward on both routes
    f_trial, _, _ = tfwi.fwi_loss(x0.copy(), p0, _port_shots(obs, p0), None,
                                  calc_grad=False, device="cpu",
                                  saved3=saved3)
    f_jt, _, _ = jfwi.fwi_loss(x0.copy(), g0, obs, j_least_square,
                               calc_grad=False)
    assert abs(f_trial - f_jt) < 1e-10 * abs(f_jt)


def test_saved_route_matches_stream_route_f64():
    """Inside the port at float64: both 3-D routes, free surface on (the
    saved route then steps with the eager update on the CPU), receivers
    pinned to one y so the saved route injects slabs."""
    kw = dict(fs=True, so=4, dtype=np.float64, rec_y=210.0)
    g1, g0 = _geom3(nlayers=3, **kw), _geom3(nlayers=1, **kw)
    p1, p0 = _port_geometry(g1), _port_geometry(g0)
    assert tfwi._rec_box(tfwi._Setup3(p0, torch.device("cpu")).r_idx,
                         p0.model.padded_shape) is not None
    obs = tfwi.fm_multi(p1, device="cpu")
    f_s, g_s, r_s = tfwi.fwi_obj_multi(p0, obs, None, calc_grad=True,
                                       device="cpu")
    f_v, g_v, r_v = tfwi.fwi_obj_multi(p0, obs, None, calc_grad=True,
                                       device="cpu", saved3=True)
    assert abs(f_v - f_s) < 1e-12 * abs(f_s)
    assert _rel(g_v, g_s) < 1e-10
    assert _rel(np.asarray(r_v[0]), np.asarray(r_s[0])) < 1e-12


def test_illumination_fix_matches_jax():
    g1, _ = _fwi_case(np.float64)
    model = g1.model
    rng = np.random.RandomState(3)
    g = rng.randn(*model.shape)
    fix = tfwi._IllumFix3(g1.rec_positions, model.spacing, model.shape,
                          torch.device("cpu"))
    for i in range(g1.nsrc):
        src = np.asarray(g1.src_positions)[i]
        want = np.asarray(jfwi._fix_illum_jax(
            jnp.asarray(g), jnp.asarray(src), jnp.asarray(g1.rec_positions),
            model.spacing, model.shape))
        got = (torch.as_tensor(g) * fix.keep(src[None])[0]
               * fix.rec_prod).numpy()
        assert _rel(got, want) < 1e-13


def test_geometry_gates_3d():
    g = _geom3()
    assert p3d.geometry_supported3(g)
    assert c3d.geometry_supported3(_port_geometry(g))
    model = g.model
    ext = model.domain_size[0]
    spread = np.stack([np.linspace(0, ext, 8), np.full(8, ext / 2),
                       np.linspace(10.0, 100.0, 8)], 1)
    g2 = AcquisitionGeometry(model, spread, g.src_positions, 0.0, TN,
                             f0=0.015, src_type="Ricker")
    assert not p3d.geometry_supported3(g2)
    p2 = _port_geometry(g2)
    assert "adjacent z-planes" in c3d.unsupported_reason(p2)
    with pytest.raises(NotImplementedError, match="adjacent z-planes"):
        tfwi._Setup3(p2, torch.device("cpu"))
    # the objective and fm_multi take such a geometry to the eager route
    tfwi.reset_counters()
    assert len(tfwi.fm_multi(p2, device="cpu")) == p2.nsrc
    assert tfwi.EAGER["fm_multi"] == 1
    # a source past the padded y grid
    src = np.asarray(g.src_positions).copy()
    src[0, 1] = model.domain_size[1] + 200.0
    g3 = AcquisitionGeometry(model, g.rec_positions, src, 0.0, TN,
                             f0=0.015, src_type="Ricker")
    assert p3d.geometry_supported3(g3) is False
    assert "y-corners" in c3d.unsupported_reason(_port_geometry(g3))
    # on cuda the saved route steps the eager update where the step kernel
    # does not apply, counted (it raised until the eager route took it)
    fs_model = _port_geometry(_geom3(fs=True)).model
    tfwi.reset_counters()
    assert tfwi._saved_step3(fs_model, torch.float32,
                             torch.device("cuda")) is False
    assert tfwi.EAGER["saved_step"] == 1
    assert tfwi._saved_step3(fs_model, torch.float32,
                             torch.device("cpu")) is False
    assert tfwi.EAGER["saved_step"] == 1
    # a 3-D gradient with stream=False takes the eager checkpoint route
    # (its traces meet the streamed kernels' to float32 rounding)
    p0 = _port_geometry(g)
    obs = tfwi.fm_multi(p0, device="cpu")
    f, grad, _ = tfwi.fwi_obj_multi(p0, obs, None, calc_grad=True,
                                    device="cpu", stream=False)
    assert tfwi.EAGER["objective"] == 1
    energy = 0.5 * sum(float(np.sum(o.data.astype(np.float64) ** 2))
                       for o in obs)
    assert 0.0 <= f <= 1e-6 * energy and np.isfinite(grad).all()
