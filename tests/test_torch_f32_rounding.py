"""Why the port's float32 kernel route on tests/test_sharding.py's weak
circle lies up to 1e-4 of the max from the JAX package's
(tests/test_torch_parallel.py ``KERNEL_F32_TOL``): the two frameworks round
the same float32 stencil differently, and the weak circle's residual is a
small difference of large traces, in which the rounding of the observed
and the synthetic data cancel only where both come from one rounding.

* XLA's CPU compiler contracts each multiply-add into a fused
  multiply-add (one rounding): the Pallas Laplacian in interpret mode, as
  JAX compiles it, equals bitwise a replay with a fused multiply-add a
  term, and the port's twin (which the CUDA kernels, built with
  ``-fmad=false``, repeat bitwise on the card) equals the replay with a
  rounding after every product and sum;
* from bitwise-equal operands the two forwards then part within a few
  float32 ulps, and their traces lie equally close to the float64 ones;
* the JAX route's residual against observed data the JAX package models
  shares its rounding (both fused), the port's does not: given the JAX
  package's data the port's gradient lies about three times further from
  the float64 gradient than the JAX route's; given data the port models
  itself it lies as close as the JAX route with the JAX package's data.
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import torch_parallel_ranks as R
from devito_fwi_tpu import AcquisitionGeometry, SeismicModel, demo_model
from devito_fwi_tpu import fwi as jfwi
from devito_fwi_tpu.misfit import least_square
from devito_fwi_tpu.models.sources import PointSource
from devito_fwi_tpu.ops import pallas_acoustic as pa
from devito_fwi_tpu.ops.self_adjoint import setup_w_over_q

from devito_fwi_tpu_torch import fwi as tfwi
from devito_fwi_tpu_torch.ops import cuda_acoustic as ca

JAX_LIB = SimpleNamespace(demo_model=demo_model, SeismicModel=SeismicModel,
                          AcquisitionGeometry=AcquisitionGeometry,
                          setup_w_over_q=setup_w_over_q)
PALLAS_ENV = {"DEVITO_FWI_TPU_PALLAS": "1",
              "DEVITO_FWI_TPU_PALLAS_INTERPRET": "1"}
F32, F64 = np.float32, np.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _rel(got, want):
    got, want = np.asarray(got, F64), np.asarray(want, F64)
    return np.abs(got - want).max() / np.abs(want).max()


class _pallas:
    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in PALLAS_ENV}
        os.environ.update(PALLAS_ENV)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _shift(x, k, axis):
    out = np.zeros_like(x)
    n = x.shape[axis]
    src = [slice(None)] * 2
    dst = [slice(None)] * 2
    if k > 0:
        src[axis], dst[axis] = slice(k, n), slice(0, n - k)
    else:
        src[axis], dst[axis] = slice(0, n + k), slice(-k, n)
    out[tuple(dst)] = x[tuple(src)]
    return out


def _lap_replay(u, w, ihx, ihz, fused):
    """The transposed Laplacian's terms in their order, float32, each
    multiply-add rounded once (``fused``) or after the product and the
    sum. A float64 product of two float32 numbers is exact, so rounding
    the float64 sum once is the fused multiply-add's result here."""
    w = [F32(v) for v in w]
    ihx, ihz = F32(ihx), F32(ihz)

    def madd(a, b, c):
        if fused:
            return (a.astype(F64) * b + c.astype(F64)).astype(F32)
        return (a * b).astype(F32) + c

    acc = []
    for axis in (1, 0):
        a = (w[0] * u).astype(F32)
        for k in range(1, len(w)):
            a = madd(w[k] * np.ones_like(u), _shift(u, k, axis)
                     + _shift(u, -k, axis), a)
        acc.append(a)
    ax, az = acc
    return madd(ax, ihx, (az * ihz).astype(F32))


def test_fused_multiply_adds_explain_the_laplacians():
    rng = np.random.default_rng(3)
    nz, nx = 40, 50
    u = rng.standard_normal((nz, nx)).astype(F32)
    w, ihx, ihz, _ = pa._stencil_constants(4, (10., 10.), 1.2)
    jl = np.asarray(jax.jit(pa._make_lap_t(w, ihx, ihz, nx, nz, False))(u))
    tl = ca._make_lap_t(w, ihx, ihz, False)(torch.as_tensor(u)).numpy()
    assert np.array_equal(jl, _lap_replay(u, w, ihx, ihz, fused=True))
    assert np.array_equal(tl, _lap_replay(u, w, ihx, ihz, fused=False))
    assert not np.array_equal(jl, tl)
    # ulps apart, no more
    assert _rel(tl, jl) < 1e-6


@pytest.fixture(scope="module")
def weak_circle():
    """The kernel-route geometry of tests/test_torch_parallel.py (receivers
    on z = 30 m) at float32 and float64, the JAX package's and the port's
    observed data, and the float64 gradient."""
    rk = dict(dtype=F32, vertical=False)
    g1, g0 = R.build(JAX_LIB, "acoustic", **rk)
    p1, p0 = R.build(R.port_lib(), "acoustic", **rk)
    d1, d0 = R.build(JAX_LIB, "acoustic", dtype=F64, vertical=False)
    obs64 = np.stack([o.data for o in jfwi.fm_multi(d1)])
    _, g64, _ = jfwi.fwi_obj_multi(d0, _records(d0, obs64), least_square,
                                   calc_grad=True)
    return SimpleNamespace(
        g1=g1, g0=g0, p1=p1, p0=p0, d0=d0, obs64=obs64, g64=g64,
        obs_jax=np.stack([o.data for o in jfwi.fm_multi(g1)]),
        obs_port=np.stack([o.data for o in tfwi.fm_multi(p1, device="cpu")]))


def _records(geometry, stack):
    out = []
    for s in stack:
        p = PointSource(name="rec", time_range=geometry.time_axis,
                        coordinates=geometry.rec_positions,
                        dtype=geometry.model.dtype)
        p.data[:] = s
        out.append(p)
    return out


def test_forwards_part_by_rounding_from_equal_operands(weak_circle):
    """The receiver rows of the Pallas forward (interpret mode) and the
    port's twin from the same operands part by float32 rounding only, and
    the traces of both lie as close to the float64 traces."""
    c = weak_circle
    model = c.g0.model
    s_idx, s_w, r_idx, r_w, wav = jfwi._batched_tables(c.g0)
    dt = float(jfwi._solver_dt(c.g0))
    with _pallas():
        z0, nck, _, _, _ = jfwi._pallas_route(
            c.g0, jfwi._default_checkpoints(c.g0.nt), "OT2",
            calc_grad=False)
    from devito_fwi_tpu.ops.acoustic import _ckpt_layout
    nsteps, seg, nseg = _ckpt_layout(c.g0.nt, nck)
    nx, nz = model.padded_shape
    m, mT, hdT, injT, wav_pad = jfwi._pallas_operands(
        jnp.asarray(model.vp), jnp.asarray(model.damp), jnp.asarray(wav),
        jnp.asarray(s_idx), jnp.asarray(s_w), dt, c.g0.nt, nseg * seg)
    st = tfwi._Setup(c.p0, torch.device("cpu"))
    for a, b in ((mT, st.mT), (hdT, st.hdT), (injT, st.injT(0, 5)),
                 (wav_pad, st.wav_pad)):
        assert np.array_equal(np.asarray(a), b.numpy())
    kw = dict(nt=c.g0.nt, nx=nx, nz=nz, space_order=model.space_order,
              spacing=model.spacing, z0=z0, n_checkpoints=nck, fs=False)
    rows = pa.forward_rec_segments(mT, hdT, wav_pad, injT, dt,
                                   interpret=True, **kw)
    rows_t = ca.forward_rec_segments(st.mT, st.hdT, st.wav_pad,
                                     st.injT(0, 5), st.dt, **kw)
    assert 0 < _rel(rows_t.numpy(), rows) < 2e-6
    d0 = c.d0
    syn64 = np.stack([o.data for o in jfwi.fm_multi(d0)])
    with _pallas():
        syn_j = np.stack([o.data for o in jfwi.fm_multi(c.g0)])
    syn_t = np.stack([o.data for o in tfwi.fm_multi(c.p0, device="cpu")])
    assert _rel(syn_j, syn64) < 4e-6 and _rel(syn_t, syn64) < 4e-6


def test_residual_rounding_sets_the_gradient_gap(weak_circle):
    """Against the float64 gradient (float64 data): the JAX Pallas route
    with the JAX package's data and the port's kernel route with its own
    data both lie within 6e-5 of the max; the port's route with the JAX
    package's data lies further (the gap tests/test_torch_parallel.py
    allows for), and the port and the JAX route differ by the same amount
    whichever data they share."""
    c = weak_circle
    with _pallas():
        _, g_jax, _ = jfwi.fwi_obj_multi(c.g0, _records(c.g0, c.obs_jax),
                                         least_square, calc_grad=True)
        _, g_jax_p, _ = jfwi.fwi_obj_multi(c.g0, _records(c.g0, c.obs_port),
                                           least_square, calc_grad=True)
    _, g_port, _ = tfwi.fwi_obj_multi(c.p0, R.records(c.p0, c.obs_port),
                                      None, calc_grad=True, device="cpu")
    _, g_port_j, _ = tfwi.fwi_obj_multi(c.p0, R.records(c.p0, c.obs_jax),
                                        None, calc_grad=True, device="cpu")
    own_jax, own_port = _rel(g_jax, c.g64), _rel(g_port, c.g64)
    crossed = _rel(g_port_j, c.g64)
    assert own_jax < 6e-5 and own_port < 6e-5
    assert crossed > 2 * own_jax
    assert crossed < 1.5e-4
    gap_jax_data, gap_port_data = _rel(g_port_j, g_jax), _rel(g_port,
                                                              g_jax_p)
    assert abs(gap_jax_data - gap_port_data) < 0.1 * gap_jax_data
