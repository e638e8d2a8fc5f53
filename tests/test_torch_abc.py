"""The port's PML and HABC boundary methods (``devito_fwi_tpu_torch.ops.abc``)
on the CPU: the checks of ``tests/test_abc.py`` on the port (against a
boundary-free big-domain trace each method cuts the boundary reflections
far below hard truncation's, and stays stable; the profiles and ramps),
and the forwards against the JAX functions at float64 within 1e-12 of each
output's max, for the PML and every ``habctype`` x ``habcw``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from devito_fwi_tpu.ops import abc as jabc

from devito_fwi_tpu_torch.models.sources import RickerSource, TimeAxis
from devito_fwi_tpu_torch.ops.abc import (extend_velocity,
                                          habc_acoustic_forward,
                                          habc_weights, pml_acoustic_forward,
                                          pml_profiles)
from devito_fwi_tpu_torch.ops.interp import interp_table

H = 10.0          # m
V0 = 1.5          # km/s
NPTI = 101        # interior points per dim
TN = 800.0        # ms
F0 = 0.015        # kHz


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this module runs: the suite runs several
    pytest workers on one machine, and torch's thread pool in each of them
    (as many threads as cores) oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _setup(margin, tn=TN, dtype=np.float32, npti=NPTI):
    """Velocity tensor and src/rec tables on a grid with ``margin`` extra
    cells on the left, right and bottom; coordinates relative to the
    interior origin."""
    v = extend_velocity(np.full((npti, npti), V0, dtype), margin)
    dt = 0.4 * H / V0
    time_range = TimeAxis(start=0.0, stop=tn, step=dt)
    src = RickerSource(name="src", f0=F0, time_range=time_range,
                       coordinates=np.array([[npti // 2 * H, 3 * H]]))
    rec_coords = np.array([[npti // 2 * H + 200.0, 400.0],
                           [npti // 2 * H - 300.0, 150.0]])
    origin = (-margin * H, 0.0)
    s_idx, s_w = interp_table(src.coordinates, origin, (H, H), dtype=dtype)
    r_idx, r_w = interp_table(rec_coords, origin, (H, H), dtype=dtype)
    return (torch.as_tensor(v), torch.as_tensor(src.data.astype(dtype)),
            s_idx, s_w, r_idx, r_w, dt, time_range.num)


@pytest.fixture(scope="module")
def traces():
    """The boundary-free reference (a margin so large that no reflection
    returns) and the hard truncation (quibar 0: Dirichlet edges and the
    Neumann top) at the interior size."""
    out = []
    for margin in (200, 20):
        v, wav, si, sw, ri, rw, dt, nt = _setup(margin)
        rec, _ = pml_acoustic_forward(v, wav, si, sw, ri, rw, dt, nt=nt,
                                      spacing=(H, H), npml=margin,
                                      quibar=0.0)
        out.append(rec.numpy())
    return out


def _err(rec, ref):
    return np.linalg.norm(rec - ref) / np.linalg.norm(ref)


def test_pml_reflection_reduction(traces):
    ref, hard = traces
    err_hard = _err(hard, ref)
    v, wav, si, sw, ri, rw, dt, nt = _setup(20)
    rec, _ = pml_acoustic_forward(v, wav, si, sw, ri, rw, dt, nt=nt,
                                  spacing=(H, H), npml=20, quibar=0.05)
    err = _err(rec.numpy(), ref)
    assert err_hard > 0.1            # hard truncation reflects strongly
    assert err < 0.01 * err_hard     # the PML absorbs the boundary energy


@pytest.mark.parametrize("habctype", [1, 2, 3])
def test_habc_reflection_reduction(traces, habctype):
    ref, hard = traces
    err_hard = _err(hard, ref)
    v, wav, si, sw, ri, rw, dt, nt = _setup(20)
    rec, _ = habc_acoustic_forward(v, wav, si, sw, ri, rw, dt, nt=nt,
                                   spacing=(H, H), npml=20,
                                   habctype=habctype, habcw=2)
    err = _err(rec.numpy(), ref)
    assert err < 0.05 * err_hard
    if habctype == 3:
        assert err < 0.005 * err_hard


def test_abc_stability():
    v, wav, si, sw, ri, rw, dt, nt = _setup(20, tn=8000.0)
    for run in (
        lambda: pml_acoustic_forward(v, wav, si, sw, ri, rw, dt, nt=nt,
                                     spacing=(H, H), npml=20, quibar=0.05),
        lambda: habc_acoustic_forward(v, wav, si, sw, ri, rw, dt, nt=nt,
                                      spacing=(H, H), npml=20, habctype=3),
    ):
        rec, _ = run()
        assert np.isfinite(np.linalg.norm(rec.numpy()))


def test_pml_profiles_interior_zero():
    zx0, zz0, zx1, zz1 = pml_profiles((80, 60), 20)
    assert np.all(zx0[20:-20, :] == 0) and np.all(zz0[:, :-20] == 0)
    assert zx0.max() > 0 and zz0.max() > 0
    assert zx1.max() > 0 and zz1.max() > 0
    assert np.all(np.diff(zx0[-20:, 0]) >= 0)
    for got, want in zip(pml_profiles((80, 60), 20, 0.07, np.float64),
                         jabc.pml_profiles((80, 60), 20, 0.07, np.float64)):
        assert np.array_equal(got, want)


def test_habc_weights_ramp():
    wx, wz = habc_weights((80, 60), 20, habcw=2, habctype=3)
    assert wx[0, 0] == 1.0 and wx[2, 0] == 1.0   # m=2 plateau at edge
    assert np.all(wx[20:-20, :] == 0)
    assert np.all(np.diff(wx[:21, 0]) <= 0)
    wl, _ = habc_weights((80, 60), 20, habcw=1)
    assert wl[0, 0] == 1.0 and np.all(np.diff(wl[:21, 0]) <= 0)
    for habcw in (1, 2):
        for habctype in (1, 2, 3):
            for got, want in zip(
                    habc_weights((80, 60), 20, habcw, habctype),
                    jabc.habc_weights((80, 60), 20, habcw, habctype)):
                assert np.array_equal(got, want)
    v = np.random.default_rng(0).random((9, 7))
    assert np.array_equal(extend_velocity(v, 3), jabc.extend_velocity(v, 3))


def _jax_case(margin=10, npti=41, tn=300.):
    """A float64 case on a heterogeneous model (a fast block that reaches
    the absorbing layer), with one receiver on the grid corner."""
    v, wav, si, sw, ri, rw, dt, nt = _setup(margin, tn=tn,
                                            dtype=np.float64, npti=npti)
    v = v.clone()
    v[30:45, 20:] = 2.0
    rc = np.array([[npti // 2 * H + 100., 200.], [npti // 2 * H - 150., 50.],
                   [-margin * H, 0.]])
    ri, rw = interp_table(rc, (-margin * H, 0.0), (H, H), dtype=np.float64)
    return v, wav, si, sw, ri, rw, dt, nt


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(got.numpy() - want).max() / np.abs(want).max()


def test_pml_matches_the_jax_forward():
    """The PML forward (traces and final field, with the derived dual
    velocity and with a given one) within 1e-12 of the JAX function's
    (measured 3.5e-15); rec[nt-1] is the only zero row."""
    v, wav, si, sw, ri, rw, dt, nt = _jax_case()
    J = jnp.asarray
    kw = dict(nt=nt, spacing=(H, H), npml=10)
    for v_dual in (None, 1.02 * v.numpy()):
        jrec, ju = jabc.pml_acoustic_forward(
            J(v.numpy()), J(wav.numpy()), J(si), J(sw), J(ri), J(rw), dt,
            v_dual=None if v_dual is None else J(v_dual), **kw)
        trec, tu = pml_acoustic_forward(v, wav, si, sw, ri, rw, dt,
                                        v_dual=v_dual, **kw)
        assert _rel(trec, jrec) <= 1e-12 and _rel(tu, ju) <= 1e-12
        assert not trec[-1].any() and trec[1:-1, 0].abs().max() > 0


@pytest.mark.parametrize("habcw", [1, 2])
@pytest.mark.parametrize("habctype", [1, 2, 3])
def test_habc_matches_the_jax_forward(habctype, habcw):
    """The HABC forward within 1e-12 of the JAX function's (measured
    2.7e-15), for each one-way scheme and weight ramp."""
    v, wav, si, sw, ri, rw, dt, nt = _jax_case()
    J = jnp.asarray
    jrec, _ = jabc.habc_acoustic_forward(
        J(v.numpy()), J(wav.numpy()), J(si), J(sw), J(ri), J(rw), dt, nt=nt,
        spacing=(H, H), npml=10, habctype=habctype, habcw=habcw)
    trec, none = habc_acoustic_forward(v, wav, si, sw, ri, rw, dt, nt=nt,
                                       spacing=(H, H), npml=10,
                                       habctype=habctype, habcw=habcw)
    assert none is None and _rel(trec, jrec) <= 1e-12
    assert not trec[-1].any()


def test_numpy_inputs_go_to_the_device(monkeypatch):
    """Handed numpy arrays, the forwards run on ``device``: "cpu" gives the
    tensor call's traces; the default "cuda" raises without a card."""
    v, wav, si, sw, ri, rw, dt, nt = _jax_case(tn=60.)
    kw = dict(nt=nt, spacing=(H, H), npml=10)
    want, _ = pml_acoustic_forward(v, wav, si, sw, ri, rw, dt, **kw)
    got, _ = pml_acoustic_forward(v.numpy(), wav.numpy(), si, sw, ri, rw,
                                  dt, device="cpu", **kw)
    assert torch.equal(got, want)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fwd in (pml_acoustic_forward, habc_acoustic_forward):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fwd(v.numpy(), wav.numpy(), si, sw, ri, rw, dt, **kw)
