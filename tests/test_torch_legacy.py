"""The port's B15 (``devito_fwi_tpu_torch.ops.cuda_legacy``) against the
legacy whole-nt Pallas forward of the JAX package
(``devito_fwi_tpu.ops.pallas_legacy``), on the CPU:

* ``forward_rows_plain`` against ``pallas_legacy.forward_rows`` in
  interpret mode on the operands the JAX wrapper builds, on
  tests/test_pallas.py's geometry (61 x 41, nbl 10, 3 shots, tn 300),
  space orders 8 and 4: rows within 1e-6 of their max (XLA on the CPU
  contracts the interpreter's products and sums into multiply-adds, the
  twin rounds twice, as the card kernel does under -fmad=false); the
  port's rows nt-2 and nt-1 are zeros (the Pallas kernel leaves them
  unwritten); the port's host operands equal the JAX wrapper's bitwise;
* ``forward_traces(device="cpu")`` against the JAX ``forward_traces`` with
  the kernel in interpret mode and against the port's ``fm_multi``
  (B1's twin) within 1e-5 of the max, the JAX test's limit;
* it raises for a free surface and for receivers on a vertical line (the
  camembert layout), where the JAX wrapper gives wrong traces without a
  word; a source on the last grid column (its zero-weight corner leaves
  the grid: the JAX wrapper raises an IndexError) gives the traces of the
  JAX wrapper on the mirror-image geometry, whose source sits on column 0.

(tests/test_torch_cuda_kernels.py holds the CUDA kernel against its twin
on the card, bitwise.)
"""
import numpy as np
import pytest
import torch

from devito_fwi_tpu import SeismicModel, AcquisitionGeometry
from devito_fwi_tpu.fwi import fm_multi as j_fm_multi
from devito_fwi_tpu.ops import pallas_legacy as pleg

from devito_fwi_tpu_torch import fwi as tfwi
from devito_fwi_tpu_torch.convert import (model_from_numpy,
                                          geometry_from_numpy)
from devito_fwi_tpu_torch.ops import cuda_legacy as cl


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this module runs: the suite runs several
    pytest workers on one machine, and torch's thread pool in each of them
    (as many threads as cores) oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _geometry(space_order=8, src=None, rec=None, fs=False):
    """tests/test_pallas.py's geometry: 61 x 41 at 10 m, vp 2.0 above z =
    200 m and 2.5 below, nbl 10, 3 shots, 31 receivers at z = 25 m."""
    shape = (61, 41)
    v = np.full(shape, 2.0, np.float32)
    v[:, 20:] = 2.5
    model = SeismicModel(origin=(0., 0.), spacing=(10., 10.), shape=shape,
                         space_order=space_order, vp=v, nbl=10, bcs="damp",
                         dtype=np.float32, fs=fs)
    if src is None:
        src = np.stack([np.linspace(50, 550, 3), np.full(3, 20.0)], axis=1)
    if rec is None:
        rec = np.stack([np.linspace(10, 590, 31), np.full(31, 25.0)], axis=1)
    return AcquisitionGeometry(model, rec, src, 0., 300., f0=0.012,
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


def _jax_traces(geom, monkeypatch, calls=None):
    """The JAX forward_traces with forward_rows in interpret mode;
    ``calls`` collects the kernel's operands and output."""
    orig = pleg.forward_rows

    def rows_interp(*args, **kw):
        kw["interpret"] = True
        out = orig(*args, **kw)
        if calls is not None:
            calls.append((args, dict(kw), np.asarray(out)))
        return out

    monkeypatch.setattr(pleg, "forward_rows", rows_interp)
    return pleg.forward_traces(geom)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("space_order", [8, 4])
def test_rows_and_traces_match_jax(space_order, monkeypatch):
    geom = _geometry(space_order)
    calls = []
    want = _jax_traces(geom, monkeypatch, calls)
    (args, kw, rows_jax), = calls
    pg = _port_geometry(geom)
    m, hd, wav, inj, dt, pkw = cl.operands(pg, device="cpu")
    for got_op, want_op in zip((m, hd, wav, inj), args[:4]):
        np.testing.assert_array_equal(got_op.numpy(), np.asarray(want_op))
    assert dt == args[4]
    kw.pop("interpret")
    assert pkw == kw
    cl.reset_counters()
    rows = cl.forward_rows_plain(m, hd, wav, inj, dt, **pkw).numpy()
    assert cl.TWIN_CALLS["forward_rows"] == 1
    nt = pkw["nt"]
    assert rows.shape == rows_jax.shape == (3, nt, 2, pkw["nx"])
    # the Pallas kernel leaves rows nt-2, nt-1 unwritten; the port zeroes
    assert not rows[:, nt - 2:].any()
    assert _rel(rows[:, :nt - 2], rows_jax[:, :nt - 2]) < 1e-6
    got = cl.forward_traces(pg, device="cpu")
    assert cl.LAUNCHES["forward_rows"] == 0
    assert got.dtype == np.float32 and got.shape == want.shape
    assert _rel(got, want) < 1e-5
    ref = np.stack([s.data for s in tfwi.fm_multi(pg, device="cpu")])
    assert _rel(got, ref) < 1e-5
    ref_jax = np.stack([s.data for s in j_fm_multi(geom)])
    assert _rel(got, ref_jax) < 1e-5


def test_forward_traces_raises_for_free_surface():
    pg = _port_geometry(_geometry(fs=True))
    with pytest.raises(ValueError, match="free-surface"):
        cl.forward_traces(pg, device="cpu")


def test_forward_traces_raises_for_receivers_off_two_planes():
    """Receivers on the vertical line x = 500 m (the camembert layout):
    the JAX wrapper takes z0 as the smallest receiver row and gives wrong
    traces; the port raises."""
    rec = np.stack([np.full(21, 500.), np.linspace(0., 400., 21)], 1)
    pg = _port_geometry(_geometry(rec=rec))
    with pytest.raises(ValueError, match="adjacent z-planes"):
        cl.forward_traces(pg, device="cpu")


def test_source_corner_off_the_grid_matches_the_mirror_geometry(
        monkeypatch):
    """A source on the last padded column, x = 700 m: its zero-weight
    corner at column nx lies outside the grid and is dropped (the JAX
    wrapper raises). The model and damping are symmetric in x, so the
    mirror geometry (source on column 0, each receiver at 600 - x) has the
    same traces, receiver by receiver."""
    rec = np.stack([np.linspace(10, 590, 31), np.full(31, 25.0)], axis=1)
    geom = _geometry(src=np.array([[700., 20.]]), rec=rec)
    with pytest.raises(IndexError):
        _jax_traces(geom, monkeypatch)
    mirror = _geometry(src=np.array([[-100., 20.]]),
                       rec=np.stack([600. - rec[:, 0], rec[:, 1]], 1))
    want = _jax_traces(mirror, monkeypatch)
    got = cl.forward_traces(_port_geometry(geom), device="cpu")
    assert _rel(got, want) < 1e-5


def test_wrapper_rejects_what_the_kernel_does_not_take():
    kw = dict(nt=6, nx=8, nz=4, space_order=4, spacing=(10., 10.), z0=1)
    f32 = dict(dtype=torch.float32)
    ops = (torch.ones((8, 4), **f32), torch.zeros((8, 4), **f32),
           torch.zeros(4, **f32), torch.zeros((1, 8, 4), **f32), 1.0)
    cl.reset_counters()
    with pytest.raises(TypeError, match="float32"):
        cl.forward_rows(ops[0].double(), *ops[1:], **kw)
    with pytest.raises(ValueError, match="shape"):
        cl.forward_rows(*ops[:2], torch.zeros(5, **f32), *ops[3:], **kw)
    with pytest.raises(ValueError, match="z0"):
        cl.forward_rows(*ops, **dict(kw, z0=3))
    assert not any(cl.TWIN_CALLS.values()) and not any(cl.LAUNCHES.values())
    assert cl.forward_rows(*ops, **kw).shape == (1, 6, 2, 8)
