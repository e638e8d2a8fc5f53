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
from devito_fwi_tpu_torch.ops.acoustic import shift


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


def _slab_rows(cur, nxt, a, b, r, mm, tm, dn, c0, cx, cz):
    """The kernel's update of the slab's local rows [a, b) (buffer rows a+r
    .. b+r-1): the z taps from the buffer, its halo included, the x taps
    zero past the grid; returns the new rows."""
    u = cur[:, a:b + 2 * r]
    uc = u[:, r:r + b - a]
    acc = c0 * uc
    for k in range(1, r + 1):
        acc = acc + cx[k] * shift(uc, k, -1)
        acc = acc + cx[k] * shift(uc, -k, -1)
        acc = acc + cz[k] * u[:, r + k:r + k + b - a]
        acc = acc + cz[k] * u[:, r - k:r - k + b - a]
    up = nxt[:, a + r:b + r]
    return ((acc + tm[a:b] * uc) - mm[a:b] * up) * dn[a:b]


def _cluster_replay(m, two_m_hd, denom, wav, inj, *, c0, cx, cz, nt, z0,
                    late=False):
    """The cluster sweep's order in torch, on (nz, nx) operands: one
    cluster a shot of ``sweep_launch``'s slabs, two buffers a block with r
    halo rows above and below, u(t+1) over u(t-1) in the other buffer. A
    step: the record from the owners of rows z0, z0 + 1; the halo rows
    (NaN until then) copied out of the owners' current buffers, zero
    beyond the grid; every row of every slab; the source at the listed
    cells by their owner; the buffers swap. ``late`` copies the halo out
    of the owners' other buffer instead, u one step late."""
    B, nz, nx = inj.shape
    r = len(cx) - 1
    cells, vals, K = cl._source_list(inj)
    plan = cl.sweep_launch(nz, nx, r, K)
    rows = plan.rows
    ext = [(k * rows, min(nz, (k + 1) * rows)) for k in range(plan.cluster)]
    bufs = [[inj.new_zeros((B, rows + 2 * r, nx)) for _ in range(2)]
            for _ in ext]
    rec = inj.new_zeros((B, nt, 2, nx))
    for t in range(nt - 2):
        cur, nxt = t & 1, (t & 1) ^ 1
        for p in range(2):
            k = (z0 + p) // rows
            rec[:, t, p] = bufs[k][cur][:, z0 + p - ext[k][0] + r]
        for k, (lo, hi) in enumerate(ext):
            bufs[k][cur][:, :r] = float("nan")
            bufs[k][cur][:, hi - lo + r:] = float("nan")
        for k, (lo, hi) in enumerate(ext):
            for h in range(2 * r):
                g = lo - r + h if h < r else hi + h - r
                dst = h if h < r else hi - lo + h
                if 0 <= g < nz:
                    o = g // rows
                    bufs[k][cur][:, dst] = \
                        bufs[o][nxt if late else cur][:, g - o * rows + r]
                else:
                    bufs[k][cur][:, dst] = 0.0
        for k, (lo, hi) in enumerate(ext):
            bk = bufs[k]
            coef = [f[lo:hi] for f in (m, two_m_hd, denom)]
            bk[nxt][:, r:hi - lo + r] = _slab_rows(
                bk[cur], bk[nxt], 0, hi - lo, r, *coef, c0, cx, cz)
            for s in range(B):
                for e in range(K):
                    cell = int(cells[s, e])
                    z, x = divmod(cell, nx)
                    if cell >= 0 and lo <= z < hi:
                        bk[nxt][s, z - lo + r, x] = \
                            bk[nxt][s, z - lo + r, x] + wav[t] * vals[s, e]
    return rec


def _replay_operands(nz, nx, space_order, z0, src_rows, B=2, nt=14):
    """Seeded (nz, nx) operands: vp 1.5-3.0 km/s at 10 m, dt 1 ms, a damp
    of up to 0.05, one wavelet, each shot's source on the rows
    ``src_rows`` (a 2 x 2 block of cells at x 3-4 and 11-12)."""
    rng = np.random.default_rng(11)
    vp = rng.uniform(1.5, 3.0, (nz, nx))
    m = torch.as_tensor(1.0 / vp ** 2, dtype=torch.float32)
    hd = torch.as_tensor(rng.uniform(0.0, 0.05, (nz, nx)),
                         dtype=torch.float32)
    inj = torch.zeros((B, nz, nx), dtype=torch.float32)
    for s in range(B):
        z = src_rows[s % len(src_rows)]
        x = 3 + 8 * s
        inj[s, z:z + 2, x:x + 2] = torch.as_tensor(
            rng.uniform(0.1, 0.5, (2, 2)), dtype=torch.float32)
    wav = torch.as_tensor(rng.standard_normal(nt - 2), dtype=torch.float32)
    c0, cx, cz = cl._legacy_constants(space_order, (10., 10.), 1.0)
    return (m, 2.0 * m + hd, 1.0 / (m + hd), wav, inj), \
        dict(c0=c0, cx=cx, cz=cz, nt=nt, z0=z0)


@pytest.mark.parametrize("cluster", [cl.CLUSTER, 8])
@pytest.mark.parametrize("space_order,nz,nx,z0,src_rows", [
    # SMARMN's radius; nz = 23 no multiple of the cluster; z0 on the last
    # row of a slab; sources on the first rows of slabs (another block's
    # halo) and on the last row
    (8, 23, 19, 5, (6, 21)),
    (8, 23, 19, 2, (12, 3)),
    (2, 21, 16, 10, (0, 18)),     # radius 1
    (16, 37, 13, 8, (9, 27)),     # radius 8: halos span several slabs
])
def test_cluster_replay_equals_twin_bitwise(cluster, space_order, nz, nx,
                                            z0, src_rows, monkeypatch):
    """The cluster sweep's order (slabs, halo copies out of the owners'
    current buffers, the two-buffer swap, the listed sources) gives the
    twin's record bit for bit at float32, at the adopted cluster size and
    at 8."""
    monkeypatch.setattr(cl, "CLUSTER", cluster)
    ops, kw = _replay_operands(nz, nx, space_order, z0, src_rows)
    plan = cl.sweep_launch(nz, nx, space_order // 2)
    assert (plan.cluster - 1) * plan.rows < nz <= plan.cluster * plan.rows
    want = cl._rows_plain(*ops, **kw)
    assert bool(want.isfinite().all()) and float(want.abs().max()) > 0
    got = _cluster_replay(*ops, **kw)
    assert torch.equal(got, want)


def test_cluster_replay_sees_a_halo_one_step_late():
    """The replay is sharp: halo rows copied out of the owners' other
    buffer (u one step late) change the record."""
    ops, kw = _replay_operands(23, 19, 8, 5, (6, 21))
    want = cl._rows_plain(*ops, **kw)
    assert torch.equal(_cluster_replay(*ops, **kw), want)
    assert not torch.equal(_cluster_replay(*ops, late=True, **kw), want)


@pytest.mark.parametrize("nz,nx,r,K,cluster,rows,stride,smem", [
    # SMARMN (186 x 380 padded, space order 8) with its 4 source cells
    (186, 380, 4, 4, 4, 47, 388, 170_768),
    (186, 380, 2, 4, 4, 47, 388, 158_352),
    # at radius 8 the halo and the x padding grow
    (186, 380, 8, 4, 4, 47, 396, 199_632),
    # nz no multiple of the cluster: the last slab is shorter
    (23, 19, 4, 4, 4, 6, 28, 3_184),
    # fewer rows than the cluster's blocks: the blocks that own a row
    (5, 8, 1, 1, 3, 2, 16, 524),
])
def test_sweep_launch_plans_the_cluster(nz, nx, r, K, cluster, rows,
                                        stride, smem, monkeypatch):
    """The launch plan at the preferred cluster of 4: slabs of ceil(nz/4)
    rows, buffer rows of nx rounded up to 4 plus ceil(r/4)*4 zero columns
    each side, two buffers of the slab and 2r halo rows and 12 bytes a
    source cell, 512 threads; every block owns a row."""
    monkeypatch.setattr(cl, "CLUSTER", 4)
    plan = cl.sweep_launch(nz, nx, r, K)
    assert (plan.cluster, plan.rows, plan.stride, plan.smem) == \
        (cluster, rows, stride, smem)
    assert plan.threads == 512 and plan.smem <= 232_448
    assert (plan.cluster - 1) * plan.rows < nz <= plan.cluster * plan.rows


def test_sweep_launch_grows_the_cluster_before_it_refuses(monkeypatch):
    """A grid whose slab does not fit at the preferred cluster takes the
    smallest larger one that fits; past a cluster of 8 the plan raises,
    naming the shared memory it needs."""
    monkeypatch.setattr(cl, "CLUSTER", 4)
    assert cl.sweep_launch(300, 380, 4).cluster == 5
    assert cl.sweep_launch(528, 380, 4).cluster == 8
    with pytest.raises(ValueError, match="even at a cluster of 8"):
        cl.sweep_launch(529, 380, 4)
    with pytest.raises(ValueError, match="even at a cluster of 8"):
        cl.sweep_launch(186, 4000, 4)


@pytest.mark.parametrize("space_order,nz,nx", [
    (18, 20, 16), (0, 20, 16), (8, 2000, 380), (8, 186, 4000)])
def test_forward_rows_refuses_before_it_builds(space_order, nz, nx,
                                               monkeypatch):
    """The CUDA path asks the plan before it builds, allocates or
    launches anything: radius 9 or 0, or a grid past a cluster of 8,
    raise ValueError here, where building the library would raise
    RuntimeError (no nvcc)."""
    from devito_fwi_tpu_torch.ops import cuda_build

    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(cuda_build, "load", no_build)
    big = torch.zeros(()).expand
    c0, cx, cz = 0.0, (0.0,) * (space_order // 2 + 1), \
        (0.0,) * (space_order // 2 + 1)
    with pytest.raises(ValueError, match="forward_rows"):
        cl._rows_cuda(big(nz, nx), big(nz, nx), big(nz, nx), big(3),
                      big(2, nz, nx), c0=c0, cx=cx, cz=cz, nt=5, z0=0)
