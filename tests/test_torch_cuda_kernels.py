"""The CUDA kernels of devito_fwi_tpu_torch.ops.cuda_acoustic,
ops.cuda_bfm, ops.cuda_staggered, ops.cuda_visco, ops.cuda_tti,
ops.cuda_acoustic3d and ops.cuda_acoustic3 against their plain torch twins,
on the card (marked ``cuda``; each test skips without one). The file
imports no JAX, so on a machine without it run it as

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py

(``--noconftest`` skips tests/conftest.py, which sets JAX up). The kernels
are compiled with -fmad=false and repeat the twins' operations one for one,
so they should agree bitwise: every output within 1e-6 of its max.

Small case: circle-isotropic 61x61, nbl=10, 2 shots, space_order 4 and 8,
with and without the free surface; the residual rows are seeded noise. The
checkpoint-route gradient must equal the streamed one bitwise. The slab
kernel runs on seeded planes that reach every row and lane offset it
takes, in both layouts, at Q 1, 4 and 8, 128 and 384 lanes, odd shot and
block counts and on pile-ups of whole columns onto one output, equal to
its twin exactly; it raises, launching nothing, for Q = 9 and for shared
memory past a block's. The banded Legendre kernel runs at both of its
bands on seeded rows in band, displaced past the band, holding a NaN and
at or below -big, bitwise, and inside the W2 misfit against the anchored
route. The elastic kernels
run on a two-layer 61 x 48 model (nbl 10, 1-5 shots, space order 4 and
8; the padded 81 x 68 grid is no multiple of the forward step's 32 x 32
tile), the three sweeps equal to their twins exactly, and raise,
launching nothing, past radius 8; the elastic objective on the card is
held against its CPU twins, and
ElasticWaveSolver against the reference goldens. The viscoacoustic kernels
run on a two-layer 61 x 48 model with qp 60/90 (nbl 10, 2-3 shots, space
order 4 and 8) in the same way, the three sweeps equal to their twins
exactly, with the sls/2 solver golden. The TTI
sweeps run on layers-tti 61 x 48 (nbl 10, 2 shots, space order 4 and 8, 7
segments) in the same way; their checkpoint-route gradient must equal the
streamed one bitwise. The 3-D sweeps run on layers-isotropic 24 x 20 x 16
(nbl 8, 2 shots, space order 4 and 8, with and without the free surface)
and the step kernel on seeded 48 x 20 x 36 fields; the 3-D objective on
the card, on both routes, is held against its CPU twins. Select them
with ``-k 3d``. B15's cluster sweep (``cuda_legacy.forward_rows``) runs at
space orders 4 and 8, at SMARMN's padded grid with 40 shots (a second
wave of clusters) and on a 187-row grid that the cluster of 4 does not
divide, with z0 and the sources on slab boundaries, equal to its twin
exactly; it raises, launching nothing, for a grid past a cluster of 8.
The eager objective route on the card (receivers on a vertical line) is
held against the same call on the CPU. Select them with ``-k "legacy or
eager"``. The operators that run no kernel on the card (the self-adjoint
solver, the PML and HABC forwards, the viscoelastic solver and gradient)
are held against the same float32 calls on the CPU: select them with ``-k
cpu``.
"""
import numpy as np
import pytest
import torch

from devito_fwi_tpu_torch import fwi
from devito_fwi_tpu_torch.models.geometry import AcquisitionGeometry
from devito_fwi_tpu_torch.models.presets import demo_model
from devito_fwi_tpu_torch.ops import cuda_acoustic as ca
from devito_fwi_tpu_torch.ops import cuda_bfm as cb

RTOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _setup(fs, space_order, dev, nsrc=2):
    model = demo_model("circle-isotropic", vp_circle=3.0, vp_background=2.5,
                       origin=(0., 0.), shape=(61, 61), spacing=(10., 10.),
                       nbl=10, space_order=space_order, fs=fs)
    zsrc = 2.0 if fs else 20.0
    src = np.stack([np.linspace(0., 600., nsrc), np.full(nsrc, zsrc)], 1)
    rec = np.stack([np.linspace(0., 600., 41), np.full(41, 20.)], 1)
    geom = AcquisitionGeometry(model, rec, src, 0., 300., f0=0.010,
                               src_type="Ricker")
    return fwi._Setup(geom, dev)


def _close(got, want):
    for g, w in zip(got, want):
        err = float((g - w).abs().max())
        assert err <= RTOL * float(w.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("space_order", [4, 8])
@pytest.mark.parametrize("fs", [False, True])
def test_forward_kernels_match_twins(cuda, fs, space_order):
    st = _setup(fs, space_order, cuda)
    ops = (st.mT, st.hdT, st.wav_pad, st.injT(0, 2), st.dt)
    ca.reset_counters()
    rec = ca.forward_rec_segments(*ops, **st.kw)
    got = ca.forward_dt2_segments(*ops, **st.kw)
    assert ca.LAUNCHES["forward_rec_segments"] == 1
    assert ca.LAUNCHES["forward_dt2_segments"] == 1
    assert sum(ca.TWIN_CALLS.values()) == 0
    want = ca.forward_dt2_plain(*ops, **st.kw)
    torch.cuda.synchronize()
    # the fused two-step tile repeats the twin's operations: exactly equal
    assert torch.equal(rec, ca.forward_rec_plain(*ops, **st.kw))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(rec, got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("space_order", [4, 8])
@pytest.mark.parametrize("fs", [False, True])
def test_gradient_kernel_matches_twin(cuda, fs, space_order):
    st = _setup(fs, space_order, cuda)
    ops = (st.mT, st.hdT, st.wav_pad, st.injT(0, 2), st.dt)
    dt2 = ca.forward_dt2_plain(*ops, **st.kw)[1]
    rng = np.random.default_rng(0)
    res = torch.as_tensor(rng.standard_normal(
        (2, st.nseg, st.seg, 2, st.nx)), dtype=torch.float32, device=cuda)
    ca.reset_counters()
    got = ca.gradient_stream_segments(st.mT, st.hdT, dt2, res, st.dt,
                                      **st.kw)
    assert ca.LAUNCHES["gradient_stream_segments"] == 1
    want = ca.gradient_stream_plain(st.mT, st.hdT, dt2, res, st.dt, **st.kw)
    torch.cuda.synchronize()
    _close([got], [want])


@pytest.mark.cuda
def test_kernels_reject_float64_on_the_card(cuda):
    st = _setup(False, 4, cuda)
    ops = (st.mT.double(), st.hdT.double(), st.wav_pad.double(),
           st.injT(0, 2).double(), st.dt)
    with pytest.raises(TypeError, match="float64"):
        ca.forward_rec_segments(*ops, **st.kw)


@pytest.mark.cuda
@pytest.mark.parametrize("space_order", [4, 8])
@pytest.mark.parametrize("fs", [False, True])
def test_checkpoint_kernels_match_twins(cuda, fs, space_order):
    st = _setup(fs, space_order, cuda)
    injT = st.injT(0, 2)
    ops = (st.mT, st.hdT, st.wav_pad, injT, st.dt)
    rng = np.random.default_rng(1)
    res = torch.as_tensor(rng.standard_normal(
        (2, st.nseg, st.seg, 2, st.nx)), dtype=torch.float32, device=cuda)
    ca.reset_counters()
    rec, pairs, illum = ca.forward_ckpt_segments(*ops, **st.kw)
    grad = ca.gradient_segments(st.mT, st.hdT, st.wav_pad, injT, pairs, res,
                                st.dt, **st.kw)
    assert ca.LAUNCHES["forward_ckpt_segments"] == 1
    assert ca.LAUNCHES["gradient_segments"] == 1
    assert sum(ca.TWIN_CALLS.values()) == 0
    want = ca.forward_ckpt_plain(*ops, **st.kw)
    torch.cuda.synchronize()
    for g, w in zip((rec, pairs, illum), want):
        assert torch.equal(g, w)
    _close([grad], [ca.gradient_segments_plain(
        st.mT, st.hdT, st.wav_pad, injT, want[1], res, st.dt, **st.kw)])
    # the recompute repeats the streamed forward's steps from its own state
    r2, dt2, il2 = ca.forward_dt2_segments(*ops, **st.kw)
    assert torch.equal(r2, rec) and torch.equal(il2, illum)
    assert torch.equal(ca.gradient_stream_segments(st.mT, st.hdT, dt2, res,
                                                   st.dt, **st.kw), grad)


@pytest.mark.cuda
def test_acoustic_forwards_raise_for_what_they_do_not_take(cuda):
    """Space order 18 (radius 9; the fused tile takes 1..8) raises before
    any launch, on the three forwards and the checkpoint gradient, whose
    recompute runs the same tile."""
    st = _setup(False, 4, cuda)
    kw = dict(st.kw, space_order=18)
    injT = st.injT(0, 2)
    ops = (st.mT, st.hdT, st.wav_pad, injT, st.dt)
    pairs = torch.zeros((2, st.nseg, 2, st.nz, st.nx), device=cuda)
    res = torch.zeros((2, st.nseg, st.seg, 2, st.nx), device=cuda)
    ca.reset_counters()
    for fn in (ca.forward_rec_segments, ca.forward_dt2_segments,
               ca.forward_ckpt_segments):
        with pytest.raises(ValueError):
            fn(*ops, **kw)
    with pytest.raises(ValueError):
        ca.gradient_segments(st.mT, st.hdT, st.wav_pad, injT, pairs, res,
                             st.dt, **kw)
    assert sum(ca.LAUNCHES.values()) == 0
    assert sum(ca.TWIN_CALLS.values()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("space_order", [4, 8])
@pytest.mark.parametrize("fs", [False, True])
def test_acoustic_reverse_sweeps_equal_twins_at_three_shots(cuda, fs,
                                                             space_order):
    """Rows 3 and 5, the two-step reverse tile (streamed, and after each
    segment's recompute), with an odd last step taken by ``adjoint_step``,
    at 3 shots: equal to their twins bit for bit, and the checkpoint-route
    gradient to the streamed one."""
    st = _setup(fs, space_order, cuda, nsrc=3)
    injT = st.injT(0, 3)
    ops = (st.mT, st.hdT, st.wav_pad, injT, st.dt)
    res = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (3, st.nseg, st.seg, 2, st.nx)), dtype=torch.float32, device=cuda)
    dt2 = ca.forward_dt2_segments(*ops, **st.kw)[1]
    pairs = ca.forward_ckpt_segments(*ops, **st.kw)[1]
    ca.reset_counters()
    g_s = ca.gradient_stream_segments(st.mT, st.hdT, dt2, res, st.dt,
                                      **st.kw)
    g_c = ca.gradient_segments(*ops[:4], pairs, res, st.dt, **st.kw)
    assert ca.LAUNCHES["gradient_stream_segments"] == 1
    assert ca.LAUNCHES["gradient_segments"] == 1
    assert sum(ca.TWIN_CALLS.values()) == 0
    torch.cuda.synchronize()
    assert torch.equal(g_s, ca.gradient_stream_plain(st.mT, st.hdT, dt2, res,
                                                     st.dt, **st.kw))
    assert torch.equal(g_c, ca.gradient_segments_plain(*ops[:4], pairs, res,
                                                       st.dt, **st.kw))
    assert torch.equal(g_c, g_s)
    assert float(g_s.abs().max()) > 0


@pytest.mark.cuda
def test_acoustic_reverse_raises_for_what_it_does_not_take(cuda):
    """Space order 18 (radius 9; the sweep takes 1..8): both reverse
    sweeps raise before any launch."""
    st = _setup(False, 4, cuda)
    kw = dict(st.kw, space_order=18)
    injT = st.injT(0, 2)
    dt2 = torch.zeros((2, st.nseg, st.seg, st.nz, st.nx), device=cuda)
    pairs = torch.zeros((2, st.nseg, 2, st.nz, st.nx), device=cuda)
    res = torch.zeros((2, st.nseg, st.seg, 2, st.nx), device=cuda)
    ca.reset_counters()
    with pytest.raises(ValueError):
        ca.gradient_stream_segments(st.mT, st.hdT, dt2, res, st.dt, **kw)
    with pytest.raises(ValueError):
        ca.gradient_segments(st.mT, st.hdT, st.wav_pad, injT, pairs, res,
                             st.dt, **kw)
    assert sum(ca.LAUNCHES.values()) == 0
    assert sum(ca.TWIN_CALLS.values()) == 0


def _planes(dev, blocked, B=2, Q=4, nblk=5, R=16, lanes=128, G=24, dxmax=7,
            pile=False):
    """Seeded planes over every offset the kernel takes: rel in [-1, G-1]
    (0 and G-2 included), dxr in [0, 2*dxmax+1], weights in [0, 1] with
    some cells empty. With ``pile`` every cell of block row i has
    rel = G-2-i and lanes 26..40 have dxr = 40-l: whole columns of cells
    land on slab rows G-2, G-1 at lanes 40, 41 (the longest lists)."""
    rng = np.random.default_rng(2)
    shape = (B, nblk, Q, R, lanes) if blocked else (B, Q, nblk * R, lanes)
    rel = rng.integers(-1, G, shape)
    dxr = rng.integers(0, 2 * dxmax + 2, shape)
    if pile:
        i = (np.arange(R).reshape(1, 1, 1, R, 1) if blocked
             else (np.arange(nblk * R) % R).reshape(1, 1, -1, 1))
        rel = np.broadcast_to(G - 2 - i, shape)
        dxr = np.broadcast_to(np.clip(40 - np.arange(lanes), 0, 2 * dxmax),
                              shape)
    mass = rng.uniform(0, 1, shape) * (rng.uniform(0, 1, shape) > 0.2)
    wy0 = mass * rng.uniform(0, 1, shape)
    wx0 = rng.uniform(0, 1, shape)
    ints = [torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32,
                            device=dev) for a in (rel, dxr)]
    return ints + [torch.as_tensor(a, dtype=torch.float32, device=dev)
                   for a in (wy0, mass, wx0)]


def _push_pair(blocked):
    return ((cb.pushforward_slabs, cb.pushforward_slabs_plain,
             "pushforward_slabs") if blocked else
            (cb.pushforward_slabs_nat, cb.pushforward_slabs_nat_plain,
             "pushforward_slabs_nat"))


@pytest.mark.cuda
@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("Q,lanes,B,nblk,pile", [
    (4, 128, 2, 5, False), (1, 384, 3, 7, False), (8, 128, 3, 5, False),
    (4, 384, 1, 3, False), (4, 128, 3, 3, True), (8, 384, 1, 1, True)])
def test_push_kernel_matches_twin(cuda, blocked, Q, lanes, B, nblk, pile):
    planes = _planes(cuda, blocked, B=B, Q=Q, nblk=nblk, lanes=lanes,
                     pile=pile)
    kernel, twin, name = _push_pair(blocked)
    cb.reset_counters()
    got = kernel(*planes, G=24, dxmax=7, R=16)
    assert cb.LAUNCHES[name] == 1 and sum(cb.TWIN_CALLS.values()) == 0
    want = twin(*planes, G=24, dxmax=7, R=16)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (B, nblk, 40, lanes)
    assert torch.equal(got, want)
    if pile:
        assert bool((want[:, :, 22:24, 40:42] > 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("blocked", [False, True])
def test_push_kernel_raises_for_what_it_does_not_take(cuda, blocked):
    """Q = 9 subsamples (the kernel takes 1..8) and R = 32 rows at Q = 8
    (past a block's shared memory) raise before any launch."""
    kernel, _, _ = _push_pair(blocked)
    cb.reset_counters()
    for Q, R in ((9, 16), (8, 32)):
        planes = _planes(cuda, blocked, B=1, Q=Q, nblk=1, R=R)
        with pytest.raises(ValueError):
            kernel(*planes, G=24, dxmax=7, R=R)
    assert sum(cb.LAUNCHES.values()) == 0
    assert sum(cb.TWIN_CALLS.values()) == 0


def _legendre_rows(dev, rows, n, shift, case="in_band"):
    """Seeded rows near the convex 0.5 s^2 (the BFM's potentials), rolled by
    ``shift`` samples (past the band when large); with a NaN, or with one
    row at big and one at twice big (every real lane's value at or below
    -big, so the pad lanes hold the max)."""
    rng = np.random.default_rng(4)
    s = (np.arange(n) + 0.5) / n
    u = (0.5 * s[None, :] ** 2 + 5e-4 * rng.uniform(size=(rows, n)))
    u = np.roll(u.astype(np.float32), shift, axis=-1)
    if case == "nan":
        u[rows // 2, n // 3] = np.nan
    if case == "below_big":
        big = np.float32(np.finfo(np.float32).max / 8)
        u[rows // 3] = big
        u[rows - 1] = np.float32(2) * big
    return torch.as_tensor(u, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("W,K,n,rows", [(24, 8, 300, 131),
                                        (48, 16, 1357, 70),
                                        (24, 8, 256, 45)])
@pytest.mark.parametrize("case", ["in_band", "displaced", "nan",
                                  "below_big"])
def test_legendre_kernel_matches_twin(cuda, W, K, n, rows, case):
    """The banded Legendre kernel against its twin at both bands of the W2
    route (300 traces, 1357 samples; and 256, a row with no pad lanes; row
    counts no multiple of the 32 rows a block): output and flag bitwise,
    NaN where the twin has NaN; rows at or below -big take the pad lanes'
    path and fail the certificate."""
    u = _legendre_rows(cuda, rows, n, 40 if case == "displaced" else 0,
                       case)
    cb.reset_counters()
    out, ok = cb.legendre_banded(u, W, K)
    assert cb.LAUNCHES["legendre_banded"] == 1
    assert sum(cb.TWIN_CALLS.values()) == 0
    want, ok_want = cb.legendre_banded_plain(u, W, K)
    torch.cuda.synchronize()
    assert bool(ok) == bool(ok_want) == (case in ("in_band", "nan"))
    assert torch.equal(torch.isnan(out), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(out), torch.nan_to_num(want))
    if case == "below_big":
        for r in (rows // 3, rows - 1):
            one = u[r:r + 1].contiguous()
            assert not bool(cb.legendre_banded(one, W, K)[1])
            assert not bool(cb.legendre_banded_plain(one, W, K)[1])


@pytest.mark.cuda
def test_legendre_kernel_raises_for_what_it_does_not_take(cuda):
    """K > W (the certificate's walk needs K <= W) and a band too wide for a
    block's shared memory raise on the card, launching nothing."""
    u = _legendre_rows(cuda, 8, 300, 0)
    cb.reset_counters()
    for W, K in ((8, 16), (1000, 8)):
        with pytest.raises(ValueError):
            cb.legendre_banded(u, W, K)
    assert sum(cb.LAUNCHES.values()) == 0
    assert sum(cb.TWIN_CALLS.values()) == 0


@pytest.mark.cuda
def test_banded_w2_route_equals_anchor_on_the_card(cuda):
    """``bfm_batch(legendre="banded")`` launches the kernel and gives the
    anchored route's loss and gradient bitwise."""
    import importlib
    bfm = importlib.import_module("devito_fwi_tpu_torch.misfit.bfm")
    t = np.arange(200)[:, None]
    x = np.arange(64)[None, :]

    def blob(t0, x0):
        return np.exp(-((t - t0) ** 2 / 80.0 + (x - x0) ** 2 / 40.0))

    mu = torch.as_tensor(np.stack([blob(60, 20) + blob(140, 40),
                                   blob(80, 28) + blob(170, 16)]) + 1e-3,
                         dtype=torch.float32, device=cuda)
    nu = torch.roll(mu, 6, 1)
    out = {}
    for leg in ("anchor", "banded"):
        cb.reset_counters()
        out[leg] = bfm.bfm_batch(mu, nu, num_steps=4, legendre=leg)
    assert cb.LAUNCHES["legendre_banded"] > 0
    assert sum(cb.TWIN_CALLS.values()) == 0
    assert torch.equal(out["banded"][0], out["anchor"][0])
    assert torch.equal(out["banded"][1], out["anchor"][1])


# ---------------------------------------------------------------------------
# elastic (ops.cuda_staggered, csrc/elastic2d.cu)
# ---------------------------------------------------------------------------

def _elastic_operands(space_order, dev, nsrc=2):
    """A two-layer 61 x 48 elastic model (nbl 10), ``nsrc`` shots and 41
    receivers on the card: the kernels' operands and keywords."""
    from devito_fwi_tpu_torch.models.model import SeismicModel
    from devito_fwi_tpu_torch.ops import cuda_staggered as cs
    from devito_fwi_tpu_torch.ops.interp import interp_table
    shape = (61, 48)
    vp = np.full(shape, 2.0, np.float32)
    vp[:, 24:] = 2.6
    vs = vp / np.float32(np.sqrt(3.0))
    vs[:, :4] = 0.0
    rho = (0.31 * (1e3 * vp) ** 0.25).astype(np.float32)
    model = SeismicModel(origin=(0., 0.), spacing=(10., 10.), shape=shape,
                         space_order=space_order, vp=vp, vs=vs, b=1.0 / rho,
                         nbl=10, bcs="mask")
    src = np.stack([np.linspace(50., 550., nsrc), np.full(nsrc, 20.)], 1)
    rec = np.stack([np.linspace(0., 600., 41), np.full(41, 30.)], 1)
    geom = AcquisitionGeometry(model, rec, src, 0., 250., f0=0.015,
                               src_type="Ricker")
    s_idx, s_w = interp_table(geom.src_positions, model.origin_pml,
                              model.spacing)
    r_idx, _ = interp_table(geom.rec_positions, model.origin_pml,
                            model.spacing)
    nx, nz = model.padded_shape
    dt = float(model.critical_dt)
    T = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    prm = cs.stagger_params(T(model.lam), T(model.mu), T(model.b),
                            T(model.damp))
    injT = cs.source_pattern(s_idx[:, None], s_w[:, None], dt, (nx, nz),
                             torch.float32, dev).transpose(1, 2).contiguous()
    kw = dict(nt=geom.nt, nx=nx, nz=nz, space_order=space_order,
              spacing=model.spacing, z0=int(r_idx[..., 1].min()))
    return model, geom, prm, injT, T(geom.src.data), dt, kw


@pytest.mark.cuda
@pytest.mark.parametrize("nsrc", [1, 2, 5])
@pytest.mark.parametrize("space_order", [4, 8])
def test_elastic_kernels_match_twins(cuda, space_order, nsrc):
    """On the 81 x 68 padded grid (no multiple of the fused steps' 32 x 32
    tile): the modeling rows, the history forward and the adjoint's five
    images equal their twins exactly."""
    from devito_fwi_tpu_torch.ops import cuda_staggered as cs
    _, _, prm, injT, wav, dt, kw = _elastic_operands(space_order, cuda,
                                                     nsrc=nsrc)
    assert kw["nx"] % 32 and kw["nz"] % 32
    nsteps = kw["nt"] - 1
    seg = 16
    nseg = -(-nsteps // seg)
    wav10 = cs.pad_wavelet(wav, nsteps, nsteps)   # one segment
    wav9 = cs.pad_wavelet(wav, nsteps, seg * nseg)
    res = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (nsrc, nseg, seg, 2, kw["nx"])), dtype=torch.float32, device=cuda)
    cs.reset_counters()
    rows10 = cs.elastic_segments(*prm, injT, wav10, dt, **kw)
    fwd = cs.elastic_fwd_hist_segments(*prm, injT, wav9, dt, seg=seg, **kw)
    imgs = cs.elastic_grad_stream_segments(*prm, fwd[1], res, dt, seg=seg,
                                           **kw)
    assert all(n == 1 for n in cs.LAUNCHES.values())
    assert sum(cs.TWIN_CALLS.values()) == 0
    torch.cuda.synchronize()
    assert torch.equal(rows10, cs.elastic_segments_plain(
        *prm, injT, wav10, dt, **kw))
    for got, want in zip(fwd, cs.elastic_fwd_hist_plain(
            *prm, injT, wav9, dt, seg=seg, **kw)):
        assert torch.equal(got, want)
    for got, want in zip(imgs, cs.elastic_grad_stream_plain(
            *prm, fwd[1], res, dt, seg=seg, **kw)):
        assert torch.equal(got, want)
    nx = kw["nx"]
    a = rows10[:, :, :, 0].reshape(nsrc, -1, 2, nx)[:, :nsteps]
    assert torch.equal(a, fwd[0].reshape(nsrc, -1, 2, nx)[:, :nsteps])


@pytest.mark.cuda
def test_elastic_forward_raises_for_what_it_does_not_take(cuda):
    """Space order 18 (radius 9; the forward step takes 1..8) raises before
    any launch, on both forward sweeps."""
    from devito_fwi_tpu_torch.ops import cuda_staggered as cs
    _, _, prm, injT, wav, dt, kw = _elastic_operands(4, cuda)
    kw = dict(kw, space_order=18)
    nsteps = kw["nt"] - 1
    cs.reset_counters()
    with pytest.raises(ValueError):
        cs.elastic_segments(*prm, injT, cs.pad_wavelet(wav, nsteps, nsteps),
                            dt, **kw)
    with pytest.raises(ValueError):
        cs.elastic_fwd_hist_segments(
            *prm, injT, cs.pad_wavelet(wav, nsteps, nsteps), dt, seg=nsteps,
            **kw)
    assert sum(cs.LAUNCHES.values()) == 0
    assert sum(cs.TWIN_CALLS.values()) == 0


@pytest.mark.cuda
def test_elastic_adjoint_raises_for_what_it_does_not_take(cuda):
    """Space order 18 (radius 9; the fused reverse step takes 1..8) raises
    before any launch."""
    from devito_fwi_tpu_torch.ops import cuda_staggered as cs
    _, _, prm, _, _, dt, kw = _elastic_operands(4, cuda)
    kw = dict(kw, space_order=18)
    nsteps = kw["nt"] - 1
    hist = torch.zeros((2, 1, nsteps, 4, kw["nz"], kw["nx"]), device=cuda)
    res = torch.zeros((2, 1, nsteps, 2, kw["nx"]), device=cuda)
    cs.reset_counters()
    with pytest.raises(ValueError):
        cs.elastic_grad_stream_segments(*prm, hist, res, dt, seg=nsteps,
                                        **kw)
    assert sum(cs.LAUNCHES.values()) == 0
    assert sum(cs.TWIN_CALLS.values()) == 0


@pytest.mark.cuda
def test_elastic_solver_golden_on_the_card(cuda):
    from devito_fwi_tpu_torch.models.geometry import setup_geometry
    from devito_fwi_tpu_torch.ops.elastic_wavesolver import ElasticWaveSolver
    model = demo_model("layers-elastic", space_order=4, shape=(50, 50),
                       nbl=40, dtype=np.float32, spacing=(20., 20.))
    geometry = setup_geometry(model, 1000.)
    rec1, rec2, _, _, _ = ElasticWaveSolver(model, geometry,
                                            space_order=4).forward()
    assert np.isclose(np.linalg.norm(rec1.data), 19.25636, atol=1e-3, rtol=0)
    assert np.isclose(np.linalg.norm(rec2.data), 0.627606, atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_elastic_objective_on_the_card_matches_the_twins(cuda):
    """elastic_fwi_obj_multi on cuda (kernels) against device='cpu' (twins):
    the sweeps agree bitwise, the traces' matrix products sum in another
    order, so the objective and gradients agree to f32 rounding (1e-5)."""
    from devito_fwi_tpu_torch import elastic_fwi as tel
    from devito_fwi_tpu_torch.ops import cuda_staggered as cs
    model, geom, *_ = _elastic_operands(4, cuda, nsrc=3)
    obs, _ = tel.elastic_fm_multi(geom, device="cpu")
    vp, vs, rho = tel.model_vp_vs_rho(model)
    vp0 = model.crop(vp) * 1.03
    out = {}
    cs.reset_counters()
    for dev in ("cuda", "cpu"):
        out[dev] = tel.elastic_fwi_obj_multi(geom, obs, calc_grad=True,
                                             vp=vp0, device=dev)
    assert cs.LAUNCHES["elastic_fwd_hist_segments"] == 1
    assert cs.LAUNCHES["elastic_grad_stream_segments"] == 1
    (fc, gc, _), (fp, gp, _) = out["cuda"], out["cpu"]
    assert abs(fc - fp) <= 1e-5 * abs(fp)
    for k in ("vp", "vs", "rho"):
        assert np.abs(gc[k] - gp[k]).max() <= 1e-5 * np.abs(gp[k]).max(), k


@pytest.mark.cuda
def test_elastic_rejects_what_the_kernels_do_not_take(cuda):
    from devito_fwi_tpu_torch import elastic_fwi as tel
    model, geom, *_ = _elastic_operands(4, cuda)
    obs, _ = tel.elastic_fm_multi(geom, device="cpu")
    rec = np.stack([np.linspace(0., 600., 41), np.linspace(30., 200., 41)],
                   1)
    bad = AcquisitionGeometry(model, rec, geom.src_positions, 0., 250.,
                              f0=0.015, src_type="Ricker")
    with pytest.raises(ValueError, match="adjacent z-planes"):
        tel.elastic_fm_multi(bad, device="cuda")


# ---------------------------------------------------------------------------
# viscoacoustic (ops.cuda_visco, csrc/visco2d.cu)
# ---------------------------------------------------------------------------

def _visco_operands(space_order, dev, nsrc=2):
    """A two-layer 61 x 48 viscoacoustic model (nbl 10), ``nsrc`` shots and
    41 receivers on the card: the kernels' operands and keywords."""
    from devito_fwi_tpu_torch.models.model import SeismicModel
    from devito_fwi_tpu_torch.ops import cuda_visco as cv
    from devito_fwi_tpu_torch.ops.interp import interp_table
    shape = (61, 48)
    vp = np.full(shape, 2.0, np.float32)
    vp[:, 24:] = 2.6
    qp = np.full(shape, 60.0, np.float32)
    qp[:, 24:] = 90.0
    rho = (0.31 * (1e3 * vp) ** 0.25).astype(np.float32)
    model = SeismicModel(origin=(0., 0.), spacing=(10., 10.), shape=shape,
                         space_order=space_order, vp=vp, qp=qp, b=1.0 / rho,
                         nbl=10, bcs="mask")
    src = np.stack([np.linspace(50., 550., nsrc), np.full(nsrc, 20.)], 1)
    rec = np.stack([np.linspace(0., 600., 41), np.full(41, 30.)], 1)
    geom = AcquisitionGeometry(model, rec, src, 0., 250., f0=0.015,
                               src_type="Ricker")
    s_idx, s_w = interp_table(geom.src_positions, model.origin_pml,
                              model.spacing)
    r_idx, _ = interp_table(geom.rec_positions, model.origin_pml,
                            model.spacing)
    nx, nz = model.padded_shape
    dt = float(model.critical_dt)
    T = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    prm, vp2 = cv.operands(T(model.vp), T(model.b), T(model.qp),
                           T(model.damp), dt, geom.f0)
    inj, injw = cv.source_patterns(s_idx[:, None], s_w[:, None], vp2, dt)
    kw = dict(nt=geom.nt, nx=nx, nz=nz, space_order=space_order,
              spacing=model.spacing, z0=int(r_idx[..., 1].min()))
    return (model, geom, prm, inj.transpose(1, 2).contiguous(),
            injw.transpose(1, 2).contiguous(), T(geom.src.data), dt, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("space_order", [4, 8])
def test_visco_kernels_match_twins(cuda, space_order):
    from devito_fwi_tpu_torch.ops import cuda_visco as cv
    _, _, prm, injT, injwT, wav, dt, kw = _visco_operands(space_order, cuda)
    nsteps = kw["nt"] - 2
    seg = 16
    nseg = -(-nsteps // seg)
    wav12 = cv.pad_wavelet(wav, kw["nt"], nsteps)   # one segment
    wav11 = cv.pad_wavelet(wav, kw["nt"], seg * nseg)
    wavs2 = wav11 * (dt * dt)
    res = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (2, nseg, seg, 2, kw["nx"])), dtype=torch.float32, device=cuda)
    cv.reset_counters()
    out12 = cv.visco_sls2_segments(*prm, injT, wav12, dt, **kw)
    fwd = cv.visco_fwd_hist_segments(*prm, injT, wav11, dt, seg=seg, **kw)
    imgs = cv.visco_grad_stream_segments(*prm, injwT, fwd[1], res, wavs2,
                                         dt, seg=seg, **kw)
    assert all(n == 1 for n in cv.LAUNCHES.values())
    assert sum(cv.TWIN_CALLS.values()) == 0
    torch.cuda.synchronize()
    for got, want in zip(out12, cv.visco_sls2_plain(*prm, injT, wav12, dt,
                                                    **kw)):
        assert torch.equal(got, want)
    for got, want in zip(fwd, cv.visco_fwd_hist_plain(
            *prm, injT, wav11, dt, seg=seg, **kw)):
        assert torch.equal(got, want)
    for g, w in zip(imgs, cv.visco_grad_stream_plain(
            *prm, injwT, fwd[1], res, wavs2, dt, seg=seg, **kw)):
        assert torch.equal(g, w)
    nx = kw["nx"]
    assert torch.equal(out12[0][:, 0],
                       fwd[0].reshape(2, -1, 2, nx)[:, :nsteps])


@pytest.mark.cuda
def test_visco_forward_raises_for_what_it_does_not_take(cuda):
    """Space order 18 (radius 9; the fused forward step takes 1..8) raises
    before any launch, on both forward sweeps."""
    from devito_fwi_tpu_torch.ops import cuda_visco as cv
    _, _, prm, injT, _, wav, dt, kw = _visco_operands(4, cuda)
    kw = dict(kw, space_order=18)
    nsteps = kw["nt"] - 2
    wav12 = cv.pad_wavelet(wav, kw["nt"], nsteps)
    cv.reset_counters()
    with pytest.raises(ValueError):
        cv.visco_sls2_segments(*prm, injT, wav12, dt, **kw)
    with pytest.raises(ValueError):
        cv.visco_fwd_hist_segments(*prm, injT, wav12, dt, seg=nsteps, **kw)
    assert sum(cv.LAUNCHES.values()) == 0
    assert sum(cv.TWIN_CALLS.values()) == 0


@pytest.mark.cuda
def test_visco_solver_golden_on_the_card(cuda):
    from devito_fwi_tpu_torch.models.geometry import setup_geometry
    from devito_fwi_tpu_torch.ops import cuda_visco as cv
    from devito_fwi_tpu_torch.ops.viscoacoustic_wavesolver import (
        ViscoacousticWaveSolver)
    model = demo_model("layers-viscoacoustic", space_order=4, shape=(50, 50),
                       nbl=40, dtype=np.float32, spacing=(20., 20.))
    geometry = setup_geometry(model, 1000.)
    cv.reset_counters()
    rec, _, _, _ = ViscoacousticWaveSolver(model, geometry,
                                           space_order=4).forward()
    assert cv.LAUNCHES["visco_sls2_segments"] == 1
    assert np.isclose(np.linalg.norm(rec.data), 684.385, atol=1e-2, rtol=0)


@pytest.mark.cuda
def test_visco_rejects_what_the_kernels_do_not_take(cuda):
    """Receivers off two adjacent z-planes: the sls/2 solver forward and the
    batched modeling raise on the card rather than run the eager torch."""
    from devito_fwi_tpu_torch import visco_fwi as tvf
    from devito_fwi_tpu_torch.ops import cuda_visco as cv
    from devito_fwi_tpu_torch.ops.viscoacoustic_wavesolver import (
        ViscoacousticWaveSolver)
    model, geom, *_ = _visco_operands(4, cuda, nsrc=1)
    rec = np.stack([np.linspace(0., 600., 41), np.linspace(30., 200., 41)],
                   1)
    bad = AcquisitionGeometry(model, rec, geom.src_positions, 0., 250.,
                              f0=0.015, src_type="Ricker")
    cv.reset_counters()
    with pytest.raises(ValueError, match="adjacent z-planes"):
        ViscoacousticWaveSolver(model, bad, space_order=4).forward()
    with pytest.raises(ValueError, match="adjacent z-planes"):
        tvf.visco_fm_multi(bad, device="cuda")
    assert sum(cv.LAUNCHES.values()) == 0


@pytest.mark.cuda
def test_visco_objective_on_the_card_matches_the_twins(cuda):
    """visco_fwi_obj_multi on cuda (kernels) against device='cpu' (twins):
    the sweeps agree bitwise, the traces' matrix products sum in another
    order, so the objective and gradients agree to f32 rounding (1e-5)."""
    from devito_fwi_tpu_torch import visco_fwi as tvf
    from devito_fwi_tpu_torch.ops import cuda_visco as cv
    model, geom, *_ = _visco_operands(4, cuda, nsrc=3)
    obs = tvf.visco_fm_multi(geom, device="cpu")
    vp0 = model.crop(model.vp) * 1.03
    out = {}
    cv.reset_counters()
    for dev in ("cuda", "cpu"):
        out[dev] = tvf.visco_fwi_obj_multi(geom, obs, calc_grad=True,
                                           vp=vp0, device=dev)
    assert cv.LAUNCHES["visco_fwd_hist_segments"] == 1
    assert cv.LAUNCHES["visco_grad_stream_segments"] == 1
    (fc, gc, _), (fp, gp, _) = out["cuda"], out["cpu"]
    assert abs(fc - fp) <= 1e-5 * abs(fp)
    for k in ("vp", "qp"):
        assert np.abs(gc[k] - gp[k]).max() <= 1e-5 * np.abs(gp[k]).max(), k


# ---------------------------------------------------------------------------
# TTI (ops.cuda_tti, csrc/tti2d.cu)
# ---------------------------------------------------------------------------

def _tti_operands(space_order, dev, nsrc=2):
    """layers-tti 61 x 48 (nbl 10), ``nsrc`` shots and 41 receivers at 30 m
    on the card: the TTI sweeps' operands and keywords for 7 segments."""
    from devito_fwi_tpu_torch.ops import cuda_tti as ct
    from devito_fwi_tpu_torch.ops.acoustic import _ckpt_layout
    from devito_fwi_tpu_torch.ops.interp import interp_table
    model = demo_model("layers-tti", shape=(61, 48), spacing=(10., 10.),
                       nbl=10, space_order=space_order, dtype=np.float32)
    src = np.stack([np.linspace(50., 550., nsrc), np.full(nsrc, 20.)], 1)
    rec = np.stack([np.linspace(0., 600., 41), np.full(41, 30.)], 1)
    geom = AcquisitionGeometry(model, rec, src, 0., 250., f0=0.015,
                               src_type="Ricker")
    s_idx, s_w = interp_table(geom.src_positions, model.origin_pml,
                              model.spacing)
    r_idx, _ = interp_table(geom.rec_positions, model.origin_pml,
                            model.spacing)
    nx, nz = model.padded_shape
    dt = float(model.critical_dt)
    T = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    m, ops = ct.operands(*(T(getattr(model, n)) for n in (
        "vp", "damp", "epsilon", "delta", "theta")), dt)
    injT = ca.source_pattern(s_idx[:, None], s_w[:, None], m,
                             dt ** 2).transpose(1, 2).contiguous()
    nck = 7
    nsteps, seg, nseg = _ckpt_layout(geom.nt, nck)
    wav = ct.pack_wavelet(T(geom.src.data), dt ** 2, geom.nt, nseg * seg)
    kw = dict(nt=geom.nt, nx=nx, nz=nz, space_order=space_order,
              spacing=model.spacing, z0=int(r_idx[..., 1].min()),
              n_checkpoints=nck)
    return model, geom, ops, injT, wav, dt, kw


@pytest.mark.cuda
@pytest.mark.parametrize("space_order", [4, 8])
def test_tti_kernels_match_twins(cuda, space_order):
    """The four TTI sweeps against their twins (7 segments, the last padded);
    the checkpoint-route gradient equals the streamed one bitwise."""
    from devito_fwi_tpu_torch.ops import cuda_tti as ct
    _, _, ops, injT, wav, dt, kw = _tti_operands(space_order, cuda)
    B, nx = injT.shape[0], kw["nx"]
    nsteps = kw["nt"] - 2
    nseg = 7
    seg = -(-nsteps // nseg)
    res = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (B, nseg, seg, 2, nx)), dtype=torch.float32, device=cuda)
    ct.reset_counters()
    fwd = ct.tti_forward_dt2_segments(*ops, injT, wav, dt, **kw)
    ck = ct.tti_forward_ckpt_segments(*ops, injT, wav, dt, **kw)
    g_s = ct.tti_gradient_stream_segments(*ops, fwd[1], fwd[2], res, dt,
                                          **kw)
    g_c = ct.tti_jacobian_adjoint_segments(*ops, injT, wav, ck[1], res, dt,
                                           **kw)
    assert all(n == 1 for n in ct.LAUNCHES.values())
    assert sum(ct.TWIN_CALLS.values()) == 0
    torch.cuda.synchronize()
    _close(fwd, ct.tti_forward_dt2_plain(*ops, injT, wav, dt, **kw))
    _close(ck, ct.tti_forward_ckpt_plain(*ops, injT, wav, dt, **kw))
    # the fused reverse step repeats the twin's operations: exactly equal
    assert torch.equal(g_s, ct.tti_gradient_stream_plain(
        *ops, fwd[1], fwd[2], res, dt, **kw))
    assert torch.equal(g_c, ct.tti_jacobian_adjoint_plain(
        *ops, injT, wav, ck[1], res, dt, **kw))
    assert torch.equal(g_c, g_s)
    assert torch.equal(ck[0], fwd[0])


@pytest.mark.cuda
@pytest.mark.parametrize("space_order", [4, 8])
def test_tti_fused_sweeps_equal_twins_at_three_shots(cuda, space_order):
    """Rows 16, 14 and 15 (the fused forward step, and the checkpoint
    route's recompute on it) and row 17 at 3 shots: every output equal to
    its twin bit for bit, and the checkpoint-route gradient to the
    streamed one."""
    from devito_fwi_tpu_torch.ops import cuda_tti as ct
    _, _, ops, injT, wav, dt, kw = _tti_operands(space_order, cuda, nsrc=3)
    B, nx = injT.shape[0], kw["nx"]
    nseg = kw["n_checkpoints"]
    seg = -(-(kw["nt"] - 2) // nseg)
    res = torch.as_tensor(np.random.default_rng(16).standard_normal(
        (B, nseg, seg, 2, nx)), dtype=torch.float32, device=cuda)
    ct.reset_counters()
    fwd = ct.tti_forward_dt2_segments(*ops, injT, wav, dt, **kw)
    ck = ct.tti_forward_ckpt_segments(*ops, injT, wav, dt, **kw)
    g_s = ct.tti_gradient_stream_segments(*ops, fwd[1], fwd[2], res, dt,
                                          **kw)
    g_c = ct.tti_jacobian_adjoint_segments(*ops, injT, wav, ck[1], res, dt,
                                           **kw)
    assert all(n == 1 for n in ct.LAUNCHES.values())
    assert sum(ct.TWIN_CALLS.values()) == 0
    torch.cuda.synchronize()
    for got, want in ((fwd, ct.tti_forward_dt2_plain(*ops, injT, wav, dt,
                                                     **kw)),
                      (ck, ct.tti_forward_ckpt_plain(*ops, injT, wav, dt,
                                                     **kw))):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert torch.equal(g_c, ct.tti_jacobian_adjoint_plain(
        *ops, injT, wav, ck[1], res, dt, **kw))
    assert torch.equal(g_c, g_s)
    assert float(g_s.abs().max()) > 0


@pytest.mark.cuda
def test_tti_forward_raises_for_what_it_does_not_take(cuda):
    """Space order 18 (radius 9), or a grid of 65,536 tiles along x (the
    fused forward step's launch takes at most 65,535): both forwards raise
    before any launch."""
    from devito_fwi_tpu_torch.ops import cuda_tti as ct
    _, _, ops, injT, wav, dt, kw = _tti_operands(4, cuda)
    ct.reset_counters()
    bad = dict(kw, space_order=18)
    for fn in (ct.tti_forward_dt2_segments, ct.tti_forward_ckpt_segments):
        with pytest.raises(ValueError):
            fn(*ops, injT, wav, dt, **bad)
    nx2 = 32 * 2 ** 16 + 1
    z = torch.zeros((2, nx2), device=cuda)
    kw2 = dict(nt=4, nx=nx2, nz=2, space_order=4, spacing=(10., 10.), z0=0,
               n_checkpoints=1)
    inj2 = torch.zeros((1, 2, nx2), device=cuda)
    w2 = torch.zeros(3, device=cuda)
    for fn in (ct.tti_forward_dt2_segments, ct.tti_forward_ckpt_segments):
        with pytest.raises(ValueError, match="tti forward"):
            fn(z, z, z, z, z, z, inj2, w2, dt, **kw2)
    assert sum(ct.LAUNCHES.values()) == 0
    assert sum(ct.TWIN_CALLS.values()) == 0


@pytest.mark.cuda
def test_tti_adjoint_raises_for_what_it_does_not_take(cuda):
    """Space order 18 (radius 9), or a grid of 65,536 tiles along x (the
    fused reverse step's launch takes at most 65,535): both reverse sweeps
    raise before any launch."""
    from devito_fwi_tpu_torch.ops import cuda_tti as ct
    from devito_fwi_tpu_torch.ops.acoustic import _ckpt_layout
    _, _, ops, injT, wav, dt, kw = _tti_operands(4, cuda)
    B, nz, nx = injT.shape
    _, seg, nseg = _ckpt_layout(kw["nt"], kw["n_checkpoints"])
    hist = torch.zeros((B, nseg, seg, nz, nx), device=cuda)
    res = torch.zeros((B, nseg, seg, 2, nx), device=cuda)
    starts = torch.zeros((B, nseg, 4, nz, nx), device=cuda)
    ct.reset_counters()
    bad = dict(kw, space_order=18)
    with pytest.raises(ValueError):
        ct.tti_gradient_stream_segments(*ops, hist, hist, res, dt, **bad)
    with pytest.raises(ValueError):
        ct.tti_jacobian_adjoint_segments(*ops, injT, wav, starts, res, dt,
                                         **bad)
    # 2 x 2,097,153 cells: 65,537 tiles of 32 along x
    nx2 = 32 * 2 ** 16 + 1
    z = torch.zeros((2, nx2), device=cuda)
    kw2 = dict(nt=4, nx=nx2, nz=2, space_order=4, spacing=(10., 10.), z0=0,
               n_checkpoints=1)
    h2 = torch.zeros((1, 1, 2, 2, nx2), device=cuda)
    r2 = torch.zeros((1, 1, 2, 2, nx2), device=cuda)
    with pytest.raises(ValueError, match="tti adjoint"):
        ct.tti_gradient_stream_segments(z, z, z, z, z, z, h2, h2, r2, dt,
                                        **kw2)
    assert sum(ct.LAUNCHES.values()) == 0


@pytest.mark.cuda
def test_tti_rejects_what_the_kernels_do_not_take(cuda):
    """Receivers off two adjacent z-planes, or two source points: the TTI
    entry points raise on the card rather than run the twins or the eager
    torch."""
    from devito_fwi_tpu_torch.ops import cuda_tti as ct
    from devito_fwi_tpu_torch.ops.interp import interp_table
    from devito_fwi_tpu_torch.ops.tti_wavesolver import AnisotropicWaveSolver
    model, geom, *_ = _tti_operands(4, cuda, nsrc=1)
    rec = np.stack([np.linspace(0., 600., 41), np.linspace(30., 200., 41)],
                   1)
    bad = AcquisitionGeometry(model, rec, geom.src_positions, 0., 250.,
                              f0=0.015, src_type="Ricker")
    ct.reset_counters()
    solver = AnisotropicWaveSolver(model, bad, space_order=4)
    with pytest.raises(ValueError, match="adjacent z-planes"):
        solver.gradient_checkpointed(bad.rec)
    two = AcquisitionGeometry(model, geom.rec_positions,
                              np.array([[100., 20.], [300., 20.]]), 0., 250.,
                              f0=0.015, src_type="Ricker")
    solver = AnisotropicWaveSolver(model, two, space_order=4)
    with pytest.raises(ValueError, match="one source point"):
        solver.gradient_checkpointed(two.rec, src=two.src)
    s_idx, s_w = interp_table(bad.src_positions, model.origin_pml,
                              model.spacing)
    r_idx, r_w = interp_table(bad.rec_positions, model.origin_pml,
                              model.spacing)
    fields = [torch.as_tensor(np.asarray(getattr(model, n), np.float32),
                              device=cuda)
              for n in ("vp", "damp", "epsilon", "delta", "theta")]
    wav = torch.as_tensor(bad.src.data[:, :1], device=cuda)
    obs = torch.zeros((1, bad.nt, 41), device=cuda)
    with pytest.raises(ValueError, match="adjacent z-planes"):
        ct.tti_gradient_batched(*fields, wav, s_idx[:, None], s_w[:, None],
                                r_idx, r_w, obs, float(model.critical_dt),
                                nt=bad.nt, spacing=model.spacing,
                                space_order=4, n_checkpoints=4)
    assert sum(ct.LAUNCHES.values()) == 0
    assert sum(ct.TWIN_CALLS.values()) == 0


@pytest.mark.cuda
def test_tti_solver_gradient_on_the_card_matches_the_twins(cuda):
    """AnisotropicWaveSolver.gradient_checkpointed on cuda (kernels, both
    routes) against device='cpu' (twins): the sweeps agree bitwise, the
    traces' and rows' matrix products sum in another order (1e-5)."""
    from devito_fwi_tpu_torch.models.geometry import setup_geometry
    from devito_fwi_tpu_torch.ops import cuda_tti as ct
    from devito_fwi_tpu_torch.ops.tti_wavesolver import AnisotropicWaveSolver
    model = demo_model("layers-tti", shape=(40, 36), spacing=(15., 15.),
                       nbl=10, space_order=4, dtype=np.float32)
    geometry = setup_geometry(model, 200.0)
    cpu = AnisotropicWaveSolver(model, geometry, space_order=4, device="cpu")
    rec, _, _, _ = cpu.forward()
    rec.data[:] = 0.3 * rec.data
    g_cpu, _ = cpu.gradient_checkpointed(rec, n_checkpoints=6)
    ct.reset_counters()
    card = AnisotropicWaveSolver(model, geometry, space_order=4)
    g_s, _ = card.gradient_checkpointed(rec, n_checkpoints=6)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ct, "_stream_fits", lambda *a: False)
        g_c, _ = card.gradient_checkpointed(rec, n_checkpoints=6)
    assert ct.LAUNCHES["tti_gradient_stream_segments"] == 1
    assert ct.LAUNCHES["tti_jacobian_adjoint_segments"] == 1
    assert np.array_equal(g_s, g_c)
    assert np.abs(g_s - g_cpu).max() <= 1e-5 * np.abs(g_cpu).max()


def _setup3(fs, space_order, dev):
    model = demo_model("layers-isotropic", nlayers=3, shape=(24, 20, 16),
                       spacing=(15., 15., 15.), space_order=space_order,
                       nbl=8, dt=1.5, fs=fs)
    ext, eyt = model.domain_size[0], model.domain_size[1]
    src = np.stack([np.linspace(0, ext, 2), np.linspace(eyt * .3, eyt * .7, 2),
                    np.full(2, 30.)], 1)
    rec = np.stack([np.linspace(0, ext, 12), np.full(12, eyt / 2),
                    np.full(12, 37.)], 1)
    geom = AcquisitionGeometry(model, rec, src, 0., 120., f0=0.015,
                               src_type="Ricker")
    return geom, fwi._Setup3(geom, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("space_order", [4, 8])
@pytest.mark.parametrize("fs", [False, True])
def test_3d_stream_kernels_match_twins(cuda, fs, space_order):
    from devito_fwi_tpu_torch.ops import cuda_acoustic3d as c3d
    _, st = _setup3(fs, space_order, cuda)
    ops = (st.m3, st.hd3, *st.planes(0, 2), st.dt)
    c3d.reset_counters()
    rec = c3d.forward_rec3(*ops, **st.kw)
    got = c3d.forward_dt2_stream3(*ops, **st.kw)
    rng = np.random.default_rng(0)
    res = torch.as_tensor(rng.standard_normal((2, st.nt, 12)),
                          dtype=torch.float32, device=cuda)
    slabs = c3d.residual_slabs3(res, st.r_idx, st.r_w, st.m, st.dt * st.dt,
                                st.z0, st.nsteps)
    grad = c3d.gradient_stream3(st.m3, st.hd3, got[1], slabs, st.dt,
                                **st.kw)
    assert all(c3d.LAUNCHES[n] == 1 for n in c3d.KERNELS)
    assert sum(c3d.TWIN_CALLS.values()) == 0
    torch.cuda.synchronize()
    # the y march (forwards and reverse) repeats the twin's operations:
    # exactly equal
    assert torch.equal(rec, c3d.forward_rec3_plain(*ops, **st.kw))
    for g, w in zip(got, c3d.forward_dt2_stream3_plain(*ops, **st.kw)):
        assert torch.equal(g, w)
    assert torch.equal(grad, c3d.gradient_stream3_plain(
        st.m3, st.hd3, got[1], slabs, st.dt, **st.kw))
    assert torch.equal(rec, got[0])


@pytest.mark.cuda
def test_3d_forwards_raise_for_what_they_do_not_take(cuda):
    """Space order 18 (radius 9; the y march takes 1..8) raises before any
    launch, on both 3-D forwards."""
    from devito_fwi_tpu_torch.ops import cuda_acoustic3d as c3d
    _, st = _setup3(False, 4, cuda)
    ops = (st.m3, st.hd3, *st.planes(0, 2), st.dt)
    kw = dict(st.kw, space_order=18)
    c3d.reset_counters()
    for fn in (c3d.forward_rec3, c3d.forward_dt2_stream3):
        with pytest.raises(ValueError):
            fn(*ops, **kw)
    assert sum(c3d.LAUNCHES.values()) == 0
    assert sum(c3d.TWIN_CALLS.values()) == 0


@pytest.mark.cuda
def test_3d_reverse_raises_for_what_it_does_not_take(cuda):
    """Space order 18 (radius 9; the reverse march takes 1..8), or a grid
    of 65,536 tiles along x: the reverse sweep raises before any launch."""
    from devito_fwi_tpu_torch.ops import cuda_acoustic3d as c3d
    _, st = _setup3(False, 4, cuda)
    ny, nz, nx = st.m3.shape
    dt2 = torch.zeros((2, st.nsteps, ny, nz, nx), device=cuda)
    slabs = torch.zeros((2, st.nsteps, ny, 2, nx), device=cuda)
    c3d.reset_counters()
    with pytest.raises(ValueError):
        c3d.gradient_stream3(st.m3, st.hd3, dt2, slabs, st.dt,
                             **dict(st.kw, space_order=18))
    nx2 = 32 * 2 ** 16 + 1
    m2 = torch.ones((1, 2, nx2), device=cuda)
    kw2 = dict(nt=3, space_order=4, spacing=(10., 10., 10.), z0=0)
    with pytest.raises(ValueError, match="acoustic3d march"):
        c3d.gradient_stream3(m2, m2 * 0, torch.zeros((1, 1, 1, 2, nx2),
                                                     device=cuda),
                             torch.zeros((1, 1, 1, 2, nx2), device=cuda),
                             st.dt, **kw2)
    assert sum(c3d.LAUNCHES.values()) == 0
    assert sum(c3d.TWIN_CALLS.values()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("space_order", [4, 8])
def test_3d_step_kernel_matches_twin(cuda, space_order):
    from devito_fwi_tpu_torch.ops import cuda_acoustic3 as c3
    from devito_fwi_tpu_torch.utils.fd import second_derivative_weights
    rng = np.random.default_rng(0)
    shape = (48, 20, 36)
    u, up = (torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                             device=cuda) for _ in range(2))
    vp = torch.as_tensor(1.5 + rng.random(shape), dtype=torch.float32,
                         device=cuda)
    hd = torch.as_tensor(0.05 * rng.random(shape), dtype=torch.float32,
                         device=cuda)
    m = 1.0 / (vp * vp)
    w_full = second_derivative_weights(space_order)
    kw = dict(w=tuple(float(v) for v in w_full[space_order // 2:]),
              inv_h2=tuple(1.0 / h ** 2 for h in (10., 12., 14.)))
    c3.reset_counters()
    got = c3.step3(u, up, m, hd, 1.21, **kw)
    assert c3.LAUNCHES["step3"] == 1 and c3.TWIN_CALLS["step3"] == 0
    torch.cuda.synchronize()
    _close([got], [c3.step3_plain(u, up, m, hd, 1.21, **kw)])


@pytest.mark.cuda
@pytest.mark.parametrize("saved3", [False, True])
def test_3d_objective_on_the_card_matches_the_twins(cuda, saved3):
    """fwi_obj_multi on cuda (the kernels) against device="cpu" (the
    twins): objective 1e-5 relative, gradient 1e-4 of the max (float32
    sums of products run in another order on the two devices)."""
    from devito_fwi_tpu_torch.ops import cuda_acoustic3 as c3
    from devito_fwi_tpu_torch.ops import cuda_acoustic3d as c3d
    geom, _ = _setup3(False, 4, cuda)
    obs = fwi.fm_multi(geom, device="cpu")
    model0 = demo_model("layers-isotropic", nlayers=1, shape=(24, 20, 16),
                        spacing=(15., 15., 15.), space_order=4, nbl=8,
                        dt=1.5)
    g0 = AcquisitionGeometry(model0, geom.rec_positions, geom.src_positions,
                             0., 120., f0=0.015, src_type="Ricker")
    c3.reset_counters()
    c3d.reset_counters()
    f_c, g_c, _ = fwi.fwi_obj_multi(g0, obs, None, calc_grad=True,
                                    precond=False, device="cuda",
                                    saved3=saved3)
    assert sum(c3d.TWIN_CALLS.values()) == 0 and c3.TWIN_CALLS["step3"] == 0
    if saved3:
        assert c3.LAUNCHES["step3"] > 0
    else:
        assert c3d.LAUNCHES["gradient_stream3"] == 1
    f_p, g_p, _ = fwi.fwi_obj_multi(g0, obs, None, calc_grad=True,
                                    precond=False, device="cpu",
                                    saved3=saved3)
    assert abs(f_c - f_p) <= 1e-5 * abs(f_p)
    assert np.abs(g_c - g_p).max() <= 1e-4 * np.abs(g_p).max()


@pytest.mark.cuda
@pytest.mark.parametrize("space_order", [4, 8])
def test_legacy_kernel_matches_twin_bitwise(cuda, space_order):
    """B15 (``cuda_legacy.forward_rows``) against its twin on the card:
    every row equal, the two trailing rows zero; ``forward_traces`` on cuda
    launches the kernel and no twin and meets the B1 traces of
    ``fm_multi`` within 1e-5 of the max (the two kernels associate the
    stencil differently)."""
    from devito_fwi_tpu_torch.ops import cuda_legacy as cl
    st = _setup(False, space_order, cuda)
    nt, nx, nz = st.nt, st.nx, st.nz
    inj = st.injT(0, 2).transpose(1, 2).contiguous()
    wav = st.wav_pad[:nt - 2].contiguous()
    hd = st.hdT.T.contiguous()
    kw = dict(nt=nt, nx=nx, nz=nz, space_order=space_order,
              spacing=(10., 10.), z0=st.z0)
    cl.reset_counters()
    got = cl.forward_rows(st.m, hd, wav, inj, st.dt, **kw)
    assert cl.LAUNCHES["forward_rows"] == 1
    assert cl.TWIN_CALLS["forward_rows"] == 0
    torch.cuda.synchronize()
    want = cl.forward_rows_plain(st.m, hd, wav, inj, st.dt, **kw)
    assert torch.equal(got, want)
    assert not got[:, nt - 2:].any()
    model = demo_model("circle-isotropic", vp_circle=3.0, vp_background=2.5,
                       origin=(0., 0.), shape=(61, 61), spacing=(10., 10.),
                       nbl=10, space_order=space_order)
    src = np.stack([np.linspace(0., 600., 2), np.full(2, 20.)], 1)
    rec = np.stack([np.linspace(0., 600., 41), np.full(41, 20.)], 1)
    geom = AcquisitionGeometry(model, rec, src, 0., 300., f0=0.010,
                               src_type="Ricker")
    cl.reset_counters()
    tr = cl.forward_traces(geom, device="cuda")
    assert cl.LAUNCHES["forward_rows"] == 1
    assert cl.TWIN_CALLS["forward_rows"] == 0
    ref = np.stack([s.data for s in fwi.fm_multi(geom, device="cuda")])
    assert np.abs(tr - ref).max() <= 1e-5 * np.abs(ref).max()


def _legacy_operands(B, nz, nx, space_order, z0, src_rows, dev, nt=60):
    """Seeded ``forward_rows`` operands in its (nx, nz) layout: vp 1.5-3.0
    km/s at 10 m, dt 1 ms, a damp of up to 0.05, one wavelet, each shot's
    2 x 2 source block on a row of ``src_rows``."""
    rng = np.random.default_rng(5)
    vp = rng.uniform(1.5, 3.0, (nx, nz))
    f32 = dict(dtype=torch.float32, device=dev)
    m = torch.as_tensor(1.0 / vp ** 2, **f32)
    hd = torch.as_tensor(rng.uniform(0.0, 0.05, (nx, nz)), **f32)
    inj = torch.zeros((B, nx, nz), **f32)
    for s in range(B):
        z, x = src_rows[s % len(src_rows)], 2 + (7 * s) % (nx - 3)
        inj[s, x:x + 2, z:z + 2] = torch.as_tensor(
            rng.uniform(0.1, 0.5, (2, 2)), **f32)
    wav = torch.as_tensor(rng.standard_normal(nt - 2), **f32)
    kw = dict(nt=nt, nx=nx, nz=nz, space_order=space_order,
              spacing=(10., 10.), z0=z0)
    return (m, hd, wav, inj, 1.0), kw


@pytest.mark.cuda
@pytest.mark.parametrize("B,nz,nx,space_order,z0,src_rows", [
    # SMARMN's padded grid at 40 shots: more clusters than the card holds
    # at once, a second wave
    (40, 186, 380, 8, 42, (20, 100)),
    # nz no multiple of the cluster (slabs of 47 rows): z0 on the last row
    # of the first slab, sources on a slab's first and last rows
    (3, 187, 61, 8, 46, (47, 93)),
    (3, 187, 61, 4, 93, (46, 140)),
])
def test_legacy_cluster_sweep_matches_twin_bitwise(cuda, B, nz, nx,
                                                   space_order, z0,
                                                   src_rows):
    """B15's cluster sweep against its twin, every row equal: at 40 SMARMN
    shots (a second wave of clusters) and on a grid whose nz the cluster
    does not divide, with z0 and the sources on slab boundaries."""
    from devito_fwi_tpu_torch.ops import cuda_legacy as cl
    ops, kw = _legacy_operands(B, nz, nx, space_order, z0, src_rows, cuda)
    plan = cl.sweep_launch(nz, nx, space_order // 2)
    waves = -(-B // cl.max_clusters(plan, space_order // 2))
    assert waves == (2 if B == 40 else 1)
    assert nz % plan.cluster or B == 40
    cl.reset_counters()
    got = cl.forward_rows(*ops, **kw)
    torch.cuda.synchronize()
    assert cl.LAUNCHES["forward_rows"] == 1
    want = cl.forward_rows_plain(*ops, **kw)
    assert bool(want.abs().max() > 0)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_legacy_refuses_an_oversized_grid_without_launching(cuda):
    """A grid whose slab does not fit a block even at a cluster of 8
    raises ValueError and launches nothing."""
    from devito_fwi_tpu_torch.ops import cuda_legacy as cl
    ops, kw = _legacy_operands(1, 600, 380, 8, 10, (5,), cuda, nt=6)
    cl.reset_counters()
    with pytest.raises(ValueError, match="even at a cluster of 8"):
        cl.forward_rows(*ops, **kw)
    assert cl.LAUNCHES["forward_rows"] == 0
    assert cl.TWIN_CALLS["forward_rows"] == 0


@pytest.mark.cuda
def test_eager_route_on_the_card_matches_the_cpu(cuda):
    """A geometry no kernel takes (3 camembert shots, 31 receivers on the
    vertical line x = 380 m) runs the eager route on cuda, counted, no
    kernel or twin called, its objective within 1e-5 and gradient within
    3e-5 of the max of the same float32 call on the CPU."""
    kw = dict(origin=(0., 0.), shape=(41, 41), spacing=(10., 10.), nbl=10,
              space_order=4)
    true = demo_model("circle-isotropic", vp_circle=3.0, vp_background=2.5,
                      r=8, **kw)
    kw["dt"] = float(true.critical_dt)
    init = demo_model("circle-isotropic", vp_circle=2.5, vp_background=2.5,
                      **kw)
    src = np.stack([np.full(3, 20.), np.linspace(0., 400., 3)], 1)
    rec = np.stack([np.full(31, 380.), np.linspace(10., 390., 31)], 1)
    g1, g0 = (AcquisitionGeometry(m, rec, src, 0., 250., f0=0.012,
                                  src_type="Ricker") for m in (true, init))
    obs = fwi.fm_multi(g1, device="cpu")
    x = 1.0 / np.asarray(g0.model.vp_unpadded, np.float64).reshape(-1) ** 2
    fwi.reset_counters()
    ca.reset_counters()
    f_c, g_c, _ = fwi.fwi_loss(x.copy(), g0, obs, None, device="cuda")
    assert fwi.EAGER["objective"] == 1
    assert not any(ca.LAUNCHES.values()) and not any(ca.TWIN_CALLS.values())
    f_p, g_p, _ = fwi.fwi_loss(x.copy(), g0, obs, None, device="cpu")
    assert abs(f_c - f_p) <= 1e-5 * abs(f_p)
    assert np.abs(g_c - g_p).max() <= 3e-5 * np.abs(g_p).max()


def _close_to_cpu(got, want, rtol):
    """max|got - want| within ``rtol`` of max|want| (``got`` on the card,
    ``want`` the CPU's)."""
    got = got.cpu() if torch.is_tensor(got) else torch.as_tensor(got)
    want = want.cpu() if torch.is_tensor(want) else torch.as_tensor(want)
    err = float((got - want).abs().max())
    assert err <= rtol * float(want.abs().max()), err


@pytest.mark.cuda
def test_sa_solver_on_the_card_matches_the_cpu(cuda):
    """``SaIsoAcousticWaveSolver`` on cuda (the eager operators, no kernel)
    against the same float32 calls on the CPU, on the (71, 61) set-up of
    ``tests/test_self_adjoint.py``: forward, adjoint and Born traces within
    1e-5 and the Jacobian adjoint within 3e-5 of the CPU's max."""
    from devito_fwi_tpu_torch.ops.sa_wavesolver import acoustic_sa_setup
    out = {}
    for dev in ("cuda", "cpu"):
        s = acoustic_sa_setup(shape=(71, 61), spacing=(10., 10.), tn=500.,
                              space_order=8, nbl=10, device=dev)
        dm = np.zeros(s.model.padded_shape, np.float32)
        dm[40:50, 30:40] = 0.1
        rec, u0, _ = s.forward(save=True)
        res = s.geometry.new_rec()
        res.data[:] = np.random.default_rng(1).standard_normal(
            res.data.shape)
        srca, _, _ = s.adjoint(res)
        born, _, _, _ = s.jacobian(dm)
        grad, _, _, _ = s.jacobian_adjoint(res, u0)
        assert u0.data.device.type == dev
        out[dev] = (rec.data.copy(), srca.data.copy(), born.data.copy(),
                    grad)
    for got, want, rtol in zip(out["cuda"], out["cpu"],
                               (1e-5, 1e-5, 1e-5, 3e-5)):
        _close_to_cpu(got, want, rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("habctype", [0, 1, 2, 3])
def test_abc_forwards_on_the_card_match_the_cpu(cuda, habctype):
    """The PML (``habctype`` 0 here) and HABC forwards on cuda against the
    CPU at float32 (margin 20 around a 101 x 101 interior with a fast
    block, tn 300 ms): traces within 1e-5 of the CPU's max."""
    from devito_fwi_tpu_torch.models.sources import RickerSource, TimeAxis
    from devito_fwi_tpu_torch.ops import abc
    from devito_fwi_tpu_torch.ops.interp import interp_table
    h, margin, n = 10.0, 20, 101
    v = abc.extend_velocity(np.full((n, n), 1.5, np.float32), margin)
    v[60:90, 40:] = 2.0
    dt = 0.4 * h / 2.0
    ta = TimeAxis(start=0.0, stop=300.0, step=dt)
    src = RickerSource(name="src", f0=0.015, time_range=ta,
                       coordinates=np.array([[n // 2 * h, 3 * h]]))
    rc = np.array([[n // 2 * h + 200.0, 400.0], [n // 2 * h - 300.0, 150.0]])
    si, sw = interp_table(src.coordinates, (-margin * h, 0.0), (h, h))
    ri, rw = interp_table(rc, (-margin * h, 0.0), (h, h))
    kw = dict(nt=ta.num, spacing=(h, h), npml=margin)
    out = []
    for dev in ("cuda", "cpu"):
        if habctype == 0:
            rec, _ = abc.pml_acoustic_forward(v, src.data, si, sw, ri, rw,
                                              dt, device=dev, **kw)
        else:
            rec, _ = abc.habc_acoustic_forward(v, src.data, si, sw, ri, rw,
                                               dt, habctype=habctype,
                                               device=dev, **kw)
        assert rec.device.type == dev
        out.append(rec)
    _close_to_cpu(out[0], out[1], 1e-5)


@pytest.mark.cuda
def test_viscoelastic_on_the_card_matches_the_cpu(cuda):
    """``ViscoelasticWaveSolver`` on cuda gives the reference goldens
    12.28040 / 0.312461 (atol 1e-3) and the CPU's traces within 1e-5 of
    their max; ``viscoelastic_value_and_grad`` on cuda (the (41, 36)
    set-up of ``tests/test_visco_grad.py`` at float32) the CPU's misfit
    within 1e-5 and five gradients within 3e-5 of their max."""
    from devito_fwi_tpu_torch.misfit import least_square_torch
    from devito_fwi_tpu_torch.models.geometry import setup_geometry
    from devito_fwi_tpu_torch.models.model import SeismicModel
    from devito_fwi_tpu_torch.ops import staggered_grad as sg
    from devito_fwi_tpu_torch.ops.elastic_wavesolver import (
        ViscoelasticWaveSolver)
    from devito_fwi_tpu_torch.ops.interp import interp_table
    recs = {}
    for dev in ("cuda", "cpu"):
        model = demo_model("layers-viscoelastic", space_order=4,
                           shape=(50, 50), nbl=40, spacing=(20., 20.))
        geometry = setup_geometry(model, 1000.)
        rec1, rec2, _, _, _ = ViscoelasticWaveSolver(
            model, geometry, space_order=4, device=dev).forward()
        recs[dev] = (rec1.data.copy(), rec2.data.copy())
    assert np.isclose(np.linalg.norm(recs["cuda"][0]), 12.28040, atol=1e-3,
                      rtol=0)
    assert np.isclose(np.linalg.norm(recs["cuda"][1]), 0.312461, atol=1e-3,
                      rtol=0)
    for got, want in zip(recs["cuda"], recs["cpu"]):
        _close_to_cpu(got, want, 1e-5)

    shape = (41, 36)
    vp = np.full(shape, 2.0, np.float32)
    vp[:, 18:] = 2.4
    vs = vp / 2
    rho = (0.31 * (1e3 * vp) ** 0.25).astype(np.float32)
    qp = np.full(shape, 60.0, np.float32)
    qs = np.full(shape, 40.0, np.float32)
    model = SeismicModel(origin=(0., 0.), spacing=(10., 10.), shape=shape,
                         space_order=4, vp=vp, vs=vs, b=1.0 / rho, qp=qp,
                         qs=qs, nbl=8, bcs="mask", dt=1.0)
    geom = AcquisitionGeometry(model, np.stack(
        [np.linspace(0., 400., 21), np.full(21, 30.0)], 1),
        np.array([[200., 20.0]]), 0., 140., f0=0.015, src_type="Ricker")
    s_idx, s_w = interp_table(geom.src_positions, model.origin_pml,
                              model.spacing)
    r_idx, r_w = interp_table(geom.rec_positions, model.origin_pml,
                              model.spacing)
    pads = tuple(tuple(p) for p in model.padsizes)
    phys = [np.pad(x, pads, mode="edge") for x in (vp, vs, rho, qp, qs)]
    obs = np.random.default_rng(2).standard_normal(
        (geom.nt, 21)).astype(np.float32) * 1e-3
    outs = {}
    for dev in ("cuda", "cpu"):
        T = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        f, grads, _, _ = sg.viscoelastic_value_and_grad(
            *[T(a) for a in phys], T(model.damp), geom.f0, T(geom.src.data),
            s_idx, s_w, r_idx, r_w, T(obs), torch.zeros_like(T(obs)),
            float(model.critical_dt), least_square_torch, nt=geom.nt,
            spacing=model.spacing, space_order=4)
        outs[dev] = (float(f), [g.cpu() for g in grads])
    assert abs(outs["cuda"][0] - outs["cpu"][0]) <= 1e-5 * abs(
        outs["cpu"][0])
    for got, want in zip(outs["cuda"][1], outs["cpu"][1]):
        _close_to_cpu(got, want, 3e-5)
