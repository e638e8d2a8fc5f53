"""The port's five 2-D acoustic sweeps (devito_fwi_tpu_torch.ops.
cuda_acoustic) against the JAX package, on the same inputs:

* the plain torch twins at float32 against the Pallas kernels run in
  interpret mode, at the tolerances of tests/test_pallas.py (receiver rows
  1e-5 of the max, illumination 1e-4, gradient 1e-5; the dt2 history
  1e-4; the segment-start pairs 1e-5);
* the checkpoint route's twins at float32 against the streamed route's:
  the same gradient bitwise (the recompute repeats the forward's steps
  from the state it saved);
* the twins at float64 against the XLA operators forward_ckpt /
  gradient_from_ckpt, to 1e-12 relative (the two associate the update
  differently, so they agree to f64 rounding, not bitwise);
* (tests/test_torch_cuda_kernels.py holds the CUDA kernels against the
  twins on the card.)

Small case: circle-isotropic 61x61, nbl=10, space_order=4, 2 shots,
n_checkpoints=7, with and without the free surface.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from devito_fwi_tpu.models.presets import demo_model
from devito_fwi_tpu.models.geometry import AcquisitionGeometry
from devito_fwi_tpu.fwi import (_batched_tables, _solver_dt, _pallas_operands,
                                _traces_from_rows)
from devito_fwi_tpu.ops import acoustic as ac
from devito_fwi_tpu.ops import pallas_acoustic as pa
from devito_fwi_tpu.ops.acoustic import _ckpt_layout

from devito_fwi_tpu_torch.ops import cuda_acoustic as ca
from devito_fwi_tpu_torch import fwi as tfwi

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


def _geometry(fs, dtype):
    model = demo_model("circle-isotropic", vp_circle=3.0, vp_background=2.5,
                       origin=(0., 0.), shape=(61, 61), spacing=(10., 10.),
                       nbl=10, space_order=4, fs=fs, dtype=dtype)
    nsrc, nrec = 2, 41
    # under fs the source sits within the first cell, so its corners touch
    # the z = 0 surface row
    zsrc = 2.0 if fs else 20.0
    src = np.stack([np.linspace(0., 600., nsrc), np.full(nsrc, zsrc)], 1)
    rec = np.stack([np.linspace(0., 600., nrec), np.full(nrec, 20.)], 1)
    return AcquisitionGeometry(model, rec, src, 0., 300., f0=0.010,
                               src_type="Ricker")


@functools.lru_cache(maxsize=None)
def _case(fs, dtype=np.float32):
    """Operands (numpy, transposed) and the JAX outputs for one case."""
    geom = _geometry(fs, dtype)
    model = geom.model
    s_idx, s_w, r_idx, r_w, wav = _batched_tables(geom)
    dt, nt = float(_solver_dt(geom)), geom.nt
    nsteps, seg, nseg = _ckpt_layout(nt, NCK)
    nx, nz = model.padded_shape
    z0 = int(np.asarray(r_idx)[..., 1].min())
    vp, damp = jnp.asarray(model.vp), jnp.asarray(model.damp)
    m, mT, hdT, injT, wav_pad = _pallas_operands(
        vp, damp, jnp.asarray(wav), jnp.asarray(s_idx), jnp.asarray(s_w),
        dt, nt, nseg * seg)
    kw = dict(nt=nt, nx=nx, nz=nz, space_order=4, spacing=model.spacing,
              z0=z0, n_checkpoints=NCK, fs=fs)
    rng = np.random.RandomState(0)
    statics = dict(nt=nt, spacing=model.spacing, space_order=4,
                   kernel="OT2", fs=fs)
    recs, seg_starts, illum = jax.vmap(
        lambda a, b: ac.forward_ckpt(vp, damp, jnp.asarray(wav), a, b,
                                     jnp.asarray(r_idx), jnp.asarray(r_w),
                                     dt, n_checkpoints=NCK, **statics))(
        jnp.asarray(s_idx), jnp.asarray(s_w))
    res = (np.asarray(recs) * 0.1
           + 0.01 * rng.randn(*recs.shape)).astype(dtype)
    out = dict(geom=geom, kw=kw, dt=dt, nsteps=nsteps, seg=seg, nseg=nseg,
               z0=z0, tables=(s_idx, s_w, r_idx, r_w, wav),
               mT=np.asarray(mT), hdT=np.asarray(hdT),
               injT=np.asarray(injT), wav_pad=np.asarray(wav_pad),
               m=np.asarray(m), res=res, recs=np.asarray(recs),
               illum=np.asarray(illum))
    if dtype == np.float32:
        rows = pa.residual_rows(jnp.asarray(res), jnp.asarray(r_idx),
                                jnp.asarray(r_w), m, dt * dt, z0, nsteps,
                                seg, nseg)
        out["res_rows"] = np.asarray(rows)
        jkw = dict(kw, interpret=True)
        out["pallas_rec"] = np.asarray(pa.forward_rec_segments(
            mT, hdT, wav_pad, injT, dt, **jkw))
        rec_rows, dt2, illumT = pa.forward_dt2_segments(
            mT, hdT, wav_pad, injT, dt, **jkw)
        out["pallas_dt2"] = (np.asarray(rec_rows), np.asarray(dt2),
                             np.asarray(illumT))
        out["pallas_grad"] = np.asarray(pa.gradient_stream_segments(
            mT, hdT, dt2, rows, dt, **jkw))
        rec_c, seg_c, illum_c = pa.forward_ckpt_segments(
            mT, hdT, wav_pad, injT, dt, **jkw)
        out["pallas_ckpt"] = (np.asarray(rec_c), np.asarray(seg_c),
                              np.asarray(illum_c))
        out["pallas_grad_seg"] = np.asarray(pa.gradient_segments(
            mT, hdT, wav_pad, injT, seg_c, rows, dt, **jkw))
    else:
        out["xla_grad"] = np.asarray(jax.vmap(
            lambda a, b, sg, r: ac.gradient_from_ckpt(
                vp, damp, jnp.asarray(wav), a, b, sg, r, jnp.asarray(r_idx),
                jnp.asarray(r_w), dt, n_checkpoints=NCK, **statics)[0])(
            jnp.asarray(s_idx), jnp.asarray(s_w), seg_starts,
            jnp.asarray(res)))
    return out


def _t(a, device="cpu"):
    return torch.tensor(np.asarray(a), device=device)


def _close(got, want, rtol):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rtol * scale, (err, scale)


# ---------------------------------------------------------------------------
# f32 twins vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fs", [False, True])
def test_forward_rec_twin_matches_pallas(fs):
    c = _case(fs)
    rows = ca.forward_rec_segments(_t(c["mT"]), _t(c["hdT"]),
                                   _t(c["wav_pad"]), _t(c["injT"]), c["dt"],
                                   **c["kw"])
    assert rows.shape == c["pallas_rec"].shape
    _close(rows, c["pallas_rec"], 1e-5)


@pytest.mark.parametrize("fs", [False, True])
def test_forward_dt2_twin_matches_pallas(fs):
    c = _case(fs)
    rows, dt2, illum = ca.forward_dt2_segments(
        _t(c["mT"]), _t(c["hdT"]), _t(c["wav_pad"]), _t(c["injT"]), c["dt"],
        **c["kw"])
    p_rows, p_dt2, p_illum = c["pallas_dt2"]
    _close(rows, p_rows, 1e-5)
    # dt2 = un - 2u + up cancels to ~1/50 of |u|, so the fields' f32
    # rounding differences weigh ~50x more against its max: 1e-4, as for
    # the illumination, another derived field
    _close(dt2, p_dt2, 1e-4)
    _close(illum, p_illum, 1e-4)


@pytest.mark.parametrize("fs", [False, True])
def test_gradient_stream_twin_matches_pallas(fs):
    c = _case(fs)
    dt2 = _t(c["pallas_dt2"][1])
    grad = ca.gradient_stream_segments(_t(c["mT"]), _t(c["hdT"]), dt2,
                                       _t(c["res_rows"]), c["dt"], **c["kw"])
    _close(grad, c["pallas_grad"], 1e-5)


@pytest.mark.parametrize("fs", [False, True])
def test_forward_ckpt_twin_matches_pallas(fs):
    c = _case(fs)
    rows, pairs, illum = ca.forward_ckpt_segments(
        _t(c["mT"]), _t(c["hdT"]), _t(c["wav_pad"]), _t(c["injT"]), c["dt"],
        **c["kw"])
    p_rows, p_pairs, p_illum = c["pallas_ckpt"]
    assert pairs.shape == p_pairs.shape
    _close(rows, p_rows, 1e-5)
    _close(pairs, p_pairs, 1e-5)
    _close(illum, p_illum, 1e-4)


@pytest.mark.parametrize("fs", [False, True])
def test_gradient_segments_twin_matches_pallas(fs):
    c = _case(fs)
    grad = ca.gradient_segments(
        _t(c["mT"]), _t(c["hdT"]), _t(c["wav_pad"]), _t(c["injT"]),
        _t(c["pallas_ckpt"][1]), _t(c["res_rows"]), c["dt"], **c["kw"])
    _close(grad, c["pallas_grad_seg"], 1e-5)


@pytest.mark.parametrize("fs", [False, True])
def test_recompute_gradient_equals_streamed(fs):
    c = _case(fs)
    ops = (_t(c["mT"]), _t(c["hdT"]), _t(c["wav_pad"]), _t(c["injT"]),
           c["dt"])
    rows, dt2, illum = ca.forward_dt2_segments(*ops, **c["kw"])
    rows_c, pairs, illum_c = ca.forward_ckpt_segments(*ops, **c["kw"])
    assert torch.equal(rows, rows_c) and torch.equal(illum, illum_c)
    res = _t(c["res_rows"])
    streamed = ca.gradient_stream_segments(ops[0], ops[1], dt2, res,
                                           c["dt"], **c["kw"])
    ca.reset_counters()
    recomputed = ca.gradient_segments(*ops[:4], pairs, res, c["dt"],
                                      **c["kw"])
    assert ca.TWIN_CALLS["gradient_segments"] == 1
    assert torch.equal(streamed, recomputed)


@pytest.mark.parametrize("fs", [False, True])
def test_operands_match_jax(fs):
    """source_pattern, pad_wavelet, residual_rows and the trace assembly
    of the port == the JAX package's, on the same tables."""
    c = _case(fs)
    s_idx, s_w, r_idx, r_w, wav = c["tables"]
    m = _t(c["m"])
    inj = ca.source_pattern(s_idx, s_w, m, c["dt"] * c["dt"])
    _close(inj.transpose(-1, -2), c["injT"], 1e-7)
    _close(ca.pad_wavelet(_t(wav), c["kw"]["nt"], c["nseg"] * c["seg"]),
           c["wav_pad"], 0)
    rows = ca.residual_rows(_t(c["res"]), r_idx, _t(r_w), m,
                            c["dt"] * c["dt"], c["z0"], c["nsteps"], c["seg"],
                            c["nseg"])
    _close(rows, c["res_rows"], 1e-6)
    nx = c["kw"]["nx"]
    W = ca.receiver_plane_matrix(r_idx, _t(r_w), c["z0"], nx).T
    tr = tfwi._traces_from_rows(_t(c["pallas_rec"]), W, c["kw"]["nt"],
                                c["nsteps"])
    want = np.asarray(_traces_from_rows(
        jnp.asarray(c["pallas_rec"]), jnp.asarray(r_idx), jnp.asarray(r_w),
        c["z0"], c["kw"]["nt"], c["nsteps"], jnp.float32))
    _close(tr, want, 1e-6)


# ---------------------------------------------------------------------------
# f64 twins vs the XLA operators
# ---------------------------------------------------------------------------

def _f64_forward(fs):
    c = _case(fs, np.float64)
    s_idx, s_w, r_idx, r_w, wav = c["tables"]
    m = _t(c["m"])
    injT = ca.source_pattern(s_idx, s_w, m, c["dt"] * c["dt"]).transpose(
        -1, -2).contiguous()
    wav_pad = ca.pad_wavelet(_t(wav), c["kw"]["nt"], c["nseg"] * c["seg"])
    rows, dt2, illumT = ca.forward_dt2_segments(
        _t(c["mT"]), _t(c["hdT"]), wav_pad, injT, c["dt"], **c["kw"])
    W = ca.receiver_plane_matrix(r_idx, _t(r_w), c["z0"],
                                 c["kw"]["nx"]).T
    return c, injT, wav_pad, rows, dt2, illumT, W


@pytest.mark.parametrize("fs", [False, True])
def test_forward_twins_match_xla_f64(fs):
    c, injT, wav_pad, rows, dt2, illumT, W = _f64_forward(fs)
    nt, nsteps = c["kw"]["nt"], c["nsteps"]
    _close(tfwi._traces_from_rows(rows, W, nt, nsteps), c["recs"], 1e-12)
    _close(illumT.transpose(-1, -2), c["illum"], 1e-12)
    rec_only = ca.forward_rec_segments(_t(c["mT"]), _t(c["hdT"]), wav_pad,
                                       injT, c["dt"], **c["kw"])
    assert torch.equal(rec_only, rows)


@pytest.mark.parametrize("fs", [False, True])
def test_gradient_twin_matches_xla_f64(fs):
    c, injT, wav_pad, rows, dt2, illumT, W = _f64_forward(fs)
    s_idx, s_w, r_idx, r_w, wav = c["tables"]
    res_rows = ca.residual_rows(_t(c["res"]), r_idx, _t(r_w), _t(c["m"]),
                                c["dt"] * c["dt"], c["z0"], c["nsteps"],
                                c["seg"], c["nseg"])
    grad = ca.gradient_stream_segments(_t(c["mT"]), _t(c["hdT"]), dt2,
                                       res_rows, c["dt"], **c["kw"])
    _close(grad.transpose(-1, -2), c["xla_grad"], 1e-12)


# ---------------------------------------------------------------------------
# dispatch: CPU tensors take the twin, bad operands raise
# ---------------------------------------------------------------------------

def test_cpu_tensors_run_the_twins():
    c = _case(False)
    ca.reset_counters()
    ca.forward_rec_segments(_t(c["mT"]), _t(c["hdT"]), _t(c["wav_pad"]),
                            _t(c["injT"]), c["dt"], **c["kw"])
    assert ca.TWIN_CALLS["forward_rec_segments"] == 1
    assert sum(ca.LAUNCHES.values()) == 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "z0"])
def test_wrappers_reject_bad_operands(bad):
    c = _case(False)
    mT, hdT, wav, injT = (_t(c["mT"]), _t(c["hdT"]), _t(c["wav_pad"]),
                          _t(c["injT"]))
    kw = dict(c["kw"])
    if bad == "dtype":
        hdT = hdT.to(torch.float16)
    elif bad == "shape":
        injT = injT[:, :-1]
    elif bad == "contiguous":
        injT = _t(c["injT"]).transpose(-1, -2).contiguous() \
            .transpose(-1, -2)
    else:
        kw["z0"] = kw["nz"] - 1
    with pytest.raises((TypeError, ValueError)):
        ca.forward_rec_segments(mT, hdT, wav, injT, c["dt"], **kw)


@pytest.mark.parametrize("tf32", [False, True])
def test_matmul_full_restores_precision_flags(tf32):
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = mm.allow_tf32, dnn.allow_tf32
    try:
        mm.allow_tf32 = dnn.allow_tf32 = tf32
        rng = np.random.default_rng(0)
        a = torch.as_tensor(rng.standard_normal((3, 5)))
        b = torch.as_tensor(rng.standard_normal((5, 4)))
        assert torch.equal(ca.matmul_full(a, b), a @ b)
        assert (mm.allow_tf32, dnn.allow_tf32) == (tf32, tf32)
    finally:
        mm.allow_tf32, dnn.allow_tf32 = saved


# ---------------------------------------------------------------------------
# the card's fused forward tile (csrc/acoustic2d.cu forward_tile), replayed
# ---------------------------------------------------------------------------

def _lap_tile(P, rows, cols, gz0, w, inv_h2x, inv_h2z, fs):
    """Laplacian on the rows x cols region of a padded tile P (B, Z, X),
    whose local row i is global row i + gz0: the kernel's laplacian_tile,
    term for term (x term first, the odd mirror on global rows 0..r)."""
    r = len(w) - 1
    (z0, z1), (x0, x1) = rows, cols
    c = P[:, z0:z1, x0:x1]
    accx = w[0] * c
    for k in range(1, r + 1):
        accx = accx + w[k] * (P[:, z0:z1, x0 + k:x1 + k]
                              + P[:, z0:z1, x0 - k:x1 - k])
    accz = w[0] * c
    for k in range(1, r + 1):
        accz = accz + w[k] * (P[:, z0 + k:z1 + k, x0:x1]
                              + P[:, z0 - k:z1 - k, x0:x1])
    if fs:
        accz = accz.clone()
        for i in range(z0, z1):
            z = i + gz0
            if not 0 <= z <= r:
                continue
            acc = w[0] * P[:, i, x0:x1]
            for k in range(1, r + 1):
                acc = acc + w[k] * P[:, i + k, x0:x1]
                if z - k > 0:
                    acc = acc + w[k] * P[:, i - k, x0:x1]
                elif z - k < 0:
                    acc = acc - w[k] * P[:, i + k - 2 * z, x0:x1]
            accz[:, i - z0] = acc
    return accx * inv_h2x + accz * inv_h2z


def _fused_forward_replay(m, two_m_hd, denom, wav_pad, inj, *, w, inv_h2x,
                          inv_h2z, nsteps, seg, z0, fs, hist, ckpt):
    """A torch replay of the card's fused forward (csrc/acoustic2d.cu
    forward_tile) in its order: two steps a launch over ca.FWD_TILE tiles,
    u on the tile and a 2r halo, step t on the tile and an r halo (zero
    beyond the grid), step t + 1 on the tile from it, the source added only
    at inj's non-zero cells (``_source_list``), the new pair into two fresh
    buffers; an odd last step one single-step launch over an r halo. The
    halo corners the kernel never reads hold NaN here, so a read of one
    would show."""
    B, nz, nx = inj.shape
    total = wav_pad.shape[0]
    r = len(w) - 1
    tx, tz = ca.FWD_TILE
    cells, vals, _ = ca._source_list(inj)
    lap = functools.partial(_lap_tile, w=w, inv_h2x=inv_h2x,
                            inv_h2z=inv_h2z, fs=fs)
    nan = float("nan")

    def padded(f, xt, zt, h, e):
        """f on the tile at (xt, zt) and an h halo, zero beyond the grid,
        NaN where both axes are more than e outside the tile."""
        P = f.new_zeros((f.shape[0], tz + 2 * h, tx + 2 * h))
        za, zb = max(zt - h, 0), min(zt + tz + h, nz)
        xa, xb = max(xt - h, 0), min(xt + tx + h, nx)
        P[:, za - zt + h:zb - zt + h, xa - xt + h:xb - xt + h] = \
            f[:, za:zb, xa:xb]
        lz = torch.arange(tz + 2 * h)
        lx = torch.arange(tx + 2 * h)
        dz = torch.clamp(torch.maximum(h - lz, lz - h - tz + 1), min=0)
        dx = torch.clamp(torch.maximum(h - lx, lx - h - tx + 1), min=0)
        P[:, (dz[:, None] > e) & (dx[None, :] > e)] = nan
        return P

    def region(f, xt, zt, h):
        """f (nz, nx) or (B, nz, nx) on the tile and an h halo, zero beyond
        the grid."""
        g = f if f.dim() == 3 else f[None]
        return padded(g, xt, zt, h, h)

    def add_source(v, xt, zt, h, wt):
        for b, slot in (cells >= 0).nonzero().tolist():
            gz, gx = divmod(int(cells[b, slot]), nx)
            lz, lx = gz - zt + h, gx - xt + h
            if 0 <= lz < v.shape[1] and 0 <= lx < v.shape[2]:
                v[b, lz, lx] = v[b, lz, lx] + wt * vals[b, slot]

    def step(P, h, xt, zt, up, t):
        """The update on the tile and an h - r halo of the tile at (xt, zt)
        from the padded u (halo h) and up, zero beyond the grid."""
        e = h - r
        sl = (r, r + tz + 2 * e), (r, r + tx + 2 * e)
        un = (lap(P, *sl, gz0=zt - h) + region(two_m_hd, xt, zt, e)
              * P[:, sl[0][0]:sl[0][1], sl[1][0]:sl[1][1]]
              - region(m, xt, zt, e) * region(up, xt, zt, e)) \
            * region(denom, xt, zt, e)
        inside = region(torch.ones_like(m), xt, zt, e)[0] == 1
        un = torch.where(inside, un, torch.zeros((), dtype=un.dtype))
        add_source(un, xt, zt, e, wav_pad[t])
        # the corners of step t's halo, which the kernel does not form
        lz = torch.arange(tz + 2 * e)
        lx = torch.arange(tx + 2 * e)
        out_z = (lz < e) | (lz >= e + tz)
        out_x = (lx < e) | (lx >= e + tx)
        un[:, out_z[:, None] & out_x[None, :]] = nan
        return un

    u = inj.new_zeros((B, nz, nx))
    up = inj.new_zeros((B, nz, nx))
    rec = inj.new_empty((B, total, 2, nx))
    dt2 = inj.new_empty((B, total, nz, nx)) if hist else None
    pairs = inj.new_empty((B, total // seg, 2, nz, nx)) if ckpt else None
    illum = inj.new_zeros((B, nz, nx)) if hist or ckpt else None
    t = 0
    while t < total:
        two = t + 1 < total
        nu, nup = inj.new_empty((B, nz, nx)), inj.new_empty((B, nz, nx))
        for zt in range(0, nz, tz):
            for xt in range(0, nx, tx):
                zs = slice(zt, min(zt + tz, nz))
                xs = slice(xt, min(xt + tx, nx))
                own = (slice(None), zs, xs)
                n_z, n_x = zs.stop - zs.start, xs.stop - xs.start
                h = 2 * r if two else r
                P = padded(u, xt, zt, h, h - r)
                un = step(P, h, xt, zt, up, t)
                uc, upc = u[own], up[own]
                e = h - r
                un_own = un[:, e:e + n_z, e:e + n_x]
                steps = [(t, uc, upc, un_own)]
                if two:
                    unn = step(un, r, xt, zt, u, t + 1)
                    steps.append((t + 1, un_own, uc, unn[:, :n_z, :n_x]))
                for ts, a, b_, c in steps:
                    if zt <= z0 < zt + n_z:
                        rec[:, ts, 0, xs] = a[:, z0 - zt]
                    if zt <= z0 + 1 < zt + n_z:
                        rec[:, ts, 1, xs] = a[:, z0 + 1 - zt]
                    if ckpt and ts % seg == 0:
                        pairs[:, ts // seg, 0, zs, xs] = a
                        pairs[:, ts // seg, 1, zs, xs] = b_
                    if hist:
                        dt2[:, ts, zs, xs] = c - 2.0 * a + b_
                    if illum is not None and ts < nsteps:
                        illum[own] = illum[own] + c * c
                nup[own] = un_own
                nu[own] = steps[-1][3]
        if two:
            u, up = nu, nup
        else:
            u, up = nu, u
        t += 2 if two else 1
    return rec, dt2 if hist else pairs, illum


@pytest.mark.parametrize("fs", [False, True])
@pytest.mark.parametrize("form", ["rec", "dt2", "ckpt"])
@pytest.mark.parametrize("n", [40, 35])
def test_fused_forward_replay_equals_twin_bitwise(fs, form, n):
    """The fused forward's order (two steps a launch over 32 x 32 tiles
    with a 2r halo, the source at its cells, an odd step count ending on a
    single step) gives the dense-pattern twin's outputs bit for bit at
    float32 on the small case, for each of the three forms (receiver rows;
    the history with the illumination; the segment pairs with the
    illumination), with and without the free surface. The illumination
    stops at nsteps = n - 3, so one two-step launch straddles it."""
    c = _case(fs)
    kw = c["kw"]
    w, inv_h2x, inv_h2z, _ = ca._stencil_constants(4, kw["spacing"],
                                                   c["dt"])
    mT, hdT = _t(c["mT"]), _t(c["hdT"])
    denom, two_m_hd = 1.0 / (mT + hdT), 2.0 * mT + hdT
    fkw = dict(w=w, inv_h2x=inv_h2x, inv_h2z=inv_h2z, nsteps=n - 3,
               seg=(8 if n % 2 == 0 else 7) if form == "ckpt" else n,
               z0=c["z0"], fs=fs, hist=form == "dt2", ckpt=form == "ckpt")
    ops = (mT, two_m_hd, denom, _t(c["wav_pad"])[:n], _t(c["injT"]))
    got = _fused_forward_replay(*ops, **fkw)
    want = ca._forward_plain(*ops, **fkw)
    for g, w_ in zip(got, want):
        if w_ is not None:
            assert torch.equal(g, w_)
            assert float(w_.abs().max()) > 0


@pytest.mark.parametrize("B,nz,nx,r,smem,grid", [
    (29, 186, 380, 4, 15_616, (29, 12, 6)),     # the SMARMN main path
    (29, 186, 380, 8, 25_600, (29, 12, 6)),
    (1, 1, 1, 1, 9_808, (1, 1, 1)),
])
def test_forward_launch_fits_shared_memory(B, nz, nx, r, smem, grid):
    """The fused forward's launch at the SMARMN main path (29 shots,
    186 x 380 padded, space order 8), at the largest radius the kernel
    takes and at the smallest case: 32 x 32 tiles, 512 threads, two steps
    a launch, the shots the fastest grid axis, within a block's 232,448
    bytes (and the 48 KB of a static launch)."""
    launch = ca.forward_launch(B, nz, nx, r)
    assert launch.smem == smem <= 48 * 1024 <= ca.SMEM_LIMIT
    assert launch.grid == grid
    assert launch.tile == (32, 32) and launch.threads == 512
    assert launch.steps == 2


@pytest.mark.parametrize("args", [
    (29, 186, 380, 0), (29, 186, 380, 9), (0, 186, 380, 4),
    (29, 0, 380, 4), (29, 186, 0, 4), (1, 2 ** 16, 2 ** 15, 4),
    (1, 1, 32 * 2 ** 16, 4), (1, 32 * 2 ** 16, 1, 4)])
def test_forward_launch_refuses_what_the_kernel_does_not_take(args):
    """Beyond radius 8, an empty grid, 2^31 cells or 65,536 tiles along an
    axis: the helper raises, so the wrapper launches nothing."""
    with pytest.raises(ValueError):
        ca.forward_launch(*args)


def _tile_reverse_replay(m, two_m_hd, denom, dt2, res, *, w, inv_h2x,
                         inv_h2z, nsteps, z0, fs, neg_inv_s2):
    """A torch replay of the card's reverse sweep (csrc/acoustic2d.cu
    adjoint_tile) in its order: two steps t, t - 1 a launch over
    ca.FWD_TILE tiles, v on the tile and a 2r halo (zero beyond the grid,
    the corners it never reads NaN), step t on the tile and an r halo with
    the residual rows of step t added there too (zero beyond the grid, the
    halo's corners NaN), step t - 1 on the tile from it; grad + dt2[t] v,
    then + dt2[t - 1] v_t, times -1/s^2 on the sweep's last step before it
    is stored; an odd last step one launch of the first design's step.
    The new pair goes to two fresh buffers."""
    B, _, nz, nx = dt2.shape
    r = len(w) - 1
    tx, tz = ca.FWD_TILE
    lap = functools.partial(_lap_tile, w=w, inv_h2x=inv_h2x,
                            inv_h2z=inv_h2z, fs=fs)
    lap_t = ca._make_lap_t(w, inv_h2x, inv_h2z, fs)
    nan = float("nan")

    def padded(f, xt, zt, h, e):
        """f on the tile at (xt, zt) and an h halo, zero beyond the grid,
        NaN where both axes are more than e outside the tile."""
        g = f if f.dim() == 3 else f[None]
        P = g.new_zeros((g.shape[0], tz + 2 * h, tx + 2 * h))
        za, zb = max(zt - h, 0), min(zt + tz + h, nz)
        xa, xb = max(xt - h, 0), min(xt + tx + h, nx)
        P[:, za - zt + h:zb - zt + h, xa - xt + h:xb - xt + h] = \
            g[:, za:zb, xa:xb]
        lz = torch.arange(tz + 2 * h)
        lx = torch.arange(tx + 2 * h)
        dz = torch.clamp(torch.maximum(h - lz, lz - h - tz + 1), min=0)
        dx = torch.clamp(torch.maximum(h - lx, lx - h - tx + 1), min=0)
        P[:, (dz[:, None] > e) & (dx[None, :] > e)] = nan
        return P

    def step(P, h, xt, zt, vn, t):
        """Reverse step t on the tile and an h - r halo of the tile at (xt,
        zt) from the padded v (halo h) and vn: the update, zero beyond the
        grid, the residual rows of step t added."""
        e = h - r
        sl = (r, r + tz + 2 * e), (r, r + tx + 2 * e)
        vc = P[:, sl[0][0]:sl[0][1], sl[1][0]:sl[1][1]]
        out = (lap(P, *sl, gz0=zt - h) + padded(two_m_hd, xt, zt, e, e) * vc
               - padded(m, xt, zt, e, e) * padded(vn, xt, zt, e, e)) \
            * padded(denom, xt, zt, e, e)
        inside = padded(torch.ones_like(m), xt, zt, e, e)[0] == 1
        out = torch.where(inside, out, torch.zeros((), dtype=out.dtype))
        for k in range(2):
            lz = z0 + k - zt + e
            xa, xb = max(xt - e, 0), min(xt + tx + e, nx)
            if 0 <= lz < out.shape[1] and 0 <= z0 + k < nz:
                cols = slice(xa - xt + e, xb - xt + e)
                out[:, lz, cols] = out[:, lz, cols] + res[:, t, k, xa:xb]
        lz = torch.arange(tz + 2 * e)
        lx = torch.arange(tx + 2 * e)
        out_z = (lz < e) | (lz >= e + tz)
        out_x = (lx < e) | (lx >= e + tx)
        out[:, out_z[:, None] & out_x[None, :]] = nan
        return out

    v = dt2.new_zeros((B, nz, nx))
    vn = dt2.new_zeros((B, nz, nx))
    grad = dt2.new_zeros((B, nz, nx))
    t = nsteps - 1
    while t - 1 >= 0:
        nv, nvn = torch.empty_like(v), torch.empty_like(v)
        for zt in range(0, nz, tz):
            for xt in range(0, nx, tx):
                zs = slice(zt, min(zt + tz, nz))
                xs = slice(xt, min(xt + tx, nx))
                own = (slice(None), zs, xs)
                n_z, n_x = zs.stop - zs.start, xs.stop - xs.start
                va = step(padded(v, xt, zt, 2 * r, r), 2 * r, xt, zt, vn, t)
                vb = step(va, r, xt, zt, v, t - 1)
                va_own = va[:, r:r + n_z, r:r + n_x]
                g = grad[own] + dt2[:, t][own] * v[own]
                g = g + dt2[:, t - 1][own] * va_own
                grad[own] = g * neg_inv_s2 if t - 1 == 0 else g
                nvn[own] = va_own
                nv[own] = vb[:, :n_z, :n_x]
        v, vn = nv, nvn
        t -= 2
    if t == 0:
        g = grad + dt2[:, 0] * v
        grad = g * neg_inv_s2
    return grad


@pytest.mark.parametrize("fs", [False, True])
@pytest.mark.parametrize("n", [40, 35])
def test_tile_reverse_replay_equals_twin_bitwise(fs, n):
    """The reverse sweep's order (two steps a launch over 32 x 32 tiles
    with a 2r halo, the residual rows added in step t's halo too, grad
    summed twice in registers and scaled on the last step; an odd step
    count ending on one step of the first design) gives the twin's
    gradient bit for bit at float32 on the small case, with and without
    the free surface (the receiver rows cross the x halos of the tiles
    beside the ones that own them)."""
    c = _case(fs)
    kw = c["kw"]
    w, inv_h2x, inv_h2z, s2 = ca._stencil_constants(4, kw["spacing"],
                                                    c["dt"])
    mT, hdT = _t(c["mT"]), _t(c["hdT"])
    denom, two_m_hd = 1.0 / (mT + hdT), 2.0 * mT + hdT
    B, nseg, seg = 2, c["nseg"], c["seg"]
    dt2 = ca.forward_dt2_plain(mT, hdT, _t(c["wav_pad"]), _t(c["injT"]),
                               c["dt"], **kw)[1].reshape(B, nseg * seg,
                                                         *mT.shape)
    res = _t(c["res_rows"]).reshape(B, nseg * seg, 2, -1)
    common = dict(w=w, inv_h2x=inv_h2x, inv_h2z=inv_h2z, fs=fs, nsteps=n,
                  z0=c["z0"], neg_inv_s2=-1.0 / s2)
    want = ca._adjoint_plain(mT, two_m_hd, denom, dt2, res, **common)
    got = _tile_reverse_replay(mT, two_m_hd, denom, dt2, res, **common)
    assert torch.equal(got, want)
    assert float(want.abs().max()) > 0 and bool(want.isfinite().all())


def test_adjoint_launch_at_the_main_path():
    """The reverse sweep's launch at the SMARMN main path (29 shots, 186 x
    380 padded, space order 8) is the forward tile's in reverse: 32 x 32
    tiles, 512 threads, two steps a launch, the shots the fastest grid
    axis, the forward's shared memory."""
    launch = ca.adjoint_launch(29, 186, 380, 4)
    assert launch.tile == (32, 32) and launch.threads == 512
    assert launch.grid == (29, 12, 6) and launch.steps == 2
    assert launch.smem == ca.forward_launch(29, 186, 380, 4).smem == 15_616


@pytest.mark.parametrize("args", [
    (29, 186, 380, 0), (29, 186, 380, 9), (0, 186, 380, 4),
    (29, 0, 380, 4), (29, 186, 0, 4), (1, 2 ** 16, 2 ** 15, 4),
    (1, 1, 32 * 2 ** 16, 4)])
def test_adjoint_launch_refuses_what_the_kernel_does_not_take(args):
    """Beyond radius 8, an empty grid, 2^31 cells a shot or 65,536 tiles
    along an axis: the helper raises, naming the reverse sweep."""
    with pytest.raises(ValueError, match="acoustic adjoint"):
        ca.adjoint_launch(*args)


@pytest.mark.parametrize("route", ["stream", "checkpoint"])
def test_reverse_refuses_before_it_builds(route):
    """Both reverse sweeps ask the launch helper before they build or
    allocate anything: radius 9 raises ValueError here, where building
    the library would raise RuntimeError (no nvcc)."""
    big = torch.zeros(()).expand
    kw = dict(w=(0.0,) * 10, inv_h2x=1.0, inv_h2z=1.0, nsteps=1, z0=0,
              fs=False, neg_inv_s2=-1.0)
    with pytest.raises(ValueError):
        if route == "stream":
            ca._adjoint_cuda(None, None, None, big(1, 1, 4, 8), None, **kw)
        else:
            ca._segments_cuda(None, None, None, None, None,
                              big(1, 1, 2, 4, 8), None, seg=1, **kw)
