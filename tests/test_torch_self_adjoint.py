"""The port's self-adjoint visco-acoustic system
(``devito_fwi_tpu_torch.ops.self_adjoint`` and ``ops.sa_wavesolver``) on the
CPU: every check of ``tests/test_self_adjoint.py`` on the port (float64,
space order 8, the reference's tolerances: skew symmetry, the w/Q field,
the F and J linearity and adjoint dot tests, the Born slopes, the 3-D smoke
and the Hankel far field), and the four operators against the JAX
functions on the same inputs at float64 within 1e-12 relative (of each
output's max)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from devito_fwi_tpu.ops import self_adjoint as jsa
from devito_fwi_tpu.ops.sa_wavesolver import acoustic_sa_setup as j_setup

from devito_fwi_tpu_torch.ops import self_adjoint as sa
from devito_fwi_tpu_torch.ops.interp import interp_table
from devito_fwi_tpu_torch.ops.sa_wavesolver import acoustic_sa_setup


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this module runs: the suite runs several
    pytest workers on one machine, and torch's thread pool in each of them
    (as many threads as cores) oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _setup(shape=(71, 61), tn=500.):
    return acoustic_sa_setup(shape=shape, spacing=(10.,) * len(shape),
                             tn=tn, space_order=8, nbl=10,
                             dtype=np.float64, device="cpu")


def _box_dm(model, size=5, seed=0):
    np.random.seed(seed)
    dm = np.zeros(model.padded_shape, dtype=np.float64)
    ns = 2 * size + 1
    ctr = [n // 2 for n in model.padded_shape]
    sl = tuple(slice(c - size, c + size + 1) for c in ctr)
    dm[sl] = -1 + 2 * np.random.rand(*([ns] * model.dim))
    return dm


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


# ---------------------------------------------------------------------------
# against the JAX functions
# ---------------------------------------------------------------------------

def test_setup_matches_the_jax_setup():
    """``acoustic_sa_setup`` builds the JAX set-up's model (vp, b, the w/Q
    field), dt (scaled by 0.6) and geometry."""
    t, j = _setup(), j_setup(shape=(71, 61), spacing=(10., 10.), tn=500.,
                             space_order=8, nbl=10, dtype=np.float64)
    for name in ("vp", "b", "damp"):
        assert np.array_equal(getattr(t.model, name), getattr(j.model, name))
    assert t.dt == j.dt and t.nt == j.nt
    assert np.array_equal(t.geometry.src.data, j.geometry.src.data)
    assert np.array_equal(t.geometry.rec_positions, j.geometry.rec_positions)


def test_operators_match_the_jax_functions():
    """``forward`` (with the saved history), ``adjoint``, ``born`` and
    ``jacobian_adjoint`` on the (71, 61) set-up, a heterogeneous vp, seeded
    receiver data and a seeded box perturbation: each output within 1e-12
    of its max of the JAX function's (measured 3.2e-15)."""
    s = _setup()
    m = s.model
    rng = np.random.default_rng(4)
    vp = np.asarray(m.vp, np.float64) + 0.2 * (
        np.arange(m.padded_shape[1]) > 45)[None, :]
    b = np.asarray(m.b, np.float64)
    woq = np.asarray(m.damp, np.float64)
    dm = _box_dm(m)
    s_idx, s_w = interp_table(s.geometry.src_positions, m.origin_pml,
                              m.spacing, dtype=np.float64)
    r_idx, r_w = interp_table(s.geometry.rec_positions, m.origin_pml,
                              m.spacing, dtype=np.float64)
    wav = np.asarray(s.geometry.src.data, np.float64)
    data = rng.standard_normal((s.nt, r_idx.shape[0]))
    kw = dict(nt=s.nt, spacing=m.spacing, space_order=8)
    J, T = jnp.asarray, torch.as_tensor
    jargs = (J(vp), J(b), J(woq))
    targs = (T(vp), T(b), T(woq))

    jrec, ju = jsa.forward(*jargs, J(wav), J(s_idx), J(s_w), J(r_idx),
                           J(r_w), s.dt, save=True, **kw)
    trec, tu = sa.forward(*targs, T(wav), s_idx, s_w, r_idx, r_w, s.dt,
                          save=True, **kw)
    assert _rel(trec, jrec) <= 1e-12 and _rel(tu, ju) <= 1e-12
    assert not trec[0].any() and not trec[-1].any()
    assert not tu[:2].any()
    _, jlast = jsa.forward(*jargs, J(wav), J(s_idx), J(s_w), J(r_idx),
                           J(r_w), s.dt, **kw)
    _, tlast = sa.forward(*targs, T(wav), s_idx, s_w, r_idx, r_w, s.dt,
                          **kw)
    assert _rel(tlast, jlast) <= 1e-12

    jsrc, jv = jsa.adjoint(*jargs, J(data), J(r_idx), J(r_w), J(s_idx),
                           J(s_w), s.dt, **kw)
    tsrc, tv = sa.adjoint(*targs, T(data), r_idx, r_w, s_idx, s_w, s.dt,
                          **kw)
    assert _rel(tsrc, jsrc) <= 1e-12 and _rel(tv, jv) <= 1e-12

    jb, ju0 = jsa.born(*jargs, J(dm), J(wav), J(s_idx), J(s_w), J(r_idx),
                       J(r_w), s.dt, save=True, **kw)
    tb, tu0 = sa.born(*targs, T(dm), T(wav), s_idx, s_w, r_idx, r_w, s.dt,
                      save=True, **kw)
    assert _rel(tb, jb) <= 1e-12 and _rel(tu0, ju0) <= 1e-12

    jg, _ = jsa.jacobian_adjoint(*jargs, ju0, J(data), J(r_idx), J(r_w),
                                 s.dt, **kw)
    tg, _ = sa.jacobian_adjoint(*targs, tu0, T(data), r_idx, r_w, s.dt,
                                **kw)
    assert _rel(tg, jg) <= 1e-12


def test_operators_follow_their_inputs_type():
    """At float32 the operators run and return float32 (the type of the
    card's runs), within 1e-5 of the float64 result's max."""
    s = _setup(tn=200.)
    rec64, _, _ = s.forward()
    r64 = rec64.data.copy()
    m = s.model
    s_idx, s_w = interp_table(s.geometry.src_positions, m.origin_pml,
                              m.spacing)
    r_idx, r_w = interp_table(s.geometry.rec_positions, m.origin_pml,
                              m.spacing)
    f32 = [torch.as_tensor(np.asarray(a, np.float32))
           for a in (m.vp, m.b, m.damp, s.geometry.src.data)]
    rec, _ = sa.forward(*f32, s_idx, s_w, r_idx, r_w, s.dt, nt=s.nt,
                        spacing=m.spacing, space_order=8)
    assert rec.dtype == torch.float32
    assert _rel(rec.numpy(), r64) <= 1e-5


# ---------------------------------------------------------------------------
# the JAX package's checks (reference test_wavesolver_iso.py), on the port
# ---------------------------------------------------------------------------

def test_derivative_skew_symmetry():
    np.random.seed(0)
    n = 101
    f1 = -1 + 2 * np.random.rand(n)
    g1 = -1 + 2 * np.random.rand(n)
    wp, op, wm, om = sa.staggered_weights(8)
    f2 = sa.shifted_derivative(torch.as_tensor(f1), torch.as_tensor(wp), op,
                               0, 1.0).numpy()
    g2 = sa.shifted_derivative(torch.as_tensor(g1), torch.as_tensor(wm), om,
                               0, 1.0).numpy()
    f1g2 = np.dot(f1, g2)
    g1f2 = np.dot(g1, f2)
    diff = (f1g2 + g1f2) / (f1g2 - g1f2)
    assert np.isclose(diff, 0.0, atol=1e-12)


@pytest.mark.parametrize("shape, npad", [((41, 31), 5), ((21, 21, 21), 4)])
def test_w_over_q(shape, npad):
    """The w/Q field: w/qmax inside, w/qmin at the corner, monotone into the
    interior; and the JAX function's array, bitwise (with and without the
    Gaussian smoothing)."""
    w, qmin, qmax = 2 * np.pi * 0.01, 0.1, 100.0
    woq = sa.setup_w_over_q(shape, w, qmin, qmax, npad, dtype=np.float64)
    interior = tuple(slice(npad, n - npad) for n in shape)
    assert np.allclose(woq[interior], w / qmax, rtol=1e-6)
    assert np.isclose(woq.flat[0], w / qmin, rtol=1e-6)
    mid = tuple(n // 2 for n in shape[1:])
    line = woq[(slice(0, npad + 1),) + mid]
    assert np.all(np.diff(line) <= 1e-12)
    for sigma in (0, 2):
        assert np.array_equal(
            sa.setup_w_over_q(shape, w, qmin, qmax, npad, sigma=sigma),
            jsa.setup_w_over_q(shape, w, qmin, qmax, npad, sigma=sigma))
    with pytest.raises(ValueError, match="npad"):
        sa.setup_w_over_q((9, 9), w, qmin, qmax, 5)


def test_linearity_forward_F():
    solver = _setup()
    src = solver.geometry.src
    a = -1 + 2 * np.random.rand()
    rec1, _, _ = solver.forward(src)
    rec1d = a * rec1.data
    src2 = solver.geometry.new_src()
    src2.data[:] = a * src.data
    rec2, _, _ = solver.forward(src2)
    rms2 = np.sqrt(np.mean(rec2.data ** 2))
    diff = (rec1d - rec2.data) / rms2
    assert np.allclose(diff, 0.0, atol=1e-12)


def test_linearity_adjoint_F():
    solver = _setup()
    np.random.seed(0)
    a = np.random.rand()
    rec = solver.geometry.rec
    rec.data[:] = np.random.rand(*rec.data.shape)
    src1, _, _ = solver.adjoint(rec)
    src1d = a * src1.data
    rec2 = solver.geometry.new_rec()
    rec2.data[:] = a * rec.data
    src2, _, _ = solver.adjoint(rec2)
    rms2 = np.sqrt(np.mean(src2.data ** 2))
    diff = (src1d - src2.data) / rms2
    assert np.allclose(diff, 0.0, atol=1e-12)


def test_adjoint_F():
    solver = _setup()
    np.random.seed(0)
    src1 = solver.geometry.src
    rec1 = solver.geometry.new_rec()
    rec1.data[:] = np.random.rand(*rec1.data.shape)
    rec2, _, _ = solver.forward(src1)
    src2, _, _ = solver.adjoint(rec1)
    sum_s = np.dot(src1.data.ravel(), src2.data.ravel())
    sum_r = np.dot(rec1.data.ravel(), rec2.data.ravel())
    diff = (sum_s - sum_r) / (sum_s + sum_r)
    assert np.isclose(diff, 0.0, atol=1e-12)


def test_linearization_F():
    solver = _setup()
    src = solver.geometry.src
    m0 = np.full(solver.model.padded_shape, 1.5, dtype=np.float64)
    dm = _box_dm(solver.model)
    rec0, _, _ = solver.forward(src, vp=m0)
    rec0_data = rec0.data.copy()
    rec1, _, _, _ = solver.jacobian(dm, src=src, vp=m0)
    rec1_data = rec1.data.copy()

    dh, h, nstep = np.sqrt(2.0), 0.1, 7
    scale = np.empty(nstep)
    norm1 = np.empty(nstep)
    norm2 = np.empty(nstep)
    for k in range(nstep):
        h = h / dh
        rec2, _, _ = solver.forward(src, vp=m0 + h * dm)
        scale[k] = h
        norm1[k] = 0.5 * np.linalg.norm(rec2.data - rec0_data) ** 2
        norm2[k] = 0.5 * np.linalg.norm(
            rec2.data - rec0_data - h * rec1_data) ** 2
    p1 = np.polyfit(np.log10(scale), np.log10(norm1), 1)
    p2 = np.polyfit(np.log10(scale), np.log10(norm2), 1)
    assert np.isclose(p1[0], dh ** 2, rtol=0.25)
    assert np.isclose(p2[0], dh ** 4, rtol=0.10)


def test_linearity_forward_J():
    solver = _setup()
    src = solver.geometry.src
    np.random.seed(0)
    a = np.random.rand()
    m0 = np.full(solver.model.padded_shape, 1.5, dtype=np.float64)
    dm = _box_dm(solver.model)
    rec1, _, _, _ = solver.jacobian(dm, src=src, vp=m0)
    rec1_data = rec1.data.copy()
    rec2, _, _, _ = solver.jacobian(a * dm, src=src, vp=m0)
    rms2 = np.sqrt(np.mean(rec2.data ** 2))
    diff = (a * rec1_data - rec2.data) / rms2
    assert np.allclose(diff, 0.0, atol=1e-12)


def test_linearity_adjoint_J():
    solver = _setup()
    src = solver.geometry.src
    np.random.seed(0)
    a = np.random.rand()
    m0 = np.full(solver.model.padded_shape, 1.5, dtype=np.float64)
    _, u0, _ = solver.forward(src, vp=m0, save=True)
    rec1 = solver.geometry.new_rec()
    rec1.data[:] = np.random.rand(*rec1.data.shape)
    dm1, _, _, _ = solver.jacobian_adjoint(rec1, u0, vp=m0)
    rec2 = solver.geometry.new_rec()
    rec2.data[:] = a * rec1.data
    dm2, _, _, _ = solver.jacobian_adjoint(rec2, u0, vp=m0)
    rms2 = np.sqrt(np.mean(dm2 ** 2))
    diff = (a * dm1 - dm2) / rms2
    # the JAX test's 1e-11 (the reference's is 1e-12)
    assert np.allclose(diff, 0.0, atol=1e-11)


def test_adjoint_J():
    solver = _setup()
    np.random.seed(0)
    src0 = solver.geometry.src
    m0 = np.full(solver.model.padded_shape, 1.5, dtype=np.float64)
    dm1 = _box_dm(solver.model)
    rec1 = solver.geometry.new_rec()
    rec1.data[:] = np.random.rand(*rec1.data.shape)
    rec2, u0, _, _ = solver.jacobian(dm1, src=src0, vp=m0, save=True)
    dm2, _, _, _ = solver.jacobian_adjoint(rec1, u0, vp=m0)
    sum_m = np.dot(dm1.ravel(), dm2.ravel())
    sum_d = np.dot(rec1.data.ravel(), rec2.data.ravel())
    diff = (sum_m - sum_d) / (sum_m + sum_d)
    assert np.isclose(diff, 0.0, atol=1e-11)


def test_jacobian_adjoint_adds_into_dm_and_aliases():
    """A ``dm`` given to ``jacobian_adjoint`` is added into; ``born`` and
    ``gradient`` are the JAX solver's aliases."""
    solver = _setup(tn=200.)
    _, u0, _ = solver.forward(save=True)
    rec = solver.geometry.new_rec()
    rec.data[:] = np.random.default_rng(1).random(rec.data.shape)
    g, _, _, _ = solver.gradient(rec, u0)
    acc = np.ones_like(g)
    out, _, _, _ = solver.jacobian_adjoint(rec, u0, dm=acc)
    assert out is acc and np.array_equal(acc, 1.0 + g)
    assert type(solver).born is type(solver).jacobian


def test_forward_3d_smoke():
    solver = acoustic_sa_setup(shape=(21, 21, 21), spacing=(10., 10., 10.),
                               tn=100., space_order=8, nbl=5,
                               dtype=np.float64, device="cpu")
    rec, u, _ = solver.forward()
    assert np.isfinite(rec.data).all()
    assert np.abs(rec.data).max() > 0


@pytest.mark.slow
def test_analytic_comparison_2d():
    """The analytic far-field case (reference :360-462, in
    ``examples/sa_far_field.py``: 401 x 401 at 0.5 m, npad 50, nt 1001):
    the numerical wholespace response against the 2-D Green's function
    within 2% of its max. Marked slow: 60-86 s at float64 on one CPU thread
    (the card runs it in ``chip_smoke.py`` phase 40)."""
    from devito_fwi_tpu_torch.examples import sa_far_field
    got, want, _, _ = sa_far_field.far_field("cpu")
    assert np.abs(got - want).max() < 0.02 * np.abs(want).max()
    assert sa_far_field.TOLERANCE == 0.02
