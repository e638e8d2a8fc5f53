"""The port's six remaining tutorials (``examples/modeling_families.py``,
``accuracy.py``, ``snapshotting.py``, ``rtm.py``, ``abc_methods.py``,
``nmo_correction.py``) on the CPU, each held against the same calls into
the JAX package on the same inputs, at cut sizes (short recording times,
two RTM shots, a 41-point ABC box):

* float64 within 1e-10 of the max (the accuracy traces);
* float32 within 1e-5 of the max for traces and snapshots and 3e-5 for
  the RTM image (the frameworks round the same float32 operations
  differently: XLA's CPU compiler fuses multiply-adds);
* each tutorial's own checks: the accuracy errors fall with the space
  order (float64, the full 800 ms), the NMO spread is 3 samples or fewer,
  the RTM image is finite and non-zero, the snapshot shapes are the
  history's, its tenth frames and the 12 segment starts;
* the new modules import no JAX (the isolation scans cover them) and
  their entry points raise without a card instead of running on the CPU.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from devito_fwi_tpu import AcquisitionGeometry as JGeometry
from devito_fwi_tpu import (AcousticWaveSolver as JAcoustic,
                            AnisotropicWaveSolver as JTTI,
                            ElasticWaveSolver as JElastic,
                            ViscoacousticWaveSolver as JVisco,
                            ViscoelasticWaveSolver as JViscoelastic,
                            SeismicModel as JModel, acoustic_sa_setup as j_sa,
                            demo_model as j_demo, setup_geometry as j_geom)
from devito_fwi_tpu.fwi import _batched_tables as j_tables
from devito_fwi_tpu.fwi import _solver_dt as j_dt
from devito_fwi_tpu.ops import acoustic as j_ac
from devito_fwi_tpu.optimize.math import nabla2 as j_nabla2
from devito_fwi_tpu.utils.nmo import nmo_correction as j_nmo

from devito_fwi_tpu_torch.examples import (abc_methods, accuracy,
                                           modeling_families, nmo_correction,
                                           rtm, snapshotting)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TRACE, F32_IMAGE, F64 = 1e-5, 3e-5, 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this module runs: the suite runs several
    pytest workers on one machine."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


def _jax_example(name):
    """A module of the repo's root ``examples/`` (the JAX tutorials)."""
    spec = importlib.util.spec_from_file_location(
        "jax_example_" + name, os.path.join(REPO, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_function(name, fn):
    """One function of a root ``examples/`` module that computes at import
    time, taken from its source without running the module's body."""
    import ast
    import scipy.special
    src = open(os.path.join(REPO, "examples", name + ".py")).read()
    node = next(n for n in ast.parse(src).body
                if isinstance(n, ast.FunctionDef) and n.name == fn)
    scope = {"np": np, "hankel2": scipy.special.hankel2}
    exec(compile(ast.Module([node], []), name, "exec"), scope)
    return scope[fn]


# ---------------------------------------------------------------------------
# modeling_families
# ---------------------------------------------------------------------------

FAM_SHAPE, FAM_SPACING, FAM_TN, FAM_SO = (50, 50), (20., 20.), 60., 4


def _jax_family(name, shape, spacing, tn, so):
    """The JAX example's closure for one family (``examples/
    modeling_families.py:42-88``)."""
    def model(preset, nbl, order=so):
        return j_demo(preset, shape=shape, spacing=spacing,
                      space_order=order, nbl=nbl)
    if name == "acoustic (OT2)":
        m = model("layers-isotropic", 40)
        return JAcoustic(m, j_geom(m, tn), space_order=so).forward()[0].data
    if name == "TTI (centered)":
        m = model("layers-tti", 10, max(so, 4))
        return JTTI(m, j_geom(m, tn / 2),
                    space_order=max(so, 4)).forward()[0].data
    if name == "elastic":
        m = model("layers-elastic", 40)
        return JElastic(m, j_geom(m, tn), space_order=so).forward()[0].data
    if name == "viscoelastic (SLS)":
        m = model("layers-viscoelastic", 40)
        return JViscoelastic(m, j_geom(m, tn),
                             space_order=so).forward()[0].data
    if name == "viscoacoustic (sls-2)":
        m = model("layers-viscoacoustic", 40)
        return JVisco(m, j_geom(m, tn), space_order=so, kernel="sls",
                      time_order=2).forward()[0].data
    solver = j_sa(shape=shape, spacing=spacing, tn=tn / 2,
                  space_order=max(so, 8), nbl=10)
    return solver.forward()[0].data


@pytest.mark.parametrize("name", modeling_families.FAMILIES)
def test_modeling_family_matches_jax(name):
    got = modeling_families.family(name, FAM_SHAPE, FAM_SPACING, FAM_TN,
                                   FAM_SO, device="cpu")
    want = _jax_family(name, FAM_SHAPE, FAM_SPACING, FAM_TN, FAM_SO)
    assert np.isfinite(got).all()
    assert _rel(got, want) < F32_TRACE


def test_modeling_families_main_runs_all_six(capsys):
    norms = modeling_families.main(["-tn", str(FAM_TN), "--device", "cpu"])
    assert list(norms) == list(modeling_families.FAMILIES)
    assert all(np.isfinite(v) and v > 0 for v in norms.values())
    assert "all families finite" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# accuracy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("so", accuracy.ORDERS)
def test_accuracy_trace_matches_jax_f64(so):
    tn = 200.0
    got = accuracy.trace(so, tn, np.float64, device="cpu")
    model = JModel(origin=(0., 0.), spacing=accuracy.SPACING,
                   shape=accuracy.SHAPE, space_order=so,
                   vp=np.full(accuracy.SHAPE, accuracy.VP), nbl=40,
                   bcs="damp", dt=accuracy.DT_MS, dtype=np.float64)
    geom = JGeometry(model, np.array([[1500.0 + accuracy.OFFSET, 1500.0]]),
                     np.array([[1500.0, 1500.0]]), 0., tn, f0=accuracy.F0,
                     src_type="Ricker")
    want = np.asarray(JAcoustic(model, geom,
                                space_order=so).forward()[0].data)[:, 0]
    assert _rel(got, want) < F64


def test_accuracy_errors_fall_with_the_order():
    """The tutorial's check at float64 over the full 800 ms, and the
    analytic trace equal to the JAX example's."""
    errs = accuracy.main(["--device", "cpu"])
    assert errs[2] > errs[4] > errs[8]
    nt = int(800.0 / accuracy.DT_MS) + 1
    ref = accuracy.analytic_trace(1500.0, 10.0, 1e-3, nt, 500.0)
    want = _jax_function("accuracy", "analytic_trace")(1500.0, 10.0, 1e-3,
                                                        nt, 500.0)
    assert np.array_equal(ref, want)


# ---------------------------------------------------------------------------
# snapshotting
# ---------------------------------------------------------------------------

def test_snapshots_match_jax():
    tn = 150.0
    full, strided, starts = snapshotting.snapshots(tn, device="cpu")
    model = j_demo("layers-isotropic", shape=(101, 101), spacing=(10., 10.),
                   nlayers=3, space_order=4, nbl=40)
    src = np.array([[500.0, 20.0]])
    rec = np.stack([np.linspace(0, 1000, 101), np.full(101, 20.0)], axis=1)
    geometry = JGeometry(model, rec, src, 0., tn, f0=0.015,
                         src_type="Ricker")
    _, u, _ = JAcoustic(model, geometry, space_order=4).forward(save=True)
    ju = np.asarray(u.data)
    s_idx, s_w, r_idx, r_w, wav = j_tables(geometry)
    _, seg_starts, _ = j_ac.forward_ckpt(
        jnp.asarray(model.vp), jnp.asarray(model.damp), jnp.asarray(wav),
        jnp.asarray(s_idx[0]), jnp.asarray(s_w[0]), jnp.asarray(r_idx),
        jnp.asarray(r_w), j_dt(geometry), nt=geometry.nt,
        spacing=model.spacing, space_order=4,
        n_checkpoints=snapshotting.N_CHECKPOINTS)
    nt = geometry.nt
    assert tuple(full.shape) == (nt,) + model.padded_shape
    assert strided.shape == ((nt + 9) // 10,) + model.padded_shape
    assert starts.shape == (12, 2) + model.padded_shape
    assert _rel(full.numpy(), ju) < F32_TRACE
    assert np.array_equal(strided, full.numpy()[::10])
    assert _rel(starts, np.asarray(seg_starts)) < F32_TRACE


def test_snapshotting_main_writes_the_frames(tmp_path):
    _, strided, _ = snapshotting.main(["--device", "cpu", "--tn", "100",
                                       "--odir", str(tmp_path)])
    data = np.fromfile(str(tmp_path / "snaps.bin"), np.float32)
    assert np.array_equal(data, strided.reshape(-1))


# ---------------------------------------------------------------------------
# rtm
# ---------------------------------------------------------------------------

def _jax_rtm(nshots):
    """The JAX example's loop (``examples/rtm.py:22-66``) over ``nshots``."""
    def layers():
        return j_demo("layers-isotropic", shape=(101, 101),
                      spacing=(10., 10.), nlayers=4, space_order=4, nbl=40)
    model, model0 = layers(), layers()
    model0.smooth("vp", sigma=4)
    rec_coordinates = np.empty((101, 2))
    rec_coordinates[:, 0] = np.linspace(0, model.domain_size[0], 101)
    rec_coordinates[:, 1] = 20.
    geometry = JGeometry(model, rec_coordinates, np.array([[500., 20.]]),
                         0., 1000., f0=0.015, src_type="Ricker")
    solver = JAcoustic(model, geometry, space_order=4)
    locs = np.empty((nshots, 2))
    locs[:, 0] = np.linspace(0., model.domain_size[0], nshots)
    locs[:, 1] = 20.
    image = np.zeros(model.padded_shape, dtype=np.float64)
    for loc in locs:
        solver.geometry.src_positions[0, :] = loc
        d_obs, _, _ = solver.forward(vp=model.vp)
        residual = solver.geometry.rec
        d_obs_data = d_obs.data.copy()
        d_syn, _, _ = solver.forward(vp=model0.vp)
        residual.data[:] = d_syn.data - d_obs_data
        g, _ = solver.jacobian_adjoint(residual, None, vp=model0.vp,
                                       checkpointing=True)
        image += np.asarray(g, dtype=np.float64)
    return image, j_nabla2(model.crop(image))


def test_rtm_image_matches_jax(tmp_path):
    img_f = rtm.main(["--device", "cpu", "--nshots", "2", "--odir",
                      str(tmp_path)])
    raw, _ = rtm.image(2, device="cpu")
    want_raw, want_f = _jax_rtm(2)
    assert np.isfinite(img_f).all() and np.abs(img_f).max() > 0
    assert _rel(raw, want_raw) < F32_IMAGE
    assert _rel(img_f, want_f) < F32_IMAGE
    data = np.fromfile(str(tmp_path / "rtm_image.bin"), np.float32)
    assert np.array_equal(data, img_f.astype(np.float32).reshape(-1))


# ---------------------------------------------------------------------------
# abc_methods
# ---------------------------------------------------------------------------

ABC_NPTI, ABC_TN, ABC_NPML, ABC_REF = 41, 260.0, 10, 60


@pytest.fixture(scope="module")
def jax_abc():
    mod = _jax_example("abc_methods")
    mod.NPTI, mod.TN = ABC_NPTI, ABC_TN
    return mod


@pytest.mark.parametrize("label,method,kw", abc_methods.METHODS,
                         ids=[m[0] for m in abc_methods.METHODS])
def test_abc_method_matches_jax(jax_abc, label, method, kw):
    got = abc_methods.run(ABC_NPML, method, ABC_TN, ABC_NPTI, "cpu", **kw)
    want = jax_abc.run(ABC_NPML, method, **kw)
    assert _rel(got, want) < F32_TRACE


def test_abc_errors_match_jax(jax_abc):
    """The reflection errors of the five treatments against the reference
    layer, each as the JAX example computes it."""
    errs = abc_methods.errors(ABC_TN, ABC_NPTI, ABC_NPML, ABC_REF, "cpu")
    ref = jax_abc.run(ABC_REF, "pml", quibar=0.0)
    ref_p = abc_methods.run(ABC_REF, "pml", ABC_TN, ABC_NPTI, "cpu",
                            quibar=0.0)
    norm = np.linalg.norm
    for label, method, kw in abc_methods.METHODS:
        rec = jax_abc.run(ABC_NPML, method, **kw)
        rec_p = abc_methods.run(ABC_NPML, method, ABC_TN, ABC_NPTI, "cpu",
                                **kw)
        want = norm(rec - ref) / norm(ref)
        # each error is a small difference of traces: it may move by as
        # much as the traces' own float32 differences (triangle inequality)
        slack = (norm(rec_p - rec) + norm(ref_p - ref)) / norm(ref)
        assert abs(errs[label] - want) <= 1.01 * slack + 1e-12, label
        assert slack < 1e-5
    assert all(np.isfinite(e) and e > 0 for e in errs.values())


# ---------------------------------------------------------------------------
# nmo_correction
# ---------------------------------------------------------------------------

def test_nmo_tutorial_flattens_both_events_as_jax():
    corrected, spreads = nmo_correction.main([])
    assert all(after <= 3 for _, after in spreads)
    gather, vnmo = nmo_correction.cmp_gather()
    want = j_nmo(gather, nmo_correction.DT, nmo_correction.OFFSETS, vnmo)
    assert np.array_equal(corrected, want)
    jx = _jax_example("nmo_correction")
    assert np.array_equal(gather, jx.cmp_gather)
    assert np.array_equal(corrected, jx.corrected)


# ---------------------------------------------------------------------------
# isolation
# ---------------------------------------------------------------------------

SLICE19_MODULES = ("examples/modeling_families.py", "examples/accuracy.py",
                   "examples/snapshotting.py", "examples/rtm.py",
                   "examples/abc_methods.py", "examples/nmo_correction.py",
                   "tools/audit_gradient.py", "tools/inversion_report.py",
                   "tools/depth_runs.py")


@pytest.mark.parametrize("module", SLICE19_MODULES)
def test_slice19_modules_are_scanned_and_import_no_jax(module):
    """Each module is among the sources tests/test_torch_isolation.py scans
    and names neither JAX nor the JAX package in an import."""
    import ast
    path = os.path.join(REPO, "devito_fwi_tpu_torch", *module.split("/"))
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(n.split(".")[0] in ("jax", "jaxlib", "devito_fwi_tpu")
                       for n in names), (module, names)


@pytest.mark.parametrize("entry", ["modeling_families", "accuracy",
                                   "snapshotting", "rtm", "abc_methods",
                                   "audit_gradient"])
def test_slice19_entry_points_raise_on_cuda_without_card(entry,
                                                         monkeypatch):
    """Without a card the tutorials and the audit raise for the missing
    device instead of running on the CPU."""
    from devito_fwi_tpu_torch.tools import audit_gradient
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "modeling_families": lambda: modeling_families.main(["-tn", "20"]),
        "accuracy": lambda: accuracy.main(["--tn", "20"]),
        "snapshotting": lambda: snapshotting.main(["--tn", "20"]),
        "rtm": lambda: rtm.main(["--nshots", "1"]),
        "abc_methods": lambda: abc_methods.main(["--tn", "20"]),
        "audit_gradient": lambda: audit_gradient.main(["--nsrc", "1",
                                                       "--tn", "100"]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
