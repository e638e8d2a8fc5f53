"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to fall back to the CPU when asked for the card."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from devito_fwi_tpu_torch import elastic_fwi as tel
from devito_fwi_tpu_torch import fwi as tfwi
from devito_fwi_tpu_torch import visco_fwi as tvf
from devito_fwi_tpu_torch.drivers import _marmousi_common as marm
from devito_fwi_tpu_torch.models.geometry import AcquisitionGeometry
from devito_fwi_tpu_torch.models.presets import demo_model
from devito_fwi_tpu_torch.ops import cuda_acoustic as ca
from devito_fwi_tpu_torch.ops import cuda_bfm as cb
from devito_fwi_tpu_torch.ops import cuda_staggered as cs
from devito_fwi_tpu_torch.ops import cuda_visco as cv
from devito_fwi_tpu_torch.ops.elastic_wavesolver import ElasticWaveSolver
from devito_fwi_tpu_torch.ops.viscoacoustic_wavesolver import (
    ViscoacousticWaveSolver)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "devito_fwi_tpu_torch")


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "devito_fwi_tpu")


def test_import_leaves_jax_out():
    """In a fresh interpreter (the test process itself has JAX loaded):
    importing the package and every module of it loads no JAX module."""
    mods = sorted(
        os.path.relpath(f, REPO)[:-3].replace(os.sep, ".")
        for f in _port_sources() if f.startswith(PKG))
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods) +
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'devito_fwi_tpu')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_sources_import_no_jax(path):
    """Source scan: no import of jax or of devito_fwi_tpu (the name not
    followed by _torch), absolute or relative."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def _geometry():
    model = demo_model("circle-isotropic", shape=(21, 21),
                       spacing=(10., 10.), nbl=4, space_order=4)
    rec = np.stack([np.linspace(0., 200., 11), np.full(11, 20.)], 1)
    return AcquisitionGeometry(model, rec, np.array([[100., 20.]]), 0.,
                               50., f0=0.01, src_type="Ricker")


@pytest.mark.parametrize("entry", ["fm_single", "fm_multi", "fwi_obj_multi",
                                   "fwi_loss"])
def test_entry_points_raise_on_cuda_without_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = _geometry()
    obs = tfwi.fm_multi(g, device="cpu")
    x = 1.0 / np.asarray(g.model.vp_unpadded, np.float64).reshape(-1) ** 2
    calls = {
        "fm_single": lambda: tfwi.fm_single(g),
        "fm_multi": lambda: tfwi.fm_multi(g),
        "fwi_obj_multi": lambda: tfwi.fwi_obj_multi(g, obs, None,
                                                    calc_grad=True),
        "fwi_loss": lambda: tfwi.fwi_loss(x, g, obs, None),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_wrappers_reject_other_devices():
    t = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="meta"):
        ca.forward_rec_segments(t, t, torch.zeros(4, device="meta"),
                                torch.zeros((1, 4, 8), device="meta"), 1.0,
                                nt=6, nx=8, nz=4, space_order=4,
                                spacing=(10., 10.), z0=1, n_checkpoints=4)


def _check_signatures(module, source):
    import ctypes
    import re
    src = open(os.path.join(PKG, "csrc", source)).read()
    kinds = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_float: "f",
             ctypes.c_longlong: "l"}

    def kind(p):
        if "*" in p:
            return "p"
        return {"float": "f", "long": "l"}.get(p.split()[0], "i")

    for name, (argtypes, _) in module.SIGNATURES.items():
        params = re.search(r"(?:int|char\*)\s+" + name + r"\(([^)]*)\)",
                           src).group(1)
        want = [kind(p) for p in params.split(",")]
        assert [kinds[a] for a in argtypes] == want, name


def test_ctypes_signatures_match_the_cuda_source():
    """The argtypes bound in cuda_acoustic.SIGNATURES follow the parameter
    lists of the extern "C" functions of csrc/acoustic2d.cu (a mismatch
    only shows on the card, as a ctypes error or a garbled argument)."""
    _check_signatures(ca, "acoustic2d.cu")


def test_acoustic2d_source_launches_the_fused_forward_tile():
    """The 2-D sweeps launch the fused forward tile (two steps a launch,
    the source as ``src_cell``/``src_val`` lists) and the reverse's two-
    step tile, with one single-step reverse launch for an odd last step;
    the forward's entry points take the lists and four state fields."""
    assert _kernels_launched("acoustic2d.cu") == {"forward_tile",
                                                  "adjoint_step",
                                                  "adjoint_tile"}
    src = open(os.path.join(PKG, "csrc", "acoustic2d.cu")).read()
    for entry in ("acoustic2d_forward", "acoustic2d_gradient_segments"):
        params = src[src.index(f"int {entry}("):].split(")")[0]
        assert "src_cell" in params and "src_val" in params
        assert "float* state" in params and "inj" not in params


def test_acoustic2d_reverse_runs_the_two_step_tile():
    """Both 2-D reverse sweeps run the forwards' two-step tile in reverse
    (``adjoint_tile``, two steps a launch, the history read with streaming
    loads) and ``adjoint_step`` only for an odd last step; no design knob
    and no cooperative launch is left in the source; the entry points take
    the adjoint pair and its spare pair as one ``adj`` operand."""
    import re
    src = open(os.path.join(PKG, "csrc", "acoustic2d.cu")).read()
    body = src[src.index("int adjoint_steps("):]
    body = body[:body.index("\n}\n")]
    loop = re.search(r"for \(; t - 1 >= lo; t -= 2\) \{\s*"
                     r"adjoint_tile<R, FS><<<", body)
    assert loop
    odd = body[loop.end():]
    assert re.search(r"if \(t >= lo\) \{\s*const int err = "
                     r"launch_step<R, FS>\(", odd)
    assert "for (" not in odd
    assert "__ldcs(h0 + cell)" in src
    assert "Cooperative" not in src and "cooperative_groups" not in src
    assert "kReverse" not in src
    for entry in ("acoustic2d_adjoint", "acoustic2d_gradient_segments"):
        params = src[src.index(f"int {entry}("):].split(")")[0]
        assert "float* adj" in params and "float* v," not in params


@pytest.mark.parametrize("probe, table, source", [
    ("probe_forwards", "VARIANTS_2D", "acoustic2d.cu"),
    ("probe_forwards", "VARIANTS_3D", "acoustic3d.cu"),
    ("probe_reverses", "VARIANTS_2D", "acoustic2d.cu"),
    ("probe_reverses", "VARIANTS_TTI", "tti2d.cu"),
    ("probe_reverses", "VARIANTS_3D", "acoustic3d.cu"),
    ("probe_forwards", "VARIANTS_LEGACY", "acoustic2d_legacy.cu")])
def test_probe_variants_apply_to_the_committed_sources(probe, table, source):
    """Every design variant the card probes build is a set of text
    substitutions into a kernel source; each text must still be in the
    committed source (else the probe stops on the card, after its
    machine has started)."""
    import importlib
    mod = importlib.import_module(f"devito_fwi_tpu_torch.tools.{probe}")
    src = open(os.path.join(PKG, "csrc", source)).read()
    for tag, subs in getattr(mod, table).items():
        subs = subs[0] if isinstance(subs, tuple) else subs
        for old in subs:
            assert src.count(old) == 1, (tag, old)


def test_ctypes_signatures_match_the_bfm_source():
    """The same for cuda_bfm.SIGNATURES and csrc/bfm_push.cu."""
    _check_signatures(cb, "bfm_push.cu")


def _kernels_launched(source):
    """The __global__ kernels that the source's run_* loops launch."""
    import re
    src = open(os.path.join(PKG, "csrc", source)).read()
    return set(re.findall(r"\b(\w+)<[^<>]*><<<", src))


def test_ctypes_signatures_match_the_elastic_source():
    """The same for cuda_staggered.SIGNATURES and csrc/elastic2d.cu, whose
    sweeps each launch one fused step kernel a step (forward_step,
    adjoint_step; the scratch of ``elastic2d_adjoint`` is two adjoint
    states)."""
    _check_signatures(cs, "elastic2d.cu")
    assert _kernels_launched("elastic2d.cu") == {"forward_step",
                                                 "adjoint_step"}


def _elastic_geometry():
    model = demo_model("layers-elastic", shape=(21, 21), spacing=(10., 10.),
                       nbl=4, space_order=4)
    rec = np.stack([np.linspace(0., 200., 11), np.full(11, 20.)], 1)
    return AcquisitionGeometry(model, rec, np.array([[100., 20.]]), 0.,
                               50., f0=0.01, src_type="Ricker")


@pytest.mark.parametrize("entry", ["elastic_fm_multi",
                                   "elastic_fwi_obj_multi", "ElasticFwiLoss",
                                   "ElasticWaveSolver", "physics_elastic"])
def test_elastic_entry_points_raise_on_cuda_without_card(entry,
                                                         monkeypatch,
                                                         tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = _elastic_geometry()
    obs, _ = tel.elastic_fm_multi(g, device="cpu")
    vp, vs, rho = (g.model.crop(f) for f in tel.model_vp_vs_rho(g.model))
    x = 1.0 / vp.astype(np.float64).reshape(-1) ** 2
    calls = {
        "elastic_fm_multi": lambda: tel.elastic_fm_multi(g),
        "elastic_fwi_obj_multi": lambda: tel.elastic_fwi_obj_multi(
            g, obs, calc_grad=True),
        "ElasticFwiLoss": lambda: tel.ElasticFwiLoss(vs, rho)(x, g, obs,
                                                             None),
        "ElasticWaveSolver": lambda: ElasticWaveSolver(g.model, g),
        "physics_elastic": lambda: marm.run_fwi(marm.SMARM2, [
            "--physics", "elastic", "--maxiter", "1", "--nsrc", "2",
            "--odir", str(tmp_path)]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_viscoacoustic_physics_still_raises(tmp_path, monkeypatch):
    """``--physics viscoacoustic`` is ported: without a card it raises only
    for the missing device, not as an unported flag."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        marm.run_fwi(marm.SMARM2, ["--physics", "viscoacoustic",
                                   "--odir", str(tmp_path)])


def test_ctypes_signatures_match_the_visco_source():
    """The same for cuda_visco.SIGNATURES and csrc/visco2d.cu, whose
    forward takes the source as its non-zero cells (src_cell, src_val, K)
    and whose sweeps each launch one fused step kernel a step."""
    _check_signatures(cv, "visco2d.cu")
    assert _kernels_launched("visco2d.cu") == {"forward_step",
                                               "adjoint_step"}


def _visco_geometry():
    model = demo_model("layers-viscoacoustic", shape=(21, 21),
                       spacing=(10., 10.), nbl=4, space_order=4)
    rec = np.stack([np.linspace(0., 200., 11), np.full(11, 20.)], 1)
    return AcquisitionGeometry(model, rec, np.array([[100., 20.]]), 0.,
                               50., f0=0.01, src_type="Ricker")


@pytest.mark.parametrize("entry", ["visco_fm_multi", "visco_fwi_obj_multi",
                                   "ViscoFwiLoss",
                                   "ViscoacousticWaveSolver",
                                   "physics_viscoacoustic"])
def test_visco_entry_points_raise_on_cuda_without_card(entry, monkeypatch,
                                                       tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = _visco_geometry()
    obs = tvf.visco_fm_multi(g, device="cpu")
    x = 1.0 / np.asarray(g.model.vp_unpadded, np.float64).reshape(-1) ** 2
    calls = {
        "visco_fm_multi": lambda: tvf.visco_fm_multi(g),
        "visco_fwi_obj_multi": lambda: tvf.visco_fwi_obj_multi(
            g, obs, calc_grad=True),
        "ViscoFwiLoss": lambda: tvf.ViscoFwiLoss()(x, g, obs, None),
        "ViscoacousticWaveSolver": lambda: ViscoacousticWaveSolver(g.model,
                                                                   g),
        "physics_viscoacoustic": lambda: marm.run_fwi(marm.SMARMN, [
            "--physics", "viscoacoustic", "--maxiter", "1", "--nsrc", "2",
            "--odir", str(tmp_path)]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_visco_wrappers_reject_other_devices():
    t = torch.zeros((4, 8), device="meta")
    b = torch.zeros((1, 4, 8), device="meta")
    kw = dict(nt=7, nx=8, nz=4, space_order=4, spacing=(10., 10.), z0=1)
    with pytest.raises(ValueError, match="meta"):
        cv.visco_sls2_segments(*([t] * 6), b, torch.zeros(5, device="meta"),
                               1.0, **kw)
    with pytest.raises(ValueError, match="meta"):
        cv.visco_grad_stream_segments(
            *([t] * 6), b, torch.zeros((1, 1, 5, 2, 4, 8), device="meta"),
            torch.zeros((1, 1, 5, 2, 8), device="meta"),
            torch.zeros(5, device="meta"), 1.0, seg=5, **kw)


def test_elastic_wrappers_reject_other_devices():
    t = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="meta"):
        cs.elastic_segments(*([t] * 9), torch.zeros((1, 4, 8), device="meta"),
                            torch.zeros(5, device="meta"), 1.0, nt=6, nx=8,
                            nz=4, space_order=4, spacing=(10., 10.), z0=1)


TTI_MODULES = ("ops/wavesolver.py", "ops/tti.py", "ops/cuda_tti.py",
               "ops/tti_wavesolver.py")


@pytest.mark.parametrize("module", TTI_MODULES)
def test_tti_modules_are_scanned(module):
    """The TTI slice's modules are among the sources the scans above read
    (and so import no JAX), beside their CUDA source."""
    assert os.path.join(PKG, *module.split("/")) in _port_sources()
    assert os.path.exists(os.path.join(PKG, "csrc", "tti2d.cu"))


def test_ctypes_signatures_match_the_tti_source():
    """The same for cuda_tti.SIGNATURES and csrc/tti2d.cu."""
    from devito_fwi_tpu_torch.ops import cuda_tti as ct
    _check_signatures(ct, "tti2d.cu")


def test_tti_source_launches_one_fused_reverse_step():
    """The TTI reverse steps (streamed and after each recompute) launch
    the one fused kernel, and so do the forward steps."""
    assert _kernels_launched("tti2d.cu") == {"forward_fused",
                                             "adjoint_fused"}


def test_tti_source_launches_one_fused_forward_step():
    """A TTI forward step (both forwards and the checkpoint route's
    recompute) is one launch of ``forward_fused``, with no product scratch
    fields; the entry points take the source as ``src_cell``/``src_val``
    lists, not the dense pattern."""
    import re
    src = open(os.path.join(PKG, "csrc", "tti2d.cu")).read()
    step = src[src.index("int forward_step("):]
    step = step[:step.index("\n}\n")]
    assert re.findall(r"\b(\w+)<[^<>]*><<<", step) == ["forward_fused"]
    assert not re.search(r"\bp[1-4]\b", src)
    for entry in ("tti2d_forward", "tti2d_jacobian_adjoint"):
        params = src[src.index(f"int {entry}("):].split(")")[0]
        assert "src_cell" in params and "src_val" in params
        assert "inj" not in params


def _tti_geometry():
    model = demo_model("layers-tti", shape=(21, 21), spacing=(10., 10.),
                       nbl=4, space_order=4)
    rec = np.stack([np.linspace(0., 200., 11), np.full(11, 20.)], 1)
    return AcquisitionGeometry(model, rec, np.array([[100., 20.]]), 0.,
                               50., f0=0.01, src_type="Ricker")


def test_tti_solver_raises_on_cuda_without_card(monkeypatch):
    """``AnisotropicWaveSolver`` defaults to the card: without one it raises
    for the missing device instead of running the twins on the CPU."""
    from devito_fwi_tpu_torch.ops.tti_wavesolver import AnisotropicWaveSolver
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = _tti_geometry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AnisotropicWaveSolver(g.model, g)
    AnisotropicWaveSolver(g.model, g, device="cpu")


def test_tti_wrappers_reject_other_devices():
    from devito_fwi_tpu_torch.ops import cuda_tti as ct
    t = torch.zeros((4, 8), device="meta")
    b = torch.zeros((1, 4, 8), device="meta")
    kw = dict(nt=7, nx=8, nz=4, space_order=4, spacing=(10., 10.), z0=1,
              n_checkpoints=1)
    with pytest.raises(ValueError, match="meta"):
        ct.tti_forward_dt2_segments(*([t] * 6), b,
                                    torch.zeros(6, device="meta"), 1.0, **kw)
    h = torch.zeros((1, 1, 5, 4, 8), device="meta")
    with pytest.raises(ValueError, match="meta"):
        ct.tti_gradient_stream_segments(
            *([t] * 6), h, h, torch.zeros((1, 1, 5, 2, 8), device="meta"),
            1.0, **kw)


W2_MODULES = ("misfit/native.py", "utils/filters.py", "ops/cuda_bfm.py",
              "misfit/bfm.py", "misfit/w2.py", "fwi.py")


@pytest.mark.parametrize("module", W2_MODULES)
def test_w2_and_host_misfit_modules_are_scanned(module):
    """The banded Legendre, native BFM and host-misfit modules are among the
    sources the scans above read (and so import no JAX), beside the banded
    kernel's CUDA source and the native solver's C++ source."""
    assert os.path.join(PKG, *module.split("/")) in _port_sources()
    assert os.path.exists(os.path.join(PKG, "csrc", "bfm_legendre.cu"))
    assert os.path.exists(os.path.join(REPO, "native", "bfm2d.cpp"))


def test_ctypes_signatures_match_the_legendre_source():
    """The same for cuda_bfm.LEGENDRE_SIGNATURES and csrc/bfm_legendre.cu."""
    from types import SimpleNamespace
    _check_signatures(SimpleNamespace(SIGNATURES=cb.LEGENDRE_SIGNATURES),
                      "bfm_legendre.cu")


def test_legendre_wrapper_rejects_what_the_kernel_does_not_take():
    """Another device, another type, a strided view, a short row: the
    wrapper raises before any kernel or twin runs."""
    cb.reset_counters()
    with pytest.raises(ValueError, match="meta"):
        cb.legendre_banded(torch.zeros((4, 8), device="meta"), 2, 2)
    with pytest.raises(TypeError, match="float32"):
        cb.legendre_banded(torch.zeros((4, 8), dtype=torch.float64), 2, 2)
    with pytest.raises(ValueError, match="contiguous"):
        cb.legendre_banded(torch.zeros((8, 4)).T, 2, 2)
    with pytest.raises(ValueError, match="rows, n"):
        cb.legendre_banded(torch.zeros((4, 1)), 2, 2)
    assert not any(cb.TWIN_CALLS.values()) and not any(cb.LAUNCHES.values())


def test_host_misfit_entry_point_raises_on_cuda_without_card(monkeypatch):
    """The host-misfit path asks for the card like the device path: without
    one it raises for the missing device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = _geometry()
    obs = tfwi.fm_multi(g, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfwi.fwi_obj_multi(g, obs, lambda a, b: (0.0, a - b),
                           calc_grad=True)


ACOUSTIC3D_MODULES = ("ops/acoustic.py", "ops/cuda_acoustic3.py",
                      "ops/cuda_acoustic3d.py", "fwi.py")


@pytest.mark.parametrize("module", ACOUSTIC3D_MODULES)
def test_acoustic3d_modules_are_scanned(module):
    """The 3-D slice's modules are among the sources the scans above read
    (and so import no JAX), beside their CUDA source."""
    assert os.path.join(PKG, *module.split("/")) in _port_sources()
    assert os.path.exists(os.path.join(PKG, "csrc", "acoustic3d.cu"))


@pytest.mark.parametrize("module", ["cuda_acoustic3", "cuda_acoustic3d"])
def test_ctypes_signatures_match_the_acoustic3d_source(module):
    """The same for the step and the sweep entry points of
    csrc/acoustic3d.cu."""
    from devito_fwi_tpu_torch.ops import cuda_acoustic3, cuda_acoustic3d
    _check_signatures({"cuda_acoustic3": cuda_acoustic3,
                       "cuda_acoustic3d": cuda_acoustic3d}[module],
                      "acoustic3d.cu")


def test_acoustic3d_source_launches_the_y_march():
    """The 3-D forwards and the reverse sweep launch the y march (its
    chunk length ``ylen`` a parameter of both entry points); the step
    kernel keeps one thread a cell."""
    assert _kernels_launched("acoustic3d.cu") == {"march", "step_kernel"}
    src = open(os.path.join(PKG, "csrc", "acoustic3d.cu")).read()
    for entry in ("acoustic3d_forward", "acoustic3d_gradient"):
        params = src[src.index(f"int {entry}("):].split(")")[0]
        assert "int ylen" in params


def _geometry3():
    model = demo_model("layers-isotropic", nlayers=2, shape=(12, 10, 10),
                       spacing=(15., 15., 15.), nbl=4, space_order=4,
                       dt=1.5)
    rec = np.stack([np.linspace(0., 165., 6), np.full(6, 60.),
                    np.full(6, 37.)], 1)
    return AcquisitionGeometry(model, rec, np.array([[80., 70., 30.]]), 0.,
                               30., f0=0.015, src_type="Ricker")


@pytest.mark.parametrize("entry", ["fm_multi", "fwi_obj_multi",
                                   "fwi_obj_multi_saved3", "fwi_loss"])
def test_3d_entry_points_raise_on_cuda_without_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = _geometry3()
    obs = tfwi.fm_multi(g, device="cpu")
    x = 1.0 / np.asarray(g.model.vp_unpadded, np.float64).reshape(-1) ** 2
    calls = {
        "fm_multi": lambda: tfwi.fm_multi(g),
        "fwi_obj_multi": lambda: tfwi.fwi_obj_multi(g, obs, None,
                                                    calc_grad=True),
        "fwi_obj_multi_saved3": lambda: tfwi.fwi_obj_multi(
            g, obs, None, calc_grad=True, saved3=True),
        "fwi_loss": lambda: tfwi.fwi_loss(x, g, obs, None),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


LEGACY_SOLVER_MODULES = ("ops/cuda_legacy.py", "ops/acoustic.py",
                         "ops/wavesolver.py", "inversion.py", "fwi.py",
                         "examples/inversion_fwi.py")


@pytest.mark.parametrize("module", LEGACY_SOLVER_MODULES)
def test_legacy_and_solver_modules_are_scanned(module):
    """B15's module, the solver, the inversion utilities and the camembert
    example are among the sources the scans above read (and so import no
    JAX), beside B15's CUDA source."""
    assert os.path.join(PKG, *module.split("/")) in _port_sources()
    assert os.path.exists(os.path.join(PKG, "csrc", "acoustic2d_legacy.cu"))


def test_ctypes_signatures_match_the_legacy_source():
    """The same for cuda_legacy.SIGNATURES and csrc/acoustic2d_legacy.cu."""
    from devito_fwi_tpu_torch.ops import cuda_legacy as cl
    _check_signatures(cl, "acoustic2d_legacy.cu")


@pytest.mark.parametrize("entry", ["forward_traces", "AcousticWaveSolver",
                                   "fm_single", "fwi_obj_single",
                                   "inversion_fwi"])
def test_legacy_and_solver_entry_points_raise_on_cuda_without_card(
        entry, monkeypatch):
    """B15's host wrapper, the solver, the objectives on it and the
    camembert example default to the card: without one they raise for the
    missing device instead of running on the CPU."""
    from devito_fwi_tpu_torch import AcousticWaveSolver
    from devito_fwi_tpu_torch.examples import inversion_fwi
    from devito_fwi_tpu_torch.misfit import least_square
    from devito_fwi_tpu_torch.ops import cuda_legacy as cl
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = _geometry()
    obs = tfwi.fm_single(g, device="cpu")[0]
    calls = {
        "forward_traces": lambda: cl.forward_traces(g),
        "AcousticWaveSolver": lambda: AcousticWaveSolver(g.model, g),
        "fm_single": lambda: tfwi.fm_single(g),
        "fwi_obj_single": lambda: tfwi.fwi_obj_single(g, obs, least_square),
        "inversion_fwi": lambda: inversion_fwi.main(iterations=0),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    AcousticWaveSolver(g.model, g, device="cpu")


def test_legacy_source_runs_one_cluster_launch_a_sweep():
    """B15's entry point launches one thread-block cluster kernel a sweep
    (``cudaLaunchKernelEx`` with a cluster dimension, after the shared-
    memory attribute and an occupancy check), not a launch a step; it
    takes the source as a cell list and no u / up scratch in device
    memory; its ctypes signature and the occupancy query's follow the
    source."""
    from devito_fwi_tpu_torch.ops import cuda_legacy as cl
    src = open(os.path.join(PKG, "csrc", "acoustic2d_legacy.cu")).read()
    assert _kernels_launched("acoustic2d_legacy.cu") == set()
    assert "<<<" not in src
    for needle in ("cudaLaunchKernelEx", "cudaLaunchAttributeClusterDimension",
                   "cudaFuncAttributeMaxDynamicSharedMemorySize",
                   "cudaOccupancyMaxActiveClusters", "map_shared_rank",
                   "barrier.cluster.arrive", "barrier.cluster.wait",
                   "cudaGetLastError"):
        assert needle in src, needle
    params = src[src.index("int acoustic2d_legacy_forward("):].split(")")[0]
    assert "src_cells" in params and "src_vals" in params
    assert "inj" not in params and "float* up" not in params
    assert set(cl.SIGNATURES) == {"acoustic2d_legacy_forward",
                                  "acoustic2d_legacy_max_clusters",
                                  "acoustic2d_legacy_error_string"}
    _check_signatures(cl, "acoustic2d_legacy.cu")


@pytest.mark.parametrize("module", ["fwi.py", "optimize/math.py"])
def test_eager_route_and_math_modules_are_scanned(module):
    """The objective layer with its eager route and the port's copy of
    the optimizer's math module are among the sources the scans above read
    (and so import no JAX)."""
    assert os.path.join(PKG, *module.split("/")) in _port_sources()


def test_legacy_wrapper_rejects_other_devices():
    from devito_fwi_tpu_torch.ops import cuda_legacy as cl
    t = torch.zeros((8, 4), device="meta")
    with pytest.raises(ValueError, match="meta"):
        cl.forward_rows(t, t, torch.zeros(4, device="meta"),
                        torch.zeros((1, 8, 4), device="meta"), 1.0, nt=6,
                        nx=8, nz=4, space_order=4, spacing=(10., 10.), z0=1)


SLICE16_MODULES = ("ops/self_adjoint.py", "ops/sa_wavesolver.py",
                   "ops/abc.py", "ops/staggered.py", "ops/staggered_grad.py",
                   "ops/elastic_wavesolver.py", "misfit/bfm.py",
                   "misfit/w2.py", "drivers/circle_fwi.py",
                   "drivers/marmousi_fm.py", "drivers/marmousi2_fm.py",
                   "drivers/test_misfit.py", "drivers/_marmousi_common.py")


@pytest.mark.parametrize("module", SLICE16_MODULES)
def test_slice16_modules_are_scanned(module):
    """The self-adjoint, boundary and viscoelastic modules, the misfit
    wrappers and the remaining drivers are among the sources the scans
    above read (and so import no JAX)."""
    assert os.path.join(PKG, *module.split("/")) in _port_sources()


@pytest.mark.parametrize("entry", [
    "SaIsoAcousticWaveSolver", "acoustic_sa_setup",
    "ViscoelasticWaveSolver", "pml_acoustic_forward",
    "habc_acoustic_forward", "bfm", "bfm_torch", "circle_fwi", "run_fm",
    "test_misfit"])
def test_slice16_entry_points_raise_on_cuda_without_card(entry, monkeypatch,
                                                         tmp_path):
    """The self-adjoint and viscoelastic solvers, the boundary forwards
    handed numpy arrays, the one-gather BFM wrappers and the drivers
    default to the card: without one they raise for the missing device
    instead of running on the CPU; with ``device="cpu"`` the solvers
    build."""
    from devito_fwi_tpu_torch.drivers import circle_fwi
    from devito_fwi_tpu_torch.drivers import test_misfit
    from devito_fwi_tpu_torch.misfit import bfm, bfm_torch
    from devito_fwi_tpu_torch.models.geometry import setup_geometry
    from devito_fwi_tpu_torch.ops import abc
    from devito_fwi_tpu_torch.ops.elastic_wavesolver import (
        ViscoelasticWaveSolver)
    from devito_fwi_tpu_torch.ops.sa_wavesolver import (
        SaIsoAcousticWaveSolver, acoustic_sa_setup)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    sa = acoustic_sa_setup(shape=(21, 21), spacing=(10., 10.), tn=50.,
                           nbl=4, device="cpu")
    ve = demo_model("layers-viscoelastic", shape=(21, 21),
                    spacing=(20., 20.), nbl=4, space_order=4)
    vg = setup_geometry(ve, 50.)
    v = np.full((21, 21), 1.5, np.float32)
    idx, w = np.zeros((1, 4, 2), np.int32), np.zeros((1, 4), np.float32)
    wav = np.zeros((10, 1), np.float32)
    gather = np.ones((8, 4), np.float32)
    calls = {
        "SaIsoAcousticWaveSolver": lambda: SaIsoAcousticWaveSolver(
            sa.model, sa.geometry),
        "acoustic_sa_setup": lambda: acoustic_sa_setup(
            shape=(21, 21), spacing=(10., 10.), tn=50., nbl=4),
        "ViscoelasticWaveSolver": lambda: ViscoelasticWaveSolver(ve, vg),
        "pml_acoustic_forward": lambda: abc.pml_acoustic_forward(
            v, wav, idx, w, idx, w, 1.0, nt=10, spacing=(10., 10.),
            npml=4),
        "habc_acoustic_forward": lambda: abc.habc_acoustic_forward(
            v, wav, idx, w, idx, w, 1.0, nt=10, spacing=(10., 10.),
            npml=4),
        "bfm": lambda: bfm(),
        "bfm_torch": lambda: bfm_torch(gather, gather),
        "circle_fwi": lambda: circle_fwi.main(["--maxiter", "1"]),
        "run_fm": lambda: marm.run_fm(marm.SMARMN, ["--nsrc", "1"]),
        "test_misfit": lambda: test_misfit.main([]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    SaIsoAcousticWaveSolver(sa.model, sa.geometry, device="cpu")
    ViscoelasticWaveSolver(ve, vg, device="cpu")


SLICE17_MODULES = ("ops/remat.py", "utils/nmo.py", "utils/plotting.py",
                   "utils/profiling.py", "examples/staggered_acoustic.py",
                   "examples/time_update.py", "examples/time_blocking.py")


@pytest.mark.parametrize("module", SLICE17_MODULES)
def test_slice17_modules_are_scanned(module):
    """The checkpointed loop, the utilities and the three tutorial examples
    are among the sources the scans above read (and so import no JAX)."""
    assert os.path.join(PKG, *module.split("/")) in _port_sources()


@pytest.mark.parametrize("entry", [
    "staggered_acoustic", "time_update", "time_blocking", "elastic_saved",
    "elastic_vjp", "visco_vjp", "visco_other_kernel", "visco_fm_other"])
def test_slice17_entry_points_raise_on_cuda_without_card(entry, monkeypatch):
    """The examples and the objectives' eager routes default to the card:
    without one they raise for the missing device instead of running on
    the CPU."""
    from devito_fwi_tpu_torch.examples import (staggered_acoustic,
                                               time_blocking, time_update)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    eg = _elastic_geometry()
    eobs, _ = tel.elastic_fm_multi(eg, device="cpu")
    vg = _visco_geometry()
    vobs = tvf.visco_fm_multi(vg, device="cpu")
    calls = {
        "staggered_acoustic": lambda: staggered_acoustic.main([]),
        "time_update": lambda: time_update.main([]),
        "time_blocking": lambda: time_blocking.main([]),
        "elastic_saved": lambda: tel.elastic_fwi_obj_multi(
            eg, eobs, calc_grad=True, grad_route="saved"),
        "elastic_vjp": lambda: tel.elastic_fwi_obj_multi(
            eg, eobs, calc_grad=True, grad_route="vjp"),
        "visco_vjp": lambda: tvf.visco_fwi_obj_multi(
            vg, vobs, calc_grad=True, grad_route="vjp"),
        "visco_other_kernel": lambda: tvf.visco_fwi_obj_multi(
            vg, vobs, calc_grad=True, kernel="ren", time_order=1),
        "visco_fm_other": lambda: tvf.visco_fm_multi(vg, "deng_mcmechan", 1),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


PARALLEL_MODULES = ("parallel/__init__.py", "parallel/group.py",
                    "parallel/sharding.py", "parallel/domain.py",
                    "parallel/dryrun.py", "tools/probe_allreduce.py")


@pytest.mark.parametrize("module", PARALLEL_MODULES)
def test_parallel_modules_are_scanned(module):
    """The parallel layer's modules are among the sources the scans above
    read (and so import no JAX)."""
    assert os.path.join(PKG, *module.split("/")) in _port_sources()


@pytest.mark.parametrize("entry", [
    "shot_mesh", "domain_mesh", "hier_mesh", "fm_multi_sharded",
    "fwi_obj_sharded", "tti_fwi_obj_sharded", "viscoacoustic_fm_sharded",
    "elastic_fwi_obj_sharded", "viscoacoustic_fwi_obj_sharded",
    "viscoelastic_fwi_obj_sharded", "sa_fwi_obj_sharded",
    "forward_domain_sharded", "gradient_domain_sharded",
    "fwi_obj_sharded2d", "fm_multi_parallel", "fwi_obj_multi_parallel",
    "spawn", "dryrun_multichip"])
def test_parallel_entry_points_raise_on_cuda_without_card(entry,
                                                         monkeypatch):
    """A mesh asked for the card (the default) on a host without one
    raises before anything runs, as does ``spawn`` before it starts a
    process: the parallel layer never falls back to the CPU."""
    from devito_fwi_tpu_torch.parallel import dryrun, group
    from devito_fwi_tpu_torch.parallel import sharding as sh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = _geometry()
    obs = tfwi.fm_multi(g, device="cpu")
    zeros = np.zeros((1, g.nt, 11), np.float32)
    calls = {
        "shot_mesh": lambda: sh.shot_mesh(),
        "domain_mesh": lambda: sh.domain_mesh((1, 1)),
        "hier_mesh": lambda: sh.hier_mesh((1, 1)),
        "fm_multi_sharded": lambda: sh.fm_multi_sharded(g),
        "fwi_obj_sharded": lambda: sh.fwi_obj_sharded(g, obs, None,
                                                      calc_grad=True),
        "tti_fwi_obj_sharded": lambda: sh.tti_fwi_obj_sharded(g, zeros),
        "viscoacoustic_fm_sharded": lambda: sh.viscoacoustic_fm_sharded(g),
        "elastic_fwi_obj_sharded": lambda: sh.elastic_fwi_obj_sharded(
            g, zeros),
        "viscoacoustic_fwi_obj_sharded":
            lambda: sh.viscoacoustic_fwi_obj_sharded(g, zeros),
        "viscoelastic_fwi_obj_sharded":
            lambda: sh.viscoelastic_fwi_obj_sharded(g, zeros),
        "sa_fwi_obj_sharded": lambda: sh.sa_fwi_obj_sharded(g, zeros),
        "forward_domain_sharded": lambda: sh.forward_domain_sharded(g),
        "gradient_domain_sharded": lambda: sh.gradient_domain_sharded(
            g, zeros[0]),
        "fwi_obj_sharded2d": lambda: sh.fwi_obj_sharded2d(g, obs, None),
        "fm_multi_parallel": lambda: tfwi.fm_multi_parallel(None, g),
        "fwi_obj_multi_parallel": lambda: tfwi.fwi_obj_multi_parallel(
            None, g, obs, None, calc_grad=True),
        "spawn": lambda: group.spawn(print, 2, device="cuda"),
        "dryrun_multichip": lambda: dryrun.dryrun_multichip(2),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
