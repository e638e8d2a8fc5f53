"""The port's domain decomposition and shots x domain objective
(``devito_fwi_tpu_torch.parallel.domain``: ``domain_mesh``,
``forward_domain_sharded``, ``gradient_domain_sharded``, ``hier_mesh``,
``fwi_obj_sharded2d``) and the multi-rank dry run
(``parallel.dryrun.dryrun_multichip``):

* the decomposed forward and checkpointed gradient are ``torch.equal`` to
  the port's undecomposed eager operators (``ops.acoustic.forward``,
  ``forward_ckpt`` + ``gradient_from_ckpt`` on the same edge-padded grid)
  at float32 and float64, on meshes (2, 1) (two of four ranks: the other
  two return None), (2, 2), a 3-D grid under (2, 2) (z whole) and a free
  surface under (2, 2) (the fix on the z = 0 slabs only);
* the same against the JAX package's sharded functions (its GSPMD runs on
  the conftest's 8-device CPU mesh), and ``fwi_obj_sharded2d`` on (2, 2)
  and (4, 1) against its: within 1e-10 at float64 (objective relative,
  gradients and gathers of their max), within 1e-5 and 3e-5 at float32;
* a split that leaves a slab thinner than 2r + 1 cells is refused before
  any step, along either axis;
* ``dryrun_multichip(2)`` on two CPU ranks, every figure finite.

The port's side runs in four spawned gloo ranks (one torch thread each,
no JAX) beside the JAX references, and the dry run in two.
"""
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from devito_fwi_tpu import AcquisitionGeometry, SeismicModel, demo_model
from devito_fwi_tpu import fwi as jfwi
from devito_fwi_tpu.misfit import least_square
from devito_fwi_tpu.ops.self_adjoint import setup_w_over_q
from devito_fwi_tpu.parallel import sharding as jsh

from devito_fwi_tpu_torch import fwi as tfwi
from devito_fwi_tpu_torch.ops import acoustic as tac
from devito_fwi_tpu_torch.parallel import domain as tdm
from devito_fwi_tpu_torch.parallel import group

JAX_LIB = SimpleNamespace(demo_model=demo_model, SeismicModel=SeismicModel,
                          AcquisitionGeometry=AcquisitionGeometry,
                          setup_w_over_q=setup_w_over_q)
F32, F64 = np.float32, np.float64
TOL = {F64: (1e-10, 1e-10), F32: (1e-5, 3e-5)}
TIMEOUT = 240
NCK = 12
# (name, recipe, recipe keywords, mesh axes)
DOMAIN = [(f"{name}_{dt.__name__}", recipe, dict(kw, dtype=dt), axes)
          for dt in (F32, F64)
          for name, recipe, kw, axes in (
              ("split21", "acoustic", {}, (2, 1)),
              ("split22", "acoustic", {}, (2, 2)),
              ("fs22", "acoustic", dict(fs=True), (2, 2)),
              ("3d22", "acoustic3d", {}, (2, 2)))]
HIER = [("hier22_float32", F32, (2, 2)), ("hier22_float64", F64, (2, 2)),
        ("hier41_float64", F64, (4, 1))]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _geometry(lib, recipe, kw, index):
    out = R.build(lib, recipe, **kw)
    return out if recipe == "acoustic3d" else out[index]


def _residual(recipe, kw):
    """The adjoint source: syn - obs of the first shot (JAX fm_multi), or
    half the traces in 3-D (as tests/test_sharding.py)."""
    if recipe == "acoustic3d":
        g = _geometry(JAX_LIB, recipe, kw, None)
        return 0.5 * jfwi.fm_multi(g)[0].data
    g1, g0 = (_geometry(JAX_LIB, recipe, kw, i) for i in (0, 1))
    return (jfwi.fm_multi(g0)[0].data - jfwi.fm_multi(g1)[0].data).astype(
        g0.model.dtype)


def _cases():
    cases = {}
    for name, recipe, kw, axes in DOMAIN:
        index = None if recipe == "acoustic3d" else 1
        base = dict(recipe=recipe, index=index, recipe_kw=kw, axes=axes)
        cases["fwd_" + name] = dict(base, fn="forward_domain_sharded")
        cases["grad_" + name] = dict(base, fn="gradient_domain_sharded",
                                     residual=_residual(recipe, kw),
                                     kw=dict(n_checkpoints=NCK))
    for name, dt, axes in HIER:
        g1 = _geometry(JAX_LIB, "acoustic", dict(dtype=dt), 0)
        cases[name] = dict(recipe="acoustic", index=1,
                           recipe_kw=dict(dtype=dt), axes=axes,
                           obs=np.stack([o.data for o in
                                         jfwi.fm_multi(g1)]),
                           fn="fwi_obj_sharded2d", kw=dict(calc_grad=True))
    return cases


@pytest.fixture(scope="module")
def cases():
    return _cases()


@pytest.fixture(scope="module")
def worlds(cases):
    with ThreadPoolExecutor(2) as pool:
        yield {"cases": pool.submit(group.spawn, R.run_cases, 4,
                                    args=(cases,), timeout=TIMEOUT),
               "dryrun": pool.submit(group.spawn, R.run_dryrun, 2,
                                     timeout=TIMEOUT)}


@pytest.fixture(scope="module")
def jax_ref(cases, worlds):
    ref = {}
    for name, c in cases.items():
        geom = _geometry(JAX_LIB, c["recipe"], c["recipe_kw"], c["index"])
        if c["fn"] == "fwi_obj_sharded2d":
            obs = [SimpleNamespace(data=d) for d in c["obs"]]
            ref[name] = jsh.fwi_obj_sharded2d(
                geom, obs, least_square, calc_grad=True,
                mesh=jsh.hier_mesh(c["axes"]))
        elif c["fn"] == "forward_domain_sharded":
            ref[name] = jsh.forward_domain_sharded(
                geom, mesh=jsh.domain_mesh(c["axes"]))
        else:
            ref[name] = jsh.gradient_domain_sharded(
                geom, c["residual"], mesh=jsh.domain_mesh(c["axes"]),
                n_checkpoints=NCK)
    return ref


@pytest.fixture(scope="module")
def port(worlds, jax_ref):
    return worlds["cases"].result()


def _undecomposed(c):
    """The port's eager operators on the whole edge-padded grid: the
    traces of ``forward``, or the gradient of ``forward_ckpt`` +
    ``gradient_from_ckpt`` cropped to the model's padded grid."""
    geom = _geometry(R.port_lib(), c["recipe"], c["recipe_kw"], c["index"])
    model = geom.model
    vp, damp, _ = tdm._padded_fields(model, c["axes"])
    es = tfwi._EagerSetup(geom, torch.device("cpu"))
    vp = torch.as_tensor(vp)
    damp = torch.as_tensor(damp) if isinstance(damp, np.ndarray) else damp
    shot = (vp, damp, es.src_wav, es.s_idx[0], es.s_w[0])
    kw = dict(nt=geom.nt, spacing=model.spacing,
              space_order=model.space_order, fs=model.fs, step3=False)
    dt = float(tfwi._solver_dt(geom))
    if c["fn"] == "forward_domain_sharded":
        return tac.forward(*shot, es.r_idx, es.r_w_np, dt, **kw)[0].numpy()
    _, starts, _ = tac.forward_ckpt(*shot, es.r_idx, es.r_w_np, dt,
                                    n_checkpoints=NCK, **kw)
    g, _ = tac.gradient_from_ckpt(*shot, starts,
                                  torch.as_tensor(c["residual"]), es.r_idx,
                                  es.r_w_np, dt, n_checkpoints=NCK, **kw)
    return g[tuple(slice(0, n) for n in model.padded_shape)].numpy()


@pytest.mark.parametrize("fn", ["fwd", "grad"])
@pytest.mark.parametrize("name", [d[0] for d in DOMAIN])
def test_decomposed_operators_equal_the_undecomposed(cases, port, fn, name):
    """Every rank of the mesh returns the whole result, equal bitwise to
    the undecomposed operator's; ranks outside a (2, 1) mesh return
    None."""
    c = cases[f"{fn}_{name}"]
    want = torch.as_tensor(_undecomposed(c))
    n = int(np.prod(c["axes"]))
    for rank, out in enumerate(port):
        got = out[f"{fn}_{name}"]
        if rank >= n:
            assert got is None
            continue
        assert torch.equal(torch.as_tensor(got), want), (rank, name)


@pytest.mark.parametrize("fn", ["fwd", "grad"])
@pytest.mark.parametrize("name", [d[0] for d in DOMAIN])
def test_decomposed_operators_match_jax(port, jax_ref, fn, name):
    got, want = port[0][f"{fn}_{name}"], jax_ref[f"{fn}_{name}"]
    assert got.shape == want.shape
    dtype = F64 if name.endswith("float64") else F32
    assert _rel(got, want) < TOL[dtype][1]


@pytest.mark.parametrize("name,dtype,axes", HIER,
                         ids=[h[0] for h in HIER])
def test_shots_by_domain_objective_matches_jax(port, jax_ref, name, dtype,
                                               axes):
    f, g = port[0][name]
    f_ref, g_ref = jax_ref[name]
    tf, tg = TOL[dtype]
    assert g.shape == g_ref.shape
    assert abs(f - f_ref) <= tf * abs(f_ref)
    assert _rel(g, g_ref) < tg
    for out in port[1:]:
        assert out[name][0] == f and np.array_equal(out[name][1], g)


def test_a_thin_split_is_refused_before_any_step():
    """Slabs of 3 cells along x and 2 along z (the free surface's grid has
    no top padding) at space order 4, where the halo and the free-surface
    rows need 2r + 1 = 5, are refused when the operator is built: no step
    and no collective runs (the meshes here have no process group)."""
    geom = R.build(R.port_lib(), "acoustic", 1, dtype=F32, fs=True)
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="3 cells along axis 0.*at least 5"):
        tdm.forward_domain_sharded(
            geom, mesh=group.Mesh((32, 1), ("dx", "dz"), None, 0, cpu))
    with pytest.raises(ValueError, match="2 cells along axis 1"):
        tdm.gradient_domain_sharded(
            geom, None, mesh=group.Mesh((1, 32), ("dx", "dz"), None, 0, cpu))


def test_dryrun_on_two_ranks(worlds):
    out = worlds["dryrun"].result()
    assert set(out[0]) >= {"acoustic", "domain_forward", "domain_gradient",
                           "tti", "elastic", "visco_fm", "visco",
                           "viscoelastic", "sa", "w2", "hier"}
    assert all(np.isfinite(v).all() for v in
               (np.asarray(x, np.float64) for x in out[0].values()))
    assert out[0]["_jax_modules"] == []
