"""The port's shot-parallel layer (``devito_fwi_tpu_torch.parallel``: the
acoustic ``fm_multi_sharded`` and ``fwi_obj_sharded``, ``fwi``'s
``fm_multi_parallel`` and ``fwi_obj_multi_parallel``, the meshes, the
budget share and ``spawn``) against the JAX package's sharded functions,
case for case with tests/test_sharding.py's geometries:

* the JAX side runs in this process on the conftest's 8-device CPU mesh,
  each reference computed once for the module;
* the port's side runs in ranks spawned by ``parallel.spawn`` (gloo on
  the CPU, one torch thread each; they never import JAX): four ranks for
  every case, two for the world-size comparison, two for the failure;
* within 1e-10 at float64 (objective relative, gradient of its max; the
  gathers of their max) and at float32 within the port's limits, 1e-5 and
  3e-5 (the frameworks round the same float32 operations in another
  order; the kernel route against the JAX Pallas route in interpret mode,
  whose association the twins repeat);
* receivers on the vertical line x = 460 m take the port's eager route,
  on z = 30 m its kernel route (the twins here); the host-misfit path
  (a W2-2d misfit without its device form) at float64;
* a world of one is ``fwi_obj_multi`` bitwise; a world larger than the
  shots (ranks without shots) matches a smaller one; shot chunks of one
  match a single pass.
"""
import os
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from devito_fwi_tpu import AcquisitionGeometry, SeismicModel, demo_model
from devito_fwi_tpu import fwi as jfwi
from devito_fwi_tpu.misfit import least_square, qWasserstein
from devito_fwi_tpu.ops.self_adjoint import setup_w_over_q
from devito_fwi_tpu.parallel import sharding as jsh

from devito_fwi_tpu_torch import fwi as tfwi
from devito_fwi_tpu_torch.parallel import group, sharding as tsh

JAX_LIB = SimpleNamespace(demo_model=demo_model, SeismicModel=SeismicModel,
                          AcquisitionGeometry=AcquisitionGeometry,
                          setup_w_over_q=setup_w_over_q)
F32, F64 = np.float32, np.float64
# objective (relative) and gradient (of its max) at each float type
TOL = {F64: (1e-10, 1e-10), F32: (1e-5, 3e-5)}
# The float32 kernel route on this geometry: the port's objective differs
# from the JAX package's by 2.0e-5 and its gradient by 8.3e-5 of the max,
# single-device as sharded, while each framework's float32 objective lies
# 6e-5 to 8e-5 from the float64 one (the weak circle's residual is a small
# difference of large traces). The JAX test holds its own two routes to
# 1e-4 on it (tests/test_sharding.py); so does this one, and the sharded
# result is held to the port's single-device one to 1e-6. The cause
# (tests/test_torch_f32_rounding.py): XLA's CPU compiler fuses the
# stencil's multiply-adds and the port rounds each product, so the JAX
# package's observed data and its Pallas route's synthetics round alike and
# cancel in the small residual, the port's synthetics do not; with data it
# models itself the port's gradient lies as close to float64 as the JAX
# route's.
KERNEL_F32_TOL = (1e-4, 1e-4)
# the JAX package's Pallas route in interpret mode on the CPU
PALLAS_ENV = {"DEVITO_FWI_TPU_PALLAS": "1",
              "DEVITO_FWI_TPU_PALLAS_INTERPRET": "1"}
# seconds a spawned world may take before the test fails
TIMEOUT = 240


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _close(f, g, f_ref, g_ref, dtype, tol=None):
    tf, tg = tol or TOL[dtype]
    assert abs(f - f_ref) <= tf * abs(f_ref), (f, f_ref)
    assert _rel(np.reshape(g, np.shape(g_ref)), g_ref) < tg


class _HostOnly:
    """The JAX W2-2d misfit with its traceable form hidden."""
    method = "2d"
    bfm_backend = "host"

    def __init__(self, num_steps):
        self.qw = qWasserstein(gamma=1.01, method="2d", num_steps=num_steps,
                               step_scale=1., bfm_backend="jax")

    def __call__(self, f, g):
        return self.qw(f, g)


def _cases(nsrc3=True):
    """The port's cases (name -> ``torch_parallel_ranks._call`` case) with
    the JAX package's observed data."""
    cases = {}
    for dt in (F32, F64):
        for line, vertical in (("eager", True), ("kernel", False)):
            rk = dict(dtype=dt, vertical=vertical)
            g1, _ = R.build(JAX_LIB, "acoustic", **rk)
            obs = np.stack([o.data for o in jfwi.fm_multi(g1)])
            base = dict(recipe="acoustic", index=1, recipe_kw=rk, obs=obs)
            cases[f"grad_{line}_{dt.__name__}"] = dict(
                base, fn="fwi_obj_sharded", kw=dict(calc_grad=True))
            cases[f"trial_{line}_{dt.__name__}"] = dict(
                base, fn="fwi_obj_sharded", kw=dict(calc_grad=False))
            cases[f"fm_{line}_{dt.__name__}"] = dict(
                recipe="acoustic", index=0, recipe_kw=rk,
                fn="fm_multi_sharded")
    k32 = cases["grad_kernel_float32"]
    cases["chunked_kernel_float32"] = dict(k32, shot_chunk=1)
    cases["fmpar_eager_float64"] = dict(cases["fm_eager_float64"],
                                        fn="fm_multi_parallel")
    e64 = cases["grad_eager_float64"]
    cases["objpar_eager_float64"] = dict(e64, fn="fwi_obj_multi_parallel")
    cases["host_w2_float64"] = dict(e64, host_steps=6)
    if nsrc3:
        rk = dict(dtype=F64, vertical=True, nsrc=3)
        g1, _ = R.build(JAX_LIB, "acoustic", **rk)
        cases["grad_nsrc3_float64"] = dict(
            recipe="acoustic", index=1, recipe_kw=rk,
            obs=np.stack([o.data for o in jfwi.fm_multi(g1)]),
            fn="fwi_obj_sharded", kw=dict(calc_grad=True))
    return cases


@pytest.fixture(scope="module")
def cases():
    return _cases()


@pytest.fixture(scope="module")
def worlds(cases):
    """The spawned worlds, started before the JAX references are computed
    and running beside them: four ranks on every case, two on the
    three-shot one."""
    sub = {"grad_nsrc3_float64": cases["grad_nsrc3_float64"]}
    with ThreadPoolExecutor(2) as pool:
        yield {n: pool.submit(group.spawn, R.run_cases, n, args=(c,),
                              timeout=TIMEOUT)
               for n, c in ((4, cases), (2, sub))}


@pytest.fixture(scope="module")
def port(cases, worlds, jax_ref):
    """The port's results of every case from the four ranks (all ranks'
    results must agree bitwise)."""
    outs = worlds[4].result()
    for o in outs[1:]:
        for k in cases:
            a, b = (outs[0][k], o[k])
            a = a if isinstance(a, tuple) else (a,)
            b = b if isinstance(b, tuple) else (b,)
            for x, y in zip(a, b):
                assert np.array_equal(np.asarray(x), np.asarray(y)), k
    return outs


@pytest.fixture(scope="module")
def jax_ref(cases):
    return _jax_ref(cases)


def _jax_ref(cases):
    """The JAX package's sharded results of every case, on its 8-device
    CPU mesh. A trial's objective is the gradient call's (the JAX package
    computes the two the same way); the float32 kernel route's reference
    is the JAX package's Pallas route in interpret mode, whose arithmetic
    the twins repeat (its XLA route associates the float32 sums another
    way: the two JAX routes differ by up to 1e-4, tests/test_sharding.py)."""
    ref = {}
    for name, c in cases.items():
        if name.startswith("trial_") or name.startswith("chunked_"):
            continue
        geom = R.build(JAX_LIB, c["recipe"], c["index"], **c["recipe_kw"])
        if c["fn"] == "fm_multi_sharded":
            ref[name] = np.stack([o.data for o in jsh.fm_multi_sharded(geom)])
            continue
        if c["fn"] == "fm_multi_parallel":
            ref[name] = np.stack([o.data for o in
                                  jfwi.fm_multi_parallel(None, geom)])
            continue
        obs = _jax_records(geom, c["obs"])
        misfit = _HostOnly(c["host_steps"]) if "host_steps" in c \
            else least_square
        if c["fn"] == "fwi_obj_multi_parallel":
            ref[name] = jfwi.fwi_obj_multi_parallel(None, geom, obs, misfit,
                                                    calc_grad=True)
            continue
        pallas = name == "grad_kernel_float32"
        saved = {k: os.environ.get(k) for k in PALLAS_ENV}
        if pallas:
            os.environ.update(PALLAS_ENV)
        try:
            ref[name] = jsh.fwi_obj_sharded(geom, obs, misfit, calc_grad=True,
                                            mesh=jsh.shot_mesh())
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    for name in cases:
        if name.startswith("trial_"):
            ref[name] = ref["grad_" + name[len("trial_"):]]
    ref["chunked_kernel_float32"] = ref["grad_kernel_float32"]
    return ref


def _jax_records(geometry, stack):
    from devito_fwi_tpu.models.sources import PointSource
    out = []
    for s in stack:
        p = PointSource(name="rec", time_range=geometry.time_axis,
                        coordinates=geometry.rec_positions,
                        dtype=geometry.model.dtype)
        p.data[:] = s
        out.append(p)
    return out


@pytest.mark.parametrize("line", ["eager", "kernel"])
@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_shot_sharded_objective_matches_jax(port, jax_ref, line, dtype):
    name = f"grad_{line}_{dtype.__name__}"
    f, g = port[0][name]
    f_ref, g_ref = jax_ref[name]
    assert g.shape == g_ref.shape
    tol = KERNEL_F32_TOL if (line, dtype) == ("kernel", F32) else None
    _close(f, g, f_ref, g_ref, dtype, tol)


@pytest.mark.parametrize("line", ["eager", "kernel"])
@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_shot_sharded_trial_matches_jax(port, jax_ref, line, dtype):
    name = f"trial_{line}_{dtype.__name__}"
    f, g = port[0][name]
    f_ref = jax_ref[name][0]
    tol = KERNEL_F32_TOL if (line, dtype) == ("kernel", F32) else TOL[dtype]
    assert abs(f - f_ref) <= tol[0] * abs(f_ref)
    assert not np.any(g)


@pytest.mark.parametrize("line", ["eager", "kernel"])
@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_fm_sharded_matches_jax(port, jax_ref, line, dtype):
    name = f"fm_{line}_{dtype.__name__}"
    got, want = port[0][name], jax_ref[name]
    assert got.shape == want.shape
    assert _rel(got, want) < TOL[dtype][1]


def test_parallel_wrappers_match_jax(port, jax_ref):
    """``fwi.fm_multi_parallel`` and ``fwi.fwi_obj_multi_parallel`` (the
    client ignored) against the JAX package's, and equal to the sharded
    functions they call."""
    out = port[0]
    assert np.array_equal(out["fmpar_eager_float64"],
                          out["fm_eager_float64"])
    assert _rel(out["fmpar_eager_float64"],
                jax_ref["fmpar_eager_float64"]) < TOL[F64][1]
    f, g = out["objpar_eager_float64"]
    assert f == out["grad_eager_float64"][0]
    assert np.array_equal(g, out["grad_eager_float64"][1])
    _close(f, g, *jax_ref["objpar_eager_float64"], F64)


def test_kernel_route_matches_the_single_device_objective(cases, port):
    """The float32 kernel route over four ranks against the port's
    single-device ``fwi_obj_multi`` on the same data (the sums meet in
    another order)."""
    c = cases["grad_kernel_float32"]
    geom = R.build(R.port_lib(), "acoustic", 1, **c["recipe_kw"])
    f, g, _ = tfwi.fwi_obj_multi(geom, R.records(geom, c["obs"]), None,
                                 calc_grad=True, device="cpu")
    fs, gs = port[0]["grad_kernel_float32"]
    assert abs(fs - f) <= 1e-6 * abs(f) and _rel(gs.reshape(-1), g) < 1e-6


def test_sharded_objective_chunks_match_single_pass(port):
    """Shot chunks of one on each rank against one chunk a rank (the
    chunked sums reorder the float32 additions)."""
    f1, g1 = port[0]["grad_kernel_float32"]
    f2, g2 = port[0]["chunked_kernel_float32"]
    assert abs(f2 - f1) <= 1e-6 * abs(f1)
    assert _rel(g2, g1) < 1e-6


def test_shot_sharded_host_misfit_objective_matches_jax(port, jax_ref):
    """A misfit the device does not compute takes the host-misfit path on
    each rank (the W2-2d BFM through the misfit's numpy call)."""
    _close(*port[0]["host_w2_float64"], *jax_ref["host_w2_float64"], F64)


def test_world_larger_than_the_shots_matches_a_smaller_one(worlds, port,
                                                           jax_ref):
    """Four ranks on three shots (one rank without shots joins the sums
    with zeros) against two ranks, and both against the JAX package."""
    two = worlds[2].result()[0]
    f4, g4 = port[0]["grad_nsrc3_float64"]
    f2, g2 = two["grad_nsrc3_float64"]
    assert abs(f4 - f2) <= 1e-13 * abs(f2) and _rel(g4, g2) < 1e-13
    _close(f4, g4, *jax_ref["grad_nsrc3_float64"], F64)


def test_ranks_import_no_jax(port):
    assert all(o["_jax_modules"] == [] for o in port)


def test_world_of_one_is_the_single_device_objective():
    """Without ``torch.distributed`` the mesh is a world of one: the
    sharded objective and modeling are ``fwi_obj_multi`` and ``fm_multi``
    bitwise (the reduction adds nothing)."""
    g1, g0 = R.build(R.port_lib(), "acoustic", dtype=F32, vertical=False)
    mesh = tsh.shot_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.coords, mesh.share) == (1, 0, (0,), 1)
    obs = tfwi.fm_multi(g1, device="cpu")
    got = tsh.fm_multi_sharded(g1, mesh=mesh)
    assert all(np.array_equal(a.data, b.data) for a, b in zip(got, obs))
    f, g, _ = tfwi.fwi_obj_multi(g0, obs, None, calc_grad=True,
                                 device="cpu")
    fs, gs = tsh.fwi_obj_sharded(g0, obs, None, calc_grad=True, mesh=mesh)
    assert fs == f and np.array_equal(gs.reshape(-1), g)


def test_budget_share_divides_the_device_budget(monkeypatch):
    """Inside ``budget_share`` the ranks that share a card each get their
    part of ``fwi._device_budget``, and the share ends with the block."""
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (1000, 0))
    monkeypatch.setattr(torch.cuda, "memory_snapshot", lambda: [])
    dev = torch.device("cuda", 0)
    mesh = SimpleNamespace(share=4)
    whole = tfwi._device_budget(dev)
    with group.budget_share(mesh):
        assert tfwi._device_budget(dev) == whole // 4
    assert tfwi._device_budget(dev) == whole == 800


def test_blocks_cover_the_shots_once():
    for n, parts in ((5, 4), (3, 4), (29, 4), (1, 2)):
        blocks = [group.block(n, parts, i) for i in range(parts)]
        assert np.array_equal(np.concatenate(blocks), np.arange(n))


def test_spawn_reraises_a_rank_failure():
    """A rank that fails stops its world, and its error reaches the
    caller (the other rank, waiting in a collective, is stopped)."""
    with pytest.raises(RuntimeError) as err:
        group.spawn(R.fail_on_rank, 2, args=(1,), timeout=TIMEOUT)
    assert str(err.value).startswith("rank 1 of 2 failed")
    assert "rank 1 fails on purpose" in str(err.value)
