"""The port's shot-sharded objectives of the other families
(``devito_fwi_tpu_torch.parallel.sharding``: ``tti_fwi_obj_sharded`` in
2-D and in 3-D with a scalar phi, ``viscoacoustic_fm_sharded``,
``elastic_fwi_obj_sharded``, ``viscoacoustic_fwi_obj_sharded``,
``viscoelastic_fwi_obj_sharded``, ``sa_fwi_obj_sharded``) against the JAX
package's, case for case with tests/test_sharding.py's geometries:

* the JAX side in this process on the conftest's 8-device CPU mesh, once
  for the module, with its observed data (zero traces for TTI, as its
  test);
* the port's side in four spawned gloo ranks (one torch thread each, no
  JAX), started before the JAX references and running beside them; every
  case has fewer shots than ranks but TTI 2-D and the viscoacoustic
  modeling, so ranks without shots join the sums;
* within 1e-10 at float64 (objective relative, each gradient of its max;
  the gathers of their max) and within 1e-5 and 3e-5 at float32; the
  elastic and viscoacoustic gradients run the port's kernel route (the
  twins here) against the JAX package's vjp and saved routes, the same
  discrete gradient;
* the objective without a gradient (``calc_grad=False``) against the JAX
  gradient call's objective.
"""
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_ranks as R
from devito_fwi_tpu import AcquisitionGeometry, SeismicModel, demo_model
from devito_fwi_tpu.elastic_fwi import elastic_fm_multi
from devito_fwi_tpu.fwi import _batched_tables
from devito_fwi_tpu.misfit import least_square
from devito_fwi_tpu.ops import self_adjoint as jsa
from devito_fwi_tpu.ops import staggered as jst
from devito_fwi_tpu.parallel import sharding as jsh
from devito_fwi_tpu.visco_fwi import visco_fm_multi

from devito_fwi_tpu_torch.parallel import group

JAX_LIB = SimpleNamespace(demo_model=demo_model, SeismicModel=SeismicModel,
                          AcquisitionGeometry=AcquisitionGeometry,
                          setup_w_over_q=jsa.setup_w_over_q)
F32, F64 = np.float32, np.float64
TOL = {F64: (1e-10, 1e-10), F32: (1e-5, 3e-5)}
TIMEOUT = 240
GRADS = {"tti2d": None, "tti3d": None, "elastic": ("vp", "vs", "rho"),
         "visco": ("vp", "qp"), "viscoelastic": ("vp", "vs", "rho", "qp",
                                                 "qs"), "sa": None}
FNS = {"tti2d": "tti_fwi_obj_sharded", "tti3d": "tti_fwi_obj_sharded",
       "elastic": "elastic_fwi_obj_sharded",
       "visco": "viscoacoustic_fwi_obj_sharded",
       "viscoelastic": "viscoelastic_fwi_obj_sharded",
       "sa": "sa_fwi_obj_sharded"}
KW = {"tti2d": dict(n_checkpoints=7), "tti3d": dict(n_checkpoints=4),
      "elastic": dict(n_checkpoints=5), "visco": {},
      "viscoelastic": dict(precond=False), "sa": dict(precond=False)}
FAMILY_CASES = [("tti2d", F32), ("tti2d", F64), ("tti3d", F32),
                ("elastic", F32), ("elastic", F64), ("visco", F32),
                ("visco", F64), ("viscoelastic", F32),
                ("viscoelastic", F64), ("sa", F32), ("sa", F64)]
TRIALS = [("tti2d", F64), ("viscoelastic", F64), ("sa", F64),
          ("elastic", F64), ("visco", F64)]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _observed(family, dtype):
    """The JAX package's observed data of a family's case (nsrc, nt,
    nrec), as its test makes them."""
    if family in ("tti2d", "tti3d"):
        g = R.build(JAX_LIB, family, dtype=dtype)
        return np.zeros((g.nsrc, g.nt, g.rec_positions.shape[0]), dtype)
    gt = R.build(JAX_LIB, family, 0, dtype=dtype)
    if family == "elastic":
        return np.stack([o.data for o in elastic_fm_multi(gt)[0]])
    if family == "visco":
        return np.stack([o.data for o in visco_fm_multi(gt)])
    m = gt.model
    s_idx, s_w, r_idx, r_w, src_wav = _batched_tables(gt)
    kw = dict(nt=gt.nt, spacing=m.spacing, space_order=m.space_order)
    dt = float(m.critical_dt)
    out = []
    for i in range(gt.nsrc):
        shot = (jnp.asarray(src_wav), jnp.asarray(s_idx[i]),
                jnp.asarray(s_w[i]), jnp.asarray(r_idx), jnp.asarray(r_w))
        if family == "viscoelastic":
            r, _ = jst.viscoelastic_forward(
                *(jnp.asarray(np.asarray(getattr(m, n)))
                  for n in ("lam", "mu", "b", "qp", "qs", "damp")),
                gt.f0, *shot, dt, **kw)
        else:
            r, _ = jsa.forward(*(jnp.asarray(np.asarray(getattr(m, n)))
                                 for n in ("vp", "b", "damp")), *shot, dt,
                               **kw)
        out.append(np.asarray(r))
    return np.stack(out)


def _name(family, dtype, trial=False):
    return f"{'trial' if trial else 'grad'}_{family}_{dtype.__name__}"


def _cases():
    cases, obs = {}, {}
    for family, dt in FAMILY_CASES:
        obs[family, dt] = _observed(family, dt)
        index = None if family.startswith("tti") else 1
        cases[_name(family, dt)] = dict(
            recipe=family, index=index, recipe_kw=dict(dtype=dt),
            obs=obs[family, dt], fn=FNS[family],
            kw=dict(KW[family], calc_grad=True))
    for family, dt in TRIALS:
        cases[_name(family, dt, True)] = dict(
            cases[_name(family, dt)],
            kw=dict(KW[family], calc_grad=False))
    cases["fm_visco_float32"] = dict(recipe="visco_fm", recipe_kw={},
                                     fn="viscoacoustic_fm_sharded",
                                     kw=dict(kernel="sls", time_order=2))
    return cases


@pytest.fixture(scope="module")
def cases():
    return _cases()


@pytest.fixture(scope="module")
def world(cases):
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(group.spawn, R.run_cases, 4, args=(cases,),
                          timeout=TIMEOUT)


@pytest.fixture(scope="module")
def jax_ref(cases, world):
    ref = {}
    for name, c in cases.items():
        if name.startswith("trial_"):
            continue
        geom = R.build(JAX_LIB, c["recipe"], c.get("index"),
                       **c["recipe_kw"])
        fn = getattr(jsh, c["fn"])
        if c["fn"] == "viscoacoustic_fm_sharded":
            ref[name] = fn(geom, **c["kw"])
        else:
            ref[name] = fn(geom, c["obs"], least_square, **c["kw"])
    return ref


@pytest.fixture(scope="module")
def port(world, jax_ref):
    outs = world.result()
    return outs[0]


@pytest.mark.parametrize("family,dtype", FAMILY_CASES,
                         ids=[f"{f}-{d.__name__}" for f, d in FAMILY_CASES])
def test_sharded_gradient_matches_jax(port, jax_ref, family, dtype):
    name = _name(family, dtype)
    f, g = port[name]
    f_ref, g_ref = jax_ref[name]
    tf, tg = TOL[dtype]
    assert abs(f - f_ref) <= tf * abs(f_ref), (f, f_ref)
    names = GRADS[family]
    if names is None:
        assert g.shape == g_ref.shape
        assert _rel(g, g_ref) < tg
        return
    assert sorted(g) == sorted(names)
    for k in names:
        assert g[k].shape == g_ref[k].shape
        assert _rel(g[k], g_ref[k]) < tg, k


@pytest.mark.parametrize("family,dtype", TRIALS,
                         ids=[f"{f}-{d.__name__}" for f, d in TRIALS])
def test_sharded_objective_without_gradient(port, jax_ref, family, dtype):
    f, g = port[_name(family, dtype, True)]
    f_ref = jax_ref[_name(family, dtype)][0]
    assert g is None
    assert abs(f - f_ref) <= TOL[dtype][0] * abs(f_ref)


def test_viscoacoustic_fm_sharded_matches_jax(port, jax_ref):
    got, want = port["fm_visco_float32"], jax_ref["fm_visco_float32"]
    assert got.shape == want.shape
    assert _rel(got, want) < TOL[F32][1]


def test_ranks_import_no_jax(world):
    assert all(o["_jax_modules"] == [] for o in world.result())
