"""Geometries and rank bodies shared by the parallel tests
(tests/test_torch_parallel.py, test_torch_parallel_families.py,
test_torch_domain.py).

Each geometry is a recipe over a package's constructors (``lib``: the JAX
package's or the port's ``demo_model``, ``SeismicModel``,
``AcquisitionGeometry`` and ``setup_w_over_q``), so the parent test builds
the JAX side and the spawned ranks the port's from the same arguments
(tests/test_sharding.py's geometries). The ranks run ``run_cases``; this
module imports no JAX, and neither do they.
"""
import sys
from types import SimpleNamespace

import numpy as np
import torch


def port_lib():
    from devito_fwi_tpu_torch import (AcquisitionGeometry, SeismicModel,
                                      demo_model)
    from devito_fwi_tpu_torch.ops.self_adjoint import setup_w_over_q
    return SimpleNamespace(demo_model=demo_model, SeismicModel=SeismicModel,
                           AcquisitionGeometry=AcquisitionGeometry,
                           setup_w_over_q=setup_w_over_q)


def _line(n, lo, hi, depth, vertical):
    """Points at ``depth`` along x (or, ``vertical``, at x = depth along z)."""
    if vertical:
        return np.stack([np.full(n, depth), np.linspace(lo, hi, n)], 1)
    return np.stack([np.linspace(lo, hi, n), np.full(n, depth)], 1)


def acoustic(lib, nsrc=5, dtype=np.float32, vertical=True, fs=False):
    """tests/test_sharding.py ``_setup``: circle 49 x 49 at 10 m, nbl 10,
    space order 4; receivers on the vertical line x = 460 m (the port's
    eager route) or, not ``vertical``, on z = 30 m (its kernel route).
    Returns (true, initial) geometries."""
    def mk(vc):
        return lib.demo_model("circle-isotropic", vp_circle=vc,
                              vp_background=3.0, r=10, origin=(0., 0.),
                              shape=(49, 49), spacing=(10., 10.),
                              space_order=4, nbl=10, dt=1.2, dtype=dtype,
                              fs=fs)
    src = _line(nsrc, 0., 480., 20., vertical)
    rec = _line(21, 0., 480., 460. if vertical else 30., vertical)
    return tuple(lib.AcquisitionGeometry(mk(vc), rec, src, 0., 200.,
                                         f0=0.010, src_type="Ricker")
                 for vc in (3.2, 3.0))


def acoustic3d(lib, dtype=np.float32):
    """tests/test_sharding.py's 3-D domain case: layers-isotropic 25^3 at
    15 m, nbl 6, one source, 15 receivers along x."""
    model = lib.demo_model("layers-isotropic", shape=(25, 25, 25),
                           spacing=(15., 15., 15.), nlayers=2, space_order=4,
                           nbl=6, dtype=dtype)
    src = np.array([[180., 180., 30.]])
    rec = np.stack([np.linspace(0., 360., 15), np.full(15, 180.),
                    np.full(15, 30.)], axis=1)
    return lib.AcquisitionGeometry(model, rec, src, 0., 120., f0=0.015,
                                   src_type="Ricker")


def tti2d(lib, dtype=np.float32):
    """layers-tti 41 x 41, nbl 8, 5 shots."""
    model = lib.demo_model("layers-tti", shape=(41, 41), spacing=(10., 10.),
                           nbl=8, space_order=4, dtype=dtype)
    src = _line(5, 0., 400., 20., False)
    rec = _line(21, 0., 400., 30., False)
    return lib.AcquisitionGeometry(model, rec, src, 0., 200., f0=0.012,
                                   src_type="Ricker")


def tti3d(lib, dtype=np.float32):
    """17 x 15 x 13 TTI with a constant scalar azimuth phi = 0.3, 2 shots."""
    shape = (17, 15, 13)
    vp = np.full(shape, 2.0, dtype)
    vp[:, :, 6:] = 2.4
    f = np.full(shape, 0.1, dtype)
    model = lib.SeismicModel(origin=(0., 0., 0.), spacing=(15., 15., 15.),
                             shape=shape, space_order=4, vp=vp, epsilon=f,
                             delta=0.5 * f, theta=0.4 * f, phi=0.3, nbl=4,
                             bcs="damp", dtype=dtype)
    src = np.stack([np.linspace(40., 200., 2), np.full(2, 100.0),
                    np.full(2, 20.0)], 1)
    rec = np.stack([np.linspace(0., 240., 9), np.full(9, 100.0),
                    np.full(9, 30.0)], 1)
    return lib.AcquisitionGeometry(model, rec, src, 0., 100., f0=0.015,
                                   src_type="Ricker")


def visco_fm(lib, dtype=np.float32):
    """41 x 41 two-layer viscoacoustic model (qp 80), 5 shots."""
    shape = (41, 41)
    vp = np.full(shape, 2.0, dtype)
    vp[:, 20:] = 2.6
    rho = 0.31 * (1e3 * vp) ** 0.25
    model = lib.SeismicModel(origin=(0., 0.), spacing=(10., 10.),
                             shape=shape, space_order=4, vp=vp,
                             qp=np.full(shape, 80.0, dtype), b=1.0 / rho,
                             nbl=8, bcs="mask", dtype=dtype)
    return lib.AcquisitionGeometry(model, _line(21, 0., 400., 30., False),
                                   _line(5, 0., 400., 20., False), 0., 200.,
                                   f0=0.012, src_type="Ricker")


def _staggered(lib, dtype, shape, nbl, nsrc, tn, rec, fields):
    """(true, initial) geometries of a staggered-grid family with the
    model ``fields``: vp two-layer (2.0 over 2.4) against 2.2 everywhere,
    rho from the two-layer vp."""
    vp = np.full(shape, 2.0, dtype)
    vp[:, shape[1] // 2:] = 2.4
    rho = (0.31 * (1e3 * vp) ** 0.25).astype(dtype)

    def mk(vpa):
        return lib.SeismicModel(origin=(0., 0.), spacing=(10., 10.),
                                shape=shape, space_order=4, vp=vpa,
                                b=1.0 / rho, nbl=nbl, bcs="mask", dt=1.0,
                                dtype=dtype, **fields)
    src = _line(nsrc, 50. if nsrc == 3 else 60., 350. if nsrc == 3
                else 260., 20., False)
    return tuple(lib.AcquisitionGeometry(mk(v), rec, src, 0., tn, f0=0.015,
                                         src_type="Ricker")
                 for v in (vp, np.full(shape, 2.2, dtype)))


def elastic(lib, dtype=np.float32):
    """41 x 36 elastic, vs = vp / 2, 3 shots."""
    shape = (41, 36)
    vp = np.full(shape, 2.0, dtype)
    vp[:, 18:] = 2.4
    vs = (vp / 2.0).astype(dtype)
    return _staggered(lib, dtype, shape, 8, 3, 200.,
                      _line(21, 0., 400., 30., False),
                      dict(vs=vs))


def visco(lib, dtype=np.float32):
    """41 x 36 viscoacoustic, qp 60, 3 shots."""
    shape = (41, 36)
    return _staggered(lib, dtype, shape, 8, 3, 200.,
                      _line(21, 0., 400., 30., False),
                      dict(qp=np.full(shape, 60.0, dtype)))


def viscoelastic(lib, dtype=np.float32):
    """33 x 29 viscoelastic, qp 60, qs 40, nbl 6, 2 shots."""
    shape = (33, 29)
    vp = np.full(shape, 2.0, dtype)
    vp[:, 14:] = 2.4
    vs = (vp / 2.0).astype(dtype)
    return _staggered(lib, dtype, shape, 6, 2, 160.,
                      _line(17, 0., 320., 30., False),
                      dict(vs=vs, qp=np.full(shape, 60.0, dtype),
                           qs=np.full(shape, 40.0, dtype)))


def sa(lib, dtype=np.float32):
    """41 x 36 self-adjoint, space order 8, w/Q damping, 3 shots."""
    shape, nbl = (41, 36), 8
    vp = np.full(shape, 2.0, dtype)
    vp[:, 18:] = 2.4

    def mk(vpa):
        m = lib.SeismicModel(origin=(0., 0.), spacing=(10., 10.),
                             shape=shape, space_order=8, vp=vpa,
                             b=np.ones(shape, dtype), nbl=nbl, bcs="damp",
                             dt=0.8, dtype=dtype)
        m.damp[:] = lib.setup_w_over_q(m.padded_shape, w=2 * np.pi * 0.015,
                                       qmin=0.1, qmax=100.0, npad=nbl,
                                       dtype=dtype)
        return m
    src = _line(3, 50., 350., 20., False)
    rec = _line(21, 0., 400., 30., False)
    return tuple(lib.AcquisitionGeometry(mk(v), rec, src, 0., 160.,
                                         f0=0.015, src_type="Ricker")
                 for v in (vp, np.full(shape, 2.2, dtype)))


RECIPES = dict(acoustic=acoustic, acoustic3d=acoustic3d, tti2d=tti2d,
               tti3d=tti3d, visco_fm=visco_fm, elastic=elastic, visco=visco,
               viscoelastic=viscoelastic, sa=sa)


def build(lib, recipe, index=None, **kw):
    """The geometry of ``recipe`` (``index`` picks one of a pair)."""
    out = RECIPES[recipe](lib, **kw)
    return out if index is None else out[index]


def records(geometry, stack):
    """Port PointSource records of an (nsrc, nt, nrec) stack."""
    from devito_fwi_tpu_torch.models.sources import PointSource
    out = []
    for s in stack:
        p = PointSource(name="rec", time_range=geometry.time_axis,
                        coordinates=geometry.rec_positions,
                        dtype=geometry.model.dtype)
        p.data[:] = s
        out.append(p)
    return out


class HostOnly:
    """A W2-2d misfit with its device form hidden, so the objectives take
    the host-misfit path (as tests/test_sharding.py's)."""
    method = "2d"
    bfm_backend = "host"

    def __init__(self, num_steps):
        from devito_fwi_tpu_torch.misfit import qWasserstein
        self.qw = qWasserstein(gamma=1.01, method="2d", num_steps=num_steps,
                               step_scale=1.)

    def __call__(self, f, g):
        return self.qw(f, g)


def _call(case, dev):
    """Run one case on this rank: (name, result)."""
    from devito_fwi_tpu_torch import fwi
    from devito_fwi_tpu_torch.parallel import domain as dm
    from devito_fwi_tpu_torch.parallel import sharding as sh
    lib = port_lib()
    fn = case["fn"]
    kw = dict(case.get("kw", {}))
    geom = build(lib, case["recipe"], case.get("index"),
                 **case.get("recipe_kw", {}))
    if fn in ("fm_multi_sharded", "fm_multi_parallel"):
        mesh = sh.shot_mesh(device=dev)
        out = sh.fm_multi_sharded(geom, mesh=mesh) \
            if fn == "fm_multi_sharded" else \
            fwi.fm_multi_parallel(None, geom, mesh=mesh)
        return np.stack([o.data for o in out])
    if fn == "viscoacoustic_fm_sharded":
        return sh.viscoacoustic_fm_sharded(geom, mesh=sh.shot_mesh(
            device=dev), **kw)
    if fn in ("forward_domain_sharded", "gradient_domain_sharded"):
        mesh = dm.domain_mesh(case["axes"], device=dev)
        if fn == "forward_domain_sharded":
            return dm.forward_domain_sharded(geom, mesh=mesh)
        return dm.gradient_domain_sharded(geom, case["residual"], mesh=mesh,
                                          **kw)
    obs = case["obs"]
    misfit = HostOnly(case["host_steps"]) if "host_steps" in case else None
    if fn in ("fwi_obj_sharded", "fwi_obj_multi_parallel"):
        obs = records(geom, obs)
    if fn == "fwi_obj_sharded2d":
        mesh = dm.hier_mesh(case["axes"], device=dev)
        return dm.fwi_obj_sharded2d(geom, obs, misfit, mesh=mesh, **kw)
    mesh = sh.shot_mesh(device=dev)
    if fn == "fwi_obj_multi_parallel":
        return fwi.fwi_obj_multi_parallel(None, geom, obs, misfit, mesh=mesh,
                                          **kw)
    if "shot_chunk" in case:
        # each rank's batches capped at shot_chunk shots
        whole = fwi._shots_per_batch
        fwi._shots_per_batch = lambda nsrc, chunk, per_shot, budget: \
            whole(nsrc, case["shot_chunk"], per_shot, budget)
        try:
            return getattr(sh, fn)(geom, obs, misfit, mesh=mesh, **kw)
        finally:
            fwi._shots_per_batch = whole
    return getattr(sh, fn)(geom, obs, misfit, mesh=mesh, **kw)


def run_cases(cases, device="cpu"):
    """A rank's body: ``torch.set_num_threads(1)`` (the tests' autouse
    fixtures do not reach a spawned rank), every case in order, and the
    JAX modules this process loaded (there must be none)."""
    torch.set_num_threads(1)
    import warnings
    warnings.simplefilter("ignore")
    out = {name: _call(case, device) for name, case in cases.items()}
    out["_jax_modules"] = [m for m in sys.modules
                           if m.split(".")[0] in ("jax", "jaxlib",
                                                  "devito_fwi_tpu")]
    return out


def fail_on_rank(bad):
    """Rank ``bad`` raises; the others wait in a collective."""
    import torch.distributed as dist
    if dist.get_rank() == bad:
        raise ValueError(f"rank {bad} fails on purpose")
    dist.all_reduce(torch.zeros(1))


def run_dryrun():
    """A rank's body: ``dryrun_multichip`` in this world on the CPU."""
    torch.set_num_threads(1)
    import warnings
    warnings.simplefilter("ignore")
    import torch.distributed as dist
    from devito_fwi_tpu_torch.parallel.dryrun import dryrun_multichip
    out = dryrun_multichip(dist.get_world_size(), "cpu")
    out["_jax_modules"] = [m for m in sys.modules
                           if m.split(".")[0] in ("jax", "jaxlib",
                                                  "devito_fwi_tpu")]
    return out
