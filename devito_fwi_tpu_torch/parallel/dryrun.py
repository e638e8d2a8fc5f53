"""Multi-rank dry run of the parallel layer at tiny shapes.

Counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``, in
its order and at its shapes (41 x 41 at 10 m, 5 or more shots, tn 150
ms): the shot-sharded acoustic gradient, the domain-decomposed forward
and gradient, the TTI, elastic, viscoacoustic (modeling and gradient),
viscoelastic and self-adjoint sharded gradients, the W2-2d sharded
gradient and, on an even number of ranks, the shots x domain objective.
Every result must be finite; rank 0 prints one line each.

    python -m devito_fwi_tpu_torch.parallel.dryrun --ranks 4 [--device cpu]
    torchrun --nproc-per-node 4 -m devito_fwi_tpu_torch.parallel.dryrun

spawns the ranks itself (``parallel.spawn``: NCCL with a card a rank,
gloo when ranks share a card or run on the CPU), or runs in the group
that ``torchrun`` set up (``--ranks`` defaults to its world size).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from . import group

__all__ = ["dryrun_multichip"]


def _check(ok, what):
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def _body(n, device):
    """One rank of the dry run: {what: figure} of every step."""
    from .. import AcquisitionGeometry, SeismicModel, demo_model
    from ..misfit import least_square, qWasserstein
    from ..ops import self_adjoint as sa
    from . import sharding as sh

    out = {}
    rank = dist.get_rank() if dist.is_initialized() else 0

    def say(key, line, value):
        out[key] = value
        if rank == 0:
            print(f"dryrun_multichip({n}): {line}", flush=True)

    mesh = sh.shot_mesh(device=device)
    shape, spacing = (41, 41), (10., 10.)
    nsrc = max(n, 4) + 1  # more shots than ranks, and a rank with more
    kw = dict(origin=(0., 0.), shape=shape, spacing=spacing, space_order=4,
              nbl=10, dt=1.2)
    true_model = demo_model("circle-isotropic", vp_circle=3.2,
                            vp_background=3.0, r=8, **kw)
    init_model = demo_model("circle-isotropic", vp_circle=3.0,
                            vp_background=3.0, r=8, **kw)
    src = np.stack([np.full(nsrc, 20.0), np.linspace(0, 400, nsrc)], 1)
    rec = np.stack([np.full(21, 380.0), np.linspace(0, 400, 21)], 1)

    def geometry(model):
        return AcquisitionGeometry(model, rec, src, 0., 150., f0=0.010,
                                   src_type="Ricker")
    geometry1, geometry0 = geometry(true_model), geometry(init_model)
    obs = sh.fm_multi_sharded(geometry1, mesh=mesh)
    fval, grad = sh.fwi_obj_sharded(geometry0, obs, least_square,
                                    calc_grad=True, mesh=mesh)
    _check(np.isfinite(fval) and np.isfinite(grad).all(), "acoustic")
    say("acoustic", f"fval={fval:.6e} |grad|max={np.abs(grad).max():.3e}",
        (fval, np.abs(grad).max()))

    # domain decomposition: the grid's two axes split, halos exchanged
    # every step, forward and the checkpointed reverse sweep
    axes = (n // 2, 2) if n % 2 == 0 and n > 1 else (n, 1)
    dmesh = sh.domain_mesh(axes, device=device)
    drec = sh.forward_domain_sharded(geometry1, mesh=dmesh)
    _check(np.isfinite(drec).all(), "domain forward")
    say("domain_forward", f"domain mesh {axes} |rec|max="
        f"{np.abs(drec).max():.3e}", np.abs(drec).max())
    syn0 = sh.forward_domain_sharded(geometry0, mesh=dmesh)
    residual = (syn0 - obs[0].data).astype(init_model.dtype)
    dgrad = sh.gradient_domain_sharded(geometry0, residual, mesh=dmesh,
                                       n_checkpoints=8)
    _check(np.isfinite(dgrad).all(), "domain gradient")
    say("domain_gradient", f"domain-sharded gradient |grad|max="
        f"{np.abs(dgrad).max():.3e}", np.abs(dgrad).max())

    tti_model = demo_model("layers-tti", shape=shape, spacing=spacing,
                           nbl=8, space_order=4)
    tti_geom = AcquisitionGeometry(tti_model, rec, src, 0., 150., f0=0.010,
                                   src_type="Ricker")
    zeros = np.zeros((nsrc, tti_geom.nt, rec.shape[0]), tti_model.dtype)
    tf, tgrad = sh.tti_fwi_obj_sharded(tti_geom, zeros, least_square,
                                       calc_grad=True, mesh=mesh,
                                       n_checkpoints=7)
    _check(np.isfinite(tf) and np.isfinite(tgrad).all()
           and np.abs(tgrad).max() > 0, "TTI")
    say("tti", f"TTI sharded gradient fval={tf:.6e} "
        f"|grad|max={np.abs(tgrad).max():.3e}", (tf, np.abs(tgrad).max()))

    evp = np.full(shape, 2.0, np.float32)
    evs = evp / 2.0
    erho = (0.31 * (1e3 * evp) ** 0.25).astype(np.float32)
    emodel = SeismicModel(origin=(0., 0.), spacing=spacing, shape=shape,
                          space_order=4, vp=evp, vs=evs, b=1.0 / erho,
                          nbl=8, bcs="mask", dt=1.2)
    egeom = AcquisitionGeometry(emodel, rec, src, 0., 150., f0=0.010,
                                src_type="Ricker")
    ef, egrads = sh.elastic_fwi_obj_sharded(
        egeom, np.zeros((nsrc, egeom.nt, rec.shape[0]), np.float32),
        least_square, calc_grad=True, mesh=mesh, n_checkpoints=5)
    _check(np.isfinite(ef) and all(np.isfinite(g).all()
                                   for g in egrads.values()), "elastic")
    say("elastic", f"elastic sharded gradient fval={ef:.6e} "
        f"|gvp|max={np.abs(egrads['vp']).max():.3e}", ef)

    vvp = np.full(shape, 2.0, np.float32)
    vrho = 0.31 * (1e3 * vvp) ** 0.25
    vmodel = SeismicModel(origin=(0., 0.), spacing=spacing, shape=shape,
                          space_order=4, vp=vvp,
                          qp=np.full(shape, 80.0, np.float32), b=1.0 / vrho,
                          nbl=8, bcs="mask")
    vgeom = AcquisitionGeometry(vmodel, rec, src, 0., 150., f0=0.010,
                                src_type="Ricker")
    vrec = sh.viscoacoustic_fm_sharded(vgeom, kernel="sls", time_order=2,
                                       mesh=mesh)
    _check(np.isfinite(vrec).all() and np.abs(vrec).max() > 0,
           "viscoacoustic modeling")
    say("visco_fm", f"viscoacoustic sharded fm |rec|max="
        f"{np.abs(vrec).max():.3e}", np.abs(vrec).max())
    vf, vgrads = sh.viscoacoustic_fwi_obj_sharded(
        vgeom, vrec * 1.1, least_square, calc_grad=True, mesh=mesh)
    _check(np.isfinite(vf) and vf > 0 and all(
        np.isfinite(g).all() for g in vgrads.values())
        and np.abs(vgrads["vp"]).max() > 0, "viscoacoustic gradient")
    say("visco", f"viscoacoustic sharded gradient fval={vf:.6e} "
        f"|gqp|max={np.abs(vgrads['qp']).max():.3e}", vf)

    vemodel = SeismicModel(origin=(0., 0.), spacing=spacing, shape=shape,
                           space_order=4, vp=evp, vs=evs, b=1.0 / erho,
                           qp=np.full(shape, 60.0, np.float32),
                           qs=np.full(shape, 40.0, np.float32), nbl=8,
                           bcs="mask", dt=1.2)
    vegeom = AcquisitionGeometry(vemodel, rec, src, 0., 150., f0=0.010,
                                 src_type="Ricker")
    vef, vegrads = sh.viscoelastic_fwi_obj_sharded(
        vegeom, np.zeros((nsrc, vegeom.nt, rec.shape[0]), np.float32),
        least_square, calc_grad=True, mesh=mesh)
    _check(np.isfinite(vef) and all(np.isfinite(g).all()
                                    for g in vegrads.values()),
           "viscoelastic")
    say("viscoelastic", f"viscoelastic sharded gradient fval={vef:.6e} "
        f"|gqs|max={np.abs(vegrads['qs']).max():.3e}", vef)

    samodel = SeismicModel(origin=(0., 0.), spacing=spacing, shape=shape,
                           space_order=8, vp=vvp,
                           b=np.ones(shape, np.float32), nbl=8, bcs="damp",
                           dt=0.8)
    samodel.damp[:] = sa.setup_w_over_q(
        samodel.padded_shape, w=2 * np.pi * 0.010, qmin=0.1, qmax=100.0,
        npad=8, dtype=np.float32)
    sageom = AcquisitionGeometry(samodel, rec, src, 0., 150., f0=0.010,
                                 src_type="Ricker")
    saf, sagrad = sh.sa_fwi_obj_sharded(
        sageom, np.zeros((nsrc, sageom.nt, rec.shape[0]), np.float32),
        least_square, calc_grad=True, mesh=mesh)
    _check(np.isfinite(saf) and np.isfinite(sagrad).all(), "self-adjoint")
    say("sa", f"self-adjoint sharded gradient fval={saf:.6e} "
        f"|g|max={np.abs(sagrad).max():.3e}", saf)

    w2 = qWasserstein(gamma=1.01, method="2d", num_steps=4)
    wf, wgrad = sh.fwi_obj_sharded(geometry0, obs, w2, calc_grad=True,
                                   mesh=mesh)
    _check(np.isfinite(wf) and np.isfinite(wgrad).all()
           and np.abs(wgrad).max() > 0, "W2-2d")
    say("w2", f"W2-2d sharded gradient fval={wf:.6e} "
        f"|grad|max={np.abs(wgrad).max():.3e}", wf)

    if n % 2 == 0 and n > 1:
        hmesh = sh.hier_mesh((n // 2, 2), device=device)
        hf, hgrad = sh.fwi_obj_sharded2d(geometry0, obs, least_square,
                                         calc_grad=True, mesh=hmesh)
        _check(np.isfinite(hf) and np.isfinite(hgrad).all(), "shots x "
               "domain")
        say("hier", f"shots x domain mesh ({n // 2}, 2) fval={hf:.6e} "
            f"|grad|max={np.abs(hgrad).max():.3e}", (hf, fval))
    return out


def dryrun_multichip(n, device="cuda"):
    """Run the dry run on ``n`` ranks: in the current ``torch.distributed``
    world when one is set up (its size must be ``n``), else on ``n``
    spawned ranks. Returns rank 0's {what: figure}."""
    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != n:
            raise ValueError(f"dryrun_multichip({n}) in a world of "
                             f"{dist.get_world_size()} ranks")
        return _body(n, device)
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" and \
        torch.cuda.device_count() >= n else "gloo"
    return group.spawn(_body, n, backend, device, args=(n, device))[0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=None,
                   help="ranks (default: torchrun's world size, else 4)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        # torchrun: one process a rank, the group from its environment
        local = int(os.environ.get("LOCAL_RANK", 0))
        cards = args.device == "cuda" and \
            torch.cuda.device_count() >= int(os.environ["LOCAL_WORLD_SIZE"])
        if cards:
            torch.cuda.set_device(local)
        dist.init_process_group("nccl" if cards else "gloo")
        try:
            dryrun_multichip(args.ranks or dist.get_world_size(),
                             args.device)
        finally:
            dist.destroy_process_group()
        return 0
    dryrun_multichip(args.ranks or 4, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
