"""Camembert (circle) FWI driver (reference ``circle_fwi.py``, the JAX
package's ``drivers/circle_fwi.py``):

    python -m devito_fwi_tpu_torch.drivers.circle_fwi --misfit 0 --maxiter 2 [--device cpu]

201 x 201 grid at 10 m, nbl 40, space order 6, 11 shots on the line z = 20
m, 201 receivers on the vertical line x = 1980 m, Ricker 10 Hz, tn 1000 ms,
L-BFGS (or NLCG, steepest descent) with the bracketing line search, misfit
from {0: L2, 1: W2-1d, 2: W2-2d}. Every flag, default and result file of
the JAX driver, plus ``--device`` (default "cuda"; "cpu" runs the plain
torch operators). No kernel takes receivers on a vertical line, so the
objective and the modeling run the eager route of ``fwi``
(``fwi._eager_objective``, counted in ``fwi.EAGER``).
"""
import argparse
import os
from time import perf_counter

import numpy as np

from ..fwi import Filter, fm_multi, fwi_obj_multi
from ..misfit import least_square, qWasserstein
from ..models.geometry import AcquisitionGeometry
from ..models.presets import demo_model
from ..optimize import LBFGS, NLCG, SteepestDescent, minimize
from ._marmousi_common import TimedLoss


def make_parser():
    p = argparse.ArgumentParser(description="Full waveform inversion")
    p.add_argument("--misfit", type=int, default=0, choices=[0, 1, 2],
                   help="misfit function type:0=least square/1=1d W2/2=2d "
                        "W2")
    p.add_argument("--precond", type=int, default=1,
                   help="apply precondition")
    p.add_argument("--odir", type=str, default="./result/circle",
                   help="directory to output result")
    p.add_argument("--bathy", type=int, default=0, help="apply bathy mask")
    p.add_argument("--check-gradient", type=int, default=0,
                   help="check the gradient at 1st iteration")
    p.add_argument("--filter", type=int, default=0, help="filtering data")
    p.add_argument("--resample", type=float, default=0.,
                   help="resample dt, default 0 will not resample")
    p.add_argument("--ftol", type=float, default=1e-2,
                   help="Optimizing loss tolerance")
    p.add_argument("--gtol", type=float, default=1e-4,
                   help="Optimizing gradient norm tolerance")
    p.add_argument("--nsrc", type=int, default=11, help="number of shots")
    p.add_argument("--maxiter", type=int, default=50, help="FWI iteration")
    p.add_argument("--steplen", type=float, default=0.05,
                   help="initial step length for line search")
    p.add_argument("--maxls", type=int, default=5,
                   help="max number of line search in each iteration")
    p.add_argument("--batch-size", type=int, default=0,
                   help="random shot subset per iteration (0 = all shots)")
    p.add_argument("--optimizer", type=str, default="LBFGS",
                   choices=["LBFGS", "NLCG", "SteepestDescent"])
    p.add_argument("--resume", type=int, default=0,
                   help="resume from the latest checkpoint under the log "
                        "dir (appends to the same metric files)")
    p.add_argument("--checkpoint-freq", type=int, default=1,
                   help="write an optimizer-state checkpoint every N "
                        "iterations (0 disables)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda or cpu")
    return p


def setup(args):
    """The true and initial circle models (reference circle_fwi.py:62-78),
    their geometries (:81-98, resampled to ``--resample`` or dt) and the
    bathy mask: ((true, init), (geometry1, geometry0), bathy_mask)."""
    shape = (201, 201)
    spacing = (10., 10.)
    origin = (0, 0)
    space_order = 6
    nbl = 40
    dt = 1.
    radius = 60
    true_model = demo_model("circle-isotropic", vp_circle=3.6,
                            vp_background=3, r=radius, origin=origin,
                            shape=shape, spacing=spacing,
                            space_order=space_order, nbl=nbl, dt=dt)
    init_model = demo_model("circle-isotropic", vp_circle=3,
                            vp_background=3, r=radius, origin=origin,
                            shape=shape, spacing=spacing,
                            space_order=space_order, nbl=nbl, dt=dt)
    bathy_mask = np.ones(shape, dtype=np.float32) if args.bathy else None

    t0, tn, f0 = 0., 1000., 0.010
    src_coordinates = np.empty((args.nsrc, 2))
    src_coordinates[:, 1] = np.linspace(0, true_model.domain_size[0],
                                        num=args.nsrc)
    src_coordinates[:, 0] = 20.
    nreceivers = shape[0]
    rec_coordinates = np.empty((nreceivers, 2))
    rec_coordinates[:, 1] = np.linspace(spacing[0],
                                        true_model.domain_size[0]
                                        - spacing[0], num=nreceivers)
    rec_coordinates[:, 0] = 1980.

    filt_func = None
    if args.filter:
        filt_func = Filter(filter_type="highpass", freqmin=2, corners=6,
                           df=1000 / dt)
    geoms = tuple(AcquisitionGeometry(m, rec_coordinates, src_coordinates,
                                      t0, tn, f0=f0, src_type="Ricker",
                                      filter=filt_func)
                  for m in (true_model, init_model))
    for g in geoms:
        g.resample(args.resample or dt)
    return (true_model, init_model), geoms, bathy_mask


def main(argv=None):
    """Parse ``argv`` (default: the command line) and run the inversion.
    Returns (m, stats): the final squared slowness and a dict with the
    objective calls in order (``calls``: (calc_grad, objective, host
    seconds)), the observed data's modeling time (``model_s``) and the
    inversion's (``fwi_s``)."""
    args = make_parser().parse_args(argv)
    result_dir = args.odir
    os.makedirs(result_dir, exist_ok=True)
    misfit_type = args.misfit
    print("---------------- Parameter Setting ------------\n",
          "\t Result dir: %s \t Misfit function: %d \t Precondition: %d\n"
          % (result_dir, misfit_type, args.precond),
          "\t Use mask: %d \t Filtering source: %d \t Resample rate: %.2f\n"
          % (args.bathy, args.filter, args.resample),
          "\t Device: %s\n" % args.device,
          "\t ftol: %e \t gtol: %e \t nsrc: %d\n"
          % (args.ftol, args.gtol, args.nsrc),
          "\t maxiter:%d \t maxls: %d \t init step length: %.3f\n"
          % (args.maxiter, args.maxls, args.steplen),
          "-------------------------------------------------")

    (true_model, init_model), (geometry1, geometry0), bathy_mask = \
        setup(args)
    t0 = perf_counter()
    obs = fm_multi(geometry1, device=args.device)
    model_s = perf_counter() - t0

    qWmetric1d = qWasserstein(gamma=1.01, method="1d")
    qWmetric2d = qWasserstein(gamma=1.01, method="2d", num_steps=10,
                              step_scale=1.)
    misfit_func = [least_square, qWmetric1d, qWmetric2d][misfit_type]

    if args.check_gradient:
        f, g, _ = fwi_obj_multi(geometry0, obs, misfit_func, None,
                                bathy_mask, args.precond, True,
                                device=args.device)
        g.tofile(os.path.join(result_dir,
                              "circle_1st_grad_" + str(misfit_type)))
        print("check-gradient: f=%.6e |g|=%.3e" % (f, np.abs(g).max()))

    # box constraints in slowness-squared (reference circle_fwi.py:142-151)
    vmin, vmax = 2.5, 4.0
    bounds = [1.0 / vmax ** 2, 1.0 / vmin ** 2]
    v0 = init_model.crop(init_model.vp)
    m0 = 1.0 / (v0.reshape(-1).astype(np.float64)) ** 2

    tic = perf_counter()
    opt_cls = {"LBFGS": LBFGS, "NLCG": NLCG,
               "SteepestDescent": SteepestDescent}[args.optimizer]
    log_path = os.path.join(result_dir, "log" + str(misfit_type))
    kwargs = dict(ls_method="Bracket", step_len_init=args.steplen,
                  max_ls=args.maxls, log_path=log_path)
    if args.optimizer == "LBFGS":
        kwargs["memory"] = 10
    loss = TimedLoss(args.device)
    minimizer = minimize(opt_cls(**kwargs), maxIter=args.maxiter,
                         ftol=args.ftol, gtol=args.gtol,
                         batch_size=args.batch_size or None,
                         checkpoint_freq=args.checkpoint_freq,
                         resume=bool(args.resume), loss_fn=loss,
                         log_path=log_path)
    m = minimizer.run(m0, geometry0, obs, misfit_func, None, bathy_mask,
                      args.precond, bounds)
    fwi_s = perf_counter() - tic
    print(f"\n Elapsed time: {fwi_s:.2f}s")

    vp = 1.0 / np.sqrt(m.reshape(true_model.shape))
    vp.astype(np.float32).tofile(
        os.path.join(result_dir, "circle_result_misfit_" + str(misfit_type)))
    print("final model range: %.3f %.3f km/s" % (vp.min(), vp.max()))
    return m, dict(calls=loss.calls, model_s=model_s, fwi_s=fwi_s)


if __name__ == "__main__":
    main()
