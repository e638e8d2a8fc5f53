"""Shared Marmousi driver logic (SMARMN and SMARM2): acoustic FWI with
the L2 (``--misfit 0``), W2-1d (``--misfit 1``) or W2-2d (``--misfit 2``)
misfit, elastic FWI (``--physics elastic``: velocity-stress propagator, vp
inverted with vs and rho pinned at the smooth model's fields) and
viscoacoustic FWI (``--physics viscoacoustic``: the SLS 2nd-order
propagator, vp inverted with qp and rho pinned at the smooth model's
fields).

CLI/flow parity with ``drivers/_marmousi_common.py`` of the JAX package
(reference ``marmousi_fwi.py`` / ``marmousi2_fwi.py``): same flags, model
and acquisition constants, misfit configurations and result-file layout,
plus ``--device`` (default "cuda"; "cpu" runs the plain torch twins). The
raw velocity models are read from ``--data-dir`` (default: the vendored
``model_data/`` at the repo root). ``--filter 1`` high-passes the source
wavelet (3 Hz, 6 corners). ``--resample`` does what the JAX driver does: it
sets the inverted geometry's dt, which only its time axis reads; the
objective is not asked to resample (``fwi_loss`` has no such argument), so a
dt that changes the number of samples makes the objective raise on the
observed data's length, as in the JAX driver. The 2-D solver's backends are
a keyword of ``run_fwi`` (``bfm_options``), not a flag: the JAX driver reads
them from the environment.

Not ported yet: the forward-modeling drivers (ROADMAP.md queue A item 6).
"""
import argparse
import os
from dataclasses import dataclass
from functools import partial
from time import perf_counter

import numpy as np

from ..elastic_fwi import ElasticFwiLoss, elastic_fm_multi
from ..fwi import Filter, fm_multi, fwi_loss
from ..misfit import least_square, qWasserstein
from ..models.geometry import AcquisitionGeometry
from ..models.model import SeismicModel
from ..optimize import LBFGS, minimize
from ..visco_fwi import ViscoFwiLoss, visco_fm_multi


@dataclass
class MarmousiConfig:
    name: str           # 'SMARMN' | 'SMARM2'
    shape: tuple        # (nx, nz)
    dt: float
    tn: float
    nsrc_default: int
    bathy_rows: int     # water rows zeroed by the bathy mask
    w2_step_scale: float
    w2_num_steps: int = 15
    spacing: tuple = (30., 30.)
    f0: float = 0.007
    space_order: int = 8
    nbl: int = 40


SMARMN = MarmousiConfig(name="SMARMN", shape=(300, 106), dt=2.95, tn=4000.,
                        nsrc_default=29, bathy_rows=7, w2_step_scale=1.)
SMARM2 = MarmousiConfig(name="SMARM2", shape=(340, 140), dt=3., tn=4500.,
                        nsrc_default=31, bathy_rows=15, w2_step_scale=4.)


def default_data_dir():
    """The vendored model_data/ at the repo root."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "model_data")


def make_parser(cfg):
    p = argparse.ArgumentParser(description="Full waveform inversion")
    p.add_argument("--misfit", type=int, default=0, choices=[0, 1, 2],
                   help="misfit function type:"
                        "0=least square/1=1d W2/2=2d W2")
    p.add_argument("--precond", type=int, default=1,
                   help="apply precondition")
    p.add_argument("--check-gradient", type=int, default=0,
                   help="check the gradient at 1st iteration")
    p.add_argument("--resample", type=float, default=0.,
                   help="resample dt, default 0 will not resample")
    p.add_argument("--ftol", type=float, default=1e-5,
                   help="Optimizing loss tolerance")
    p.add_argument("--gtol", type=float, default=1e-10,
                   help="Optimizing gradient norm tolerance")
    p.add_argument("--maxiter", type=int, default=200,
                   help="FWI iteration")
    p.add_argument("--steplen", type=float, default=0.1,
                   help="initial step length for line search")
    p.add_argument("--maxls", type=int, default=5,
                   help="max number of line search in each iteration")
    p.add_argument("--batch-size", type=int, default=0,
                   help="random shot subset per iteration (0 = all shots)")
    p.add_argument("--physics", type=str, default="acoustic",
                   choices=["acoustic", "elastic", "viscoacoustic"],
                   help="propagator: acoustic, elastic staggered-grid "
                        "Vp/Vs/rho FWI, or viscoacoustic SLS "
                        "(Q-compensated) FWI")
    p.add_argument("--resume", type=int, default=0,
                   help="resume from the latest checkpoint under the log "
                        "dir")
    p.add_argument("--checkpoint-freq", type=int, default=1,
                   help="write an optimizer-state checkpoint every N "
                        "iterations (0 disables)")
    p.add_argument("--odir", type=str, default="./result/" + cfg.name,
                   help="directory to output result")
    p.add_argument("--bathy", type=int, default=1, help="apply bathy mask")
    p.add_argument("--filter", type=int, default=0, help="filtering data")
    p.add_argument("--nsrc", type=int, default=cfg.nsrc_default,
                   help="number of shots")
    p.add_argument("--data-dir", type=str, default=default_data_dir(),
                   help="directory holding %s/vp.true etc." % cfg.name)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (the kernels) or cpu (the "
                        "plain torch twins)")
    return p


def load_models(cfg, data_dir):
    """Returns (true_vp, smooth_vp) in km/s."""
    base = os.path.join(data_dir, cfg.name)
    true_vp = np.fromfile(os.path.join(base, "vp.true"),
                          dtype=np.float32).reshape(cfg.shape) / 1000
    smooth_vp = np.fromfile(os.path.join(base, "vp.smooth_20"),
                            dtype=np.float32).reshape(cfg.shape) / 1000
    return true_vp, smooth_vp


def setup(cfg, args, nsources):
    """Build (true, init, constant-water) models + geometries + bathy mask
    (reference marmousi_fwi.py:62-117)."""
    origin = (0, 0)
    true_vp, smooth_vp = load_models(cfg, args.data_dir)
    constant_vp = np.ones(cfg.shape) * 1.5

    bathy_mask = np.ones(cfg.shape, dtype=np.float32)
    bathy_mask[:, :cfg.bathy_rows] = 0
    if not args.bathy:
        bathy_mask = None

    def model(vp):
        return SeismicModel(origin=origin, spacing=cfg.spacing,
                            shape=cfg.shape, space_order=cfg.space_order,
                            vp=vp, nbl=cfg.nbl, fs=False, dt=cfg.dt,
                            bcs="damp")

    true_model = model(true_vp)
    init_model = model(smooth_vp)
    constant_model = model(constant_vp)

    src_coordinates = np.empty((nsources, 2))
    src_coordinates[:, 0] = np.linspace(0, true_model.domain_size[0],
                                        num=nsources)
    src_coordinates[:, -1] = 2 * cfg.spacing[0]
    nreceivers = cfg.shape[0]
    rec_coordinates = np.empty((nreceivers, 2))
    rec_coordinates[:, 0] = np.linspace(cfg.spacing[0],
                                        true_model.domain_size[0]
                                        - cfg.spacing[0], num=nreceivers)
    rec_coordinates[:, 1] = 2 * cfg.spacing[0]

    filt_func = None
    if args.filter:
        filt_func = Filter(filter_type="highpass", freqmin=3, corners=6,
                           df=1000 / cfg.dt)
    geoms = [AcquisitionGeometry(m, rec_coordinates, src_coordinates, 0.,
                                 cfg.tn, f0=cfg.f0, src_type="Ricker",
                                 filter=filt_func)
             for m in (true_model, init_model, constant_model)]
    return (true_model, init_model, constant_model), geoms, \
        (true_vp, smooth_vp), bathy_mask


def elastic_fields(cfg, vp):
    """Derive (vs, rho) for an elastic Marmousi run: vs = vp/sqrt(3)
    (Poisson solid) with a fluid water column (vs = 0), rho from
    Gardner's relation 0.31 (1000 vp)^0.25 g/cc (the reference's
    empirical preset relation, ``seismic/preset_models.py:349-351``)
    with water at 1.0 g/cc."""
    vs = (vp / np.sqrt(3.0)).astype(np.float32)
    vs[:, :cfg.bathy_rows] = 0.0
    rho = (0.31 * (1e3 * vp) ** 0.25).astype(np.float32)
    rho[:, :cfg.bathy_rows] = 1.0
    return vs, rho


def setup_elastic(cfg, args, nsources):
    """Elastic counterpart of ``setup``: (true, init, water) models carry
    (vs, b) so the staggered propagator drives them; one pinned dt keeps
    all time axes aligned."""
    origin = (0, 0)
    true_vp, smooth_vp = load_models(cfg, args.data_dir)
    constant_vp = np.ones(cfg.shape, dtype=np.float32) * 1.5

    bathy_mask = np.ones(cfg.shape, dtype=np.float32)
    bathy_mask[:, :cfg.bathy_rows] = 0
    if not args.bathy:
        bathy_mask = None

    vs_t, rho_t = elastic_fields(cfg, true_vp)
    vs_0, rho_0 = elastic_fields(cfg, smooth_vp)
    vs_w = np.zeros(cfg.shape, np.float32)
    rho_w = np.ones(cfg.shape, np.float32)

    def model(vp, vs, rho, dt=None):
        return SeismicModel(origin=origin, spacing=cfg.spacing,
                            shape=cfg.shape, space_order=cfg.space_order,
                            vp=vp, vs=vs, b=(1.0 / rho), nbl=cfg.nbl,
                            fs=False, dt=dt, bcs="mask")

    # CFL-safe for the inversion bound's ceiling (5.2 km/s), not just the
    # true model: line-search trials may push the bounded vp above the
    # true maximum, and a step past the pinned dt's CFL limit blows the
    # staggered forward up
    vmax_bound = 5.2
    dt_e = float(model(true_vp, vs_t, rho_t).critical_dt)
    dt_e *= min(1.0, float(true_vp.max()) / vmax_bound)
    true_model = model(true_vp, vs_t, rho_t, dt=dt_e)
    init_model = model(smooth_vp, vs_0, rho_0, dt=dt_e)
    water_model = model(constant_vp, vs_w, rho_w, dt=dt_e)

    src_coordinates = np.empty((nsources, 2))
    src_coordinates[:, 0] = np.linspace(0, true_model.domain_size[0],
                                        num=nsources)
    src_coordinates[:, -1] = 2 * cfg.spacing[0]
    nreceivers = cfg.shape[0]
    rec_coordinates = np.empty((nreceivers, 2))
    rec_coordinates[:, 0] = np.linspace(cfg.spacing[0],
                                        true_model.domain_size[0]
                                        - cfg.spacing[0], num=nreceivers)
    rec_coordinates[:, 1] = 2 * cfg.spacing[0]

    geoms = [AcquisitionGeometry(m, rec_coordinates, src_coordinates, 0.,
                                 cfg.tn, f0=cfg.f0, src_type="Ricker")
             for m in (true_model, init_model, water_model)]
    return (true_model, init_model, water_model), geoms, \
        (true_vp, smooth_vp, vs_0, rho_0), bathy_mask


def visco_fields(cfg, vp):
    """(qp, rho) of a viscoacoustic Marmousi run: qp from Li's empirical
    relation 3.516 (1000 vp)^2.2 1e-6 (reference ``preset_models.py:349``),
    rho from Gardner's relation with water at 1.0 g/cc."""
    qp = (3.516 * ((vp * 1000.0) ** 2.2) * 1e-6).astype(np.float32)
    rho = (0.31 * (1e3 * vp) ** 0.25).astype(np.float32)
    rho[:, :cfg.bathy_rows] = 1.0
    return qp, rho


def setup_visco(cfg, args, nsources):
    """Viscoacoustic counterpart of ``setup``: (true, init, water) models
    carry (qp, b) derived from each model's vp (``visco_fields``) with the
    mask boundary; one pinned dt (the true model's CFL) keeps all time axes
    aligned."""
    origin = (0, 0)
    true_vp, smooth_vp = load_models(cfg, args.data_dir)
    constant_vp = np.ones(cfg.shape, dtype=np.float32) * 1.5

    bathy_mask = np.ones(cfg.shape, dtype=np.float32)
    bathy_mask[:, :cfg.bathy_rows] = 0
    if not args.bathy:
        bathy_mask = None

    def model(vp, dt=None):
        qp, rho = visco_fields(cfg, vp)
        return SeismicModel(origin=origin, spacing=cfg.spacing,
                            shape=cfg.shape, space_order=cfg.space_order,
                            vp=vp, qp=qp, b=(1.0 / rho), nbl=cfg.nbl,
                            fs=False, dt=dt, bcs="mask")

    dt_v = float(model(true_vp).critical_dt)
    true_model = model(true_vp, dt=dt_v)
    init_model = model(smooth_vp, dt=dt_v)
    water_model = model(constant_vp, dt=dt_v)

    src_coordinates = np.empty((nsources, 2))
    src_coordinates[:, 0] = np.linspace(0, true_model.domain_size[0],
                                        num=nsources)
    src_coordinates[:, -1] = 2 * cfg.spacing[0]
    nreceivers = cfg.shape[0]
    rec_coordinates = np.empty((nreceivers, 2))
    rec_coordinates[:, 0] = np.linspace(cfg.spacing[0],
                                        true_model.domain_size[0]
                                        - cfg.spacing[0], num=nreceivers)
    rec_coordinates[:, 1] = 2 * cfg.spacing[0]

    geoms = [AcquisitionGeometry(m, rec_coordinates, src_coordinates, 0.,
                                 cfg.tn, f0=cfg.f0, src_type="Ricker")
             for m in (true_model, init_model, water_model)]
    return (true_model, init_model, water_model), geoms, smooth_vp, \
        bathy_mask


class TimedLoss:
    """An objective (default: ``fwi_loss`` on ``device``) recording each
    call in order as (calc_grad, objective, host seconds). Each call ends
    with the objective (and gradient) on the host, so its time includes
    the device work."""

    def __init__(self, device, loss=None):
        self.loss = loss or partial(fwi_loss, device=device)
        self.calls = []

    def __call__(self, x, geometry, obs, misfit_func, direct_wave=None,
                 mask=None, precond=True, calc_grad=True, shot_indices=None):
        t0 = perf_counter()
        out = self.loss(x, geometry, obs, misfit_func, direct_wave, mask,
                        precond, calc_grad, shot_indices=shot_indices)
        self.calls.append((bool(calc_grad), out[0], perf_counter() - t0))
        return out


def misfits(cfg, bfm_options=None):
    """[least_square, W2-1d, W2-2d], indexed by ``--misfit`` (the JAX
    driver's configurations); ``bfm_options`` goes to the W2-2d solver."""
    return [least_square,
            qWasserstein(gamma=1.01, method="1d"),
            qWasserstein(gamma=1.01, method="2d",
                         num_steps=cfg.w2_num_steps,
                         step_scale=cfg.w2_step_scale,
                         bfm_options=bfm_options)]


def run_fwi_elastic(cfg, args):
    """Elastic Marmousi FWI: velocity-stress propagator, vp inversion in
    squared slowness with vs/rho pinned at the smooth model's fields (the
    BASELINE.json "Marmousi2 elastic FWI" workload). Returns (m, stats)
    as ``run_fwi`` does."""
    result_dir = args.odir
    misfit_type = args.misfit
    models, geoms, fields, bathy_mask = setup_elastic(cfg, args, args.nsrc)
    geometry1, geometry0, geometry2 = geoms
    _, smooth_vp, vs_0, rho_0 = fields
    print("elastic FWI %s: nsrc %d, misfit %d, device %s, dt %.4f ms"
          % (cfg.name, args.nsrc, misfit_type, args.device,
             geometry0.model.critical_dt))

    t0 = perf_counter()
    obs, _ = elastic_fm_multi(geometry1, device=args.device)
    direct_wave, _ = elastic_fm_multi(geometry2, device=args.device)
    model_s = perf_counter() - t0
    misfit_func = misfits(cfg)[misfit_type]
    loss = TimedLoss(args.device, ElasticFwiLoss(vs=vs_0, rho=rho_0,
                                                 device=args.device))
    vmin, vmax = 1.5, 5.2
    bounds = [1.0 / vmax ** 2, 1.0 / vmin ** 2]
    m0 = 1. / (smooth_vp.reshape(-1).astype(np.float64)) ** 2

    if args.check_gradient:
        f, g, _ = loss(m0, geometry0, obs, misfit_func, direct_wave,
                       bathy_mask, args.precond, calc_grad=True)
        np.asarray(g, np.float32).tofile(
            os.path.join(result_dir, "marmousi_elastic_1st_grad_"
                         + str(misfit_type)))
        print("check-gradient: f=%.6e |g|max=%.3e" % (f, np.abs(g).max()))

    tic = perf_counter()
    log_path = os.path.join(result_dir, "log_el" + str(misfit_type))
    optimizer = LBFGS(memory=10, ls_method="Bracket",
                      step_len_init=args.steplen, max_ls=args.maxls,
                      log_path=log_path)
    minimizer = minimize(optimizer, maxIter=args.maxiter, ftol=args.ftol,
                         gtol=args.gtol, batch_size=args.batch_size or None,
                         checkpoint_freq=args.checkpoint_freq,
                         resume=bool(args.resume), loss_fn=loss,
                         log_path=log_path)
    m = minimizer.run(m0, geometry0, obs, misfit_func, direct_wave,
                      bathy_mask, args.precond, bounds)
    print(f"\n Elapsed time: {perf_counter() - tic:.2f}s")

    vp = 1.0 / np.sqrt(m.reshape(cfg.shape))
    vp.astype(np.float32).tofile(
        os.path.join(result_dir,
                     "marmousi_elastic_result_misfit_" + str(misfit_type)))
    print("final model range: %.3f %.3f km/s" % (vp.min(), vp.max()))
    return m, dict(calls=loss.calls, model_s=model_s)


def run_fwi_visco(cfg, args):
    """Viscoacoustic (SLS) Marmousi FWI: vp inversion in squared slowness
    with qp and rho pinned at the smooth model's fields (Q-compensated FWI;
    the reference's viscoacoustic solver has no gradient). Returns (m,
    stats) as ``run_fwi`` does."""
    result_dir = args.odir
    misfit_type = args.misfit
    models, geoms, smooth_vp, bathy_mask = setup_visco(cfg, args, args.nsrc)
    geometry1, geometry0, geometry2 = geoms
    print("viscoacoustic FWI %s: nsrc %d, misfit %d, device %s, dt %.4f ms"
          % (cfg.name, args.nsrc, misfit_type, args.device,
             geometry0.model.critical_dt))

    t0 = perf_counter()
    obs = visco_fm_multi(geometry1, device=args.device)
    direct_wave = visco_fm_multi(geometry2, device=args.device)
    model_s = perf_counter() - t0
    misfit_func = misfits(cfg)[misfit_type]
    loss = TimedLoss(args.device, ViscoFwiLoss(device=args.device))
    vmin, vmax = 1.5, 5.2
    bounds = [1.0 / vmax ** 2, 1.0 / vmin ** 2]
    m0 = 1. / (smooth_vp.reshape(-1).astype(np.float64)) ** 2

    tic = perf_counter()
    log_path = os.path.join(result_dir, "log_va" + str(misfit_type))
    optimizer = LBFGS(memory=10, ls_method="Bracket",
                      step_len_init=args.steplen, max_ls=args.maxls,
                      log_path=log_path)
    minimizer = minimize(optimizer, maxIter=args.maxiter, ftol=args.ftol,
                         gtol=args.gtol, batch_size=args.batch_size or None,
                         checkpoint_freq=args.checkpoint_freq,
                         resume=bool(args.resume), loss_fn=loss,
                         log_path=log_path)
    m = minimizer.run(m0, geometry0, obs, misfit_func, direct_wave,
                      bathy_mask, args.precond, bounds)
    print(f"\n Elapsed time: {perf_counter() - tic:.2f}s")

    vp = 1.0 / np.sqrt(m.reshape(cfg.shape))
    vp.astype(np.float32).tofile(
        os.path.join(result_dir,
                     "marmousi_visco_result_misfit_" + str(misfit_type)))
    print("final model range: %.3f %.3f km/s" % (vp.min(), vp.max()))
    return m, dict(calls=loss.calls, model_s=model_s)


def run_fwi(cfg, argv=None, bfm_options=None):
    """Parse ``argv`` (default: the command line) and run the inversion;
    ``bfm_options`` are the W2-2d solver's keywords (``misfit.bfm``'s
    backends, e.g. ``{"legendre": "banded"}``). Returns (m, stats): the
    final squared slowness and a dict with the objective calls in order
    (``calls``: (calc_grad, objective, host seconds); a gradient opens each
    iteration, the line-search trials follow) and the time of the forward
    modeling of the observed data and the direct wave (``model_s``)."""
    args = make_parser(cfg).parse_args(argv)
    result_dir = args.odir
    os.makedirs(result_dir, exist_ok=True)
    if args.physics == "elastic":
        return run_fwi_elastic(cfg, args)
    if args.physics == "viscoacoustic":
        return run_fwi_visco(cfg, args)
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

    models, geoms, vps, bathy_mask = setup(cfg, args, args.nsrc)
    geometry1, geometry0, geometry2 = geoms
    _, smooth_vp = vps
    geometry0.resample(args.resample or cfg.dt)

    t0 = perf_counter()
    obs = fm_multi(geometry1, device=args.device)
    direct_wave = fm_multi(geometry2, device=args.device)
    model_s = perf_counter() - t0
    misfit_func = misfits(cfg, bfm_options)[misfit_type]
    loss = TimedLoss(args.device)

    if args.check_gradient:
        f, g, _ = loss(1. / smooth_vp.reshape(-1).astype(np.float64) ** 2,
                       geometry0, obs, misfit_func, None, bathy_mask,
                       args.precond)
        g.tofile(os.path.join(result_dir, "marmousi_1st_grad_"
                              + str(misfit_type)))
        print("check-gradient: f=%.6e |g|max=%.3e" % (f, np.abs(g).max()))

    vmin, vmax = 1.5, 5.2
    bounds = [1.0 / vmax ** 2, 1.0 / vmin ** 2]
    m0 = 1. / (smooth_vp.reshape(-1).astype(np.float64)) ** 2

    tic = perf_counter()
    log_path = os.path.join(result_dir, "log" + str(misfit_type))
    optimizer = LBFGS(memory=10, ls_method="Bracket",
                      step_len_init=args.steplen, max_ls=args.maxls,
                      log_path=log_path)
    minimizer = minimize(optimizer, maxIter=args.maxiter, ftol=args.ftol,
                         gtol=args.gtol, batch_size=args.batch_size or None,
                         checkpoint_freq=args.checkpoint_freq,
                         resume=bool(args.resume), loss_fn=loss,
                         log_path=log_path)
    m = minimizer.run(m0, geometry0, obs, misfit_func, direct_wave,
                      bathy_mask, args.precond, bounds)
    print(f"\n Elapsed time: {perf_counter() - tic:.2f}s")

    vp = 1.0 / np.sqrt(m.reshape(cfg.shape))
    vp.astype(np.float32).tofile(
        os.path.join(result_dir,
                     "marmousi_result_misfit_" + str(misfit_type)))
    print("final model range: %.3f %.3f km/s" % (vp.min(), vp.max()))
    return m, dict(calls=loss.calls, model_s=model_s)
