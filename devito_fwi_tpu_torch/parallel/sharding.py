"""Shot parallelism over the ranks of a mesh, on ``torch.distributed``.

Port of ``devito_fwi_tpu.parallel.sharding``: the replacement of the
reference's dask task layer (``fwi.py:83-102, 207-234``). Each rank of a
``shot_mesh`` takes one contiguous block of the shots and runs it through
the port's own single-device objective (``fwi._objective_sums``,
``elastic_fwi._elastic_sums``, ``visco_fwi._visco_sums``: the kernels on
the card, their twins on the CPU, the eager routes where no kernel takes
the call; chunked to its part of the card's memory,
``group.budget_share``); then the (fval, gradient, illumination) sums meet
in one all_reduce, and the precondition and the mask follow. Host misfits
run on each rank's own host. The TTI, viscoelastic and self-adjoint
objectives, which the JAX package has only here, loop over the block's
shots through the eager operators of ``ops.tti``, ``ops.staggered_grad``
and ``ops.self_adjoint``. Modeling gathers the blocks' traces exactly
(``group`` module docstring). Divergence from the JAX package: shot
blocks are not padded to equal lengths (``shard_map`` needed that); a rank
without shots adds zeros.

The domain decomposition (``domain_mesh``, ``forward_domain_sharded``,
``gradient_domain_sharded``) and the shots x domain objective
(``hier_mesh``, ``fwi_obj_sharded2d``) live in ``parallel.domain`` and are
re-exported here, as the JAX module holds them.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import elastic_fwi as _el
from .. import fwi as _fwi
from .. import visco_fwi as _vf
from ..ops import self_adjoint as _sa
from ..ops import staggered as _st
from ..ops import staggered_grad as _sg
from ..ops import tti as _tti
from .domain import (domain_mesh, forward_domain_sharded,
                     fwi_obj_sharded2d, gradient_domain_sharded, hier_mesh)
from .group import block, budget_share, shot_mesh

__all__ = ["shot_mesh", "fm_multi_sharded", "fwi_obj_sharded",
           "tti_fwi_obj_sharded", "viscoacoustic_fm_sharded",
           "elastic_fwi_obj_sharded", "domain_mesh",
           "forward_domain_sharded", "gradient_domain_sharded",
           "hier_mesh", "fwi_obj_sharded2d",
           "viscoacoustic_fwi_obj_sharded", "viscoelastic_fwi_obj_sharded",
           "sa_fwi_obj_sharded"]


def _block(geometry, mesh):
    """This rank's shots: None when it holds them all (a world of one),
    else their indices (possibly none)."""
    sel = block(geometry.nsrc, mesh.size, mesh.rank)
    return None if len(sel) == geometry.nsrc else sel


def _gather_traces(mesh, geometry, traces, sel):
    """The (nsrc, nt, nrec) gathers of every rank from each rank's block
    ``traces`` of the shots ``sel``: an exact all_reduce."""
    full = torch.zeros((geometry.nsrc,) + tuple(traces.shape[1:]),
                       dtype=traces.dtype, device=mesh.device)
    full[torch.as_tensor(sel, device=mesh.device)] = traces
    return mesh.sum_(full)


def _reduce(mesh, fval, fields, shape):
    """(fval, fields) summed over the mesh's ranks in one all_reduce of a
    float64 buffer; ``fields`` None (a rank without shots, or no gradient)
    adds zeros."""
    n = int(np.prod(shape))
    nf = len(fields)
    buf = torch.zeros(1 + nf * n, dtype=torch.float64, device=mesh.device)
    buf[0] = torch.as_tensor(fval, dtype=torch.float64)
    for k, f in enumerate(fields):
        if f is not None:
            buf[1 + k * n:1 + (k + 1) * n] = f.reshape(-1)
    mesh.sum_(buf)
    return float(buf[0]), [buf[1 + k * n:1 + (k + 1) * n].reshape(shape)
                           for k in range(nf)]


def fm_multi_sharded(geometry, save=False, mesh=None):
    """All-shot forward modeling over the ranks of ``mesh`` (default
    ``shot_mesh()``): each rank models its block (``fwi._traces``: row 1's
    kernel where it takes the geometry); every rank returns the list of
    PointSource records of all shots. ``save`` changes nothing, as in
    ``fwi.fm_multi``."""
    mesh = mesh or shot_mesh()
    sel = block(geometry.nsrc, mesh.size, mesh.rank)
    nrec = geometry.rec_positions.shape[0]
    traces = _fwi._traces(geometry, mesh.device, sel) if len(sel) else \
        torch.zeros((0, geometry.nt, nrec),
                    dtype=_torch_dtype(geometry.model), device=mesh.device)
    rec_all = _gather_traces(mesh, geometry, traces, sel)
    return _fwi._shot_records(rec_all.cpu().numpy(), geometry)


def _torch_dtype(model):
    return torch.float64 if model.dtype == np.float64 else torch.float32


def fwi_obj_sharded(geometry, obs, misfit_func, direct_wave=None, mask=None,
                    precond=True, calc_grad=False, mesh=None,
                    resample_dt=None):
    """Shot-sharded acoustic objective: (fval, grad on the model's shape,
    float64 numpy; zeros without ``calc_grad``). Each rank runs its block
    through ``fwi._objective_sums`` (the batched kernels, the 3-D or eager
    routes, and the host misfits: custom numpy callables, the native 2-D
    solver and ``resample_dt``, on each rank's host); one all_reduce sums
    (fval, grad, illum), then the precondition and the mask."""
    mesh = mesh or shot_mesh()
    shape = geometry.model.shape
    sel = _block(geometry, mesh)
    fval, grad, illum = 0.0, None, None
    if sel is None or len(sel):
        with budget_share(mesh):
            fval, grad, illum, _ = _fwi._objective_sums(
                geometry, obs, misfit_func, direct_wave, calc_grad,
                resample_dt, None, sel, mesh.device)
    fval, (grad, illum) = _reduce(mesh, fval, (grad, illum), shape)
    if not calc_grad:
        return fval, np.zeros(shape)
    return fval, _fwi._precondition(grad, illum, precond, mask).cpu().numpy()


def _one_shot(misfit_func):
    """``misfit(syn, obs)`` of one (nt, nrec) gather on the device through
    the misfit's batched torch form: (fval, residual)."""
    batch, _ = _fwi._misfit_batch(misfit_func)

    def misfit(syn, ob):
        f, res = batch(syn[None], ob[None])
        return f[0], res[0]
    return misfit


class _ShotLoop:
    """The shots of one rank's block for the objectives that loop over
    them through eager operators: tables, observed and direct-wave data,
    the illumination-fix factors and the sums."""

    def __init__(self, geometry, obs, direct_wave, mesh, calc_grad):
        model = geometry.model
        self.dev = mesh.device
        self.sel = block(geometry.nsrc, mesh.size, mesh.rank)
        (self.s_idx, self.s_w, self.r_idx, self.r_w,
         src_wav) = _fwi._batched_tables(geometry)
        self.src_wav = torch.as_tensor(np.asarray(src_wav, model.dtype),
                                       device=self.dev)
        # a list of records or an (nsrc, nt, nrec) array
        self.obs = _fwi._device_stack(obs, self.dev)
        self.dw = None if direct_wave is None else \
            _fwi._device_stack(direct_wave, self.dev)
        self.pads, self.shape = _fwi._pads(model), model.shape
        self.fval = 0.0
        self.grads = self.illum = None
        if calc_grad and len(self.sel):
            self.factors = _fwi._illum_factors(
                geometry, np.asarray(geometry.src_positions)[self.sel],
                self.dev)

    def data(self, i):
        """(obs, direct wave or 0.0) of shot i."""
        return self.obs[i], (0.0 if self.dw is None else self.dw[i])

    def add(self, j, f, grads=None, illum=None):
        """Add the j-th shot of the block: its misfit and, cropped to the
        physical domain, its gradients and illumination times the
        illumination fix."""
        self.fval = self.fval + f.double()
        if grads is None:
            return
        keep, rec_prod = self.factors(j, j + 1)
        fix = keep[0] * rec_prod
        gs = tuple(g.double() * fix for g in grads)
        il = illum.double() * fix
        self.grads = gs if self.grads is None else \
            tuple(a + g for a, g in zip(self.grads, gs))
        self.illum = il if self.illum is None else self.illum + il

    def crop(self, field):
        return _fwi._crop(field, self.pads, self.shape)


def _finish(mesh, loop, nfields, calc_grad, precond, mask, names):
    """Reduce a shot loop's sums over the mesh: (fval, {name: grad}) with
    the elastic objectives' finishing (``elastic_fwi._finish_grads``), or
    (fval, None) without ``calc_grad``."""
    fields = (loop.grads or (None,) * nfields) + (loop.illum,) \
        if calc_grad else ()
    fval, sums = _reduce(mesh, loop.fval, fields, loop.shape)
    if not calc_grad:
        return fval, None
    return fval, _el._finish_grads(tuple(sums[:-1]), sums[-1], precond,
                                   mask, names)


def tti_fwi_obj_sharded(geometry, obs, misfit_func=None, direct_wave=None,
                        mask=None, precond=True, calc_grad=False, mesh=None,
                        n_checkpoints=16):
    """Shot-sharded TTI objective: each rank's shots through the eager
    checkpoint pair ``ops.tti.forward_ckpt(with_illum=True)`` and
    ``jacobian_adjoint_from_ckpt`` (the TTI kernels give no illumination),
    the crop and the illumination fix, one all_reduce, the precondition and
    the mask. ``geometry.model`` carries epsilon, delta, theta (and phi in
    3-D; a constant phi may be a scalar); ``obs`` is the (u + v) gather
    list or an (nsrc, nt, nrec) stack. Returns (fval, grad on the model's
    shape, float64 numpy; None without ``calc_grad``)."""
    mesh = mesh or shot_mesh()
    model = geometry.model
    misfit = _one_shot(misfit_func)
    loop = _ShotLoop(geometry, obs, direct_wave, mesh, calc_grad)
    dev = loop.dev

    def field(x):
        return torch.as_tensor(np.asarray(x, dtype=model.dtype), device=dev)

    vp, damp = field(model.vp), field(model.damp)
    eps, delta, theta = (field(getattr(model, n))
                         for n in ("epsilon", "delta", "theta"))
    phi = None
    if model.dim == 3:
        p = getattr(model, "phi", None)
        if p is not None and not (np.ndim(p) == 0 and float(p) == 0.0):
            phi = field(p)
    args = (vp, damp, eps, delta, theta, phi)
    kw = dict(nt=geometry.nt, spacing=model.spacing,
              space_order=model.space_order, n_checkpoints=n_checkpoints)
    dt = float(_fwi._solver_dt(geometry))
    for j, i in enumerate(loop.sel):
        shot = (loop.src_wav, loop.s_idx[i], loop.s_w[i])
        ob, dw = loop.data(i)
        out = _tti.forward_ckpt(*args, *shot, loop.r_idx, loop.r_w, dt,
                                with_illum=calc_grad, **kw)
        f, res = misfit(out[0] - dw, ob - dw)
        if not calc_grad:
            loop.add(j, f)
            continue
        _, starts, illum = out
        g, _ = _tti.jacobian_adjoint_from_ckpt(
            *args, *shot, starts, res.to(vp.dtype), loop.r_idx, loop.r_w,
            dt, **kw)
        loop.add(j, f, (loop.crop(g),), loop.crop(illum))
    fval, grads = _finish(mesh, loop, 1, calc_grad, precond, mask, ("g",))
    return fval, None if grads is None else grads["g"]


def viscoacoustic_fm_sharded(geometry, kernel="sls", time_order=2,
                             mesh=None):
    """Shot-sharded viscoacoustic modeling: each rank models its block
    through ``visco_fwi.visco_fm_multi`` (row 19's kernel for sls/2 where it
    takes the geometry, the eager forward otherwise); every rank returns
    the (nsrc, nt, nrec) gather stack as numpy."""
    mesh = mesh or shot_mesh()
    sel = block(geometry.nsrc, mesh.size, mesh.rank)
    nrec = geometry.rec_positions.shape[0]
    if len(sel):
        recs = _vf.visco_fm_multi(_fwi._subset_geometry(geometry, sel),
                                  kernel, time_order, mesh.device)
        traces = torch.as_tensor(np.stack([r.data for r in recs]),
                                 device=mesh.device)
    else:
        traces = torch.zeros((0, geometry.nt, nrec),
                             dtype=_torch_dtype(geometry.model),
                             device=mesh.device)
    return _gather_traces(mesh, geometry, traces, sel).cpu().numpy()


def _family_sharded(sums, nfields, names, geometry, mesh, calc_grad,
                    precond, mask, **kw):
    """Elastic and viscoacoustic: each rank's block through the family's
    single-device sums (``shot_indices``), one all_reduce, the family's
    finishing."""
    sel = _block(geometry, mesh)
    fval, grads, illum = 0.0, None, None
    if sel is None or len(sel):
        with budget_share(mesh):
            fval, grads, illum, _ = sums(
                geometry, calc_grad=calc_grad, shot_indices=sel,
                dev=mesh.device, **kw)
    fields = ((grads or (None,) * nfields) + (illum,)) if calc_grad else ()
    fval, sums_ = _reduce(mesh, fval, fields, geometry.model.shape)
    if not calc_grad:
        return fval, None
    return fval, _el._finish_grads(tuple(sums_[:-1]), sums_[-1], precond,
                                   mask, names)


def elastic_fwi_obj_sharded(geometry, obs, misfit_func=None,
                            direct_wave=None, mask=None, precond=True,
                            calc_grad=False, mesh=None, n_checkpoints=0,
                            vp=None, vs=None, rho=None):
    """Shot-sharded elastic objective: each rank's block through
    ``elastic_fwi``'s objective ("auto": the kernels, rows 18, 20, 21,
    where they take the geometry, else the saved route), one all_reduce of
    (fval,
    g_vp, g_vs, g_rho, illum), then the precondition and the mask. Returns
    (fval, {"vp", "vs", "rho"} gradients, float64 numpy; None without
    ``calc_grad``)."""
    mesh = mesh or shot_mesh()
    return _family_sharded(
        _el._elastic_sums, 3, ("vp", "vs", "rho"), geometry, mesh,
        calc_grad, precond, mask, obs=obs, misfit_func=misfit_func,
        direct_wave=direct_wave, vp=vp, vs=vs, rho=rho, shot_chunk=None,
        n_checkpoints=n_checkpoints, illum_fix=True, grad_route=None)


def viscoacoustic_fwi_obj_sharded(geometry, obs, misfit_func=None,
                                  direct_wave=None, mask=None,
                                  precond=True, calc_grad=False,
                                  kernel="sls", time_order=2, mesh=None,
                                  n_checkpoints=0, vp=None, qp=None):
    """Shot-sharded viscoacoustic objective: each rank's block through
    ``visco_fwi``'s objective (sls/2 on rows 19, 22, 23 where the kernels
    take the call; the other kernels on the vjp route), one all_reduce,
    the precondition and the mask. Returns (fval, {"vp", "qp"}; None
    without ``calc_grad``)."""
    _vf._check_kernel(kernel, time_order)
    mesh = mesh or shot_mesh()
    return _family_sharded(
        _vf._visco_sums, 2, ("vp", "qp"), geometry, mesh, calc_grad,
        precond, mask, obs=obs, misfit_func=misfit_func,
        direct_wave=direct_wave, vp=vp, qp=qp, kernel=kernel,
        time_order=time_order, shot_chunk=None,
        n_checkpoints=n_checkpoints, illum_fix=True, grad_route=None)


def viscoelastic_fwi_obj_sharded(geometry, obs, misfit_func=None,
                                 direct_wave=None, mask=None,
                                 precond=True, calc_grad=False,
                                 mesh=None, n_checkpoints=0):
    """Shot-sharded viscoelastic (vp, vs, rho, qp, qs) objective: per shot
    of each rank's block the saved-history gradient
    ``staggered_grad.viscoelastic_value_and_grad`` (without a gradient the
    eager ``staggered.viscoelastic_forward``), ``pad_fold``, the crop and
    the illumination fix, one all_reduce, the precondition and the mask.
    Observed data is the rec1 (tau_zz) gather. ``n_checkpoints`` is
    accepted for parity: the saved-history route keeps every step."""
    mesh = mesh or shot_mesh()
    model = geometry.model
    model._initialize_bcs(bcs="mask")
    misfit = _one_shot(misfit_func)
    loop = _ShotLoop(geometry, obs, direct_wave, mesh, calc_grad)
    dev, pads = loop.dev, loop.pads
    crop = tuple(slice(lo, lo + n) for (lo, _), n in zip(pads, loop.shape))
    mvp, mvs, mrho = _el.model_vp_vs_rho(model)
    phys = [torch.as_tensor(np.asarray(f)[crop], device=dev)
            for f in (mvp, mvs, mrho, _vf._field(model, "qp"),
                      _vf._field(model, "qs"))]
    vpp, vsp, rhp, qpp, qsp = (_el._pad_edge(x, pads) for x in phys)
    damp = torch.as_tensor(_el._damp_field(model), device=dev)
    dt = float(model.critical_dt)
    f0 = float(geometry.f0)
    kw = dict(nt=geometry.nt, spacing=model.spacing,
              space_order=model.space_order)
    for j, i in enumerate(loop.sel):
        shot = (loop.src_wav, loop.s_idx[i], loop.s_w[i], loop.r_idx,
                loop.r_w)
        ob, dw = loop.data(i)
        if not calc_grad:
            lam, mu = _el._lame(vpp, vsp, rhp)[:2]
            with torch.no_grad():
                rec1, _ = _st.viscoelastic_forward(
                    lam, mu, 1.0 / rhp, qpp, qsp, damp, f0, *shot, dt, **kw)
            loop.add(j, misfit(rec1 - dw, ob - dw)[0])
            continue
        f, grads, illum, _ = _sg.viscoelastic_value_and_grad(
            vpp, vsp, rhp, qpp, qsp, damp, f0, *shot[:3], loop.r_idx,
            loop.r_w, ob, dw, dt, misfit, **kw)
        loop.add(j, f, tuple(_sg.pad_fold(g, pads) for g in grads),
                 loop.crop(illum))
    return _finish(mesh, loop, 5, calc_grad, precond, mask,
                   ("vp", "vs", "rho", "qp", "qs"))


def sa_fwi_obj_sharded(geometry, obs, misfit_func=None, direct_wave=None,
                       mask=None, precond=True, calc_grad=False, mesh=None):
    """Shot-sharded self-adjoint objective: per shot of each rank's block
    the saved forward ``ops.self_adjoint.forward(save=True)`` and the
    explicit ``jacobian_adjoint`` imaging condition (reference
    ``IsoJacobianAdjOperator``), the crop and the illumination fix, one
    all_reduce, the precondition and the mask. The model carries vp, b and
    a w/Q damp field (``self_adjoint.setup_w_over_q``). Returns (fval,
    g_vp on the model's shape; None without ``calc_grad``). Each shot in
    flight holds its nt x grid history."""
    mesh = mesh or shot_mesh()
    model = geometry.model
    misfit = _one_shot(misfit_func)
    loop = _ShotLoop(geometry, obs, direct_wave, mesh, calc_grad)
    dev = loop.dev
    vp, b, woq = (torch.as_tensor(_vf._field(model, n, d), device=dev)
                  for n, d in (("vp", None), ("b", 1.0), ("damp", None)))
    dt = float(model.critical_dt)
    kw = dict(nt=geometry.nt, spacing=model.spacing,
              space_order=model.space_order)
    for j, i in enumerate(loop.sel):
        ob, dw = loop.data(i)
        rec, u0 = _sa.forward(vp, b, woq, loop.src_wav, loop.s_idx[i],
                              loop.s_w[i], loop.r_idx, loop.r_w, dt,
                              save=calc_grad, **kw)
        f, res = misfit(rec - dw, ob - dw)
        if not calc_grad:
            loop.add(j, f)
            continue
        dm, _ = _sa.jacobian_adjoint(vp, b, woq, u0, res.to(vp.dtype),
                                     loop.r_idx, loop.r_w, dt, **kw)
        illum = torch.sum(u0 * u0, dim=0)
        del u0
        loop.add(j, f, (loop.crop(dm),), loop.crop(illum))
    fval, grads = _finish(mesh, loop, 1, calc_grad, precond, mask, ("g",))
    return fval, None if grads is None else grads["g"]
