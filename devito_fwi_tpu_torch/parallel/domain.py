"""Spatial domain decomposition with an explicit halo exchange (the
Devito-MPI analog; reference ``seismic/inversion/inversion_utils.py:7-25``)
and the shots x domain objective.

Port of the domain half of ``devito_fwi_tpu.parallel.sharding``, where
GSPMD inserts the halo exchanges; here they are written out. The grid is
edge-padded to multiples of the mesh axes (the appended cells extend the
absorbing boundary, as the JAX package's ``_domain_sharded_fields``), and
each rank of a ``domain_mesh`` holds one slab of it along the mesh's
leading axes (a 3-D grid under a 2-D mesh keeps z whole). A rank steps
its slab's extension: the slab widened by ``steps`` rings of r =
space_order/2 cells on every side with a neighbour, cut at the grid's
edges, where ``shift``'s zeros stand as they do on the whole grid. Each
step runs the port's eager OT2 update (``ops.acoustic._operator``:
``laplacian_parts``, ``_update``) on the extension and leaves r fewer
exact cells on those sides, so after ``steps`` steps (at most
``STEPS_PER_EXCHANGE``, and no more than a slab's width allows) only the
slab is exact: the exchange then rebuilds the extension of the stepped
pair from every slab (one all_reduce of zero-filled grids, one term a
cell: exact; a stored checkpoint is exchanged before its recompute).
Fewer, larger exchanges: an all_reduce between the ranks of one card
costs several eager steps (``tools/probe_allreduce.py``). Sources and
residuals are injected at the corners inside the extension, in the order
of the whole-grid scatter;
receiver corners are read where they are owned, gathered once at the end
by the exact all_reduce and weighted as ``_sampler`` does. The
free-surface fix runs on the extensions that hold the global rows 0..r
and reads rows up to 2r, so a split that leaves a slab thinner than 2r +
1 cells along a split axis is refused before any step. So every exact
cell sees the operands it sees on the whole grid, in the same order: the
decomposed forward, checkpointed forward and reverse sweep equal the
undecomposed eager operators bitwise. The steps are eager torch (the JAX
package's are XLA), host-bound on the card; no kernel runs here.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import fwi as _fwi
from ..ops import acoustic as _ac
from ..ops.interp import valid_corners
from .group import _world, all_sum_, block, domain_mesh, hier_mesh

__all__ = ["domain_mesh", "forward_domain_sharded", "gradient_domain_sharded",
           "hier_mesh", "fwi_obj_sharded2d"]

# the most steps between two halo exchanges: an all_reduce between ranks
# of one card costs several eager steps (tools/probe_allreduce.py)
STEPS_PER_EXCHANGE = 16


def _padded_fields(model, sizes):
    """(vp, damp, padded shape): the model's padded grid edge-padded at the
    high end of its leading ``len(sizes)`` axes to multiples of ``sizes``
    (numpy; damp 0.0 when the model holds a scalar, as the JAX package)."""
    pads = [(0, (-n) % (sizes[a] if a < len(sizes) else 1))
            for a, n in enumerate(model.padded_shape)]
    vp = np.pad(np.asarray(model.vp), pads, mode="edge")
    damp = np.pad(model.damp, pads, mode="edge") \
        if isinstance(model.damp, np.ndarray) else model.dtype(0.0)
    return vp, damp, vp.shape


class _Points:
    """A point table (``interp_table``'s idx, w) on a slab: every corner's
    weight; the corners in the extension, in ext coordinates and in the
    whole-grid scatter's order (injection); the corners the rank owns
    (sampling)."""

    def __init__(self, slab, idx, w, dtype):
        dev = slab.dev
        valid, cl = valid_corners(idx, slab.shape)
        self.wt = torch.as_tensor(np.where(valid, w, 0.0), dtype=dtype,
                                  device=dev)
        inext = np.ones(cl.shape[:-1], dtype=bool)
        own = np.ones(cl.shape[:-1], dtype=bool)
        for d in range(cl.shape[-1]):
            c = cl[..., d]
            inext &= (c >= slab.elo[d]) & (c < slab.ehi[d])
            own &= (c >= slab.lo[d]) & (c < slab.hi[d])

        def local(mask):
            return tuple(torch.as_tensor(cl[..., d][mask] - slab.elo[d],
                                         dtype=torch.long, device=dev)
                         for d in range(cl.shape[-1]))
        self.inext = torch.as_tensor(inext, device=dev)
        self.point = torch.as_tensor(np.nonzero(inext)[0], device=dev)
        self.ext_coords = local(inext)
        self.own = torch.as_tensor(own, device=dev)
        self.own_coords = local(own)

    def injector(self, m, s2):
        """``inject(field, vals)``: ``acoustic._injector``'s scatter of
        ``vals[:, None] * w * s^2 / m``, restricted to the extension."""
        scale = self.wt[self.inext] * s2 / m[self.ext_coords]

        def inject(field, vals):
            return field.index_put(self.ext_coords, vals[self.point] * scale,
                                   accumulate=True)
        return inject

    def corners(self, field, out):
        """Write the owned corners' values of ``field`` into ``out`` (npt,
        2^d), which holds zeros elsewhere."""
        out[self.own] = field[self.own_coords]


class _Slab:
    """One rank's slab of the (edge-padded) grid ``shape`` split over its
    leading axes in ``sizes`` parts, at ``coords``, with ``group`` the
    slabs' ranks. Its extension reaches ``steps`` r-cell rings past every
    side with a neighbour: after an exchange the extension is exact, and
    each step leaves r fewer exact cells on those sides, so ``steps``
    steps run between two exchanges."""

    def __init__(self, group, sizes, coords, shape, space_order, fs, dev):
        r = space_order // 2
        self.group, self.dev, self.shape = group, dev, tuple(shape)
        self.sizes = tuple(sizes)
        self.coords = tuple(coords)
        widths = []
        for a, parts in enumerate(self.sizes):
            width = self.shape[a] // parts
            if parts > 1:
                if width < 2 * r + 1:
                    raise ValueError(
                        f"domain split {self.sizes} leaves slabs of {width}"
                        f" cells along axis {a}: at space order "
                        f"{space_order} a slab needs at least {2 * r + 1} "
                        "(the halo and the free-surface rows)")
                widths.append(width)
        self.split = bool(widths)
        self.steps = min([STEPS_PER_EXCHANGE] + [w // r for w in widths])
        halo = self.steps * r
        self.lo, self.hi, self.elo, self.ehi = [], [], [], []
        for a, n in enumerate(self.shape):
            parts = self.sizes[a] if a < len(self.sizes) else 1
            c = self.coords[a] if a < len(self.sizes) else 0
            width = n // parts
            lo, hi = c * width, (c + 1) * width
            self.lo.append(lo)
            self.hi.append(hi)
            self.elo.append(max(lo - halo, 0))
            self.ehi.append(min(hi + halo, n))
        # the fix rewrites global rows 0..r: on extensions that hold them
        self.fs = fs and self.elo[-1] == 0
        self.ext = tuple(slice(a, b) for a, b in zip(self.elo, self.ehi))
        self.inner = tuple(slice(lo - e, hi - e) for lo, hi, e in
                           zip(self.lo, self.hi, self.elo))
        self.owned = tuple(slice(lo, hi) for lo, hi in zip(self.lo, self.hi))

    def exchange(self, *fields):
        """Fresh extensions of ``fields`` (whose slab cells are exact): the
        whole grid of each gathered by one all_reduce of zero-filled grids
        (one term a cell: exact), then this rank's extension of it."""
        if not self.split:
            return fields
        full = fields[0].new_zeros((len(fields),) + self.shape)
        for k, f in enumerate(fields):
            full[k][self.owned] = f[self.inner]
        all_sum_(full, self.group)
        return tuple(full[(k,) + self.ext].clone()
                     for k in range(len(fields)))

    def gather(self, f_ext, dtype=None):
        """The whole grid of a field from every slab's cells: an exact
        all_reduce of zero-filled grids."""
        full = torch.zeros(self.shape, dtype=dtype or f_ext.dtype,
                           device=self.dev)
        full[self.owned] = f_ext[self.inner]
        return all_sum_(full, self.group)


class _SlabOperator:
    """The eager OT2 operators of ``ops.acoustic`` on one slab: ``forward``,
    ``forward_ckpt`` and ``gradient_from_ckpt``, step for step and
    operation for operation theirs; the stepped pair is exchanged every
    ``slab.steps`` steps."""

    def __init__(self, slab, vp, damp, dt, spacing, space_order, s_idx, s_w,
                 r_idx, r_w, src_wav):
        self.slab = slab
        dev = slab.dev
        self.vp = torch.as_tensor(np.ascontiguousarray(vp[slab.ext]),
                                  device=dev)
        damp = torch.as_tensor(np.ascontiguousarray(damp[slab.ext]),
                               device=dev) \
            if isinstance(damp, np.ndarray) else damp
        _, _, self.m, self.s2, self.step = _ac._operator(
            self.vp, damp, dt, spacing, space_order, slab.fs, "OT2", False)
        dtype = self.vp.dtype
        self.src = _Points(slab, s_idx, s_w, dtype)
        self.rec = _Points(slab, r_idx, r_w, dtype)
        self.inject_src = self.src.injector(self.m, self.s2)
        self.src_wav = torch.as_tensor(np.asarray(src_wav), dtype=dtype,
                                       device=dev)
        self.nrec, self.ncorner = self.rec.wt.shape

    def _traces(self, vals, nt):
        """Receiver traces (nt, nrec) from every rank's owned corner values
        (nt, nrec, 2^d): gathered exactly, weighted a step at a time as
        ``acoustic._sampler``."""
        all_sum_(vals, self.slab.group)
        recs = torch.zeros((nt, self.nrec), dtype=vals.dtype,
                           device=vals.device)
        for t in range(1, nt - 1):
            recs[t] = torch.sum(vals[t] * self.rec.wt, dim=-1)
        return recs

    def _zeros(self, *lead):
        return self.vp.new_zeros(lead + tuple(self.vp.shape))

    def _advance(self, pair, n, src_t, illum=None, starts=None, seg=None,
                 vals=None, keep=None):
        """``n`` forward steps of the pair (u, u_prev) from step index
        ``src_t`` (the wavelet sample of the first), exchanging every
        ``slab.steps`` steps while steps remain: the final pair (exact on
        the slab), and the illumination, starts, receiver corners and
        (``keep``) the stepped fields as asked."""
        u, u_prev = pair
        for j in range(n):
            i = src_t - 1 + j
            if starts is not None and i % seg == 0:
                starts.append((u, u_prev))
            if vals is not None:
                self.rec.corners(u, vals[i + 1])
            unext = self.inject_src(self.step(u, u_prev),
                                    self.src_wav[src_t + j])
            if illum is not None:
                illum = illum + unext * unext
            u_prev, u = u, unext
            if (j + 1) % self.slab.steps == 0 and j < n - 1:
                u, u_prev = self.slab.exchange(u, u_prev)
            if keep is not None:
                keep.append(u)
        return (u, u_prev), illum

    def forward(self, nt):
        """``acoustic.forward(save=False)``'s traces (nt, nrec)."""
        z = self._zeros()
        vals = self.vp.new_zeros((nt, self.nrec, self.ncorner))
        self._advance((z, z), nt - 2, 1, vals=vals)
        return self._traces(vals, nt)

    def forward_ckpt(self, nt, n_checkpoints):
        """``acoustic.forward_ckpt``: (traces, segment starts [(u, u_prev)]
        on the extension, the illumination on the extension)."""
        nsteps, seg, _ = _ac._ckpt_layout(nt, n_checkpoints)
        z = self._zeros()
        vals = self.vp.new_zeros((nt, self.nrec, self.ncorner))
        starts = []
        _, illum = self._advance((z, z), nsteps, 1, illum=self._zeros(),
                                 starts=starts, seg=seg, vals=vals)
        return self._traces(vals, nt), starts, illum

    def gradient_from_ckpt(self, starts, rec_res, nt, n_checkpoints):
        """``acoustic.gradient_from_ckpt``'s gradient on the extension."""
        inject_rec = self.rec.injector(self.m, self.s2)
        res = torch.as_tensor(rec_res, dtype=self.vp.dtype,
                              device=self.vp.device)
        nsteps, seg, nseg = _ac._ckpt_layout(nt, n_checkpoints)
        v = v_next = self._zeros()
        grad = self._zeros()
        since = 0
        for k in range(nseg - 1, -1, -1):
            base = k * seg
            n = min(seg, nsteps - base)
            # a stored start may have been taken between two exchanges
            u, u_prev = self.slab.exchange(*starts[k])
            useg = [u_prev, u]
            self._advance((u, u_prev), n, base + 1, keep=useg)
            for j in range(n - 1, -1, -1):
                t = base + j + 1
                grad = grad + (useg[j + 2] - 2.0 * useg[j + 1]
                               + useg[j]) * v
                vprev = inject_rec(self.step(v, v_next), res[t])
                v, v_next = vprev, v
                since += 1
                if since % self.slab.steps == 0:
                    v, v_next = self.slab.exchange(v, v_next)
        return grad * (-(1.0 / self.s2))


def _domain_operator(geometry, mesh, shot):
    """(slab operator of shot ``shot`` on this rank of ``mesh``, padded
    shape)."""
    model = geometry.model
    vp, damp, shape = _padded_fields(model, mesh.shape)
    slab = _Slab(mesh.group, mesh.shape, mesh.coords, shape,
                 model.space_order, model.fs, mesh.device)
    s_idx, s_w, r_idx, r_w, src_wav = _fwi._batched_tables(geometry)
    op = _SlabOperator(slab, vp, damp, _fwi._solver_dt(geometry),
                       model.spacing, model.space_order, s_idx[shot],
                       s_w[shot], r_idx, r_w, src_wav)
    return op, shape


def _default_domain_mesh(axis_sizes):
    return domain_mesh(axis_sizes or (_world()[1], 1))


def forward_domain_sharded(geometry, mesh=None, axis_sizes=None, shot=0):
    """Single-shot acoustic OT2 forward with the padded grid split over the
    ranks of ``mesh`` (default ``domain_mesh(axis_sizes or (world, 1))``):
    the receiver gather (nt, nrec) as numpy on every rank of the mesh, None
    on the others."""
    mesh = mesh or _default_domain_mesh(axis_sizes)
    if mesh.rank is None:
        return None
    op, _ = _domain_operator(geometry, mesh, shot)
    return op.forward(geometry.nt).cpu().numpy()


def gradient_domain_sharded(geometry, residual, mesh=None, axis_sizes=None,
                            shot=0, n_checkpoints=None):
    """Single-shot checkpointed FWI gradient (``acoustic.forward_ckpt`` +
    ``gradient_from_ckpt`` with the residual (nt, nrec) as adjoint source)
    with the grid split over the ranks of ``mesh``: the gradient on the
    model's padded grid as numpy on every rank of the mesh, None on the
    others."""
    mesh = mesh or _default_domain_mesh(axis_sizes)
    if mesh.rank is None:
        return None
    nck = n_checkpoints or _fwi._default_checkpoints(geometry.nt)
    op, _ = _domain_operator(geometry, mesh, shot)
    _, starts, _ = op.forward_ckpt(geometry.nt, nck)
    g = op.gradient_from_ckpt(starts, residual, geometry.nt, nck)
    full = op.slab.gather(g)
    return full[tuple(slice(0, n) for n in
                      geometry.model.padded_shape)].cpu().numpy()


def fwi_obj_sharded2d(geometry, obs, misfit_func, direct_wave=None,
                      mask=None, precond=True, calc_grad=False, mesh=None,
                      axis_sizes=None):
    """Shots x domain objective on a ``hier_mesh`` (S, D) (default
    ``axis_sizes`` or (world/2, 2), (1, 1) on one rank): shot group s takes
    block s of the shots, one at a time, each on its row of D ranks with
    the grid's leading axis split D ways (``forward_ckpt``,
    the misfit, ``gradient_from_ckpt`` on the slabs); each rank crops and
    fixes its slab's part of each shot's gradient and illumination on the
    whole grid's zeros, and one all_reduce over all ranks sums the shot
    groups (and joins the slabs, one term a cell). Returns (fval, grad on
    the model's shape as float64 numpy; zeros without ``calc_grad``). Needs
    a misfit the device computes."""
    if _fwi._host_misfit(misfit_func, None, geometry):
        raise ValueError("fwi_obj_sharded2d needs a device misfit; use "
                         "fwi_obj_sharded for host-side misfits")
    from .sharding import _one_shot, _reduce
    if mesh is None:
        world = _world()[1]
        mesh = hier_mesh(axis_sizes or ((max(1, world // 2), 2)
                                        if world >= 2 else (1, 1)))
    misfit = _one_shot(misfit_func)
    S, D = mesh.shape
    s, d = mesh.coords
    model = geometry.model
    dev = mesh.device
    vp, damp, shape = _padded_fields(model, (D,))
    slab = _Slab(mesh.axis_groups.get("dx"), (D,), (d,), shape,
                 model.space_order, model.fs, dev)
    s_idx, s_w, r_idx, r_w, src_wav = _fwi._batched_tables(geometry)
    dt = _fwi._solver_dt(geometry)
    nt = geometry.nt
    nck = _fwi._default_checkpoints(nt)
    sel = block(geometry.nsrc, S, s)
    obs_t = _fwi._device_stack(obs, dev)
    dw_t = None if direct_wave is None else \
        _fwi._device_stack(direct_wave, dev)
    pads, phys = _fwi._pads(model), model.shape
    fval, grad, illum = 0.0, None, None
    if calc_grad and len(sel):
        factors = _fwi._illum_factors(
            geometry, np.asarray(geometry.src_positions)[sel], dev)
    for j, i in enumerate(sel):
        op = _SlabOperator(slab, vp, damp, dt, model.spacing,
                           model.space_order, s_idx[i], s_w[i], r_idx, r_w,
                           src_wav)
        if calc_grad:
            rec, starts, il = op.forward_ckpt(nt, nck)
        else:
            rec = op.forward(nt)
        dw = 0.0 if dw_t is None else dw_t[i]
        f, res = misfit(rec - dw, obs_t[i] - dw)
        if d == 0:
            fval = fval + f.double()
        if not calc_grad:
            continue
        g = op.gradient_from_ckpt(starts, res, nt, nck)
        del starts
        keep, rec_prod = factors(j, j + 1)
        fix = keep[0] * rec_prod
        parts = []
        for field in (g, il):
            full = torch.zeros(shape, dtype=field.dtype, device=dev)
            full[slab.owned] = field[slab.inner]
            parts.append(_fwi._crop(full, pads, phys).double() * fix)
        grad = parts[0] if grad is None else grad + parts[0]
        illum = parts[1] if illum is None else illum + parts[1]
    fields = (grad, illum) if calc_grad else ()
    fval, sums = _reduce(mesh, fval, fields, phys)
    if not calc_grad:
        return fval, np.zeros(phys)
    return fval, _fwi._precondition(sums[0], sums[1], precond,
                                    mask).cpu().numpy()
