"""The FWI objective of the reference, whole: the observed and direct-wave
data modeled from the configuration's true and water models, the L2 misfit
of the direct-wave-free traces, the adjoint-state gradient, the
source/receiver illumination fix, the illumination precondition and the
bathymetry mask, in the squared-slowness parameterisation of the devito-fwi
drivers (``fwi.py:131-246``, ``marmousi_fwi.py``, ``marmousi2_fwi.py``).

``build(config, geometry, device)`` returns the family's objective:
``objective(x, calc_grad) -> (f, g or None)`` with x the flat float64
squared slowness of the physical grid and g float64 of the same shape.
``hist_dtype`` and ``trace_dtype`` lower the precision the objective keeps
its forward history and its traces in (the control of the comparison).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import grid as G
from .acoustic import Acoustic
from .elastic import Elastic, lame

__all__ = ["build", "load_models", "elastic_fields"]


def load_models(config, data_dir):
    """(true vp, starting vp) in km/s from the raw float32 files."""
    shape = tuple(config["shape"])
    base = os.path.join(data_dir, config["model_dir"])

    def read(name):
        return np.fromfile(os.path.join(base, name),
                           dtype=np.float32).reshape(shape) / 1000

    return read(config["true_model"]), read(config["start_model"])


def elastic_fields(vp, water_rows):
    """(vs, rho) of the elastic Marmousi runs: vs = vp / sqrt(3), zero in
    the water rows; rho = 0.31 (1000 vp)^0.25 (Gardner), 1 in the water."""
    vs = (vp / np.sqrt(3.0)).astype(np.float32)
    vs[:, :water_rows] = 0.0
    rho = (0.31 * (1e3 * vp) ** 0.25).astype(np.float32)
    rho[:, :water_rows] = 1.0
    return vs, rho


class _Base:
    def __init__(self, config, src, rec, data_dir, dev, dtype,
                 hist_dtype=None, trace_dtype=None):
        self.cfg = config
        self.dev = dev
        self.dtype = dtype
        self.np_dtype = np.float32 if dtype == torch.float32 else np.float64
        self.grid = G.Grid(config["shape"], config["spacing"],
                           config["nbl"])
        self.hist_dtype = hist_dtype
        self.trace_dtype = trace_dtype
        self.true_vp, self.start_vp = load_models(config, data_dir)
        self.src_idx, self.src_w = self.grid.table(src)
        self.rec_idx, self.rec_w = self.grid.table(rec)
        self.shots = np.arange(len(src))
        keep, prod = G.illum_fix_factors(src, rec, self.grid.spacing,
                                         self.grid.shape)
        self.fix = torch.as_tensor(keep * prod[None], device=dev)
        mask = np.ones(self.grid.shape)
        mask[:, :config["water_rows"]] = 0.0
        self.mask = torch.as_tensor(mask, device=dev)

    def _pad(self, field):
        return torch.as_tensor(G.pad_edge(np.asarray(field, self.np_dtype),
                                          self.grid.nbl), device=self.dev)

    def _profile(self, kind):
        return torch.as_tensor(G.damping_profile(
            self.grid.padded, self.grid.nbl, self.grid.spacing, kind),
            dtype=self.dtype, device=self.dev)

    def _rounded(self, traces):
        if self.trace_dtype is None:
            return traces
        return traces.to(self.trace_dtype).to(traces.dtype)

    def misfit(self, syn):
        """L2 of the direct-wave-free traces: (0.5 sum r^2 in float64, r)."""
        syn = self._rounded(syn)
        res = (syn - self.dw) - (self.obs - self.dw)
        return float(0.5 * torch.sum(res.double() ** 2)), res

    def _finish(self, grad, illum):
        """Per-shot fields (B, nx, nz) on the physical grid -> the fixed,
        summed, preconditioned and masked gradient, flat float64."""
        g = torch.sum(grad.double() * self.fix, dim=0)
        il = torch.sum(illum.double() * self.fix, dim=0)
        g = g / torch.sqrt(il + 1e-30) * self.mask
        return g.cpu().numpy().reshape(-1)


class AcousticObjective(_Base):
    """The acoustic OT2 objective, every shot in one batch."""

    def __init__(self, config, src, rec, data_dir, dev, dtype, **kw):
        super().__init__(config, src, rec, data_dir, dev, dtype, **kw)
        c = config
        self.eta = self._profile("damp")
        self.dt = float(c["dt"])
        self.wav = G.ricker(G.num_steps(c["tn"], self.dt), self.dt, c["f0"])
        self.obs = self.op(self.true_vp).forward(self.shots)[0]
        self.dw = self.op(np.full(self.grid.shape, c["water_vp"])).forward(
            self.shots)[0]

    def op(self, vp):
        return Acoustic(self._pad(vp), self.eta, self.dt, self.grid.spacing,
                        self.cfg["space_order"], self.wav, self.src_idx,
                        self.src_w, self.rec_idx, self.rec_w,
                        hist_dtype=self.hist_dtype)

    def __call__(self, x, calc_grad):
        op = self.op(1.0 / np.sqrt(x.reshape(self.grid.shape)))
        if not calc_grad:
            return self.misfit(op.forward(self.shots)[0])[0], None
        syn, illum, hist = op.forward(self.shots, history=True)
        f, res = self.misfit(syn)
        grad = op.gradient(hist, res)
        del hist
        return f, self._finish(self.grid.crop(grad), self.grid.crop(illum))


class ElasticObjective(_Base):
    """The elastic objective in vp with vs and rho pinned at the starting
    model's fields, every shot in one batch."""

    def __init__(self, config, src, rec, data_dir, dev, dtype, **kw):
        super().__init__(config, src, rec, data_dir, dev, dtype, **kw)
        c = config
        rows = c["water_rows"]
        self.eta = self._profile("mask")
        vs_t, rho_t = elastic_fields(self.true_vp, rows)
        self.vs0, self.rho0 = (self._pad(a) for a in
                               elastic_fields(self.start_vp, rows))
        # the time step: the true model's CFL step (float32 Lame fields, as
        # the model holds them), scaled so that the inversion's upper vp
        # bound stays stable
        b_t = (1.0 / rho_t).astype(np.float32)
        nb = c["nbl"]
        self.dt = G.elastic_critical_dt(
            G.pad_edge((self.true_vp ** 2 - 2.0 * vs_t ** 2) / b_t, nb),
            G.pad_edge(vs_t ** 2 / b_t, nb), G.pad_edge(b_t, nb),
            c["space_order"], self.grid.spacing)
        self.dt *= min(1.0, float(self.true_vp.max()) / c["vp_bounds"][1])
        self.wav = G.ricker(G.num_steps(c["tn"], self.dt), self.dt, c["f0"])
        self.op = Elastic(self.eta, self.dt, self.grid.spacing,
                          c["space_order"], self.wav, self.src_idx,
                          self.src_w, self.rec_idx, self.rec_w,
                          state_dtype=self.hist_dtype)
        self.obs = self.op.forward(self.op.params(*lame(
            self._pad(self.true_vp), self._pad(vs_t), self._pad(rho_t))),
            self.shots)
        w = np.full(self.grid.shape, c["water_vp"], np.float32)
        self.dw = self.op.forward(self.op.params(*lame(
            self._pad(w), self._pad(np.zeros_like(w)),
            self._pad(np.ones_like(w)))), self.shots)

    def __call__(self, x, calc_grad):
        vp64 = 1.0 / np.sqrt(x.reshape(self.grid.shape))
        vpp = self._pad(vp64)
        lam, mu, b = lame(vpp, self.vs0, self.rho0)
        if not calc_grad:
            return self.misfit(self.op.forward(self.op.params(lam, mu, b),
                                               self.shots))[0], None
        _, f, g_lam, illum = self.op.gradient(lam, mu, b, self.shots,
                                              self.misfit)
        g_vp = _fold(2.0 * self.rho0 * vpp * g_lam, self.grid.nbl)
        g = self._finish(g_vp, self.grid.crop(illum))
        return f, g * (-0.5 * vp64.reshape(-1) ** 3)


def _fold(g, nbl):
    """Transpose of the edge pad: each layer's sum lands on the edge cell
    it copies, (B, nx+2nbl, nz+2nbl) -> (B, nx, nz)."""
    for axis in (1, 2):
        n = g.shape[axis] - 2 * nbl
        core = g.narrow(axis, nbl, n).clone()
        core.narrow(axis, 0, 1).add_(
            g.narrow(axis, 0, nbl).sum(dim=axis, keepdim=True))
        core.narrow(axis, n - 1, 1).add_(
            g.narrow(axis, nbl + n, nbl).sum(dim=axis, keepdim=True))
        g = core
    return g


FAMILIES = {"acoustic": AcousticObjective, "elastic": ElasticObjective}


def build(config, src, rec, data_dir, device, dtype=torch.float32,
          hist_dtype=None, trace_dtype=None):
    """The objective of ``config["family"]`` for the acquisition (src,
    rec) on ``device``, computed in ``dtype``."""
    return FAMILIES[config["family"]](config, src, rec, data_dir,
                                      torch.device(device), dtype,
                                      hist_dtype=hist_dtype,
                                      trace_dtype=trace_dtype)
