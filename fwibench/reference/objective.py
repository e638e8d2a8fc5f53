"""The FWI objective of the reference, whole: the observed and direct-wave
data modeled from the configuration's true and water models, the
workload's misfit of the direct-wave-free traces, the adjoint-state
gradient, the source/receiver illumination fix, the illumination
precondition and the bathymetry mask, in the squared-slowness
parameterisation of the devito-fwi drivers (``fwi.py:131-246``,
``marmousi_fwi.py``, ``marmousi2_fwi.py``).

``build(config, work, src, rec, data_dir, device)`` returns the objective
of the configuration's family under the workload's misfit:
``objective(x, calc_grad) -> (f, g or None)`` with x the flat float64
squared slowness of the physical grid and g float64 of the same shape.
``hist_dtype`` and ``trace_dtype`` lower the precision the objective keeps
its forward history and its traces in (the control of the comparison).

Both halves are found by file in the benchmark's folder ``here``, so that
a cell of another family or misfit is added as files alone:

* a family is ``reference/families/<config["family"]>.py`` with a class
  ``Objective(config, src, rec, data_dir, dev, dtype, misfit=...,
  hist_dtype=..., trace_dtype=...)``, as a rule a subclass of ``_Base``;
* a misfit is ``reference/misfits/<name>.py`` with a function
  ``misfit(syn, obs, dw) -> (value as a float in float64, residual)``,
  the residual being the value's cotangent of the traces; ``name`` is the
  workload's ``"misfit"`` index in the drivers' ``--misfit`` numbering
  (``MISFITS``).

``find`` loads both, and raises ``Missing`` naming the file it looked for
where one is not there.
"""
from __future__ import annotations

import importlib
import importlib.util
import os

import numpy as np
import torch

from . import grid as G

__all__ = ["MISFITS", "Missing", "find", "build", "load_models",
           "elastic_fields"]

# the benchmark's folder
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the drivers' --misfit numbering (the port's ``misfits(cfg)``)
MISFITS = ("l2", "w2_1d", "w2_2d")


class Missing(FileNotFoundError):
    """A cell names a family or a misfit that the reference has no module
    for."""


def _by_file(kind, name, here, what):
    """The module ``reference/<kind>/<name>.py`` of the folder ``here``,
    loaded from its file into this package (its relative imports reach the
    reference's modules)."""
    path = os.path.join(here, "reference", kind, name + ".py")
    if not os.path.isfile(path):
        raise Missing(f"the plain reference has no module for the {what}: "
                      f"{path}")
    importlib.import_module(f"{__package__}.{kind}")
    spec = importlib.util.spec_from_file_location(
        f"{__package__}.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find(config, work, here=None):
    """(the family's ``Objective`` class, the workload's misfit function)
    from their files under ``here`` (default: this benchmark's folder)."""
    here = here or HERE
    family = _by_file("families", config["family"], here,
                      f"family {config['family']!r}")
    index = work["misfit"]
    if index not in range(len(MISFITS)):
        raise Missing(f"misfit {index} is none of the drivers' --misfit "
                      f"numbering {dict(enumerate(MISFITS))}")
    misfit = _by_file("misfits", MISFITS[index], here, f"misfit {index}")
    return family.Objective, misfit.misfit


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
    def __init__(self, config, src, rec, data_dir, dev, dtype, misfit,
                 hist_dtype=None, trace_dtype=None):
        self.cfg = config
        self.dev = dev
        self.dtype = dtype
        self.np_dtype = np.float32 if dtype == torch.float32 else np.float64
        self.grid = G.Grid(config["shape"], config["spacing"],
                           config["nbl"])
        self.hist_dtype = hist_dtype
        self.trace_dtype = trace_dtype
        self._misfit = misfit
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
        """The workload's misfit of the traces, rounded first to
        ``trace_dtype``: (value in float64, residual)."""
        return self._misfit(self._rounded(syn), self.obs, self.dw)

    def _finish(self, grad, illum):
        """Per-shot fields (B, nx, nz) on the physical grid -> the fixed,
        summed, preconditioned and masked gradient, flat float64."""
        g = torch.sum(grad.double() * self.fix, dim=0)
        il = torch.sum(illum.double() * self.fix, dim=0)
        g = g / torch.sqrt(il + 1e-30) * self.mask
        return g.cpu().numpy().reshape(-1)


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


def build(config, work, src, rec, data_dir, device, dtype=torch.float32,
          hist_dtype=None, trace_dtype=None, here=None):
    """The objective of ``config["family"]`` under ``work["misfit"]`` for
    the acquisition (src, rec) on ``device``, computed in ``dtype``; the
    modules are found under ``here`` (``find``)."""
    objective, misfit = find(config, work, here)
    return objective(config, src, rec, data_dir, torch.device(device),
                     dtype, misfit=misfit, hist_dtype=hist_dtype,
                     trace_dtype=trace_dtype)
