"""Elastic and viscoelastic solver wrappers (API parity with the reference
``seismic/elastic/wavesolver.py`` and ``seismic/viscoelastic/wavesolver.py``:
forward-only solvers returning (rec1, rec2, v, tau, summary)).

Port of ``devito_fwi_tpu.ops.elastic_wavesolver``. ``ElasticWaveSolver``
on "cuda" (the default) runs the modeling kernel of ``ops.cuda_staggered``
and raises ``ValueError`` for a geometry the kernel does not take; on "cpu"
it runs the eager ``staggered.elastic_forward`` (1-3 dims, any float type).
``ViscoelasticWaveSolver`` runs the eager ``staggered.viscoelastic_forward``
on its device, as the JAX solver runs its XLA scan: no kernel.
"""
from __future__ import annotations

import time as _time

import numpy as np
import torch

from . import cuda_staggered as _cs
from . import staggered as _st
from .interp import interp_table
from .wavesolver import PerfSummary

__all__ = ["ElasticWaveSolver", "ViscoelasticWaveSolver", "PerfSummary"]


class _StaggeredSolverBase:
    """What the staggered solvers share: the mask boundary, the device,
    the tables, the fields as tensors and the receiver bookkeeping."""

    def __init__(self, model, geometry, space_order=4, device="cuda",
                 **kwargs):
        from ..fwi import _resolve_device
        self.model = model
        # staggered solvers use the mask boundary
        # (reference elastic/wavesolver.py:25)
        self.model._initialize_bcs(bcs="mask")
        self.geometry = geometry
        self.space_order = space_order
        self.device = _resolve_device(device)
        self._kwargs = kwargs

    @property
    def dt(self):
        return self.model.critical_dt

    @property
    def nt(self):
        return self.geometry.nt

    def _tables(self, coords):
        return interp_table(coords, self.model.origin_pml, self.model.spacing,
                            dtype=self.model.dtype)

    def _field(self, name, default=None, override=None):
        """Model field (or caller override) as a full-grid tensor of the
        model's type on the solver's device; scalars expand."""
        val = override if override is not None else \
            getattr(self.model, name, default)
        if val is None:
            val = default
        val = np.asarray(val, dtype=self.model.dtype)
        if val.ndim == 0:
            val = np.full(self.model.padded_shape, val,
                          dtype=self.model.dtype)
        return torch.as_tensor(val, device=self.device)

    def _recs(self, src, rec1, rec2):
        src = src or self.geometry.src
        rec1 = rec1 or self.geometry.new_rec(name="rec1")
        rec2 = rec2 or self.geometry.new_rec(name="rec2")
        if not np.array_equal(np.asarray(rec1.coordinates),
                              np.asarray(rec2.coordinates)):
            raise ValueError(
                "rec1/rec2 must share coordinates: the staggered sweeps "
                "sample tau_zz and div(v) at one receiver table")
        return src, rec1, rec2

    def _wavelet(self, src):
        return torch.as_tensor(np.asarray(src.data, dtype=self.model.dtype),
                               device=self.device)

    def _finish(self, tic, r1, r2, rec1, rec2, cells):
        """Fill the receivers; the summary's clock stops after the
        device's work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        toc = _time.perf_counter()
        rec1.data[:] = r1.cpu().numpy()
        rec2.data[:] = r2.cpu().numpy()
        return rec1, rec2, None, None, PerfSummary(toc - tic,
                                                   self.nt * cells)


class ElasticWaveSolver(_StaggeredSolverBase):
    """Velocity-stress elastic solver (reference
    ``seismic/elastic/wavesolver.py:7-93``). ``device``: "cuda" (the
    kernel; raises without a card) or "cpu" (the eager torch forward)."""

    def forward(self, src=None, rec1=None, rec2=None, lam=None, mu=None,
                b=None, v=None, tau=None, save=None, **kwargs):
        src, rec1, rec2 = self._recs(src, rec1, rec2)
        lam = self._field("lam", override=lam)
        mu = self._field("mu", override=mu)
        b = self._field("b", 1.0, override=b)
        damp = self._field("damp", 1.0)
        dt = kwargs.pop("dt", self.dt)
        s_idx, s_w = self._tables(src.coordinates)
        r_idx, r_w = self._tables(rec1.coordinates)
        wav = self._wavelet(src)
        kw = dict(nt=self.nt, spacing=self.model.spacing,
                  space_order=self.space_order)
        tic = _time.perf_counter()
        if self.device.type == "cuda":
            why = _cs.unsupported_reason(self.model, s_idx, r_idx, src.data)
            if why is not None:
                raise ValueError(f"ElasticWaveSolver on cuda: {why} (run "
                                 "other geometries with device='cpu')")
            r1, r2 = _cs.elastic_forward_segments(lam, mu, b, damp, wav,
                                                  s_idx, s_w, r_idx, r_w, dt,
                                                  **kw)
        else:
            r1, r2 = _st.elastic_forward(lam, mu, b, damp, wav, s_idx, s_w,
                                         r_idx, r_w, dt, **kw)
        return self._finish(tic, r1, r2, rec1, rec2, lam.numel())


class ViscoelasticWaveSolver(_StaggeredSolverBase):
    """SLS viscoelastic solver (reference
    ``seismic/viscoelastic/wavesolver.py:8-112``): the eager
    ``staggered.viscoelastic_forward`` on ``device`` ("cuda", raising
    without a card, or "cpu")."""

    def __init__(self, model, geometry, space_order=4, device="cuda",
                 **kwargs):
        super().__init__(model, geometry, space_order, device, **kwargs)
        # viscoelastic needs a smaller dt than the elastic CFL
        # (reference viscoelastic/wavesolver.py:33-35)
        self.model.dt_scale = .9

    def forward(self, src=None, rec1=None, rec2=None, lam=None, qp=None,
                mu=None, qs=None, b=None, v=None, tau=None, r=None,
                save=None, **kwargs):
        src, rec1, rec2 = self._recs(src, rec1, rec2)
        lam = self._field("lam", override=lam)
        mu = self._field("mu", override=mu)
        b = self._field("b", 1.0, override=b)
        qp = self._field("qp", override=qp)
        qs = self._field("qs", override=qs)
        damp = self._field("damp", 1.0)
        dt = kwargs.pop("dt", self.dt)
        s_idx, s_w = self._tables(src.coordinates)
        r_idx, r_w = self._tables(rec1.coordinates)
        tic = _time.perf_counter()
        r1, r2 = _st.viscoelastic_forward(
            lam, mu, b, qp, qs, damp, self.geometry.f0, self._wavelet(src),
            s_idx, s_w, r_idx, r_w, dt, nt=self.nt,
            spacing=self.model.spacing, space_order=self.space_order)
        return self._finish(tic, r1, r2, rec1, rec2, lam.numel())
