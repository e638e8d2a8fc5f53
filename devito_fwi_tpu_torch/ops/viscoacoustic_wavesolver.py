"""Viscoacoustic solver wrapper (API parity with the reference
``seismic/viscoacoustic/wavesolver.py:7-206``): forward and adjoint over the
six kernel variants {sls, ren, deng_mcmechan} x {1st, 2nd order}.

Port of ``ViscoacousticWaveSolver`` of
``devito_fwi_tpu.ops.viscoacoustic_wavesolver``. On "cuda" (the default)
the sls/2 forward without ``save`` runs the modeling kernel of
``ops.cuda_visco`` (as the JAX solver routes it to its Pallas kernel) and
raises on a geometry the kernel does not take
(``cuda_staggered.unsupported_reason``); the other kernels, ``save`` and
``adjoint`` run the eager torch of ``ops.viscoacoustic`` on the solver's
device. On "cpu" everything runs the eager torch (1-3 dims, any float
type).
"""
from __future__ import annotations

import time as _time

import numpy as np
import torch

from . import cuda_staggered as _cs
from . import cuda_visco as _cv
from . import viscoacoustic as _va
from .interp import interp_table
from .wavesolver import PerfSummary

__all__ = ["ViscoacousticWaveSolver"]


class ViscoacousticWaveSolver:
    """``device``: "cuda" (the sls/2 modeling kernel for ``forward``; raises
    without a card) or "cpu" (the eager torch)."""

    def __init__(self, model, geometry, space_order=4, kernel="sls",
                 time_order=2, device="cuda", **kwargs):
        from ..fwi import _resolve_device
        if (kernel, time_order) not in _va.KERNELS:
            raise ValueError(f"kernel {(kernel, time_order)}: expected one "
                             f"of {sorted(_va.KERNELS)}")
        self.model = model
        self.model._initialize_bcs(bcs="mask")
        self.geometry = geometry
        self.space_order = space_order
        self.kernel = kernel
        self.time_order = time_order
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

    def _field(self, name, override=None, default=None):
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

    def _params(self, vp=None, qp=None, b=None):
        return (self._field("vp", vp), self._field("b", b, 1.0),
                self._field("qp", qp), self._field("damp", None, 1.0))

    def _static(self):
        return dict(kernel=self.kernel, time_order=self.time_order,
                    nt=self.nt, spacing=self.model.spacing,
                    space_order=self.space_order)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def forward(self, src=None, rec=None, v=None, r=None, p=None, qp=None,
                b=None, vp=None, save=None, **kwargs):
        """Returns (rec, p wavefield (the history if ``save``, else the
        final p), v, summary) like the reference."""
        src = src or self.geometry.src
        rec = rec or self.geometry.rec
        vp_, b_, qp_, damp = self._params(vp, qp, b)
        dt = kwargs.pop("dt", self.dt)
        s_idx, s_w = self._tables(src.coordinates)
        r_idx, r_w = self._tables(rec.coordinates)
        wav = torch.as_tensor(np.asarray(src.data, dtype=self.model.dtype),
                              device=self.device)
        tic = _time.perf_counter()
        if not save and self.device.type == "cuda" and \
                (self.kernel, self.time_order) == ("sls", 2):
            why = _cs.unsupported_reason(self.model, s_idx, r_idx, src.data)
            if why is not None:
                raise ValueError(
                    f"ViscoacousticWaveSolver sls/2 forward on cuda: {why} "
                    "(run other geometries with device='cpu')")
            rec_data, p_out = _cv.visco_sls2_forward_segments(
                vp_, b_, qp_, damp, wav, s_idx, s_w, r_idx, r_w, dt,
                self.geometry.f0, nt=self.nt, spacing=self.model.spacing,
                space_order=self.space_order)
        else:
            rec_data, p_out = _va.forward(
                vp_, b_, qp_, damp, wav, s_idx, s_w, r_idx, r_w, dt,
                self.geometry.f0, save=bool(save), **self._static())
        self._sync()
        toc = _time.perf_counter()
        rec.data[:] = rec_data.cpu().numpy()
        summary = PerfSummary(toc - tic, self.nt * np.prod(vp_.shape))
        return rec, p_out.cpu().numpy(), None, summary

    def adjoint(self, rec, srca=None, va=None, pa=None, vp=None, qp=None,
                b=None, r=None, **kwargs):
        """Returns (srca, pa wavefield (the final adjoint p), va,
        summary)."""
        srca = srca or self.geometry.new_src(name="srca", src_type=None)
        vp_, b_, qp_, damp = self._params(vp, qp, b)
        dt = kwargs.pop("dt", self.dt)
        s_idx, s_w = self._tables(srca.coordinates)
        r_idx, r_w = self._tables(rec.coordinates)
        rec_data = torch.as_tensor(np.asarray(rec.data,
                                              dtype=self.model.dtype),
                                   device=self.device)
        tic = _time.perf_counter()
        srca_data, p_out = _va.adjoint(vp_, b_, qp_, damp, rec_data, r_idx,
                                       r_w, s_idx, s_w, dt,
                                       self.geometry.f0, **self._static())
        self._sync()
        toc = _time.perf_counter()
        srca.data[:] = srca_data.cpu().numpy()
        summary = PerfSummary(toc - tic, self.nt * np.prod(vp_.shape))
        return srca, p_out.cpu().numpy(), None, summary
