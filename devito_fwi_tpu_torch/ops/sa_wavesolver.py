"""SaIsoAcousticWaveSolver: API-parity wrapper for the self-adjoint system.

Port of ``devito_fwi_tpu.ops.sa_wavesolver`` (reference
``seismic/self_adjoint/wavesolver.py:7-266``): ``forward`` / ``adjoint`` /
``jacobian`` / ``jacobian_adjoint`` with the same call conventions and the
aliases ``born`` and ``gradient``, plus the ``acoustic_sa_setup`` example
set-up (``seismic/self_adjoint/example_iso.py:11-34``). The operators are
the eager ones of ``ops.self_adjoint`` on the solver's device: "cuda" (the
default; raises without a card) or "cpu". No kernel is involved.
"""
from __future__ import annotations

import time as _time

import numpy as np
import torch

from . import self_adjoint as _sa
from .interp import interp_table
from .wavesolver import PerfSummary, Wavefield

__all__ = ["SaIsoAcousticWaveSolver", "acoustic_sa_setup"]


class SaIsoAcousticWaveSolver:
    """Solver for the scalar isotropic variable-density visco-acoustic
    self-adjoint wave equation. The model must carry ``vp``, ``b`` and a
    w/Q ``damp`` field (build it with ``self_adjoint.setup_w_over_q``).
    ``device``: "cuda" or "cpu"."""

    def __init__(self, model, geometry, space_order=8, device="cuda",
                 **kwargs):
        from ..fwi import _resolve_device
        self.model = model
        self.geometry = geometry
        self.space_order = space_order
        self.device = _resolve_device(device)
        # Time step is 0.6x smaller due to Q (reference wavesolver.py:48-49)
        self.model.dt_scale = .6
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

    def _static(self):
        return dict(nt=self.nt, spacing=self.model.spacing,
                    space_order=self.space_order)

    def _tensor(self, a):
        """An array or a tensor in the model's type on the solver's
        device."""
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device,
                        dtype=getattr(torch, np.dtype(self.model.dtype).name))
        return torch.as_tensor(np.asarray(a, dtype=self.model.dtype),
                               device=self.device)

    def _params(self, vp=None, b=None, damp=None):
        def full(x, default):
            x = self._tensor(default if x is None else x)
            if x.dim() == 0:
                x = x.expand(self.model.padded_shape).contiguous()
            return x
        return (full(vp, self.model.vp),
                full(b, getattr(self.model, "b", 1.0)),
                full(damp, self.model.damp))

    def _run(self, fn, sweeps, vp):
        """(fn's result, PerfSummary) with the device synchronised before
        the clock stops."""
        tic = _time.perf_counter()
        out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out, PerfSummary(_time.perf_counter() - tic,
                                sweeps * self.nt * vp.numel())

    # --------------------------------------------------------------- forward
    def forward(self, src=None, rec=None, b=None, vp=None, damp=None, u=None,
                save=None, **kwargs):
        src = src or self.geometry.src
        rec = rec or self.geometry.rec
        vp, b, damp = self._params(vp, b, damp)
        dt = kwargs.pop("dt", self.dt)
        s_idx, s_w = self._tables(src.coordinates)
        r_idx, r_w = self._tables(rec.coordinates)
        (rec_data, u_out), summary = self._run(lambda: _sa.forward(
            vp, b, damp, self._tensor(src.data), s_idx, s_w, r_idx, r_w, dt,
            save=bool(save), **self._static()), 1, vp)
        rec.data[:] = rec_data.cpu().numpy()
        return rec, Wavefield(u_out), summary

    # --------------------------------------------------------------- adjoint
    def adjoint(self, rec, src=None, b=None, v=None, damp=None, vp=None,
                save=None, **kwargs):
        srca = src or self.geometry.new_src(name="srca", src_type=None)
        vp, b, damp = self._params(vp, b, damp)
        dt = kwargs.pop("dt", self.dt)
        s_idx, s_w = self._tables(srca.coordinates)
        r_idx, r_w = self._tables(rec.coordinates)
        (srca_data, v_out), summary = self._run(lambda: _sa.adjoint(
            vp, b, damp, self._tensor(rec.data), r_idx, r_w, s_idx, s_w, dt,
            **self._static()), 1, vp)
        srca.data[:] = srca_data.cpu().numpy()
        return srca, Wavefield(v_out), summary

    # ------------------------------------------------------------------ born
    def jacobian(self, dm, src=None, rec=None, b=None, vp=None, damp=None,
                 u0=None, du=None, save=None, **kwargs):
        src = src or self.geometry.src
        rec = rec or self.geometry.rec
        vp, b, damp = self._params(vp, b, damp)
        dt = kwargs.pop("dt", self.dt)
        s_idx, s_w = self._tables(src.coordinates)
        r_idx, r_w = self._tables(rec.coordinates)
        dmv = np.asarray(dm, dtype=self.model.dtype)
        if dmv.shape == self.model.shape:
            from ..utils.fd import pad_edge
            dmv = pad_edge(dmv, self.model.padsizes)
        (rec_data, u0_out), summary = self._run(lambda: _sa.born(
            vp, b, damp, self._tensor(dmv), self._tensor(src.data), s_idx,
            s_w, r_idx, r_w, dt, save=bool(save), **self._static()), 2, vp)
        rec.data[:] = rec_data.cpu().numpy()
        return rec, Wavefield(u0_out), None, summary

    # ----------------------------------------------------- jacobian adjoint
    def jacobian_adjoint(self, rec, u0, b=None, vp=None, damp=None,
                         dm=None, du=None, **kwargs):
        """The padded-grid velocity gradient (numpy) of the receiver
        residual ``rec`` about the saved background ``u0`` (a
        ``Wavefield`` or an array, from ``forward(save=True)``); a ``dm``
        given is added into."""
        vp, b, damp = self._params(vp, b, damp)
        dt = kwargs.pop("dt", self.dt)
        r_idx, r_w = self._tables(rec.coordinates)
        u0_save = self._tensor(u0.data if isinstance(u0, Wavefield) else u0)
        (dm_out, _), summary = self._run(lambda: _sa.jacobian_adjoint(
            vp, b, damp, u0_save, self._tensor(rec.data), r_idx, r_w, dt,
            **self._static()), 2, vp)
        dm_out = dm_out.cpu().numpy()
        if dm is not None:
            dm += dm_out
            result = dm
        else:
            result = dm_out
        return result, u0, None, summary

    # aliases matching the acoustic solver naming
    born = jacobian
    gradient = jacobian_adjoint


def acoustic_sa_setup(shape=(50, 50, 50), spacing=(10.0, 10.0, 10.0),
                      tn=500., space_order=8, nbl=10, dtype=np.float32,
                      fpeak=0.010, qmin=0.1, qmax=1000.0, vp=1.5, b=1.0,
                      device="cuda", **kwargs):
    """Standard self-adjoint test/demo setup (reference
    ``example_iso.py:11-34``): constant vp/b wholespace, w/Q boundary from
    the Ricker peak frequency, source at the centre, receivers near the
    surface; the solver on ``device``."""
    from ..models.geometry import setup_geometry
    from ..models.model import SeismicModel

    omega = 2.0 * np.pi * fpeak
    shape = tuple(shape)
    spacing = tuple(spacing[:len(shape)])
    origin = tuple(0.0 for _ in shape)
    vp_arr = np.full(shape, vp, dtype=dtype)
    b_arr = np.full(shape, b, dtype=dtype)

    def init_damp(model):
        return _sa.setup_w_over_q(model.padded_shape, omega, qmin, qmax,
                                  model.nbl, dtype=dtype)
    model = SeismicModel(origin=origin, shape=shape, vp=vp_arr, b=b_arr,
                         spacing=spacing, nbl=nbl, space_order=space_order,
                         bcs=init_damp, dtype=dtype, **kwargs)
    geometry = setup_geometry(model, tn, f0=fpeak)
    return SaIsoAcousticWaveSolver(model, geometry, space_order=space_order,
                                   device=device)
