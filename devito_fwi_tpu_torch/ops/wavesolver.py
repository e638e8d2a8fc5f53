"""The acoustic solver object and what the solver wrappers share: the
wavefield holder and the performance summary they return.

Port of ``devito_fwi_tpu.ops.wavesolver``. ``AcousticWaveSolver`` mirrors
the reference solver (``seismic/acoustic/wavesolver.py:10-246``):
``forward`` / ``adjoint`` / ``jacobian`` (``born``) / ``jacobian_adjoint``
(``gradient``) with the same call conventions, over the eager operators of
``ops.acoustic`` on the solver's device ("cuda", the default, raises
without a card; "cpu" runs on the host). 3-D float32 OT2 forwards without a
free surface step through the CUDA step kernel on the card (the step hook
of ``ops.acoustic``; ``step3=False`` turns it off). Shot records come back
in the ``PointSource`` objects' numpy data, gradients as numpy arrays on
the padded grid, wavefields as ``Wavefield`` objects holding tensors on
the solver's device.
"""
from __future__ import annotations

import time as _time

import numpy as np
import torch

from . import acoustic as _ac
from .interp import interp_table

__all__ = ["AcousticWaveSolver", "Wavefield", "PerfSummary"]


class Wavefield:
    """Thin wrapper so callers can use ``.data`` like a devito TimeFunction."""

    def __init__(self, data):
        self.data = data


class PerfSummary:
    """Per-operator performance summary (the reference consumes devito's
    ``summary.gflopss/oi/timings``)."""

    FLOPS_PER_CELL = 40.0   # nominal so=8 stencil+update flop count
    BYTES_PER_CELL = 24.0   # nominal streamed bytes per cell and step

    def __init__(self, elapsed, gpoints):
        self.elapsed = elapsed
        self.gpointss = gpoints / elapsed / 1e9 if elapsed > 0 else 0.0
        self.gflopss = self.gpointss * self.FLOPS_PER_CELL
        self.oi = self.FLOPS_PER_CELL / self.BYTES_PER_CELL
        self.timings = {"kernel": elapsed}

    def __repr__(self):
        return f"PerfSummary(elapsed={self.elapsed:.4f}s, " \
               f"gpoints/s={self.gpointss:.3f}, gflops/s~{self.gflopss:.1f})"


class AcousticWaveSolver:
    """
    Parameters
    ----------
    model : SeismicModel
    geometry : AcquisitionGeometry
    kernel : 'OT2' | 'OT4'
    space_order : int — stencil order for the wave equation
    device : "cuda" (raises without a card) or "cpu"
    """

    def __init__(self, model, geometry, kernel="OT2", space_order=4,
                 device="cuda", **kwargs):
        from ..fwi import _resolve_device
        self.model = model
        # solvers require the damping (not mask) boundary, like the reference
        # (seismic/acoustic/wavesolver.py:30)
        self.model._initialize_bcs(bcs="damp")
        self.geometry = geometry
        self.space_order = space_order
        self.kernel = kernel
        self.device = _resolve_device(device)
        self._kwargs = kwargs

    # ------------------------------------------------------------------ misc
    @property
    def dt(self):
        if self.kernel == "OT4":
            # OT4 allows a sqrt(3)~1.73x larger dt (reference wavesolver.py:42-46)
            return self.model.dtype(1.73 * self.model.critical_dt)
        return self.model.critical_dt

    @property
    def nt(self):
        return self.geometry.nt

    def _tables(self, coords):
        return interp_table(coords, self.model.origin_pml, self.model.spacing,
                            dtype=self.model.dtype)

    def _static(self):
        return dict(nt=self.nt, spacing=self.model.spacing,
                    space_order=self.space_order, kernel=self.kernel,
                    fs=self.model.fs)

    def _tensor(self, a):
        """An array, or a tensor, in the model's type on the solver's
        device."""
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device,
                        dtype=getattr(torch, np.dtype(self.model.dtype).name))
        return torch.as_tensor(np.asarray(a, dtype=self.model.dtype),
                               device=self.device)

    def _damp(self):
        """The damping profile as a padded-grid tensor (zeros without an
        absorbing layer, so the step kernel gets a full field)."""
        d = self.model.damp
        if not isinstance(d, np.ndarray):
            d = np.zeros(self.model.padded_shape, self.model.dtype)
        return self._tensor(d)

    def _vp(self, vp):
        if vp is None:
            vp = self.model.vp
        vp = self._tensor(vp)
        if vp.dim() == 0:
            vp = vp.expand(self.model.padded_shape).contiguous()
        return vp

    def _run(self, fn, sweeps, nt_cells):
        """(fn's result, PerfSummary) with the device synchronised before
        the clock stops."""
        tic = _time.perf_counter()
        out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out, PerfSummary(_time.perf_counter() - tic,
                                sweeps * nt_cells)

    # --------------------------------------------------------------- forward
    def forward(self, src=None, rec=None, u=None, vp=None, save=None,
                **kwargs):
        """Returns (rec, u, summary) — rec is a PointSource (nt, nrec), u the
        wavefield (saved history if save else the last two slices).
        Keywords: ``dt``, ``w_override`` (custom FD weights, devito's
        coefficients='symbolic' analog, tutorial 07_DRP_schemes),
        ``save_dtype`` and ``step3`` (``ops.acoustic.forward``)."""
        src = src or self.geometry.src
        rec = rec or self.geometry.rec
        vp = self._vp(vp)
        dt = kwargs.pop("dt", self.dt)
        opts = {k: kwargs.pop(k, None)
                for k in ("w_override", "save_dtype", "step3")}
        s_idx, s_w = self._tables(src.coordinates)
        r_idx, r_w = self._tables(rec.coordinates)
        (rec_data, u_out), summary = self._run(lambda: _ac.forward(
            vp, self._damp(), self._tensor(src.data), s_idx, s_w, r_idx,
            r_w, dt, save=bool(save), **opts, **self._static()),
            1, self.nt * vp.numel())
        rec.data[:] = rec_data.cpu().numpy()
        return rec, Wavefield(u_out), summary

    # --------------------------------------------------------------- adjoint
    def adjoint(self, rec, srca=None, v=None, vp=None, **kwargs):
        """Returns (srca, v, summary): the adjoint source record and the
        adjoint field's last two slices."""
        srca = srca or self.geometry.new_src(name="srca", src_type=None)
        vp = self._vp(vp)
        dt = kwargs.pop("dt", self.dt)
        s_idx, s_w = self._tables(srca.coordinates)
        r_idx, r_w = self._tables(rec.coordinates)
        (srca_data, v_out), summary = self._run(lambda: _ac.adjoint(
            vp, self._damp(), self._tensor(rec.data), r_idx, r_w, s_idx,
            s_w, dt, **self._static()), 1, self.nt * vp.numel())
        srca.data[:] = srca_data.cpu().numpy()
        return srca, Wavefield(v_out), summary

    # ----------------------------------------------------- jacobian adjoint
    def jacobian_adjoint(self, rec, u, v=None, grad=None, vp=None,
                         checkpointing=False, n_checkpoints=16, **kwargs):
        """Gradient w.r.t. squared slowness on the padded grid (numpy). ``u``
        is the saved forward wavefield (a ``Wavefield`` or a tensor, from
        ``forward(save=True)``) unless ``checkpointing``, in which case the
        forward is recomputed segment-wise (pyrevolve equivalent, reference
        ``wavesolver.py:188-201``). A ``grad`` array given is added into,
        as devito's Inc does."""
        vp = self._vp(vp)
        dt = kwargs.pop("dt", self.dt)
        r_idx, r_w = self._tables(rec.coordinates)
        res = self._tensor(rec.data)
        if checkpointing:
            src = self.geometry.src
            s_idx, s_w = self._tables(src.coordinates)

            def run():
                return _ac.gradient_checkpointed(
                    vp, self._damp(), self._tensor(src.data), s_idx, s_w,
                    res, r_idx, r_w, dt, n_checkpoints=n_checkpoints,
                    **self._static())[0]
        else:
            u_save = u.data if isinstance(u, Wavefield) else u
            u_save = torch.as_tensor(u_save, device=self.device)

            def run():
                return _ac.gradient(vp, self._damp(), u_save, res, r_idx,
                                      r_w, dt, **self._static())[0]
        grad_out, summary = self._run(run, 2, self.nt * vp.numel())
        grad_out = grad_out.cpu().numpy()
        if grad is not None:
            grad += grad_out
            return grad, summary
        return grad_out, summary

    # --------------------------------------------------------------- born
    def jacobian(self, dmin, src=None, rec=None, vp=None, **kwargs):
        """Born modeling of ``dmin`` (padded, or at the model's shape and
        then edge-padded). Returns (rec, summary)."""
        src = src or self.geometry.src
        rec = rec or self.geometry.rec
        vp = self._vp(vp)
        dt = kwargs.pop("dt", self.dt)
        s_idx, s_w = self._tables(src.coordinates)
        r_idx, r_w = self._tables(rec.coordinates)
        dm = np.asarray(dmin, dtype=self.model.dtype)
        if dm.shape == self.model.shape:
            from ..utils.fd import pad_edge
            dm = pad_edge(dm, self.model.padsizes)
        rec_data, summary = self._run(lambda: _ac.born(
            vp, self._damp(), self._tensor(dm), self._tensor(src.data),
            s_idx, s_w, r_idx, r_w, dt, **self._static()),
            2, self.nt * vp.numel())
        rec.data[:] = rec_data.cpu().numpy()
        return rec, summary

    # backward compatibility aliases (reference wavesolver.py:244-246)
    born = jacobian
    gradient = jacobian_adjoint

