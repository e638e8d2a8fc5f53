"""TTI solver wrapper (API parity with the reference
``seismic/tti/wavesolver.py:11-357``: forward / adjoint / jacobian /
jacobian_adjoint over the centred kernels, and a checkpointed gradient).

Port of ``AnisotropicWaveSolver`` of ``devito_fwi_tpu.ops.tti_wavesolver``.
``forward``, ``adjoint``, ``jacobian`` (``born``) and ``jacobian_adjoint``
run the eager torch of ``ops.tti`` on the solver's device, as the JAX solver
runs them in XLA. ``gradient_checkpointed`` runs
``cuda_tti.tti_gradient_residual_batched``: the kernels on "cuda" (the
default), their plain twins on "cpu". On cuda a geometry the kernels do not
take (``cuda_tti.supported_reason``, or more than one source point) raises
``ValueError`` naming the condition, where the JAX solver warns and runs the
XLA pair; on the CPU such a geometry runs the eager ``forward_ckpt`` +
``jacobian_adjoint_from_ckpt``. Wavefields come back as ``Wavefield``
objects holding tensors on the solver's device.
"""
from __future__ import annotations

import time as _time

import numpy as np
import torch

from . import cuda_tti as _ct
from . import tti as _tti
from .interp import interp_table
from .wavesolver import PerfSummary, Wavefield

__all__ = ["AnisotropicWaveSolver"]


class AnisotropicWaveSolver:
    """``device``: "cuda" (raises without a card) or "cpu"."""

    def __init__(self, model, geometry, space_order=4, device="cuda",
                 **kwargs):
        from ..fwi import _resolve_device
        self.model = model
        self.model._initialize_bcs(bcs="damp")
        self.geometry = geometry
        self.space_order = space_order
        self.device = _resolve_device(device)
        self._kwargs = kwargs

    @property
    def dt(self):
        # critical_dt includes the Thomsen sqrt(1+2 max(eps)) scale
        return self.model.critical_dt

    @property
    def nt(self):
        return self.geometry.nt

    def _tables(self, coords):
        return interp_table(coords, self.model.origin_pml, self.model.spacing,
                            dtype=self.model.dtype)

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, dtype=self.model.dtype),
                               device=self.device)

    def _field(self, name, override=None, default=0.0):
        """Model field (or caller override) as a full-grid tensor of the
        model's type on the solver's device; scalars expand, None stays."""
        val = override if override is not None else \
            getattr(self.model, name, default)
        if val is None:
            return None
        val = np.asarray(val, dtype=self.model.dtype)
        if val.ndim == 0:
            val = np.full(self.model.padded_shape, val,
                          dtype=self.model.dtype)
        return self._tensor(val)

    def _params(self, vp=None, epsilon=None, delta=None, theta=None,
                phi=None):
        ph = self._field("phi", phi) if self.model.dim == 3 else None
        return (self._field("vp", vp), self._field("damp", None, 0.0),
                self._field("epsilon", epsilon), self._field("delta", delta),
                self._field("theta", theta), ph)

    def _static(self):
        return dict(nt=self.nt, spacing=self.model.spacing,
                    space_order=self.space_order)

    def _timed(self, fn):
        tic = _time.perf_counter()
        out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out, _time.perf_counter() - tic

    def _gpoints(self, sweeps):
        return sweeps * self.nt * np.prod(self.model.padded_shape)

    def forward(self, src=None, rec=None, u=None, v=None, vp=None,
                epsilon=None, delta=None, theta=None, phi=None, save=False,
                kernel="centered", **kwargs):
        """Returns (rec, u, v, summary): ``u``, ``v`` the histories (nt,
        *grid) if ``save`` else their last two steps (None with the
        staggered kernel)."""
        if kernel not in ("centered", "staggered"):
            raise ValueError(f"kernel {kernel!r}: expected 'centered' or "
                             "'staggered'")
        src = src or self.geometry.src
        rec = rec or self.geometry.rec
        params = self._params(vp, epsilon, delta, theta, phi)
        dt = kwargs.pop("dt", self.dt)
        s_idx, s_w = self._tables(src.coordinates)
        r_idx, r_w = self._tables(rec.coordinates)
        args = (*params, self._tensor(src.data), s_idx, s_w, r_idx, r_w, dt)
        if kernel == "staggered":
            rec_data, sec = self._timed(lambda: _tti.forward_staggered(
                *args, **self._static()))
            rec.data[:] = rec_data.cpu().numpy()
            return rec, None, None, PerfSummary(sec, self._gpoints(2))
        out, sec = self._timed(lambda: _tti.forward(
            *args, save=bool(save), **self._static()))
        rec.data[:] = out[0].cpu().numpy()
        return rec, Wavefield(out[1]), Wavefield(out[2]), \
            PerfSummary(sec, self._gpoints(2))

    def adjoint(self, rec, srca=None, p=None, r=None, vp=None, epsilon=None,
                delta=None, theta=None, phi=None, save=None,
                kernel="centered", **kwargs):
        """Returns (srca, final p, None, summary), the reference's arity."""
        if kernel != "centered":
            raise ValueError(f"kernel {kernel!r}: the adjoint is 'centered'")
        srca = srca or self.geometry.new_src(name="srca", src_type=None)
        params = self._params(vp, epsilon, delta, theta, phi)
        dt = kwargs.pop("dt", self.dt)
        s_idx, s_w = self._tables(srca.coordinates)
        r_idx, r_w = self._tables(rec.coordinates)
        (srca_data, p_fin), sec = self._timed(lambda: _tti.adjoint(
            *params, self._tensor(rec.data), r_idx, r_w, s_idx, s_w, dt,
            **self._static()))
        srca.data[:] = srca_data.cpu().numpy()
        return srca, Wavefield(p_fin), None, \
            PerfSummary(sec, self._gpoints(2))

    def jacobian(self, dm, src=None, rec=None, vp=None, epsilon=None,
                 delta=None, theta=None, phi=None, **kwargs):
        """Born modeling of ``dm`` (padded, or physical and edge-padded).
        Returns (rec, None, None, None, None, summary), the reference's
        arity; the twin fields are not kept."""
        src = src or self.geometry.src
        rec = rec or self.geometry.rec
        params = self._params(vp, epsilon, delta, theta, phi)
        dt = kwargs.pop("dt", self.dt)
        dmv = np.asarray(dm, dtype=self.model.dtype)
        if dmv.shape == self.model.shape:
            from ..utils.fd import pad_edge
            dmv = pad_edge(dmv, self.model.padsizes)
        s_idx, s_w = self._tables(src.coordinates)
        r_idx, r_w = self._tables(rec.coordinates)
        rec_data, sec = self._timed(lambda: _tti.born(
            *params, self._tensor(dmv), self._tensor(src.data), s_idx, s_w,
            r_idx, r_w, dt, **self._static()))
        rec.data[:] = rec_data.cpu().numpy()
        return rec, None, None, None, None, PerfSummary(sec,
                                                        self._gpoints(4))

    born = jacobian

    def _result(self, dm_out, dm):
        out = dm_out.cpu().numpy()
        if dm is None:
            return out
        dm += out
        return dm

    def jacobian_adjoint(self, rec, u0, v0, dm=None, vp=None, epsilon=None,
                         delta=None, theta=None, phi=None, **kwargs):
        """Gradient over the saved histories ``u0``, ``v0`` of
        ``forward(save=True)`` (``Wavefield`` or array). Returns (dm (padded
        grid, numpy; added into ``dm`` when given), summary)."""
        params = self._params(vp, epsilon, delta, theta, phi)
        dt = kwargs.pop("dt", self.dt)
        r_idx, r_w = self._tables(rec.coordinates)
        u0s = u0.data if isinstance(u0, Wavefield) else u0
        v0s = v0.data if isinstance(v0, Wavefield) else v0
        (dm_out, _), sec = self._timed(lambda: _tti.jacobian_adjoint(
            *params, u0s, v0s, self._tensor(rec.data), r_idx, r_w, dt,
            **self._static()))
        return self._result(dm_out, dm), PerfSummary(sec, self._gpoints(4))

    gradient = jacobian_adjoint

    def gradient_checkpointed(self, rec, src=None, n_checkpoints=16,
                              dm=None, vp=None, epsilon=None, delta=None,
                              theta=None, phi=None, **kwargs):
        """TTI gradient of the residual ``rec`` without saved histories:
        the four TTI sweeps of ``cuda_tti`` (streamed histories when they
        fit, else the checkpoint pair with ``n_checkpoints`` segments).
        Returns (dm (padded grid, numpy), summary)."""
        src = src or self.geometry.src
        params = self._params(vp, epsilon, delta, theta, phi)
        dt = kwargs.pop("dt", self.dt)
        s_idx, s_w = self._tables(src.coordinates)
        r_idx, r_w = self._tables(rec.coordinates)
        npt = s_idx.shape[0]
        if self.device.type == "cuda":
            why = _ct.supported_reason(self.model, r_idx)
            if why is None and npt != 1:
                why = f"one source point is supported; got {npt}"
            if why is not None:
                raise ValueError(f"AnisotropicWaveSolver."
                                 f"gradient_checkpointed on cuda: {why} "
                                 "(run other geometries with device='cpu')")
            kernels = True
        else:
            kernels = npt == 1 and _ct._reason(
                self.model.dim, True, self.model.padded_shape[-1],
                r_idx) is None
        wav = self._tensor(src.data)
        res = self._tensor(rec.data)
        if kernels:
            def run():
                return _ct.tti_gradient_residual_batched(
                    *params[:5], wav[:, :1], s_idx[:, None], s_w[:, None],
                    r_idx, r_w, res[None], dt, n_checkpoints=n_checkpoints,
                    **self._static())[0]
        else:
            def run():
                _, starts = _tti.forward_ckpt(
                    *params, wav, s_idx, s_w, r_idx, r_w, dt,
                    n_checkpoints=n_checkpoints, **self._static())
                return _tti.jacobian_adjoint_from_ckpt(
                    *params, wav, s_idx, s_w, starts, res, r_idx, r_w, dt,
                    n_checkpoints=n_checkpoints, **self._static())[0]
        dm_out, sec = self._timed(run)
        return self._result(dm_out, dm), PerfSummary(sec, self._gpoints(12))
