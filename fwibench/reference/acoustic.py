"""The acoustic OT2 solver of the reference and its adjoint-state gradient,
batched over shots in plain torch.

Discretisation (devito-fwi ``seismic/acoustic/operators.py`` as solved by
devito, damping form): with m = 1/vp^2, s = dt and eta the damping profile,

    u[t+1] = (s^2 lap(u[t]) + (2 m + s eta) u[t] - m u[t-1]) / (m + s eta)

for t = 1..nt-2 from u[0] = u[1] = 0, the source adding w_c src[t] s^2 /
m_c at its bilinear corners c into u[t+1]; the receivers read u[t]
bilinearly for t = 1..nt-2 (rec[0] = rec[nt-1] = 0). The gradient with
respect to m is ``-sum_t u.dt2[t] v[t]`` over t = nt-2..1, where v steps
backward through the same update from v = 0 with the residual res[t]
injected like a source into v[t-1], and u.dt2[t] = (u[t+1] - 2 u[t] +
u[t-1]) / s^2. The illumination is sum_t u[t]^2.
"""
from __future__ import annotations

import numpy as np
import torch

from .grid import second_derivative_weights
from .stencil import laplacian

__all__ = ["Acoustic"]


class Acoustic:
    """One padded model on the device and the shots' point tables.

    ``vp`` (nx, nz) padded velocity (km/s); ``eta`` the damping profile;
    ``src_idx``/``src_w`` (nsrc, 4, 2)/(nsrc, 4) and ``rec_idx``/``rec_w``
    (nrec, 4, 2)/(nrec, 4) the bilinear tables of ``grid.point_table``;
    ``wav`` (nt,) the wavelet. ``hist_dtype`` is the element type the
    gradient keeps the forward history in."""

    def __init__(self, vp, eta, dt, spacing, space_order, wav, src_idx,
                 src_w, rec_idx, rec_w, hist_dtype=None):
        dev, dtype = vp.device, vp.dtype
        self.dev = dev
        self.m = 1.0 / (vp * vp)
        self.s2 = float(dt) * float(dt)
        hd = float(dt) * eta
        self.two_m_hd = 2.0 * self.m + hd
        self.inv = 1.0 / (self.m + hd)
        self.w = second_derivative_weights(space_order)
        self.inv_h2 = [1.0 / (h * h) for h in spacing]
        self.nt = len(wav)
        self.wav = torch.as_tensor(wav, dtype=dtype, device=dev)
        self.hist_dtype = hist_dtype or dtype
        self.src = self._points(src_idx, src_w)
        rx, rz = (torch.as_tensor(rec_idx[..., d], device=dev)
                  for d in (0, 1))
        self.rec = (rx, rz, torch.as_tensor(rec_w, dtype=dtype, device=dev))
        self.rec_scale = torch.as_tensor(rec_w, dtype=dtype, device=dev) \
            * self.s2 / self.m[rx, rz]

    def _points(self, idx, w):
        """Per-shot source corners (nsrc, 4) and their scale w s^2 / m."""
        x = torch.as_tensor(idx[..., 0], device=self.dev)
        z = torch.as_tensor(idx[..., 1], device=self.dev)
        scale = torch.as_tensor(w, dtype=self.m.dtype,
                                device=self.dev) * self.s2 / self.m[x, z]
        return x, z, scale

    def _step(self, u, u_prev):
        return (self.s2 * laplacian(u, self.w, self.inv_h2)
                + self.two_m_hd * u - self.m * u_prev) * self.inv

    def _sample(self, u):
        rx, rz, rw = self.rec
        return torch.sum(u[:, rx, rz] * rw, dim=-1)

    def forward(self, shots, history=False):
        """Traces (B, nt, nrec) of ``shots`` (index array); with
        ``history`` also the illumination (B, nx, nz) and the wavefield
        history (nt, B, nx, nz) in ``hist_dtype``."""
        sel = torch.as_tensor(np.asarray(shots), device=self.dev)
        x, z, scale = (a[sel].reshape(-1) for a in self.src)
        bi = torch.arange(len(shots), device=self.dev).repeat_interleave(4)
        B = len(shots)
        u = self.m.new_zeros((B,) + tuple(self.m.shape))
        u_prev = torch.zeros_like(u)
        rec = u.new_zeros((B, self.nt, self.rec[0].shape[0]))
        hist = illum = None
        if history:
            hist = u.new_zeros((self.nt, B) + tuple(self.m.shape),
                               dtype=self.hist_dtype)
            illum = torch.zeros_like(u)
        for t in range(1, self.nt - 1):
            rec[:, t] = self._sample(u)
            un = self._step(u, u_prev)
            un.index_put_((bi, x, z), scale * self.wav[t], accumulate=True)
            u_prev, u = u, un
            if history:
                hist[t + 1] = u
                illum.add_(u * u)
        return rec, illum, hist

    def gradient(self, hist, res):
        """``-sum_t u.dt2[t] v[t]`` (B, nx, nz) from the history of
        ``forward`` and the residual (B, nt, nrec)."""
        rx, rz, _ = self.rec
        B = res.shape[0]
        v = self.m.new_zeros((B,) + tuple(self.m.shape))
        v_next = torch.zeros_like(v)
        grad = torch.zeros_like(v)
        bi = torch.arange(B, device=self.dev)[:, None, None].expand(
            B, rx.shape[0], 4)
        xi, zi = (a[None].expand(B, -1, -1) for a in (rx, rz))
        for t in range(self.nt - 2, 0, -1):
            u0, u1, u2 = (hist[k].to(v.dtype) for k in (t - 1, t, t + 1))
            udt2 = (u2 - 2.0 * u1 + u0) / self.s2
            grad.sub_(udt2 * v)
            vn = self._step(v, v_next)
            vn.index_put_((bi, xi, zi), res[:, t, :, None] * self.rec_scale,
                          accumulate=True)
            v_next, v = v, vn
        return grad
