"""The elastic velocity-stress solver of the reference on a staggered grid,
batched over shots in plain torch, and the exact gradient of its traces'
misfit by reverse-mode autodiff over recomputed segments.

Discretisation (devito-fwi ``seismic/elastic/operators.py`` as solved by
devito): vx at +h/2 in x, vz at +h/2 in z, txx and tzz at the nodes, txz at
+h/2 in both; D+ is the first derivative of a node field at +h/2 and D- of
a staggered field at the node, order so; a node parameter used at a
staggered point is averaged over the shifted axes with zero beyond the
grid. One step, with s = dt and the mask profile d:

    vx' = d_x (vx + s b_x (D+x txx + D-z txz))
    vz' = d_z (vz + s b_z (D+z tzz + D-x txz))
    txx' = d (txx + s lam (D-x vx' + D-z vz') + 2 s mu D-x vx')
    tzz' = d (tzz + s lam (D-x vx' + D-z vz') + 2 s mu D-z vz')
    txz' = d_xz (txz + s mu_xz (D+z vx' + D+x vz'))

and the source adds w_c src[t] s at its corners c into txx' and tzz'. The
receivers read tzz bilinearly before each step, t = 0..nt-2 (rec[nt-1] =
0). The illumination is sum over steps of vx'^2 + vz'^2.
"""
from __future__ import annotations

import numpy as np
import torch

from .grid import staggered_weights
from .stencil import shifted

__all__ = ["Elastic", "lame"]


def lame(vp, vs, rho):
    """(lam, mu, b) of (vp, vs, rho)."""
    return rho * (vp * vp - 2.0 * vs * vs), rho * vs * vs, 1.0 / rho


def _avg(p, axes):
    """Average to +h/2 along each of ``axes`` (1 = x, 2 = z) of a (., nx,
    nz) field, zero beyond the grid."""
    for a in axes:
        nxt = torch.cat([p.narrow(a, 1, p.shape[a] - 1),
                         torch.zeros_like(p.narrow(a, 0, 1))], a)
        p = 0.5 * (p + nxt)
    return p


class Elastic:
    """The operators of one padded grid and the shots' point tables.

    ``eta`` is the mask profile (nx, nz); the tables are those of
    ``grid.point_table``; ``wav`` (nt,) the wavelet. ``state_dtype`` is
    the element type the gradient keeps its segment starts in."""

    def __init__(self, eta, dt, spacing, space_order, wav, src_idx, src_w,
                 rec_idx, rec_w, state_dtype=None):
        dev, dtype = eta.device, eta.dtype
        self.dev, self.dtype = dev, dtype
        self.s = float(dt)
        wp, op, wm, om = staggered_weights(space_order)
        self.dp = (wp, op)
        self.dm = (wm, om)
        self.inv_h = [1.0 / h for h in spacing]
        self.eta = eta[None]
        self.eta_x, self.eta_z = _avg(self.eta, (1,)), _avg(self.eta, (2,))
        self.eta_xz = _avg(self.eta, (1, 2))
        self.nt = len(wav)
        self.wav = torch.as_tensor(wav, dtype=dtype, device=dev)
        self.src = (torch.as_tensor(src_idx[..., 0], device=dev),
                    torch.as_tensor(src_idx[..., 1], device=dev),
                    torch.as_tensor(src_w, dtype=dtype, device=dev) * self.s)
        self.rec = (torch.as_tensor(rec_idx[..., 0], device=dev),
                    torch.as_tensor(rec_idx[..., 1], device=dev),
                    torch.as_tensor(rec_w, dtype=dtype, device=dev))
        self.state_dtype = state_dtype or dtype

    def _d(self, u, which, axis):
        w, off = self.dp if which == "+" else self.dm
        return shifted(u, w, off, axis, self.inv_h[axis - 1])

    def params(self, lam, mu, b):
        """The step's parameters of padded (nx, nz) or (B, nx, nz)
        fields."""
        lam, mu, b = (x if x.dim() == 3 else x[None] for x in (lam, mu, b))
        return lam, mu, _avg(b, (1,)), _avg(b, (2,)), _avg(mu, (1, 2))

    def _src(self, shots, t):
        """(shot, x, z, value) of the sources of ``shots`` at step t; the
        corner tables of a shot set are moved to the device once."""
        key = tuple(int(i) for i in shots)
        if getattr(self, "_src_key", None) != key:
            x, z, w = self.src
            sel = torch.as_tensor(np.asarray(key), device=self.dev)
            bi = torch.arange(len(key), device=self.dev).repeat_interleave(4)
            self._src_key = key
            self._src_tab = (bi, x[sel].reshape(-1), z[sel].reshape(-1),
                             w[sel].reshape(-1))
        bi, x, z, w = self._src_tab
        return bi, x, z, w * self.wav[t]

    def _sample(self, tzz):
        rx, rz, rw = self.rec
        return torch.sum(tzz[:, rx, rz] * rw, dim=-1)

    def forward(self, prm, shots):
        """Traces (B, nt, nrec) of ``shots``."""
        state = self._zero(len(shots))
        rows = []
        with torch.no_grad():
            for t in range(self.nt - 1):
                rows.append(self._sample(state[3]))
                state = self._full_step(prm, state, shots, t)
        return self._traces(rows)

    def _zero(self, B):
        z = torch.zeros((B,) + tuple(self.eta.shape[1:]), dtype=self.dtype,
                        device=self.dev)
        return (z,) * 5

    def _traces(self, rows):
        rows.append(torch.zeros_like(rows[0]))
        return torch.stack(rows, dim=1)

    def _full_step(self, prm, state, shots, t):
        lam, mu, b_x, b_z, mu_xz = prm
        vx, vz, txx, tzz, txz = state
        s = self.s
        vx = self.eta_x * (vx + s * b_x * (self._d(txx, "+", 1)
                                           + self._d(txz, "-", 2)))
        vz = self.eta_z * (vz + s * b_z * (self._d(tzz, "+", 2)
                                           + self._d(txz, "-", 1)))
        dvx, dvz = self._d(vx, "-", 1), self._d(vz, "-", 2)
        ldiv = s * lam * (dvx + dvz)
        txx = self.eta * (txx + ldiv + 2.0 * s * mu * dvx)
        tzz = self.eta * (tzz + ldiv + 2.0 * s * mu * dvz)
        txz = self.eta_xz * (txz + s * mu_xz * (self._d(vx, "+", 2)
                                                + self._d(vz, "+", 1)))
        bi, x, z, val = self._src(shots, t)
        inj = torch.zeros_like(txx).index_put((bi, x, z), val,
                                              accumulate=True)
        return vx, vz, txx + inj, tzz + inj, txz

    def gradient(self, lam, mu, b, shots, misfit, seg=None):
        """(traces, d misfit / d lam (B, nx, nz) per shot, illumination
        (B, nx, nz)) of ``shots``; ``lam``, ``mu``, ``b`` padded (nx,
        nz). ``misfit(traces) -> (value, residual)`` gives the cotangent
        of the traces. The forward keeps each segment's start (in
        ``state_dtype``); the reverse rebuilds one segment's graph at a
        time from it and runs autodiff through it."""
        B = len(shots)
        nsteps = self.nt - 1
        seg = seg or max(1, int(np.sqrt(nsteps)))
        starts = list(range(0, nsteps, seg))
        mu_b, b_b = mu[None], b[None]
        prm = self.params(lam[None], mu_b, b_b)
        state = self._zero(B)
        saved, rows = [], []
        illum = torch.zeros_like(state[0])
        with torch.no_grad():
            for t in range(nsteps):
                if t % seg == 0:
                    saved.append(tuple(x.to(self.state_dtype)
                                       for x in state))
                rows.append(self._sample(state[3]))
                state = self._full_step(prm, state, shots, t)
                illum.add_(state[0] * state[0] + state[1] * state[1])
        traces = self._traces(rows)
        del rows, state
        value, res = misfit(traces)
        lam_b = lam[None].expand(B, -1, -1).clone().requires_grad_(True)
        g_lam = torch.zeros_like(lam_b)
        carry = None
        for k in range(len(starts) - 1, -1, -1):
            t0, t1 = starts[k], min(starts[k] + seg, nsteps)
            st = tuple(x.to(self.dtype, copy=True).requires_grad_(True)
                       for x in saved[k])
            saved[k] = None
            lam_b.grad = None
            prm = self.params(lam_b, mu_b, b_b)
            cur, outs = st, []
            for t in range(t0, t1):
                outs.append(self._sample(cur[3]))
                cur = self._full_step(prm, cur, shots, t)
            rec = torch.stack(outs, dim=1)
            tensors = [rec] + ([] if carry is None else list(cur))
            grads = [res[:, t0:t1]] + ([] if carry is None else list(carry))
            torch.autograd.backward(tensors, grads)
            g_lam += lam_b.grad
            carry = tuple(torch.zeros_like(x) if x.grad is None else x.grad
                          for x in st)
        return traces, value, g_lam, illum
