"""The elastic family: the velocity-stress objective of
``marmousi2_fwi.py`` in vp, every shot in one batch, on the reference's
elastic solver."""
from __future__ import annotations

import numpy as np

from .. import grid as G
from ..elastic import Elastic, lame
from ..objective import _Base, _fold, elastic_fields


class Objective(_Base):
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
