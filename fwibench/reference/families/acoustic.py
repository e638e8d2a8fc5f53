"""The acoustic family: the OT2 objective of ``marmousi_fwi.py``, every
shot in one batch, on the reference's acoustic solver."""
from __future__ import annotations

import numpy as np

from .. import grid as G
from ..acoustic import Acoustic
from ..objective import _Base


class Objective(_Base):
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
