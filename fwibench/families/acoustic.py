"""The acoustic family: ``run_fwi``'s models, geometries and data, the
port's ``fwi_loss`` on the card's kernels."""
from __future__ import annotations

from functools import partial

import numpy as np

from fwibench.lib import bounds

from .common import System, driver_args, driver_config, with_sources


def setup(config, workload, src, data_dir, device):
    from devito_fwi_tpu_torch import fwi
    from devito_fwi_tpu_torch.drivers import _marmousi_common as marm
    cfg = driver_config(config)
    args = driver_args(cfg, data_dir, device)
    _, geoms, (_, smooth_vp), mask = marm.setup(cfg, args, len(src))
    true_g, start_g, water_g = (with_sources(g, src) for g in geoms)
    obs = fwi.fm_multi(true_g, device=device)
    direct_wave = fwi.fm_multi(water_g, device=device)
    misfit = marm.misfits(cfg)[workload["misfit"]]
    m0 = 1.0 / smooth_vp.reshape(-1).astype(np.float64) ** 2
    return System(loss=partial(fwi.fwi_loss, device=device),
                  geometry=start_g, m0=m0,
                  run_args=(obs, misfit, direct_wave, mask, args.precond),
                  bounds=bounds(config),
                  eager=lambda: sum(fwi.EAGER.values()))
