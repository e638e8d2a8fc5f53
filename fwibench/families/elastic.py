"""The elastic family: ``run_fwi_elastic``'s models, geometries and data,
the port's ``ElasticFwiLoss`` (vp inverted, vs and rho pinned at the
starting model's fields) on the card's kernels."""
from __future__ import annotations

import numpy as np

from fwibench.lib import bounds

from .common import System, driver_args, driver_config, with_sources


def setup(config, workload, src, data_dir, device):
    from devito_fwi_tpu_torch import elastic_fwi, fwi
    from devito_fwi_tpu_torch.drivers import _marmousi_common as marm
    cfg = driver_config(config)
    args = driver_args(cfg, data_dir, device)
    _, geoms, (_, smooth_vp, vs_0, rho_0), mask = marm.setup_elastic(
        cfg, args, len(src))
    true_g, start_g, water_g = (with_sources(g, src) for g in geoms)
    obs, _ = elastic_fwi.elastic_fm_multi(true_g, device=device)
    direct_wave, _ = elastic_fwi.elastic_fm_multi(water_g, device=device)
    misfit = marm.misfits(cfg)[workload["misfit"]]
    m0 = 1.0 / smooth_vp.reshape(-1).astype(np.float64) ** 2
    loss = elastic_fwi.ElasticFwiLoss(vs=vs_0, rho=rho_0, device=device)
    return System(loss=loss, geometry=start_g, m0=m0,
                  run_args=(obs, misfit, direct_wave, mask, args.precond),
                  bounds=bounds(config),
                  eager=lambda: sum(elastic_fwi.EAGER.values())
                  + sum(fwi.EAGER.values()))
