"""What the families share: the port's driver configuration built from a
configuration file, and the inversion's fixed inputs."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class System:
    """One cell's system under test: ``loss`` has the signature of the
    port's ``fwi_loss``; ``run_args`` are the positional arguments of
    ``minimize.run`` after the starting model; ``eager`` counts the calls
    that took an eager route instead of the kernels."""
    loss: object
    geometry: object
    m0: np.ndarray
    run_args: tuple
    bounds: list
    eager: object


def driver_config(config):
    """The port's ``MarmousiConfig`` of a configuration file."""
    from devito_fwi_tpu_torch.drivers import _marmousi_common as marm
    return marm.MarmousiConfig(
        name=config["model_dir"], shape=tuple(config["shape"]),
        dt=config.get("dt", 0.0), tn=config["tn"],
        nsrc_default=config["shots"], bathy_rows=config["water_rows"],
        w2_step_scale=config.get("w2_step_scale", 1.0),
        w2_num_steps=config.get("w2_num_steps", 15),
        spacing=tuple(config["spacing"]), f0=config["f0"],
        space_order=config["space_order"], nbl=config["nbl"])


def driver_args(cfg, data_dir, device):
    from devito_fwi_tpu_torch.drivers import _marmousi_common as marm
    return marm.make_parser(cfg).parse_args(
        ["--data-dir", data_dir, "--device", device])


def with_sources(geometry, src):
    """``geometry`` with the seed's source positions."""
    from devito_fwi_tpu_torch.models.geometry import AcquisitionGeometry
    return AcquisitionGeometry(geometry.model, geometry.rec_positions, src,
                               geometry.t0, geometry.tn, f0=geometry.f0,
                               src_type=geometry.src_type)
