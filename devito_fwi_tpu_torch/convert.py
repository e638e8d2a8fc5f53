"""Build the port's model and geometry objects from plain numpy arrays and
scalars, e.g. the fields of another package's objects. The port itself
takes only numpy here.

    model = model_from_numpy(dict(vp=..., damp=..., origin=..., ...))
    geometry = geometry_from_numpy(model, dict(rec_positions=..., ...))
"""
from __future__ import annotations

import numpy as np

from .models.geometry import AcquisitionGeometry
from .models.model import SeismicModel

__all__ = ["model_from_numpy", "geometry_from_numpy"]


def model_from_numpy(d):
    """A ``SeismicModel`` from ``d``: ``vp`` and ``damp`` on the padded
    grid (numpy; damp may be a scalar), ``origin``, ``spacing``,
    ``shape``, ``nbl``, ``space_order``, ``fs`` and ``dt`` (the user time
    step, or None for the CFL one). The padded fields are copied as given,
    so a padding that is not an edge replication survives."""
    vp = np.asarray(d["vp"])
    shape = tuple(int(s) for s in d["shape"])
    model = SeismicModel(origin=tuple(d["origin"]),
                         spacing=tuple(d["spacing"]), shape=shape,
                         space_order=int(d["space_order"]), vp=vp[tuple(
                             slice(0, n) for n in shape)],
                         nbl=int(d["nbl"]), fs=bool(d["fs"]),
                         dtype=vp.dtype.type, bcs="damp", dt=d["dt"])
    model.vp = vp.copy()
    damp = d["damp"]
    model.damp = np.array(damp) if isinstance(damp, np.ndarray) \
        else vp.dtype.type(damp)
    return model


def geometry_from_numpy(model, d):
    """An ``AcquisitionGeometry`` on ``model`` from ``d``:
    ``rec_positions``, ``src_positions``, ``t0``, ``tn``, ``f0`` and
    ``src_type``."""
    return AcquisitionGeometry(model, np.asarray(d["rec_positions"]),
                               np.asarray(d["src_positions"]), d["t0"],
                               d["tn"], f0=d["f0"], src_type=d["src_type"])
