"""Build the port's model and geometry objects from plain numpy arrays and
scalars, e.g. the fields of another package's objects. The port itself
takes only numpy here.

    model = model_from_numpy(dict(vp=..., damp=..., origin=..., ...))
    model = model_from_numpy(dict(lam=..., mu=..., b=..., damp=..., ...))
    model = model_from_numpy(dict(vp=..., qp=..., b=..., damp=..., ...))
    model = model_from_numpy(dict(vp=..., epsilon=..., delta=...,
                                  theta=..., damp=..., ...))
    geometry = geometry_from_numpy(model, dict(rec_positions=..., ...))
"""
from __future__ import annotations

import numpy as np

from .models.geometry import AcquisitionGeometry
from .models.model import SeismicModel

__all__ = ["model_from_numpy", "geometry_from_numpy"]

# the TTI fields a model may carry beside vp (phi in 3-D only)
TTI_FIELDS = ("epsilon", "delta", "theta", "phi")


def _elastic_velocities(d):
    """Physical-domain (vp, vs, b) of an elastic field dict, for the
    constructor only (its padded lam, mu, b are replaced afterwards)."""
    lam = np.asarray(d["lam"])
    mu = np.asarray(d["mu"])
    b = np.broadcast_to(np.asarray(d.get("b", 1.0), dtype=lam.dtype),
                        lam.shape)
    vs = np.sqrt(mu * b)
    vp = np.sqrt((lam + 2.0 * mu) * b)
    return vp, vs, b


def model_from_numpy(d):
    """A ``SeismicModel`` from ``d``: either ``vp`` (acoustic; with
    ``epsilon``, ``delta``, ``theta`` and in 3-D ``phi``, TTI), ``vp`` and
    ``qp`` and optionally ``b`` (viscoacoustic) or ``lam``, ``mu`` and
    optionally ``b`` and ``vs`` (elastic), each on the padded grid (numpy;
    ``b`` may be a scalar); ``damp`` on the padded grid or a scalar (the
    "damp" profile for acoustic models, the "mask" one for viscoacoustic
    and elastic ones); ``origin``, ``spacing``, ``shape``, ``nbl``,
    ``space_order``, ``fs`` and ``dt`` (the user time step, or None for
    the CFL one). The padded fields are copied as given, so a padding that
    is not an edge replication survives."""
    shape = tuple(int(s) for s in d["shape"])
    core = tuple(slice(0, n) for n in shape)
    elastic = "lam" in d
    visco = not elastic and d.get("qp") is not None
    if elastic:
        vp, vs, b = _elastic_velocities(d)
        kw = dict(vp=vp[core], vs=vs[core], b=b[core], bcs="mask")
    elif visco:
        vp = np.asarray(d["vp"])
        b = np.broadcast_to(np.asarray(d.get("b", 1.0), dtype=vp.dtype),
                            vp.shape)
        kw = dict(vp=vp[core], qp=np.asarray(d["qp"])[core], b=b[core],
                  bcs="mask")
    else:
        vp = np.asarray(d["vp"])
        kw = dict(vp=vp[core], bcs="damp")
    tti = [n for n in TTI_FIELDS if d.get(n) is not None]
    kw.update({n: np.asarray(d[n])[core] if np.ndim(d[n]) else d[n]
               for n in tti})
    model = SeismicModel(origin=tuple(d["origin"]),
                         spacing=tuple(d["spacing"]), shape=shape,
                         space_order=int(d["space_order"]),
                         nbl=int(d["nbl"]), fs=bool(d["fs"]),
                         dtype=vp.dtype.type, dt=d["dt"], **kw)
    if elastic:
        model.lam = np.array(d["lam"])
        model.mu = np.array(d["mu"])
        b = d.get("b", 1.0)
        model.b = np.array(b) if isinstance(b, np.ndarray) \
            else vp.dtype.type(b)
        if d.get("vs") is not None:
            model.vs = np.array(d["vs"])
    else:
        model.vp = vp.copy()
    if visco:
        model.qp = np.array(d["qp"])
        b = d.get("b", 1.0)
        model.b = np.array(b) if isinstance(b, np.ndarray) \
            else vp.dtype.type(b)
    for n in tti:
        setattr(model, n, np.array(d[n]))
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
