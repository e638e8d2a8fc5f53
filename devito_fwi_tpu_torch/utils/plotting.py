"""Plotting utilities (reference ``seismic/plotting.py``); the port's copy
of ``devito_fwi_tpu.utils.plotting``.

The same four entry points. Fields may be numpy arrays or torch tensors
(on any device). matplotlib is imported at the first call of a plotting
function: a machine without it imports this module (and the package, which
exports the four), and only a call raises.
"""
from __future__ import annotations

import numpy as np

__all__ = ["plot_perturbation", "plot_velocity", "plot_shotrecord",
           "plot_image"]


def _np(x):
    """A numpy copy of an array or a tensor."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _pyplot():
    """(pyplot, cm), imported on first use."""
    try:
        import matplotlib.pyplot as plt
        from matplotlib import cm
    except ImportError as e:
        raise ImportError("plotting needs matplotlib, which is not "
                          "installed") from e
    return plt, cm


def _extent(model):
    domain_size = 1.e-3 * np.array(model.domain_size)
    return [model.origin[0], model.origin[0] + domain_size[0],
            model.origin[1] + domain_size[1], model.origin[1]]


def plot_perturbation(model, model1, colorbar=True, show=True):
    """Plot the velocity difference between two models."""
    pl, cm = _pyplot()
    dv = np.transpose(_np(model.crop(_np(model1.vp)))) - \
        np.transpose(_np(model.crop(_np(model.vp))))
    plot = pl.imshow(dv, animated=True, cmap=cm.jet,
                     vmin=min(dv.reshape(-1)), vmax=max(dv.reshape(-1)),
                     extent=_extent(model))
    pl.xlabel("X position (km)")
    pl.ylabel("Depth (km)")
    if colorbar:
        pl.colorbar(plot, shrink=0.5, label="Velocity perturbation (km/s)")
    if show:
        pl.show()


def plot_velocity(model, source=None, receiver=None, colorbar=True,
                  cmap="jet", show=True):
    """Plot a 2-D velocity field with optional source/receiver overlays."""
    pl, _ = _pyplot()
    vp = model.vp
    field = _np(model.crop(_np(vp))) if np.ndim(_np(vp)) else \
        np.full(model.shape, float(_np(vp)))
    plot = pl.imshow(np.transpose(field), animated=True, cmap=cmap,
                     vmin=np.min(field), vmax=np.max(field),
                     extent=_extent(model))
    pl.xlabel("X position (km)")
    pl.ylabel("Depth (km)")
    if receiver is not None:
        receiver = _np(receiver)
        pl.scatter(1e-3 * receiver[:, 0], 1e-3 * receiver[:, 1],
                   s=25, c="green", marker="D")
    if source is not None:
        source = _np(source)
        pl.scatter(1e-3 * source[:, 0], 1e-3 * source[:, 1],
                   s=25, c="red", marker="o")
    if colorbar:
        pl.colorbar(plot, shrink=0.5, label="Velocity (km/s)")
    if show:
        pl.show()


def plot_shotrecord(rec, model, t0, tn, colorbar=True, show=True, clim=None):
    """Plot a shot record (time vs. receiver position)."""
    pl, cm = _pyplot()
    rec = _np(rec)
    scale = np.max(rec) / 10.
    if clim is not None:
        scale = clim
    extent = [model.origin[0], model.origin[0] + 1e-3 * model.domain_size[0],
              1e-3 * tn, t0]
    plot = pl.imshow(rec, vmin=-scale, vmax=scale, cmap=cm.gray,
                     extent=extent, aspect="auto")
    pl.xlabel("X position (km)")
    pl.ylabel("Time (s)")
    if colorbar:
        pl.colorbar(plot, shrink=0.5)
    if show:
        pl.show()


def plot_image(data, vmin=None, vmax=None, colorbar=True, cmap="gray",
               show=True):
    """Plot a 2-D image field (gradient, image, section)."""
    pl, _ = _pyplot()
    data = _np(data)
    plot = pl.imshow(np.transpose(data),
                     vmin=vmin or 0.9 * np.min(data),
                     vmax=vmax or 1.1 * np.max(data),
                     cmap=cmap)
    if colorbar:
        pl.colorbar(plot, shrink=0.5)
    if show:
        pl.show()
