"""Preset demo models (reference ``seismic/preset_models.py``).

Implemented presets: constant-isotropic, constant-elastic,
constant-viscoelastic, constant-viscoacoustic, constant-tti,
layers-isotropic, layers-elastic, layers-viscoelastic, layers-viscoacoustic,
layers-tti, circle-isotropic, plus raw-binary Marmousi loaders pointed at a
data directory (the reference ships `model_data/SMARMN|SMARM2`).
"""
from __future__ import annotations

import numpy as np

from .model import SeismicModel

__all__ = ["demo_model", "load_velocity"]


def load_velocity(path, shape, dtype=np.float32):
    """Read a raw little-endian float32 velocity model (reference
    ``model_data/*/REAMDE.txt`` format: row-major (nx, nz))."""
    v = np.fromfile(path, dtype=np.float32).astype(dtype)
    v = v.reshape(shape)
    if v.max() > 100.0:
        # reference binaries store m/s (SMARMN vp.true is 1500..5200);
        # the framework works in km/s like the reference drivers
        # (marmousi_fwi.py:70-71 divides by 1000)
        v = v / 1000.0
    return v


def _vendored_marmousi():
    """Path to the vendored SMARMN truth model (km/s after /1000 by the
    caller; raw file is m/s). Raises if the data dir is absent."""
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "model_data", "SMARMN", "vp.true")
    if not os.path.exists(path):
        raise FileNotFoundError(
            "no data_path given and vendored model_data/SMARMN/vp.true "
            "not found at %s" % path)
    return path


def _layered_v(shape, dtype, vp_top, vp_bottom, nlayers):
    v = np.empty(shape, dtype=dtype)
    v[:] = vp_top
    vp_i = np.linspace(vp_top, vp_bottom, nlayers)
    for i in range(1, nlayers):
        v[..., i * int(shape[-1] / nlayers):] = vp_i[i]
    return v


def demo_model(preset, **kwargs):
    space_order = kwargs.pop("space_order", 2)
    shape = kwargs.pop("shape", (101, 101))
    spacing = kwargs.pop("spacing", tuple(10.0 for _ in shape))
    origin = kwargs.pop("origin", tuple(0.0 for _ in shape))
    nbl = kwargs.pop("nbl", 10)
    dtype = kwargs.pop("dtype", np.float32)
    vp = kwargs.pop("vp", 1.5)
    nlayers = kwargs.pop("nlayers", 3)
    fs = kwargs.pop("fs", False)
    preset = preset.lower()

    if preset == "constant-isotropic":
        return SeismicModel(space_order=space_order, vp=vp, origin=origin,
                            shape=shape, dtype=dtype, spacing=spacing, nbl=nbl,
                            fs=fs, **kwargs)

    if preset == "constant-elastic":
        return SeismicModel(space_order=space_order, vp=vp, vs=0.5 * vp, b=1.0,
                            origin=origin, shape=shape, dtype=dtype,
                            spacing=spacing, nbl=nbl, **kwargs)

    if preset == "constant-viscoelastic":
        qp = kwargs.pop("qp", 100.0)
        vs = kwargs.pop("vs", 1.2)
        qs = kwargs.pop("qs", 70.0)
        return SeismicModel(space_order=space_order, vp=vp, qp=qp, vs=vs,
                            qs=qs, b=1 / 2.0, origin=origin, shape=shape,
                            dtype=dtype, spacing=spacing, nbl=nbl, **kwargs)

    if preset == "constant-viscoacoustic":
        qp = kwargs.pop("qp", 100.0)
        return SeismicModel(space_order=space_order, vp=vp, qp=qp, b=1 / 2.0,
                            nbl=nbl, dtype=dtype, origin=origin, shape=shape,
                            spacing=spacing, **kwargs)

    if preset == "constant-tti":
        v = np.full(shape, 1.5, dtype=dtype)
        epsilon = 0.3 * np.ones(shape, dtype=dtype)
        delta = 0.2 * np.ones(shape, dtype=dtype)
        theta = 0.7 * np.ones(shape, dtype=dtype)
        phi = 0.35 * np.ones(shape, dtype=dtype) if len(shape) > 2 else None
        return SeismicModel(space_order=space_order, vp=v, origin=origin,
                            shape=shape, dtype=dtype, spacing=spacing, nbl=nbl,
                            epsilon=epsilon, delta=delta, theta=theta, phi=phi,
                            bcs="damp", **kwargs)

    if preset == "layers-isotropic":
        vp_top = kwargs.pop("vp_top", 1.5)
        vp_bottom = kwargs.pop("vp_bottom", 3.5)
        v = _layered_v(shape, dtype, vp_top, vp_bottom, nlayers)
        return SeismicModel(space_order=space_order, vp=v, origin=origin,
                            shape=shape, dtype=dtype, spacing=spacing, nbl=nbl,
                            bcs="damp", fs=fs, **kwargs)

    if preset == "layers-elastic":
        vp_top = kwargs.pop("vp_top", 1.5)
        vp_bottom = kwargs.pop("vp_bottom", 3.5)
        v = _layered_v(shape, dtype, vp_top, vp_bottom, nlayers)
        vs = 0.5 * v[:]
        b = 1 / (0.31 * (1e3 * v) ** 0.25)  # Gardner relation
        b[v < 1.51] = 1.0
        vs[v < 1.51] = 0.0
        return SeismicModel(space_order=space_order, vp=v, vs=vs, b=b,
                            origin=origin, shape=shape, dtype=dtype,
                            spacing=spacing, nbl=nbl, **kwargs)

    if preset in ("layers-viscoelastic", "twolayer-viscoelastic",
                  "2layer-viscoelastic"):
        # Two-layer viscoelastic model (reference preset_models.py:152-196)
        ratio = kwargs.pop("ratio", 3)
        vals = dict(vp=(kwargs.pop("vp_top", 1.6), kwargs.pop("vp_bottom", 2.2)),
                    qp=(kwargs.pop("qp_top", 40.), kwargs.pop("qp_bottom", 100.)),
                    vs=(kwargs.pop("vs_top", 0.4), kwargs.pop("vs_bottom", 1.2)),
                    qs=(kwargs.pop("qs_top", 30.), kwargs.pop("qs_bottom", 70.)),
                    b=(kwargs.pop("b_top", 1 / 1.3), kwargs.pop("b_bottom", 1 / 2.)))
        fields = {}
        for name, (top, bottom) in vals.items():
            f = np.full(shape, top, dtype=dtype)
            f[..., int(shape[-1] / ratio):] = bottom
            fields[name] = f
        return SeismicModel(space_order=space_order, origin=origin,
                            shape=shape, dtype=dtype, spacing=spacing,
                            nbl=nbl, **fields, **kwargs)

    if preset == "layers-viscoacoustic":
        vp_top = kwargs.pop("vp_top", 1.5)
        vp_bottom = kwargs.pop("vp_bottom", 3.5)
        v = _layered_v(shape, dtype, vp_top, vp_bottom, nlayers)
        qp = 3.516 * ((v * 1000.0) ** 2.2) * 1e-6  # Li & Gurevich relation
        b = 1 / (0.31 * (1e3 * v) ** 0.25)
        return SeismicModel(space_order=space_order, vp=v, qp=qp, b=b,
                            origin=origin, shape=shape, dtype=dtype,
                            spacing=spacing, nbl=nbl, **kwargs)

    if preset == "layers-tti":
        vp_top = kwargs.pop("vp_top", 1.5)
        vp_bottom = kwargs.pop("vp_bottom", 3.5)
        v = _layered_v(shape, dtype, vp_top, vp_bottom, nlayers)
        epsilon = 0.3 * (v - 1.5)
        delta = 0.2 * (v - 1.5)
        theta = 0.5 * (v - 1.5)
        phi = 0.25 * (v - 1.5) if len(shape) > 2 else None
        model = SeismicModel(space_order=space_order, vp=v, origin=origin,
                             shape=shape, dtype=dtype, spacing=spacing,
                             nbl=nbl, epsilon=epsilon, delta=delta,
                             theta=theta, phi=phi, bcs="damp", **kwargs)
        if kwargs.get("smooth", False):
            names = ("epsilon", "delta", "theta") if len(shape) == 2 else \
                ("epsilon", "delta", "theta", "phi")
            model.smooth(names)
        return model

    if preset == "circle-isotropic":
        # Camembert model (reference seismic/preset_models.py:231-251)
        vp_circle = kwargs.pop("vp_circle", 3.0)
        vp_background = kwargs.pop("vp_background", 2.5)
        r = kwargs.pop("r", 15)
        assert len(shape) == 2
        v = np.empty(shape, dtype=dtype)
        v[:] = vp_background
        a, b = shape[0] / 2, shape[1] / 2
        y, x = np.ogrid[-a:shape[0] - a, -b:shape[1] - b]
        v[x * x + y * y <= r * r] = vp_circle
        kwargs.pop("grid", None)  # devito grid-sharing arg; not needed here
        return SeismicModel(space_order=space_order, vp=v, origin=origin,
                            shape=shape, dtype=dtype, spacing=spacing, nbl=nbl,
                            bcs="damp", fs=fs, **kwargs)

    if preset in ("marmousi-isotropic", "marmousi2d-isotropic"):
        # SMARMN-format raw binary (reference marmousi_fwi.py:62-71);
        # defaults to the vendored repo-root model_data/SMARMN/vp.true
        data_path = kwargs.pop("data_path", None) or _vendored_marmousi()
        shape = kwargs.pop("marmousi_shape", (300, 106))
        spacing = kwargs.pop("marmousi_spacing", (30.0, 30.0))
        v = load_velocity(data_path, shape, dtype)
        return SeismicModel(space_order=space_order, vp=v, origin=origin,
                            shape=shape, dtype=dtype, spacing=spacing, nbl=nbl,
                            bcs="damp", **kwargs)

    if preset in ("marmousi-tti2d", "marmousi-tti3d", "marmousi-tti"):
        # TTI Marmousi (reference preset_models.py marmousi-tti*): vp from
        # the raw binary, Thomsen/tilt fields derived from vp where the
        # reference's devitocodes/data .mat fields are unavailable
        data_path = kwargs.pop("data_path", None) or _vendored_marmousi()
        shape2d = kwargs.pop("marmousi_shape", (300, 106))
        spacing = kwargs.pop("marmousi_spacing", (30.0, 30.0))
        v = load_velocity(data_path, shape2d, dtype) / 1.0
        if preset == "marmousi-tti3d":
            ny = kwargs.pop("ny", 21)
            v = np.repeat(v[:, None, :], ny, axis=1)
            spacing = (spacing[0], spacing[0], spacing[1])
        shape = v.shape
        epsilon = (0.2 * (v - v.min()) / max(v.max() - v.min(), 1e-6)
                   ).astype(dtype)
        delta = (0.5 * epsilon).astype(dtype)
        theta = (0.5 * epsilon).astype(dtype)
        phi = (0.25 * epsilon).astype(dtype) if len(shape) == 3 else None
        # re-derive the origin from the FINAL shape (the reference does
        # the same, preset_models.py:322) — the default popped earlier is
        # a 2-tuple and would leave a 3-D model with a 2-D origin
        if len(origin) != len(shape):
            origin = tuple([0.0] * len(shape))
        return SeismicModel(space_order=space_order, vp=v, origin=origin,
                            shape=shape, dtype=dtype, spacing=spacing,
                            nbl=nbl, epsilon=epsilon, delta=delta,
                            theta=theta, phi=phi, bcs="damp", **kwargs)

    raise ValueError("Unknown model preset name: %s" % preset)
