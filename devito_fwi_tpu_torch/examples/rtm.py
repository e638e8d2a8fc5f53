"""Reverse-time migration (RTM):

    python -m devito_fwi_tpu_torch.examples.rtm [--device cpu]
        [--nshots 21] [--tn 1000] [--odir result]

Port of ``examples/rtm.py`` (the reference tutorial
``seismic/tutorials/03_rtm.ipynb``): a four-layer 101 x 101 model at 10 m
(space order 4, nbl 40) and its copy smoothed with sigma 4, ``--nshots``
sources along z = 20 m, 101 receivers recording ``--tn`` ms. For each
shot the observed data in the true model, the synthetic data in the
smooth one and their residual's imaging condition,
``solver.jacobian_adjoint(residual, None,
checkpointing=True)`` (segment checkpoints, no saved wavefield), summed
over the shots; the cropped image then goes through ``optimize.math.
nabla2`` against low-wavenumber backscatter and is written as float32 to
``<odir>/rtm_image.bin``. The image must be finite and non-zero. The
solver runs the eager torch operators on ``--device`` (cuda by default).
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..models.geometry import AcquisitionGeometry
from ..models.presets import demo_model
from ..optimize.math import nabla2
from ..ops.wavesolver import AcousticWaveSolver

__all__ = ["setup", "image", "main"]

NRECEIVERS = 101
SHAPE, SPACING = (101, 101), (10., 10.)


def setup(nshots=21, device="cuda", tn=1000.0):
    """(true model, smooth model, solver, source locations) of the JAX
    example."""
    def layers():
        return demo_model("layers-isotropic", shape=SHAPE, spacing=SPACING,
                          nlayers=4, space_order=4, nbl=40)
    model, model0 = layers(), layers()
    model0.smooth("vp", sigma=4)
    src_coordinates = np.array([[500., 20.]])
    rec_coordinates = np.empty((NRECEIVERS, 2))
    rec_coordinates[:, 0] = np.linspace(0, model.domain_size[0], NRECEIVERS)
    rec_coordinates[:, 1] = 20.
    geometry = AcquisitionGeometry(model, rec_coordinates, src_coordinates,
                                   0., tn, f0=0.015, src_type="Ricker")
    solver = AcousticWaveSolver(model, geometry, space_order=4,
                                device=device)
    sources = np.empty((nshots, 2))
    sources[:, 0] = np.linspace(0., model.domain_size[0], nshots)
    sources[:, 1] = 20.
    return model, model0, solver, sources


def image(nshots=21, device="cuda", tn=1000.0):
    """(raw image on the padded grid (float64), filtered cropped image)."""
    model, model0, solver, sources = setup(nshots, device, tn)
    img = np.zeros(model.padded_shape, dtype=np.float64)
    for loc in sources:
        solver.geometry.src_positions[0, :] = loc
        d_obs, _, _ = solver.forward(vp=model.vp)
        residual = solver.geometry.rec
        d_obs_data = d_obs.data.copy()
        d_syn, _, _ = solver.forward(vp=model0.vp)
        residual.data[:] = d_syn.data - d_obs_data
        # imaging condition: sum_t u0.dt2 * v (checkpointed, no saved field)
        g, _ = solver.jacobian_adjoint(residual, None, vp=model0.vp,
                                       checkpointing=True)
        img += np.asarray(g, dtype=np.float64)
    return img, nabla2(model.crop(img))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--nshots", type=int, default=21)
    p.add_argument("--tn", type=float, default=1000.0)
    p.add_argument("--odir", type=str, default="result")
    args = p.parse_args(argv)
    _, img_f = image(args.nshots, args.device, args.tn)
    os.makedirs(args.odir, exist_ok=True)
    out = os.path.join(args.odir, "rtm_image.bin")
    img_f.astype(np.float32).tofile(out)
    print("RTM image written to", out,
          "| energy below first interface: %.3e" % np.abs(img_f[:, 30:]).max())
    assert np.isfinite(img_f).all() and np.abs(img_f).max() > 0
    return img_f


if __name__ == "__main__":
    main()
