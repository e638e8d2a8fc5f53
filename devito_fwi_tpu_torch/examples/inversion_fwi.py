"""Camembert FWI example with the reference's golden values:

    python -m devito_fwi_tpu_torch.examples.inversion_fwi [--device cpu]

Port of ``examples/inversion_fwi.py`` (the reference's
``seismic/inversion/fwi.py``): a 2-D circle anomaly (101 x 101 at 10 m,
nbl 40), 9 shots, 101 receivers on the vertical line x = 980 m, acoustic
modeling through ``AcousticWaveSolver`` (space order 4, the eager
operators), L2 misfit, the adjoint-state gradient, and plain gradient
descent with a box constraint (``update_with_box``). Golden values
(reference :95-97,121): first objective ~39113, gradient min / max
~-821 / +2442, misfit at the 5th iteration ~3828 (atol 10).

``main`` models each shot's observed data once and reuses it in every
iteration (the example models it anew each time, with the same result),
and the first iteration reuses the gradient it checks the goldens on.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..inversion import compute_residual, update_with_box
from ..models.geometry import AcquisitionGeometry
from ..models.presets import demo_model
from ..ops.wavesolver import AcousticWaveSolver

__all__ = ["GOLDEN", "ATOL", "setup", "fwi_gradient", "main"]

NSHOTS = 9
NRECEIVERS = 101
FWI_ITERATIONS = 5
# reference seismic/inversion/fwi.py:95-97,121
GOLDEN = dict(objective=39113.0, grad_min=-821.0, grad_max=2442.0,
              last_misfit=3828.0)
ATOL = 10.0


def setup(device="cuda", nshots=NSHOTS, nreceivers=NRECEIVERS):
    """(true model, starting model, solver, source locations)."""
    shape, spacing, origin = (101, 101), (10., 10.), (0., 0.)
    model = demo_model("circle-isotropic", vp_circle=3.0, vp_background=2.5,
                       origin=origin, shape=shape, spacing=spacing, nbl=40)
    model0 = demo_model("circle-isotropic", vp_circle=2.5,
                        vp_background=2.5, origin=origin, shape=shape,
                        spacing=spacing, nbl=40)
    src_coordinates = np.empty((1, 2))
    src_coordinates[0, :] = np.array(model.domain_size) * .5
    src_coordinates[0, 0] = 20.
    rec_coordinates = np.empty((nreceivers, 2))
    rec_coordinates[:, 1] = np.linspace(0, model.domain_size[0],
                                        num=nreceivers)
    rec_coordinates[:, 0] = 980.
    geometry = AcquisitionGeometry(model, rec_coordinates, src_coordinates,
                                   0., 1000., f0=0.010, src_type="Ricker")
    solver = AcousticWaveSolver(model, geometry, space_order=4,
                                device=device)
    source_locations = np.empty((nshots, 2), dtype=np.float32)
    source_locations[:, 0] = 20.
    source_locations[:, 1] = np.linspace(0., 1000, num=nshots)
    return model, model0, solver, source_locations


def fwi_gradient(solver, model, source_locations, vp_in, d_obs=None):
    """(objective, gradient (padded grid, float64)) of the L2 misfit over
    the shots at ``vp_in``. ``d_obs`` (a dict shot -> observed data) is
    filled on first use and read after."""
    d_obs = {} if d_obs is None else d_obs
    grad = np.zeros(model.padded_shape, dtype=np.float64)
    objective = 0.
    for i in range(source_locations.shape[0]):
        solver.geometry.src_positions[0, :] = source_locations[i, :]
        if i not in d_obs:
            d_obs[i] = solver.forward(vp=model.vp)[0]
        d_syn, u0, _ = solver.forward(vp=vp_in, save=True)
        residual = compute_residual(solver.geometry.rec, d_obs[i], d_syn)
        objective += .5 * np.linalg.norm(residual.data) ** 2
        g, _ = solver.jacobian_adjoint(residual, u0, vp=vp_in)
        grad += np.asarray(g, dtype=np.float64)
    return objective, grad


def main(device="cuda", iterations=FWI_ITERATIONS):
    """Run the example: (misfit history of ``iterations`` gradient-descent
    iterations, the first gradient's min, its max). With ``iterations`` 0
    only the first gradient is computed and the history is empty."""
    model, model0, solver, source_locations = setup(device)
    d_obs = {}
    ff, update = fwi_gradient(solver, model, source_locations, model0.vp,
                              d_obs)
    history = np.zeros(iterations)
    for i in range(iterations):
        phi, direction = (ff, update) if i == 0 else fwi_gradient(
            solver, model, source_locations, model0.vp, d_obs)
        history[i] = phi
        alpha = .05 / direction.max()
        update_with_box(model0.vp, alpha, direction)
        print("Objective value is %f at iteration %d" % (phi, i + 1))
    return history, float(update.min()), float(update.max()), ff


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args()
    history, gmin, gmax, ff = main(args.device)
    print("objective %f  grad min %f max %f" % (ff, gmin, gmax))
    assert np.isclose(ff, GOLDEN["objective"], atol=ATOL, rtol=0)
    assert np.isclose(gmin, GOLDEN["grad_min"], atol=ATOL, rtol=0)
    assert np.isclose(gmax, GOLDEN["grad_max"], atol=ATOL, rtol=0)
    assert np.isclose(history[-1], GOLDEN["last_misfit"], atol=ATOL, rtol=0)
    print("camembert inversion regression PASSED")
