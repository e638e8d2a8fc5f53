"""Deriving (and numerically verifying) the acoustic time update:

    python -m devito_fwi_tpu_torch.examples.time_update [--device cpu]

Port of ``examples/time_update.py`` (the reference's derivation notebook
``seismic/acoustic/acoustic_time_update_nb.ipynb``), which works the
Cerjan-damped constant-density acoustic system

    m d2u/dt2 + eta du/dt = laplacian(u) + q

into the explicit update its operator implements: with the centred
d2u/dt2 and the forward 1st-order du/dt,

    u[t+1] = ( dt^2 (lap + q) + (2 m + dt eta) u[t] - m u[t-1] )
             / (m + dt eta)

The port's update (``ops/acoustic._update``) is this expression with
``hd = dt*eta`` and the reciprocal hoisted. Three numerical checks, on
``--device`` (cuda by default):

1. the derived right-hand side equals ``_update`` within 1e-6 of its max
   on random float32 fields (the same algebra, associated differently);
2. solving the damped PDE's residual for u[t+1] with a generic root find
   (one Newton step: the residual is affine in u[t+1]) gives the same
   update within 1e-5 of its max;
3. the scheme self-converges at 2nd order in dt on a smooth standing wave
   (float64, undamped): each observed order above 1.8.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..fwi import _resolve_device
from ..ops.acoustic import _make_lap, _prep, _update

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    dev = _resolve_device(args.device)

    def T(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    rng = np.random.RandomState(3)
    shape = (40, 40)
    vp = T(1.5 + rng.rand(*shape).astype(np.float32))
    damp = T(rng.rand(*shape).astype(np.float32) * 0.3)
    dt, spacing = 1.1, (10.0, 10.0)
    u = T(rng.randn(*shape).astype(np.float32))
    up = T(rng.randn(*shape).astype(np.float32))
    q = T(rng.randn(*shape).astype(np.float32))

    w, inv_h2, m, s2, hd, inv_mhd = _prep(vp, damp, dt, spacing, 4)
    lap = _make_lap(m, w, inv_h2, False, "OT2", s2)(u)

    # 1. the derived closed form == the port's _update
    eta = damp
    derived = (dt * dt * (lap + q) + (2 * m + dt * eta) * u - m * up) \
        / (m + dt * eta)
    prod = _update(u, up, lap, q, m, hd, s2, inv_mhd)
    d1 = float((derived - prod).abs().max() / prod.abs().max())
    print(f"derived formula vs _update: max rel {d1:.2e} (limit 1e-6)")
    assert d1 < 1e-6, d1

    # 2. no algebra: solve R(un) = m(un - 2u + up)/dt^2 + eta(un - u)/dt
    #    - lap - q = 0 for un; R is affine, so one Newton step from 0
    r0 = (m * (-2 * u + up) / dt ** 2 + eta * (-u) / dt - lap - q)
    un_solved = -r0 / (m / dt ** 2 + eta / dt)
    d2 = float((un_solved - prod).abs().max() / prod.abs().max())
    print(f"implicit PDE solve vs _update: max rel {d2:.2e} (limit 1e-5)")
    assert d2 < 1e-5, d2

    # 3. 2nd-order temporal self-convergence on a smooth standing wave
    f64 = torch.float64
    n = 64
    x = np.arange(n) * 10.0
    u0 = T(np.sin(np.pi * x[:, None] / x[-1]) *
           np.sin(np.pi * x[None, :] / x[-1]), f64)
    vpc = torch.full((n, n), 2.0, dtype=f64, device=dev)
    zero = torch.zeros((n, n), dtype=f64, device=dev)

    def run(dt, nsteps):
        w, inv_h2, m, s2, hd, inv_mhd = _prep(vpc, zero, dt, (10., 10.), 4)
        lap_fn = _make_lap(m, w, inv_h2, False, "OT2", s2)
        # 2nd-order leapfrog start-up for du/dt(0) = 0: the Taylor history
        # u(-dt) = u0 + dt^2/(2m) lap(u0)
        u, up = u0, u0 + 0.5 * dt * dt * lap_fn(u0) / m
        for _ in range(nsteps):
            u, up = _update(u, up, lap_fn(u), 0.0, m, hd, s2, inv_mhd), u
        return u

    T_end = 48.0
    errs = []
    for k in (1, 2, 4):
        dt = 1.2 / k
        coarse = run(dt, int(T_end / dt))
        fine = run(dt / 2, int(T_end / (dt / 2)))
        errs.append(float((coarse - fine).abs().max()))
    orders = [np.log2(errs[i] / errs[i + 1]) for i in range(2)]
    print(f"self-convergence errors: {[f'{e:.3e}' for e in errs]}")
    print(f"observed temporal orders: {[f'{o:.2f}' for o in orders]} "
          "(each above 1.8)")
    assert all(o > 1.8 for o in orders), orders
    print("ok")
    return d1, d2, orders


if __name__ == "__main__":
    main()
