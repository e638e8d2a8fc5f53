"""First-order (pressure-velocity) staggered-grid acoustics:

    python -m devito_fwi_tpu_torch.examples.staggered_acoustic [--device cpu]

Port of ``examples/staggered_acoustic.py`` (the reference tutorial
``seismic/tutorials/05_staggered_acoustic.ipynb``): the system

    dv/dt = 1/rho grad(p)        (velocity on half-staggered points)
    dp/dt = rho Vp^2 div(v)      (pressure on nodes)

advanced with the notebook's leapfrog (``v.forward = v + dt/rho *
grad(p)``; ``p.forward = p + dt*rho*Vp^2 * div(v.forward)``), a DGauss
source at the domain centre, in float32 on ``--device`` (cuda by
default). Goldens: ``norm(p) = 0.35098`` at 2nd order in space (the
notebook's; devito's ``norm`` of a ``time_order=1`` TimeFunction covers
both time buffers) and 0.33737 at 4th order with the (9/8, -1/24)
half-point coefficients, each within 1e-4.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..fwi import _resolve_device
from ..models.sources import dgauss_wavelet

__all__ = ["GOLDEN", "staggered_diff", "run", "main"]

# norm(p) by space order (atol 1e-4)
GOLDEN = {2: 0.35098, 4: 0.33737}


def staggered_diff(f, axis, h, so, forward):
    """Staggered first derivative along ``axis`` with a zero halo:
    ``forward=True`` evaluates a node field at i+1/2, ``False`` a staggered
    field at the node i. ``so`` 2 or 4."""
    fp = torch.nn.functional.pad(f, (2, 2) * f.dim())
    n = f.shape[axis]

    def sh(k):
        return fp.narrow(1 - axis, 2, f.shape[1 - axis]).narrow(
            axis, 2 + k, n)

    a, b = (1, 0) if forward else (0, -1)
    if so == 2:
        return (sh(a) - sh(b)) / h
    return (9. / 8. * (sh(a) - sh(b))
            - 1. / 24. * (sh(a + 1) - sh(b - 1))) / h


def run(so, device="cuda", shape=(81, 81), extent=2000., tn=200., vp=4.0,
        density=1.0, f0=0.01, amp=0.004):
    """norm(p) over the last two time buffers at space order ``so``."""
    dev = _resolve_device(device)
    h = extent / (shape[0] - 1)
    dt = 1e2 * (1. / np.sqrt(2.)) / 60.          # notebook's CFL choice
    num = int(np.ceil((tn - 0.) / dt)) + 1
    tv = np.linspace(0., dt * (num - 1), num)
    wav = torch.as_tensor(dgauss_wavelet(tv, f0, a=amp), dtype=torch.float32,
                          device=dev)
    ro = dt / density
    l2m = dt * density * vp * vp
    si = (shape[0] // 2, shape[1] // 2)
    p = vx = vz = torch.zeros(shape, dtype=torch.float32, device=dev)
    for t in range(num - 1):
        vx = vx + ro * staggered_diff(p, 0, h, so, True)
        vz = vz + ro * staggered_diff(p, 1, h, so, True)
        pn = p + l2m * (staggered_diff(vx, 0, h, so, False)
                        + staggered_diff(vz, 1, h, so, False))
        pn[si] += wav[t]
        p_prev, p = p, pn
    # devito norm(p) covers the TimeFunction's two time buffers
    return float(torch.sqrt(torch.sum(p ** 2) + torch.sum(p_prev ** 2)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    norms = {}
    for so, want in GOLDEN.items():
        norms[so] = run(so, args.device)
        print(f"space order {so}: norm(p) = {norms[so]:.5f} (golden "
              f"{want}, atol 1e-4)")
        assert np.isclose(norms[so], want, atol=1e-4, rtol=0), norms[so]
    print("ok")
    return norms


if __name__ == "__main__":
    main()
