"""The self-adjoint solver against the 2-D analytic far field:

    python -m devito_fwi_tpu_torch.examples.sa_far_field [--device cpu]

The reference's analytic comparison (``seismic/self_adjoint/
test_wavesolver_iso.py:360-462``, the JAX package's
``tests/test_self_adjoint.py::test_analytic_comparison_2d``): a constant
1.5 km/s wholespace of 401 x 401 cells at 0.5 m with npad 50, float64,
space order 8, nt 1001 at dt 0.1 ms, a 90 Hz Ricker source at the centre,
the w/Q boundary from 0.1 to 1e5, and the receiver 60 m off the source in
x and z. The analytic trace is the 2-D Green's function (Hankel function of
the second kind) convolved with the wavelet, with 20 x temporal padding,
scaled by dx^2 to pressure. The numerical trace must lie within 2% of the
analytic trace's max (``TOLERANCE``).
"""
from __future__ import annotations

import argparse

import numpy as np

from ..models.geometry import AcquisitionGeometry
from ..models.model import SeismicModel
from ..models.sources import ricker_wavelet
from ..ops import self_adjoint as _sa
from ..ops.sa_wavesolver import SaIsoAcousticWaveSolver

__all__ = ["TOLERANCE", "far_field", "main"]

TOLERANCE = 0.02


def far_field(device="cuda"):
    """Run the case on ``device``. Returns (the solver's trace, the
    analytic trace, the forward's ``PerfSummary``, the padded shape)."""
    from scipy.special import hankel2

    nt, dt = 1001, 0.1
    tmax = dt * (nt - 1)
    fpeak = 0.090
    t0w = 1.0 / fpeak
    omega = 2 * np.pi * fpeak
    so, npad, dx = 8, 50, 0.5
    shape = (401, 401)
    v0 = 1.5

    def init_damp(m):
        return _sa.setup_w_over_q(m.padded_shape, omega, 0.1, 1e5, m.nbl,
                                  dtype=np.float64)
    model = SeismicModel(origin=(0., 0.), shape=shape,
                         vp=np.full(shape, v0), b=np.full(shape, 1.0),
                         spacing=(dx, dx), nbl=npad, space_order=so,
                         bcs=init_damp, dtype=np.float64, dt=dt)
    src_coords = np.array([[shape[0] // 2 * dx, shape[1] // 2 * dx]])
    rec_coords = src_coords + 60.0
    geometry = AcquisitionGeometry(model, rec_coords, src_coords, 0.0, tmax,
                                   src_type="Ricker", f0=fpeak)
    solver = SaIsoAcousticWaveSolver(model, geometry, space_order=so,
                                     device=device)
    rec, _, summary = solver.forward()

    # u(r, t) = ifft(-i pi H0^2(w r / v) q(w)) / (2 pi)
    sx, sz = src_coords[0]
    rx, rz = rec_coords[0]
    ntpad = 20 * (nt - 1) + 1
    tmaxpad = dt * (ntpad - 1)
    tpad = np.linspace(0, tmaxpad, ntpad)
    wav = ricker_wavelet(tpad, fpeak, t0w)
    nf = ntpad // 2 + 1
    faxis = np.arange(nf) / tmaxpad
    R = np.fft.fft(wav)[:nf]
    U_a = np.zeros(nf, dtype=complex)
    r = np.sqrt((rx - sx) ** 2 + (rz - sz) ** 2)
    w = 2 * np.pi * faxis[1:nf - 1]
    U_a[1:nf - 1] = -1j * np.pi * hankel2(0.0, w * r / v0) * R[1:nf - 1]
    u_ana = (np.real(np.fft.ifft(U_a, ntpad))[:nt] / (2 * np.pi)) * dx ** 2
    return rec.data[:, 0].copy(), u_ana, summary, model.padded_shape


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    got, want, summary, padded = far_field(args.device)
    err = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"padded {padded}: max|numerical - analytic| / max = {err:.4e} "
          f"(limit {TOLERANCE}); forward {summary.elapsed:.3f} s")
    if not err < TOLERANCE:
        raise SystemExit("the far field is off the analytic trace")
    return err


if __name__ == "__main__":
    main()
