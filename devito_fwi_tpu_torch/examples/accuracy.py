"""Accuracy study: the acoustic solver against the analytic wholespace
trace across space orders:

    python -m devito_fwi_tpu_torch.examples.accuracy [--device cpu]
        [--tn 800] [--dtype float64]

Port of ``examples/accuracy.py`` (the reference notebook
``seismic/acoustic/accuracy.ipynb``): a 301 x 301 wholespace at 10 m (vp
1.5 km/s, nbl 40, dt 1 ms), a Ricker source at its centre and one
receiver 500 m away; ``AcousticWaveSolver`` (OT2, eager torch on
``--device``, cuda by default) at space orders 2, 4 and 8 against the 2-D
analytic response (the Hankel function's, ``analytic_trace``), as the
normalized L2 error of each trace. The errors must fall as the order
rises. Float64 by default on the CPU (the JAX example's), float32 on the
card.
"""
from __future__ import annotations

import argparse

import numpy as np
from scipy.special import hankel2

from ..models.geometry import AcquisitionGeometry
from ..models.model import SeismicModel
from ..ops.wavesolver import AcousticWaveSolver

__all__ = ["ORDERS", "analytic_trace", "errors", "main"]

ORDERS = (2, 4, 8)
SHAPE, SPACING = (301, 301), (10., 10.)
VP, DT_MS, F0, OFFSET = 1.5, 1.0, 0.010, 500.0


def analytic_trace(vp, f0, dt, nt, offset):
    """Analytic 2-D wholespace response at ``offset`` for a Ricker source
    (frequency domain: -i pi H0^2(k r) / 4; SI units)."""
    nf = nt // 2 + 1
    freq = np.fft.rfftfreq(nt, dt)
    t = np.arange(nt) * dt
    src = (1 - 2 * (np.pi * f0 * (t - 1.0 / f0)) ** 2) * \
        np.exp(-(np.pi * f0 * (t - 1.0 / f0)) ** 2)
    S = np.fft.rfft(src)
    k = 2 * np.pi * freq / vp
    G = np.zeros(nf, complex)
    G[1:] = -1j * np.pi * hankel2(0, k[1:] * offset) / 4.0
    return np.fft.irfft(S * G, nt)


def trace(so, tn, dtype, device="cuda"):
    """The solver's trace at space order ``so``."""
    model = SeismicModel(origin=(0., 0.), spacing=SPACING, shape=SHAPE,
                         space_order=so, vp=np.full(SHAPE, VP), nbl=40,
                         bcs="damp", dt=DT_MS, dtype=dtype)
    src = np.array([[1500.0, 1500.0]])
    rec = np.array([[1500.0 + OFFSET, 1500.0]])
    geom = AcquisitionGeometry(model, rec, src, 0., tn, f0=F0,
                               src_type="Ricker")
    out, _, _ = AcousticWaveSolver(model, geom, space_order=so,
                                   device=device).forward()
    return np.asarray(out.data)[:, 0]


def errors(tn=800.0, dtype=np.float64, device="cuda"):
    """{space order: normalized L2 error against the analytic trace}."""
    ref = analytic_trace(VP * 1000, F0 * 1000, DT_MS / 1000,
                         int(tn / DT_MS) + 1, OFFSET)
    out = {}
    for so in ORDERS:
        num = trace(so, tn, dtype, device)
        out[so] = float(np.linalg.norm(num / np.abs(num).max()
                                       - ref / np.abs(ref).max())
                        / np.sqrt(len(ref)))
        print("space_order=%d: normalized L2 error vs analytic = %.4f"
              % (so, out[so]))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--tn", type=float, default=800.0)
    p.add_argument("--dtype", choices=["float32", "float64"], default=None,
                   help="default: float64 on the CPU, float32 on the card")
    args = p.parse_args(argv)
    dtype = args.dtype or ("float64" if args.device == "cpu" else "float32")
    errs = errors(args.tn, np.dtype(dtype).type, args.device)
    es = [errs[so] for so in ORDERS]
    assert all(a > b for a, b in zip(es, es[1:])), errs
    print("the error falls with the space order")
    return errs


if __name__ == "__main__":
    main()
