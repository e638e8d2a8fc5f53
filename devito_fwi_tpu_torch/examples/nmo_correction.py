"""NMO correction of a synthetic CMP gather:

    python -m devito_fwi_tpu_torch.examples.nmo_correction

Port of ``examples/nmo_correction.py`` (the reference tutorial
``tutorials/10_nmo_correction.ipynb``): two hyperbolic Ricker events (t0
0.8 s at 2000 m/s, 2.0 s at 3000 m/s) over 60 offsets to 2950 m, 1000
samples at 4 ms, corrected by ``utils.nmo.nmo_correction`` with the blocky
true velocity profile. Each event's peak times across the offsets must
then spread over 3 samples or fewer. numpy only: nothing runs on a device.
"""
from __future__ import annotations

import numpy as np

from ..utils.nmo import nmo_correction

__all__ = ["ricker", "cmp_gather", "flattening", "main"]

NT, DT = 1000, 0.004
NTRACES = 60
OFFSETS = np.linspace(0.0, 2950.0, NTRACES)
EVENTS = ((0.8, 2000.0), (2.0, 3000.0))  # (t0 s, vnmo m/s)


def ricker(t, f0):
    a = (np.pi * f0 * t) ** 2
    return (1 - 2 * a) * np.exp(-a)


def cmp_gather():
    """(gather (nt, ntraces) float32, vnmo(t0))."""
    t = np.arange(NT) * DT
    gather = np.zeros((NT, NTRACES), np.float32)
    for t0, v in EVENTS:
        for j, x in enumerate(OFFSETS):
            tx = np.sqrt(t0 ** 2 + (x / v) ** 2)
            gather[:, j] += ricker(t - tx, 25.0)
    # v(t0): blocky interval-velocity profile (constant through each event)
    vnmo = np.where(t < 1.4, EVENTS[0][1], EVENTS[1][1])
    return gather, vnmo


def flattening(corrected):
    """[(raw moveout in samples, peak-time spread after NMO)] per event."""
    out = []
    for t0, v in EVENTS:
        win = slice(int((t0 - 0.15) / DT), int((t0 + 0.15) / DT))
        moveout = (np.sqrt(t0 ** 2 + (OFFSETS[-1] / v) ** 2) - t0) / DT
        out.append((moveout, int(np.ptp(np.argmax(corrected[win], axis=0)))))
    return out


def main(argv=None):
    gather, vnmo = cmp_gather()
    corrected = nmo_correction(gather, DT, OFFSETS, vnmo)
    spreads = flattening(corrected)
    for (t0, _), (moveout, after) in zip(EVENTS, spreads):
        print("event t0=%.1fs: raw moveout %.0f samples -> %d after NMO"
              % (t0, moveout, after))
        assert after <= 3
    print("NMO correction flattened both events.")
    return corrected, spreads


if __name__ == "__main__":
    main()
