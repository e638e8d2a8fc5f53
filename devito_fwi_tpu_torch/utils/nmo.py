"""Normal-moveout (NMO) correction of CMP gathers; the port's copy of
``devito_fwi_tpu.utils.nmo`` (numpy).

Functional port of the reference tutorial
``seismic/tutorials/10_nmo_correction.ipynb``: for a common-midpoint
gather ``cmp[t, trace]`` with per-trace ``offsets`` and a zero-offset
velocity profile ``v(t0)``, the reflection time at offset x is

    t(t0, x) = sqrt(t0^2 + x^2 / v(t0)^2)

and the corrected gather resamples each trace at t(t0, x), as one
vectorised numpy gather. Unlike the notebook, which takes the nearest
sample and maps out-of-range times to sample 0, it interpolates linearly
between samples and mutes out-of-range times to zero.
"""
from __future__ import annotations

import numpy as np

__all__ = ["nmo_correction"]


def nmo_correction(cmp_gather, dt, offsets, velocities):
    """NMO-correct a CMP gather.

    Parameters
    ----------
    cmp_gather : (nt, ntraces) array
        Time-by-trace common-midpoint gather.
    dt : float
        Sample interval in seconds.
    offsets : (ntraces,) array
        Source-receiver offset of each trace (m).
    velocities : (nt,) array
        NMO velocity profile v(t0) in m/s.

    Returns
    -------
    (nt, ntraces) array: the corrected gather; samples whose reflection
    time falls outside the trace are muted to zero.
    """
    cmp_gather = np.asarray(cmp_gather)
    nt, ntraces = cmp_gather.shape
    t0 = np.arange(nt) * dt
    velocities = np.asarray(velocities, dtype=np.float64)
    offsets = np.asarray(offsets, dtype=np.float64)

    # reflection time per (t0, trace)
    t = np.sqrt(t0[:, None] ** 2 +
                (offsets[None, :] / velocities[:, None]) ** 2)
    f = t / dt
    i0 = np.floor(f).astype(np.int64)
    w = (f - i0).astype(cmp_gather.dtype)
    valid = i0 < nt - 1
    i0c = np.clip(i0, 0, nt - 2)
    cols = np.broadcast_to(np.arange(ntraces)[None, :], (nt, ntraces))
    out = (1.0 - w) * cmp_gather[i0c, cols] + w * cmp_gather[i0c + 1, cols]
    return np.where(valid, out, 0.0).astype(cmp_gather.dtype)
