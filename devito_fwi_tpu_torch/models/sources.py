"""Sparse point sources/receivers and analytic source wavelets.

The reference binds these to devito ``SparseTimeFunction`` symbols
(``seismic/source.py:78-351``). Here they are plain data containers: a
``PointSource`` is just ``(data[nt, npoint], coordinates[npoint, ndim],
time_range)``. All device-side scatter/gather happens in ``ops.interp`` from
precomputed index/weight tables, so the containers stay framework-agnostic
and cheaply picklable.
"""
from __future__ import annotations

import numpy as np
from scipy import interpolate

from .timeaxis import TimeAxis

__all__ = ["PointSource", "Receiver", "Shot", "WaveletSource", "RickerSource",
           "GaborSource", "DGaussSource", "sources",
           "ricker_wavelet", "gabor_wavelet", "dgauss_wavelet"]


# ---------------------------------------------------------------------------
# wavelets (pure functions; reference: seismic/source.py:272-351)
# ---------------------------------------------------------------------------

def ricker_wavelet(time_values, f0, t0=None, a=None):
    t0 = t0 or 1.0 / f0
    a = a or 1.0
    r = np.pi * f0 * (time_values - t0)
    return a * (1.0 - 2.0 * r**2) * np.exp(-r**2)


def gabor_wavelet(time_values, f0, t0=None, a=None):
    agauss = 0.5 * f0
    tcut = t0 or 1.5 / agauss
    s = (time_values - tcut) * agauss
    a = a or 1.0
    return a * np.exp(-2 * s**2) * np.cos(2 * np.pi * s)


def dgauss_wavelet(time_values, f0, t0=None, a=None):
    t0 = t0 or 1.0 / f0
    a = a or 1.0
    t = time_values - t0
    return -2.0 * a * t * np.exp(-a * t**2)


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------

class PointSource:
    """A set of sparse space-time points with a data buffer (nt, npoint)."""

    def __init__(self, name="src", grid=None, time_range=None, npoint=None,
                 coordinates=None, data=None, dtype=np.float32):
        if time_range is None:
            raise TypeError("time_range is required")
        if npoint is None:
            if coordinates is None:
                raise TypeError("Need either `npoint` or `coordinates`")
            npoint = np.asarray(coordinates).shape[0]
        self.name = name
        self.grid = grid  # kept for API parity; may be None
        self._time_range = time_range._rebuild()
        self.npoint = npoint
        if coordinates is not None:
            coordinates = np.asarray(coordinates, dtype=np.float64).reshape(npoint, -1)
        self.coordinates = coordinates
        self.dtype = dtype
        self.data = np.zeros((time_range.num, npoint), dtype=dtype)
        if data is not None:
            self.data[:] = np.asarray(data, dtype=dtype)

    @property
    def time_range(self):
        return self._time_range

    @property
    def time_values(self):
        return self._time_range.time_values

    @property
    def nt(self):
        return self._time_range.num

    def resample(self, dt=None, num=None, rtol=1e-5, order=3):
        """Cubic-spline trace resampling (reference ``seismic/source.py:140-170``)."""
        if dt is None:
            assert num is not None
        else:
            assert num is None
        start, stop = self._time_range.start, self._time_range.stop
        dt0 = self._time_range.step
        if dt is None:
            new_time_range = TimeAxis(start=start, stop=stop, num=num)
            dt = new_time_range.step
        else:
            new_time_range = TimeAxis(start=start, stop=stop, step=dt)
        if np.isclose(dt, dt0):
            return self
        nsamples, ntraces = self.data.shape
        new_traces = np.zeros((new_time_range.num, ntraces))
        for i in range(ntraces):
            tck = interpolate.splrep(self._time_range.time_values,
                                     self.data[:, i], k=order)
            new_traces[:, i] = interpolate.splev(new_time_range.time_values, tck)
        return PointSource(name=self.name, grid=self.grid, data=new_traces,
                           time_range=new_time_range, coordinates=self.coordinates,
                           dtype=self.dtype)


Receiver = PointSource
Shot = PointSource


class WaveletSource(PointSource):
    """Point source carrying an analytic wavelet in every trace
    (reference ``seismic/source.py:181-245``)."""

    wavelet_fn = None

    def __init__(self, name="src", grid=None, time_range=None, npoint=1,
                 coordinates=None, f0=None, a=None, t0=None, dtype=np.float32,
                 **kwargs):
        if coordinates is not None:
            coords = np.asarray(coordinates)
            if coords.ndim == 1:
                coords = coords.reshape(1, -1)
            coordinates = coords.reshape(-1, coords.shape[-1])
            npoint = coordinates.shape[0]
        super().__init__(name=name, grid=grid, time_range=time_range,
                         npoint=npoint, coordinates=coordinates, dtype=dtype)
        self.f0 = f0
        self.a = a
        self.t0 = t0
        for p in range(self.npoint):
            self.data[:, p] = self.wavelet

    @property
    def wavelet(self):
        if self.wavelet_fn is None:
            raise NotImplementedError("Wavelet not defined")
        return type(self).wavelet_fn(self.time_values, self.f0, self.t0, self.a)


class RickerSource(WaveletSource):
    wavelet_fn = staticmethod(ricker_wavelet)


class GaborSource(WaveletSource):
    wavelet_fn = staticmethod(gabor_wavelet)


class DGaussSource(WaveletSource):
    wavelet_fn = staticmethod(dgauss_wavelet)


sources = {"Wavelet": WaveletSource, "Ricker": RickerSource, "Gabor": GaborSource}
