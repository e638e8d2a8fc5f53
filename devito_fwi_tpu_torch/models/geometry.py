"""Acquisition geometry: source/receiver layouts + time axis.

API-parity re-implementation of the reference ``AcquisitionGeometry``
(``seismic/utils.py:50-189``) and the default layouts ``setup_geometry`` /
``setup_rec_coords`` (``seismic/utils.py:12-47``). Pure host-side metadata;
device index/weight tables are derived in ``ops.interp``.
"""
from __future__ import annotations

import numpy as np

from .timeaxis import TimeAxis
from .sources import PointSource, sources

__all__ = ["AcquisitionGeometry", "setup_geometry", "setup_rec_coords",
           "seismic_args"]


def setup_geometry(model, tn, f0=0.010):
    src_coordinates = np.empty((1, model.dim))
    src_coordinates[0, :] = np.array(model.domain_size) * 0.5
    if model.dim > 1:
        src_coordinates[0, -1] = model.origin[-1] + model.spacing[-1]
    rec_coordinates = setup_rec_coords(model)
    return AcquisitionGeometry(model, rec_coordinates, src_coordinates,
                               t0=0.0, tn=tn, src_type="Ricker", f0=f0)


def setup_rec_coords(model):
    nrecx = model.shape[0]
    recx = np.linspace(model.origin[0], model.domain_size[0], nrecx)
    if model.dim == 1:
        return recx.reshape((nrecx, 1))
    elif model.dim == 2:
        rec_coordinates = np.empty((nrecx, model.dim))
        rec_coordinates[:, 0] = recx
        rec_coordinates[:, -1] = model.origin[-1] + 2 * model.spacing[-1]
        return rec_coordinates
    else:
        nrecy = model.shape[1]
        recy = np.linspace(model.origin[1], model.domain_size[1], nrecy)
        rec_coordinates = np.empty((nrecx * nrecy, model.dim))
        rec_coordinates[:, 0] = np.repeat(recx, nrecy)
        rec_coordinates[:, 1] = np.tile(recy, nrecx)
        rec_coordinates[:, -1] = model.origin[-1] + 2 * model.spacing[-1]
        return rec_coordinates


class AcquisitionGeometry:
    """Source/receiver positions, recording window, and source signature."""

    def __init__(self, model, rec_positions, src_positions, t0, tn, **kwargs):
        self.rec_positions = np.reshape(rec_positions, (-1, model.dim))
        self._nrec = self.rec_positions.shape[0]
        self.src_positions = np.reshape(src_positions, (-1, model.dim))
        self._nsrc = self.src_positions.shape[0]
        self._src_type = kwargs.get("src_type")
        assert self.src_type in sources or self.src_type is None
        self._f0 = kwargs.get("f0")
        self._a = kwargs.get("a", None)
        self._t0w = kwargs.get("t0w", None)
        if self._src_type is not None and self._f0 is None:
            raise ValueError("Peak frequency must be provided in kHz for "
                             "source of type %s" % self._src_type)
        self._model = model
        self._dt = model.critical_dt
        self._t0 = t0
        self._tn = tn
        self._src_data = kwargs.get("src_data", None)
        self._filter = kwargs.get("filter", None)

    def resample(self, dt):
        self._dt = dt
        return self

    @property
    def time_axis(self):
        return TimeAxis(start=self.t0, stop=self.tn, step=self.dt)

    @property
    def src_type(self):
        return self._src_type

    @property
    def model(self):
        return self._model

    @property
    def f0(self):
        return self._f0

    @property
    def tn(self):
        return self._tn

    @property
    def t0(self):
        return self._t0

    @property
    def dt(self):
        return self._dt

    @property
    def nt(self):
        return self.time_axis.num

    @property
    def nrec(self):
        return self._nrec

    @property
    def nsrc(self):
        return self._nsrc

    @property
    def dtype(self):
        return self._model.dtype

    @property
    def rec(self):
        return self.new_rec()

    def new_rec(self, name="rec"):
        return PointSource(name=name, time_range=self.time_axis,
                           npoint=self.nrec, coordinates=self.rec_positions,
                           dtype=self.dtype)

    @property
    def adj_src(self):
        """Time-reversed source wavelet placed at every receiver
        (reference ``seismic/utils.py:153-164``)."""
        if self.src_type is None:
            return self.new_rec()
        adj_src = sources[self.src_type](name="rec", f0=self.f0,
                                         time_range=self.time_axis,
                                         npoint=self.nrec,
                                         coordinates=self.rec_positions,
                                         t0=self._t0w, a=self._a,
                                         dtype=self.dtype)
        adj_src.data[:] = adj_src.wavelet[::-1, None]
        return adj_src

    @property
    def src(self):
        return self.new_src()

    def new_src(self, name="src", src_type="self"):
        if self.src_type is None or src_type is None:
            return PointSource(name=name, time_range=self.time_axis,
                               npoint=self.nsrc, coordinates=self.src_positions,
                               dtype=self.dtype)
        source = sources[self.src_type](name=name, f0=self.f0,
                                        time_range=self.time_axis,
                                        npoint=self.nsrc,
                                        coordinates=self.src_positions,
                                        t0=self._t0w, a=self._a,
                                        dtype=self.dtype)
        if self._filter is not None:
            # df in Hz from dt in ms (reference seismic/utils.py:181-185)
            self._filter.df = 1000 / self._dt
            for i in range(self.nsrc):
                source.data[:, i] = self._filter(source.data[:, i])
        return source


def seismic_args(description):
    """Shared CLI for the example scripts (reference
    ``seismic/utils.py:195-230``). The devito-specific ``-opt``/``-a``
    compiler knobs are accepted for flag parity but ignored — XLA owns
    those decisions here."""
    from argparse import ArgumentParser, Action

    class _dtype_store(Action):
        def __call__(self, parser, args, values, option_string=None):
            values = {"float32": np.float32, "float64": np.float64}[values]
            setattr(args, self.dest, values)

    parser = ArgumentParser(description=description)
    parser.add_argument("-nd", dest="ndim", default=3, type=int,
                        help="Number of dimensions")
    parser.add_argument("-d", "--shape", default=(51, 51, 51), type=int,
                        nargs="+",
                        help="Number of grid points along each axis")
    parser.add_argument("-f", "--full", default=False, action="store_true",
                        help="Execute all operators and store the forward "
                             "wavefield")
    parser.add_argument("-so", "--space_order", default=4, type=int,
                        help="Space order of the simulation")
    parser.add_argument("--nbl", default=40, type=int,
                        help="Number of boundary layers around the domain")
    parser.add_argument("--constant", default=False, action="store_true",
                        help="Constant velocity model, default is a two "
                             "layer model")
    parser.add_argument("--checkpointing", default=False,
                        action="store_true",
                        help="Use wavefield checkpointing (segment "
                             "recompute) for the gradient")
    parser.add_argument("-opt", default="advanced",
                        help="accepted for reference-CLI parity (ignored)")
    parser.add_argument("-a", "--autotune", default="off",
                        help="accepted for reference-CLI parity (ignored)")
    parser.add_argument("-tn", "--tn", default=0, type=float,
                        help="Simulation time in millisecond")
    parser.add_argument("-dtype", action=_dtype_store, dest="dtype",
                        default=np.float32,
                        choices=["float32", "float64"])
    return parser
