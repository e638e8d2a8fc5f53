"""Physical model: padded parameter grids + absorbing boundary + CFL.

Re-design of the reference ``SeismicModel`` (``seismic/model.py:87-432``)
without devito: parameters live as plain numpy arrays on the *padded* grid
(edge-replicated into the absorbing layers), the damping profile is a numpy
precompute, and the CFL ``critical_dt`` replicates the reference formulas
bit-for-bit (including the ``"%.3e"`` rounding at ``seismic/model.py:365``)
so time axes — and therefore golden regression values — line up.

The model object is host-side and mutable (API parity with
``model.update('vp', v)``); jitted device code receives the raw arrays.
"""
from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter

from ..utils.fd import damping_profile, pad_edge, cfl_coefficient

__all__ = ["SeismicModel", "Model", "ModelElastic", "ModelViscoelastic",
           "ModelViscoacoustic"]


class SeismicModel:
    """
    Parameters mirror the reference (``seismic/model.py:227-314``):

    origin, spacing, shape : physical-domain geometry (unpadded)
    space_order : int — used for CFL; solvers may use their own order
    vp : array (km/s) or float
    nbl : absorbing-layer thickness in points
    fs : free surface at the top of the last axis
    bcs : 'damp' (0 inside, grows in layer) or 'mask' (1 inside, decays)
    dt : optional user time step (must be <= critical_dt)
    kwargs : optional physics — vs (converted to lam/mu), b, qp, qs,
             epsilon, delta, theta, phi
    """

    _known_parameters = ["vp", "damp", "vs", "b", "epsilon", "delta",
                         "theta", "phi", "qp", "qs", "lam", "mu"]

    def __init__(self, origin, spacing, shape, space_order, vp, nbl=20,
                 fs=False, dtype=np.float32, bcs="mask", dt=None, **kwargs):
        self.shape = tuple(int(s) for s in shape)
        self.spacing = tuple(float(s) for s in spacing)
        self.origin = tuple(dtype(o) for o in origin)
        self.space_order = int(space_order)
        self.nbl = int(nbl)
        self.fs = bool(fs)
        self.dtype = dtype
        self._dt = dt
        self._dt_scale = 1.0
        self._physical_parameters = set()
        self._bcs_type = None
        self.damp = None

        self._initialize_bcs(bcs=bcs)
        self._initialize_physics(vp, **kwargs)

    # ------------------------------------------------------------------ grid
    @property
    def dim(self):
        return len(self.shape)

    @property
    def padsizes(self):
        """Padding per dimension; the top of the last axis is unpadded under
        a free surface (reference ``seismic/model.py:151-158``)."""
        pads = [(self.nbl, self.nbl) for _ in range(self.dim - 1)]
        pads.append((0 if self.fs else self.nbl, self.nbl))
        return pads

    @property
    def padded_shape(self):
        return tuple(n + l + r for n, (l, r) in zip(self.shape, self.padsizes))

    @property
    def origin_pml(self):
        """Origin of the padded computational grid."""
        return tuple(o - l * h for o, h, (l, _) in
                     zip(self.origin, self.spacing, self.padsizes))

    @property
    def domain_size(self):
        return tuple((n - 1) * h for n, h in zip(self.shape, self.spacing))

    # ------------------------------------------------------------------- bcs
    def _initialize_bcs(self, bcs="damp"):
        if callable(bcs):
            # custom boundary initializer, e.g. the self-adjoint w/Q field
            # (reference seismic/self_adjoint/example_iso.py:22 passes a
            # callable bcs into Model)
            self.damp = np.asarray(bcs(self), dtype=self.dtype)
            self._bcs_type = "custom"
            self._physical_parameters.add("damp")
            return
        assert bcs in ("damp", "mask")
        if self._bcs_type == "custom":
            # never clobber a callable-initialized boundary field (e.g.
            # the self-adjoint w/Q profile) with a standard one — the
            # reference's re-init value check likewise leaves it alone
            import warnings
            warnings.warn(
                "model carries a custom boundary field; keeping it "
                f"instead of re-initializing bcs='{bcs}'")
            return
        if self.nbl == 0:
            self.damp = 1.0 if bcs == "mask" else 0.0
            self._bcs_type = bcs
            return
        if self._bcs_type != bcs:
            if self._bcs_type is not None:
                # reference model.py warns on damp<->mask re-init too
                import warnings
                warnings.warn(f"re-initializing boundary field "
                              f"'{self._bcs_type}' -> '{bcs}'")
            self.damp = damping_profile(self.padded_shape, self.padsizes,
                                        self.spacing, abc_type=bcs, fs=self.fs,
                                        dtype=self.dtype)
            self._bcs_type = bcs
        self._physical_parameters.add("damp")

    # --------------------------------------------------------------- physics
    def _initialize_physics(self, vp, **kwargs):
        b = kwargs.get("b", 1)
        if "vs" in kwargs:
            vs = kwargs.pop("vs")
            # Lame parametrization, as in reference seismic/model.py:300-305
            self.lam = self._gen_phys_param((vp**2 - 2.0 * vs**2) / b, "lam")
            self.mu = self._gen_phys_param(vs**2 / b, "mu")
        else:
            self.vp = self._gen_phys_param(vp, "vp")
        for name in self._known_parameters:
            if kwargs.get(name) is not None:
                setattr(self, name, self._gen_phys_param(kwargs.get(name), name))

    def _gen_phys_param(self, field, name):
        if field is None:
            return 0
        if isinstance(field, np.ndarray):
            value = pad_edge(field.astype(self.dtype), self.padsizes)
        else:
            value = self.dtype(field)  # scalar parameter (devito Constant)
        self._physical_parameters.add(name)
        return value

    @property
    def physical_parameters(self):
        return tuple(self._physical_parameters)

    def physical_params(self, **kwargs):
        known = {name: getattr(self, name) for name in self.physical_parameters}
        known.update({k: v for k, v in kwargs.items() if v is not None})
        return known

    def update(self, name, value):
        """In-place parameter update, accepting padded or unpadded arrays
        (reference ``seismic/model.py:372-393``)."""
        if not hasattr(self, name):
            setattr(self, name, self._gen_phys_param(value, name))
            return
        param = getattr(self, name)
        if isinstance(value, np.ndarray):
            if isinstance(param, np.ndarray) and value.shape == param.shape:
                param[:] = value.astype(self.dtype)
            elif value.shape == self.shape:
                setattr(self, name, pad_edge(value.astype(self.dtype),
                                             self.padsizes))
            else:
                raise ValueError(
                    "Incorrect input size %s for model %s without or %s with "
                    "padding" % (value.shape, self.shape,
                                 getattr(param, "shape", None)))
        else:
            setattr(self, name, self.dtype(value))

    # ------------------------------------------------------------------- CFL
    @property
    def _is_elastic(self):
        return "lam" in self._physical_parameters or "vs" in self._physical_parameters

    @property
    def _max_vp(self):
        if "vp" in self._physical_parameters:
            return float(np.max(self.vp))
        b = self.b if isinstance(self.b, np.ndarray) else np.float64(self.b)
        return float(np.sqrt(np.min(b) * (np.max(self.lam) + 2 * np.max(self.mu))))

    @property
    def _thomsen_scale(self):
        if "epsilon" in self._physical_parameters:
            return np.sqrt(1 + 2 * float(np.max(self.epsilon)))
        return 1.0

    @property
    def dt_scale(self):
        return self._dt_scale

    @dt_scale.setter
    def dt_scale(self, val):
        self._dt_scale = val

    @property
    def _cfl_coeff(self):
        return cfl_coefficient(self.space_order, self.dim,
                               elastic=self._is_elastic)

    @property
    def critical_dt(self):
        """CFL-critical dt with the reference's 3-significant-digit rounding
        (``seismic/model.py:356-370``)."""
        dt = self._cfl_coeff * np.min(self.spacing) / (self._thomsen_scale *
                                                       self._max_vp)
        dt = self.dtype("%.3e" % (self.dt_scale * dt))
        if self._dt:
            if self._dt > dt:
                raise ValueError("Critical dt: %f, set dt: %f" % (dt, self._dt))
            return self._dt
        return dt

    # --------------------------------------------------------------- helpers
    @property
    def m(self):
        """Squared slowness on the padded grid."""
        return 1.0 / (self.vp * self.vp)

    @property
    def vp_unpadded(self):
        sl = tuple(slice(l, n + l) for (l, _), n in zip(self.padsizes, self.shape))
        return self.vp[sl]

    def crop(self, field):
        """Remove the absorbing-layer padding from a padded-grid array."""
        sl = tuple(slice(l, n + l) for (l, _), n in zip(self.padsizes, self.shape))
        return field[sl]

    def smooth(self, physical_parameters, sigma=5.0):
        """Gaussian-smooth padded parameters in place
        (reference ``seismic/model.py:411-425``)."""
        if isinstance(physical_parameters, str):
            physical_parameters = (physical_parameters,)
        for name in physical_parameters:
            param = getattr(self, name)
            if isinstance(param, np.ndarray):
                setattr(self, name,
                        gaussian_filter(param, sigma=sigma).astype(self.dtype))


# Backward-compatible aliases (reference seismic/model.py:429-432)
Model = SeismicModel
ModelElastic = SeismicModel
ModelViscoelastic = SeismicModel
ModelViscoacoustic = SeismicModel
