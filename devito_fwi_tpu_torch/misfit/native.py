"""ctypes bindings for the native C++ BFM W2-2d solver (the repo's
``native/bfm2d.cpp``); port of ``devito_fwi_tpu.misfit.native``.

The in-process counterpart of the reference's native misfit stack: the
``bfm2d`` subprocess binary built from ``misfit/QW2D/src``, its
``ctransform``/``pushforward`` kernels, and the MPI ``mpibfm2d`` batch binary
(an OpenMP batch here). An exact sequential convex hull with float64
internals: the host-side anchor of the batch BFM of ``misfit.bfm``.

The shared library is compiled with the C++ compiler (``$CXX``, else
``g++``) and the flags of ``native/Makefile`` at first use, into the port's
git-ignored ``_build/`` directory under a name that carries a digest of the
source, the compiler and the flags; a temporary file is renamed into place,
so a concurrent process never loads a partial library. ``native/`` itself is
never written. A compiler that fails raises with its message. A compiler
without an OpenMP runtime builds the library without ``-fopenmp``, with a
warning: the solver's OpenMP loops hold no reductions, so the numbers are
the same, and the batch then runs its gathers one after another.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import warnings
from pathlib import Path

import numpy as np

from ..ops.cuda_build import BUILD_DIR

__all__ = ["available", "bfm_gradient", "bfm_gradient_batch", "ctransform",
           "pushforward", "bfm_native"]

SOURCE = Path(__file__).resolve().parents[2] / "native" / "bfm2d.cpp"
# native/Makefile's CXXFLAGS, then its link flag
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-fopenmp", "-Wall", "-shared")

_LIB = []
_OPENMP = {}


def _cxx():
    return os.environ.get("CXX", "g++")


def _flags():
    """CXX_FLAGS, without -fopenmp (and with a warning) when the compiler
    cannot link an OpenMP program."""
    cxx = _cxx()
    if cxx not in _OPENMP:
        try:
            proc = subprocess.run(
                [cxx, "-fopenmp", "-x", "c++", "-", "-o", os.devnull],
                input="int main() { return 0; }\n", capture_output=True,
                text=True)
            _OPENMP[cxx] = proc.returncode == 0
        except OSError:
            _OPENMP[cxx] = True     # no compiler: the build says so
        if not _OPENMP[cxx]:
            warnings.warn(f"{cxx} cannot link OpenMP ({proc.stderr.strip()}"
                          "): the native BFM is built without -fopenmp and "
                          "its batch runs the gathers one after another")
    if _OPENMP[cxx]:
        return CXX_FLAGS
    return tuple(f for f in CXX_FLAGS if f != "-fopenmp")


def library_path():
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((_cxx(),) + _flags()).encode())
    return BUILD_DIR / f"libbfm2d-{h.hexdigest()[:12]}.so"


def build():
    """Compile ``native/bfm2d.cpp`` unless it is built already; returns the
    library's path."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_cxx(), *_flags(), "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"{_cxx()} {SOURCE.name} exited "
                           f"{proc.returncode}:\n{proc.stdout}")
    os.replace(tmp, path)
    return path


def _load():
    if _LIB:
        return _LIB[0]
    lib = ctypes.CDLL(str(build()))
    fp = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
    dp = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
    I, F = ctypes.c_int, ctypes.c_float
    for name, argtypes in (
            ("bfm2d_gradient", [fp, fp, I, I, I, F, I, fp,
                                ctypes.POINTER(F)]),
            ("bfm2d_gradient_timed", [fp, fp, I, I, I, F, I, fp,
                                      ctypes.POINTER(F), dp]),
            ("bfm2d_gradient_batch", [fp, fp, I, I, I, I, F, I, fp, fp]),
            ("bfm2d_ctransform", [fp, I, I, fp]),
            ("bfm2d_pushforward", [fp, fp, I, I, I, fp])):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = I
    _LIB.append(lib)
    return lib


def available():
    """True when the library is built or a C++ compiler can build it (a
    compiler that fails raises when the library is first used)."""
    return bool(_LIB) or library_path().exists() or \
        shutil.which(_cxx()) is not None


def bfm_gradient(f, g, num_steps=10, step_scale=1.0, nsub=2,
                 return_phases=False):
    """(loss, grad) of the 2-D quadratic-Wasserstein distance of two
    (nt, ntraces) = (n2, n1) densities. ``nsub=0`` selects the reference
    binary's per-cell adaptive pushforward supersampling (fot2d.c:405-406);
    positive values a fixed nsub x nsub grid. ``return_phases=True``
    appends the solver's wall-clock split, a dict with keys update /
    legendre / pushforward / total (seconds; fot2d.c:530-534,599-602)."""
    lib = _load()
    f = np.ascontiguousarray(f, dtype=np.float32)
    g = np.ascontiguousarray(g, dtype=np.float32)
    n2, n1 = f.shape
    grad = np.empty_like(f)
    loss = ctypes.c_float(0.0)
    if return_phases:
        phases = np.zeros(4, dtype=np.float64)
        rc = lib.bfm2d_gradient_timed(f, g, n1, n2, int(num_steps),
                                      float(step_scale), int(nsub), grad,
                                      ctypes.byref(loss), phases)
        if rc != 0:
            raise RuntimeError("bfm2d_gradient_timed failed rc=%d" % rc)
        keys = ("update", "legendre", "pushforward", "total")
        return float(loss.value), grad, dict(zip(keys, phases.tolist()))
    rc = lib.bfm2d_gradient(f, g, n1, n2, int(num_steps), float(step_scale),
                            int(nsub), grad, ctypes.byref(loss))
    if rc != 0:
        raise RuntimeError("bfm2d_gradient failed rc=%d" % rc)
    return float(loss.value), grad


def bfm_gradient_batch(f, g, num_steps=10, step_scale=1.0, nsub=2):
    """(loss[b], grad[b]) over the leading axis, the gathers spread over
    OpenMP threads (the mpibfm2d analog)."""
    lib = _load()
    f = np.ascontiguousarray(f, dtype=np.float32)
    g = np.ascontiguousarray(g, dtype=np.float32)
    nb, n2, n1 = f.shape
    grad = np.empty_like(f)
    loss = np.empty(nb, dtype=np.float32)
    rc = lib.bfm2d_gradient_batch(f, g, nb, n1, n2, int(num_steps),
                                  float(step_scale), int(nsub), grad, loss)
    if rc != 0:
        raise RuntimeError("bfm2d_gradient_batch failed rc=%d" % rc)
    return loss, grad


def ctransform(u):
    """Separable discrete Legendre transform (quadratic-cost c-transform)."""
    lib = _load()
    u = np.ascontiguousarray(u, dtype=np.float32)
    n2, n1 = u.shape
    out = np.empty_like(u)
    rc = lib.bfm2d_ctransform(u, n1, n2, out)
    if rc != 0:
        raise RuntimeError("bfm2d_ctransform failed rc=%d" % rc)
    return out


def pushforward(mu, dual, nsub=2):
    """Push the density mu through the gradient map of ``dual``."""
    lib = _load()
    mu = np.ascontiguousarray(mu, dtype=np.float32)
    dual = np.ascontiguousarray(dual, dtype=np.float32)
    n2, n1 = mu.shape
    out = np.empty_like(mu)
    rc = lib.bfm2d_pushforward(mu, dual, n1, n2, int(nsub), out)
    if rc != 0:
        raise RuntimeError("bfm2d_pushforward failed rc=%d" % rc)
    return out


class bfm_native:
    """Host-side BFM driver with the call shape ``gradient(f, g) -> (loss,
    grad)``."""

    def __init__(self, num_steps=10, step_scale=8.0, nsub=2):
        self.num_steps = num_steps
        self.step_scale = step_scale
        self.nsub = nsub

    def gradient(self, f, g):
        return bfm_gradient(f, g, num_steps=self.num_steps,
                            step_scale=self.step_scale, nsub=self.nsub)
