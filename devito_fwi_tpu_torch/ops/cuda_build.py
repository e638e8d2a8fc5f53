"""Build the port's CUDA source with ``nvcc`` at first use and load it with
``ctypes``.

``csrc/<name>.cu`` has a plain C interface and becomes one shared library
``_build/lib<name>-<digest>.so`` next to the sources; the digest covers
the source and the flags, so an edited source rebuilds and an unchanged
one loads the library already built. Nothing is built when a module is
imported: the first kernel call (or ``chip_smoke.py``) builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["NVCC_FLAGS", "nvcc_path", "library_path", "build", "load"]

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# -fmad=false: no multiply-add contraction, so the kernels round exactly
# like their plain torch twins (see csrc/acoustic2d.cu).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false")

_LOADED = {}


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    for cand in (home and os.path.join(home, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def library_path(name):
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(name):
    """Compile ``csrc/<name>.cu`` unless it is built already; returns the
    library's path."""
    path = library_path(name)
    if path.exists():
        return path
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    src = CSRC_DIR / f"{name}.cu"
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc {name}.cu exited {proc.returncode}:\n"
                           f"{proc.stdout}")
    # atomic publish: a concurrent process never loads a partial file
    os.replace(tmp, path)
    return path


def load(name):
    """The ctypes handle of ``csrc/<name>.cu``, built if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib
