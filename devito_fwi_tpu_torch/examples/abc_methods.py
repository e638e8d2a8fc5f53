"""Absorbing-boundary methods: hard truncation, PML and the three HABCs
against a boundary-free reference:

    python -m devito_fwi_tpu_torch.examples.abc_methods [--device cpu]
        [--tn 800]

Port of ``examples/abc_methods.py`` (the reference notebooks
``seismic/abc_methods/01_introduction`` to ``04_habc``): a Ricker source
near the top of a homogeneous 1 km x 1 km box (101 points a side at 10 m,
vp 1.5 km/s, dt 0.4 h / vp), 51 receivers at z = 20 m; the box truncated
20 cells past its left, right and bottom edges with each treatment of
``ops.abc`` (``pml_acoustic_forward`` with quibar 0, the hard Dirichlet
truncation, and 0.05; ``habc_acoustic_forward`` with Clayton-Engquist A1,
A2 and Higdon), each against a 200-cell layer without damping, whose edges
the wave does not reach within ``--tn``. Prints each relative reflection
error. The forwards run the eager torch on ``--device`` (cuda by
default), as the JAX functions run their XLA scans.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..models.sources import RickerSource
from ..models.timeaxis import TimeAxis
from ..ops.abc import (extend_velocity, habc_acoustic_forward,
                       pml_acoustic_forward)
from ..ops.interp import interp_table

__all__ = ["METHODS", "run", "errors", "main"]

H = 10.0          # m
V0 = 1.5          # km/s
NPTI = 101        # interior grid points per dim (1 km x 1 km)
TN = 800.0        # ms
F0 = 0.015        # kHz
NPML = 20
REF_MARGIN = 200
# (label, method, keywords), in the JAX example's order
METHODS = (("hard truncation", "pml", dict(quibar=0.0)),
           ("PML (quibar=0.05)", "pml", dict(quibar=0.05)),
           ("HABC Clayton A1", "habc", dict(habctype=1)),
           ("HABC Clayton A2", "habc", dict(habctype=2)),
           ("HABC Higdon", "habc", dict(habctype=3)))


def run(margin, method, tn=TN, npti=NPTI, device="cuda", **kw):
    """The receiver gather (numpy) of one boundary treatment with layers of
    ``margin`` cells."""
    v = extend_velocity(np.full((npti, npti), V0, np.float32), margin)
    dt = 0.4 * H / V0
    time_range = TimeAxis(start=0.0, stop=tn, step=dt)
    src = RickerSource(name="src", f0=F0, time_range=time_range,
                       coordinates=np.array([[npti // 2 * H, 3 * H]]))
    rec_coords = np.stack([np.linspace(0, (npti - 1) * H, 51),
                           np.full(51, 20.0)], axis=-1)
    origin = (-margin * H, 0.0)
    s_idx, s_w = interp_table(src.coordinates, origin, (H, H))
    r_idx, r_w = interp_table(rec_coords, origin, (H, H))
    args = (v, np.asarray(src.data), s_idx, s_w, r_idx, r_w, dt)
    kwargs = dict(nt=time_range.num, spacing=(H, H), npml=margin,
                  device=device)
    if method == "pml":
        rec, _ = pml_acoustic_forward(*args, **kwargs, **kw)
    else:
        rec, _ = habc_acoustic_forward(*args, **kwargs, **kw)
    return rec.cpu().numpy()


def errors(tn=TN, npti=NPTI, npml=NPML, ref_margin=REF_MARGIN,
           device="cuda"):
    """{label: relative reflection error} against the reference layer."""
    ref = run(ref_margin, "pml", tn, npti, device, quibar=0.0)
    out = {}
    print(f"{'method':<28s} relative reflection error")
    for label, method, kw in METHODS:
        rec = run(npml, method, tn, npti, device, **kw)
        out[label] = float(np.linalg.norm(rec - ref) / np.linalg.norm(ref))
        print(f"{label:<28s} {out[label]:.2e}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--tn", type=float, default=TN)
    args = p.parse_args(argv)
    return errors(args.tn, device=args.device)


if __name__ == "__main__":
    main()
