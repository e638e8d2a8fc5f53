"""Wavefield snapshots, three ways:

    python -m devito_fwi_tpu_torch.examples.snapshotting [--device cpu]
        [--tn 600] [--odir result]

Port of ``examples/snapshotting.py`` (the reference tutorial
``tutorials/08_snapshotting.ipynb``), on a three-layer 101 x 101 model at
10 m (space order 4, nbl 40), one Ricker source, 101 receivers:

1. the full history of ``solver.forward(save=True)``, (nt, *grid) on
   ``--device`` (cuda by default);
2. strided snapshots: every ``FACTOR``-th frame sliced on the device
   before the one copy to the host, written as float32 to
   ``<odir>/snaps.bin``;
3. memory-lean: the segment-start states (u, u_prev) of
   ``ops.acoustic.forward_ckpt``, nseg evenly spaced snapshots (12
   segments), from the operands ``fwi._batched_tables`` and
   ``fwi._solver_dt`` give the objective.

Every snapshot must be finite. The solver runs the eager torch operators
on the card, as the JAX solver runs its XLA scan.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..fwi import _batched_tables, _resolve_device, _solver_dt
from ..models.geometry import AcquisitionGeometry
from ..models.presets import demo_model
from ..ops import acoustic as ac
from ..ops.wavesolver import AcousticWaveSolver

__all__ = ["FACTOR", "N_CHECKPOINTS", "setup", "snapshots", "main"]

FACTOR = 10
N_CHECKPOINTS = 12


def setup(tn=600.0, device="cuda"):
    """(model, geometry, solver) of the JAX example."""
    model = demo_model("layers-isotropic", shape=(101, 101),
                       spacing=(10., 10.), nlayers=3, space_order=4, nbl=40)
    src = np.array([[500.0, 20.0]])
    rec = np.stack([np.linspace(0, 1000, 101), np.full(101, 20.0)], axis=1)
    geometry = AcquisitionGeometry(model, rec, src, 0., tn, f0=0.015,
                                   src_type="Ricker")
    return model, geometry, AcousticWaveSolver(model, geometry,
                                               space_order=4, device=device)


def snapshots(tn=600.0, device="cuda"):
    """(full history, strided frames, segment starts), the last two as
    numpy; the history stays a tensor on the device."""
    model, geometry, solver = setup(tn, device)
    dev = _resolve_device(device)
    _, u, _ = solver.forward(save=True)
    full = u.data
    # sliced on the device; only the kept frames cross to the host
    strided = full[::FACTOR].cpu().numpy()
    s_idx, s_w, r_idx, r_w, wav = _batched_tables(geometry)
    dtype = model.dtype
    _, seg_starts, _ = ac.forward_ckpt(
        torch.as_tensor(np.asarray(model.vp, dtype), device=dev),
        torch.as_tensor(np.asarray(model.damp, dtype), device=dev),
        torch.as_tensor(np.asarray(wav, dtype), device=dev), s_idx[0],
        s_w[0], r_idx, r_w, _solver_dt(geometry), nt=geometry.nt,
        spacing=model.spacing, space_order=4, n_checkpoints=N_CHECKPOINTS)
    return full, strided, seg_starts.cpu().numpy()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--tn", type=float, default=600.0)
    p.add_argument("--odir", type=str, default="result")
    args = p.parse_args(argv)
    full, strided, starts = snapshots(args.tn, args.device)
    print("full history:", tuple(full.shape))
    print("strided snapshots:", strided.shape)
    print("checkpoint snapshots:", starts.shape[0], "states of",
          starts.shape[2:])
    for arr, name in [(strided, "strided"), (starts, "ckpt")]:
        assert np.isfinite(arr).all(), name
    os.makedirs(args.odir, exist_ok=True)
    path = os.path.join(args.odir, "snaps.bin")
    strided.astype(np.float32).tofile(path)
    print("wrote", path)
    return full, strided, starts


if __name__ == "__main__":
    main()
