"""The all_reduce between ranks of one card, and what it costs the domain
decomposition.

    python -m devito_fwi_tpu_torch.tools.probe_allreduce [--ranks 4]
        [--device cpu]

Spawns ``--ranks`` gloo ranks (``parallel.spawn``; on the card all on
cuda:0, as ``chip_smoke.py`` phases 47-50 run them) and prints, per rank:
the mean time of one ``all_reduce`` of float32 buffers of 1, 2264 (the
(2, 2) split's edge strips at SMARMN's grid, space order 8), 9056 and 70680
(SMARMN's padded grid) elements, on the device's tensors, over 40 calls
after 3; then ``forward_domain_sharded`` of SMARMN's first shot on the
mesh (ranks, 1), nt cut to ``chip_smoke.CUT_STEPS``, with the halo
exchanged every step (``domain.STEPS_PER_EXCHANGE = 1``) and every
``STEPS_PER_EXCHANGE`` steps, the seconds of each and whether their traces
are equal (they must be: both are the undecomposed operator's). Run from
the repository root; on the card about two minutes.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _rank(device):
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    import chip_smoke
    from devito_fwi_tpu_torch.drivers import _marmousi_common as marm
    from devito_fwi_tpu_torch.parallel import domain
    from devito_fwi_tpu_torch.parallel import sharding as sh
    torch.set_num_threads(1)
    mesh = sh.shot_mesh(device=device)
    dev = mesh.device
    out = {}
    for n in (1, 2264, 9056, 70680):
        buf = torch.zeros(n, device=dev)
        for _ in range(3):
            dist.all_reduce(buf)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(40):
            dist.all_reduce(buf)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out[f"all_reduce of {n} floats, ms"] = \
            (time.perf_counter() - t0) / 40 * 1e3
    args = marm.make_parser(marm.SMARMN).parse_args(["--device",
                                                     dev.type])
    _, geoms, _, _ = marm.setup(marm.SMARMN, args, 1)
    g, = chip_smoke.cut_geometries(geoms[1])
    dmesh = sh.domain_mesh((mesh.size, 1), device=device)
    recs = {}
    for steps in (1, domain.STEPS_PER_EXCHANGE):
        saved = domain.STEPS_PER_EXCHANGE
        domain.STEPS_PER_EXCHANGE = steps
        try:
            t0 = time.perf_counter()
            recs[steps] = sh.forward_domain_sharded(g, mesh=dmesh)
            out[f"forward, an exchange every {steps} steps, s"] = \
                time.perf_counter() - t0
        finally:
            domain.STEPS_PER_EXCHANGE = saved
    out["the two forwards' traces equal"] = float(
        np.array_equal(*recs.values()))
    out["steps"] = float(g.nt - 2)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    from devito_fwi_tpu_torch.parallel import group
    if args.device == "cuda":
        import subprocess
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())
    outs = group.spawn(_rank, args.ranks, "gloo", args.device,
                       args=(args.device,))
    for key in outs[0]:
        print(f"{key}: {[round(o[key], 4) for o in outs]}")
    if not all(o["the two forwards' traces equal"] for o in outs):
        raise AssertionError("the exchange's cadence changed the traces")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
