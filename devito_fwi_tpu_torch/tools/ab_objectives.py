"""Time the end-to-end objectives of two checkouts in turns on the card.

    python -m devito_fwi_tpu_torch.tools.ab_objectives OTHER [--reps 7]

OTHER is a checkout of another commit (for example the parent, unpacked
with ``git archive <commit> | tar -x -C <dir>`` into a directory that
``.gitignore`` lists). The script runs OTHER, this checkout, this
checkout, OTHER, each in a process of its own that imports
``devito_fwi_tpu_torch`` from its checkout (building its kernels first,
untimed) and times, on the host clock to a synchronise after one warm
call, ``reps`` calls each of the SMARMN 29-shot L2 gradient and trial,
bench config 5's stream-route gradient and trial, and bench config 4's
marmousi-tti2d 8-shot gradient (``cuda_tti.tti_gradient_batched``); it
prints the median, min and max of each. Run from the repository root;
needs one card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _time_one(root, reps):
    """In a process whose ``devito_fwi_tpu_torch`` is ``root``'s: time the
    five objectives and print one line each."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as smoke
    import devito_fwi_tpu_torch
    from devito_fwi_tpu_torch import fwi
    from devito_fwi_tpu_torch.drivers import _marmousi_common as marm
    from devito_fwi_tpu_torch.misfit import least_square
    from devito_fwi_tpu_torch.ops import cuda_tti as ct
    if not devito_fwi_tpu_torch.__file__.startswith(root):
        raise RuntimeError(f"imported {devito_fwi_tpu_torch.__file__}, "
                           f"not {root}'s package")

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms

    args = marm.make_parser(marm.SMARMN).parse_args(["--device", "cuda"])
    _, geoms, _, _ = marm.setup(marm.SMARMN, args, marm.SMARMN.nsrc_default)
    g0 = geoms[1]
    obs = fwi.fm_multi(geoms[0], device="cuda")
    dw = fwi.fm_multi(geoms[2], device="cuda")
    x0 = 1.0 / np.asarray(g0.model.vp_unpadded,
                          np.float64).reshape(-1) ** 2
    mask = np.ones(g0.model.shape, np.float32)
    mask[:, :marm.SMARMN.bathy_rows] = 0
    g1, g5 = smoke.config5(3), smoke.config5(1)
    obs5 = fwi.fm_multi(g1, device="cuda")
    x5 = 1.0 / np.asarray(g5.model.vp_unpadded,
                          np.float64).reshape(-1) ** 2
    tc = smoke.TtiCase(torch.device("cuda", 0), smoke.TTI_SHOTS)
    tkw = dict(nt=tc.nt, spacing=tc.model.spacing, space_order=8,
               n_checkpoints=smoke.TTI_CHECKPOINTS)
    obs4 = 0.999 * ct.tti_forward_batched(*tc.batched(), tc.dt, **tkw)
    calls = {"config 4 TTI gradient": lambda: ct.tti_gradient_batched(
        *tc.batched(), obs4, tc.dt, **tkw)}
    for grad in (True, False):
        what = "gradient" if grad else "trial"
        calls[f"SMARMN L2 {what}"] = lambda grad=grad: fwi.fwi_loss(
            x0, g0, obs, least_square, dw, mask, calc_grad=grad,
            device="cuda")
        calls[f"config 5 {what}"] = lambda grad=grad: fwi.fwi_loss(
            x5, g5, obs5, least_square, calc_grad=grad, device="cuda")
    for name, fn in calls.items():
        ms = timed(fn)
        print(f"{os.path.basename(root.rstrip(os.sep))}: {name}: median "
              f"{np.median(ms):.3f} ms, min {min(ms):.3f}, max "
              f"{max(ms):.3f} ({reps} calls)", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.other)
    if args.one:
        _time_one(root, args.reps)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("ab_objectives: no CUDA device", file=sys.stderr)
        return 2
    build = ("from devito_fwi_tpu_torch.ops import cuda_build\n"
             "for n in ('acoustic2d', 'acoustic3d', 'tti2d'): "
             "cuda_build.build(n)")
    for tree in (root, HERE):
        subprocess.run([sys.executable, "-c", build], cwd=tree, check=True)
    for tree in (root, HERE, HERE, root):
        subprocess.run([sys.executable, os.path.abspath(__file__), tree,
                        "--reps", str(args.reps), "--one"], cwd=tree,
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
