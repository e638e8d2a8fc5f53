"""The flagship SMARMN inversions at the reference's depth, through the
port's own driver.

    python -m devito_fwi_tpu_torch.tools.depth_runs [--root result_torch]
        [--keep DIR]

Runs, one after the other, the driver commands the README gives for the
headline result (``docs/06_w2_marmousi_demo.md``):

    python -m devito_fwi_tpu_torch.drivers.marmousi_fwi --misfit 0
        --maxiter 200 --odir <root>/l2_200
    python -m devito_fwi_tpu_torch.drivers.marmousi_fwi --misfit 2
        --maxiter 50 --odir <root>/w2_50

each with its standard output in ``<root>/<run>.log``, headed by the
card's name and power limit as ``nvidia-smi`` gives them and ended by the
run's wall time (host clock around the driver's process). ``--keep DIR``
then copies what ``result_r5/`` keeps of a run (the ``log*/`` tables, the
final model, the ``.log``), and none of the per-iteration checkpoints,
gradients, residuals and models, under DIR. Afterwards
``python -m devito_fwi_tpu_torch.tools.inversion_report`` prints the
q-factor table. On an H100 the L2 run's process took about two minutes
and the W2-2d run's about five (``result_torch/*.log``).
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import time

from . import card_line

RUNS = {"l2_200": ("--misfit", "0", "--maxiter", "200"),
        "w2_50": ("--misfit", "2", "--maxiter", "50")}
# what result_r5/ commits of a run beside its log tables and final model
DROPPED = ("checkpoint", "gradient", "residual", "model_est")


def run(name, root):
    """Run one driver command with its output teed into <root>/<name>.log;
    returns (exit code, wall seconds)."""
    odir = os.path.join(root, name)
    cmd = [sys.executable, "-u", "-m",
           "devito_fwi_tpu_torch.drivers.marmousi_fwi", *RUNS[name],
           "--odir", odir]
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, name + ".log"), "w") as log:
        head = "card: %s\ncommand: %s\n" % (card_line(), " ".join(cmd[1:]))
        log.write(head)
        sys.stdout.write(head)
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        for line in proc.stdout:
            log.write(line)
            sys.stdout.write(line)
        rc = proc.wait()
        wall = time.perf_counter() - t0
        tail = "wall time of the driver's process: %.2f s (exit %d)\n" % (
            wall, rc)
        log.write(tail)
        sys.stdout.write(tail)
    return rc, wall


def keep(name, root, dest):
    """Copy the run's log tables, final model and log under dest."""
    src = os.path.join(root, name)
    out = os.path.join(dest, name)
    shutil.copytree(src, out, dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns(*DROPPED))
    shutil.copy(os.path.join(root, name + ".log"), dest)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default="result_torch")
    p.add_argument("--keep", default=None)
    args = p.parse_args(argv)
    rcs = []
    for name in RUNS:
        rc, _ = run(name, args.root)
        rcs.append(rc)
        if args.keep:
            keep(name, args.root, args.keep)
    return max(rcs)


if __name__ == "__main__":
    sys.exit(main())
