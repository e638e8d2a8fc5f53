"""The control of the comparison that decides ``correct``: the plain
reference with its forward history (acoustic) or segment starts (elastic)
and its traces kept in bfloat16, one precision below the configuration's
float32, put in the program's place and read against the float32
reference by the same readings as a run. It has to come out as not
correct. Both follow the workload's misfit and the configuration's family
from their files (``reference/objective.py`` says how a family or a misfit
is added), as the run's reference does.

    python3 -m fwibench.control --workload smarmn-l2-lbfgs \\
        --seeds 11 12 13 [--device cuda]

prints one JSON line a seed with the control's readings. The benchmark's
runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(name, seed, device="cuda", root=ROOT, here=None,
             data_dir=None):
    """The control's readings of cell ``name`` at ``seed``."""
    import numpy as np
    import torch

    from fwibench import check, lib
    from fwibench.reference import objective
    bench = lib.Bench(root, **({"here": here} if here else {}))
    work = bench.workload(name)
    config = bench.config(work["config"])
    data_dir = data_dir or os.path.join(root, "model_data")
    src, rec = lib.acquisition(config, work, seed)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for label, low in (("reference", None), ("control", torch.bfloat16)):
        obj = objective.build(config, work, src, rec, data_dir, device,
                              hist_dtype=low, trace_dtype=low,
                              here=bench.here)
        m0 = 1.0 / obj.start_vp.reshape(-1).astype(np.float64) ** 2
        out[label] = lib.follow_reference(obj, m0, config, work)
        del obj
    low = out["control"]
    prog = {"x": [m0, low["m1"]], "f": low["f"], "g": low["g"],
            "trials": low["trials"]}
    return check.readings(prog, out["reference"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": readings(args.workload, seed,
                                              args.device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
