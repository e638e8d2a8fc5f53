"""The control of the comparison for a cell whose misfit solves in a
precision of its own (``reference/misfits/w2_2d.py`` solves in float64
whatever the traces' dtype): ``control.py``'s control, the reference's
forward history and traces in bfloat16, with the misfit's solve lowered to
bfloat16 too, one precision below the configuration's float32. It has to
come out as not correct.

Lowering the stored fields alone does not make a control of such a cell:
a float64 solve of bfloat16-rounded traces reads closer to the float64
reference than a float32 solve of exact ones (the W2-2d objective is
ill-conditioned in float32, not in its traces).

    python3 -m fwibench.control_misfit --workload smarmn-w2-lbfgs \\
        --seeds 11 12 13 [--device cuda]

prints one JSON line a seed with the control's readings. The benchmark's
runs do not run it.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import sys

from fwibench import control


@contextlib.contextmanager
def misfit_in(dtype):
    """``objective.build`` with the misfit of the objectives it builds
    with lowered fields (the control's) solving in ``dtype``."""
    from fwibench.reference import objective
    build = objective.build

    def lowered(*args, **kw):
        obj = build(*args, **kw)
        if kw.get("trace_dtype") is not None:
            obj._misfit = functools.partial(obj._misfit, dtype=dtype)
        return obj

    objective.build = lowered
    try:
        yield
    finally:
        objective.build = build


def readings(name, seed, device="cuda", **kw):
    """The control's readings of cell ``name`` at ``seed``, its fields and
    its misfit's solve in bfloat16."""
    import torch
    with misfit_in(torch.bfloat16):
        return control.readings(name, seed, device, **kw)


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
