"""How float32 rounding moves the SMARMN W2-2d objective at the starting
model.

    python -m devito_fwi_tpu_torch.tools.probe_w2_first [--shots 0 14 28]
        [--chunk 15]

The 29 SMARMN gathers of the driver's starting model (``vp.smooth_20``)
and true model, the direct wave subtracted, modeled on the card; the
driver's W2-2d misfit (gamma 1.01, 15 BFM steps) of them: the 29-shot sum
and each shot's value in float32 (as the objective runs it) and, on the
same float32 gathers, in float64; the 29-shot sum solved in batches of
``--chunk`` shots (15: the JAX package's gradient chunks on the TPU, its
10 GB budget over a bfloat16 history and the misfit's temporaries); then
the ``--shots`` alone, one at a time and as one batch, in both types.
The BFM's per-shot step size grows or shrinks by 0.8 at thresholds and
its pushforward route is chosen for the whole batch, so rounding, and
the batch a gather is solved in, move a shot's misfit far more than the
gathers' own rounding. Prints the card's name and power limit first.
About two minutes on the card.
"""
from __future__ import annotations

import argparse
from types import SimpleNamespace

import torch

from .. import fwi
from ..drivers._marmousi_common import SMARMN, default_data_dir, setup
from ..misfit import qWasserstein
from . import card_line

__all__ = ["gathers", "misfits", "main"]


def gathers(device="cuda"):
    """(syn - dw, obs - dw) of the 29 SMARMN shots on ``device``."""
    args = SimpleNamespace(bathy=1, filter=0, data_dir=default_data_dir())
    _, (g1, g0, g2), _, _ = setup(SMARMN, args, SMARMN.nsrc_default)
    dev = fwi._resolve_device(device)
    obs, syn, dw = (fwi._device_stack(fwi.fm_multi(g, device=device), dev)
                    for g in (g1, g0, g2))
    return syn - dw, obs - dw


def misfits(f, g, dtype):
    """Per-shot W2-2d misfits of the batch (f, g) in ``dtype``."""
    qw = qWasserstein(gamma=1.01, method="2d", num_steps=SMARMN.w2_num_steps,
                      step_scale=SMARMN.w2_step_scale)
    vals, _ = qw.torch_batch(f.to(dtype), g.to(dtype))
    return vals.double().cpu().numpy()


def _fmt(v):
    return " ".join("%.6e" % x for x in v)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--shots", type=int, nargs="+", default=[0, 14, 28])
    p.add_argument("--chunk", type=int, default=15)
    args = p.parse_args(argv)
    print("card:", card_line())
    f, g = gathers()
    out = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        v = misfits(f, g, dtype)
        out[name, "batch of 29"] = v
        print(f"{name}, batch of 29: sum {v.sum():.6e}")
        print(f"   per shot: {_fmt(v)}")
        print(f"   shots {args.shots}: {_fmt(v[args.shots])}")
        v = [misfits(f[lo:lo + args.chunk], g[lo:lo + args.chunk], dtype)
             for lo in range(0, f.shape[0], args.chunk)]
        out[name, "chunks"] = v
        print(f"{name}, batches of {args.chunk}: sum "
              f"{sum(x.sum() for x in v):.6e}")
        sel = torch.as_tensor(args.shots, device=f.device)
        v = misfits(f[sel], g[sel], dtype)
        out[name, "batch of shots"] = v
        print(f"{name}, shots {args.shots} as one batch: {_fmt(v)}")
        v = [misfits(f[i:i + 1], g[i:i + 1], dtype)[0] for i in args.shots]
        out[name, "alone"] = v
        print(f"{name}, shots {args.shots} one at a time: {_fmt(v)}")
    return out


if __name__ == "__main__":
    main()
