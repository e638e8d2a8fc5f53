"""Misfit smoke driver (reference ``test_misfit.py``): W2-1d against W2-2d
loss and gradient on the saved gathers ``./result/syn1`` and
``./result/obs1`` (410 x 101 float32), or on synthetic shifted Ricker
wavelets when none are saved; writes ``./result/grad1d`` and
``./result/grad2d``:

    python -m devito_fwi_tpu_torch.drivers.test_misfit [--device cpu]
"""
import argparse
import os

import numpy as np
import torch

from ..misfit import qWasserstein

SHAPE = (410, 101)


def wavelet(dt, n, freq, delay):
    t = (np.arange(0, n) - delay) * dt
    tmp = np.pi * np.pi * freq * freq * t * t
    return ((1. - 2. * tmp) * np.exp(-tmp)).reshape(n, 1)


w1d = qWasserstein(trans_type="linear", gamma=1.01, method="1d")
w2d = qWasserstein(trans_type="linear", gamma=1.01, method="2d",
                   num_steps=10, step_scale=1.)


def main(argv=None):
    """Parse ``argv`` (default: the command line), run both misfits on
    ``--device`` and write the gradients. Returns ((loss1, grad1), (loss2,
    grad2))."""
    from ..fwi import _resolve_device
    p = argparse.ArgumentParser(description="W2-1d against W2-2d")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda or cpu")
    dev = _resolve_device(p.parse_args(argv).device)
    if os.path.exists("./result/syn1"):
        data1 = np.fromfile("./result/syn1", dtype=np.float32).reshape(SHAPE)
        data2 = np.fromfile("./result/obs1", dtype=np.float32).reshape(SHAPE)
    else:
        print("no saved gathers; using synthetic shifted Ricker wavelets")
        ntr = SHAPE[1]
        data1 = np.tile(wavelet(0.001, SHAPE[0], 5, 120), (1, ntr))
        data2 = np.tile(wavelet(0.001, SHAPE[0], 5, 200), (1, ntr))

    f = torch.as_tensor(data1, device=dev)[None]
    g = torch.as_tensor(data2, device=dev)[None]
    out = []
    for w in (w1d, w2d):
        loss, grad = w.torch_batch(f, g)
        out.append((float(loss[0]), grad[0].cpu().numpy()))
    (loss1, grad1), (loss2, grad2) = out
    print("W2-1d loss %.6e   W2-2d loss %.6e" % (loss1, loss2))
    os.makedirs("./result", exist_ok=True)
    grad1.astype(np.float32).tofile("./result/grad1d")
    grad2.astype(np.float32).tofile("./result/grad2d")
    return out


if __name__ == "__main__":
    main()
