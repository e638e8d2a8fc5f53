"""The split of the SMARMN L2 gradient into its pieces (port of
``tools/audit_gradient.py``):

    python -m devito_fwi_tpu_torch.tools.audit_gradient [--nsrc 29]
        [--tn 4000] [--repeat 5] [--device cuda]

The 29-shot L2 gradient of ``drivers/marmousi_fwi.py`` (SMARMN, padded 380
x 186, space order 8, nt 1357, the direct wave subtracted, the bathymetry
mask, the illumination precondition), on the streamed route
``fwi.fwi_obj_multi`` takes, split into the JAX tool's six pieces:

  1. the whole objective, ``fwi_obj_multi(..., calc_grad=True)``;
  2. the forward with the history (row 2, ``forward_dt2_segments``);
  3. the reverse over the history (row 3, ``gradient_stream_segments``);
  4. the forward with the receivers only (row 1, ``forward_rec_segments``);
  5. the checkpoint pair (rows 4 + 5, ``forward_ckpt_segments`` and
     ``gradient_segments``), the route the gradient takes when the history
     does not fit;
  6. the glue, 1 - 2 - 3: operands, traces, misfit, residual rows, the
     illumination fix and precondition, the copies to the host.

``pieces`` composes the gradient from pieces 2 and 3 and the objective's
own glue (``fwi._Setup``, ``_illum_fixer``, ``_precondition``) in the
order ``fwi._shot_objective`` runs them, so the composed gradient equals
``fwi_obj_multi``'s; the checkpoint pair gives it again. On the card the
kernels are timed with CUDA events and the whole objective with the host
clock after a synchronise, best of ``--repeat``; each piece's per-step
device-memory traffic floor (fields of the shot batch a step, as
``chip_smoke.acoustic_step_floors`` counts them) is printed against the
card's 3.35 TB/s, with the glue's share, which is the host's. With
``--device cpu`` the pieces run the kernels' plain twins once and no time
is printed. ``--nsrc`` and ``--tn`` cut the shots and the steps.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import fwi
from ..drivers._marmousi_common import SMARMN, default_data_dir, setup
from ..misfit.w2 import least_square_torch
from ..ops import cuda_acoustic as _ca
from . import card_line

__all__ = ["FIELDS", "build", "pieces", "checkpoint_gradient", "timings",
           "main"]

# per-step device-memory traffic floors, in fields of the shot batch (the
# fused designs', chip_smoke.acoustic_step_floors)
FIELDS = {"forward_dt2_segments": 4, "gradient_stream_segments": 4,
          "forward_rec_segments": 2, "checkpoint pair": 3 + 7}
PEAK_BYTES_PER_S = 3.35e12


def build(nsrc=29, tn=SMARMN.tn, device="cuda"):
    """(inversion geometry, observed data, direct wave, bathymetry mask) of
    the SMARMN driver, ``tn`` cutting the steps."""
    cfg = dataclasses.replace(SMARMN, tn=tn)
    args = SimpleNamespace(bathy=1, filter=0, data_dir=default_data_dir())
    _, geoms, _, mask = setup(cfg, args, nsrc)
    geometry1, geometry0, geometry2 = geoms
    obs = fwi.fm_multi(geometry1, device=device)
    dw = fwi.fm_multi(geometry2, device=device)
    return geometry0, obs, dw, mask


class _Operands:
    """The objective's operands on the device, built once."""

    def __init__(self, geometry, obs, dw, dev):
        self.st = fwi._Setup(geometry, dev)
        self.nsrc = geometry.nsrc
        self.injT = self.st.injT(0, self.nsrc)
        self.obs = fwi._device_stack(obs, dev)
        self.dw = fwi._device_stack(dw, dev)
        self.fix = fwi._illum_fixer(
            geometry, np.asarray(geometry.src_positions), dev)


def _residual_rows(op, rec_rows):
    """(objective, residual rows) of the receiver rows: the traces, the L2
    misfit of the direct-wave-free gathers, the rows the reverse injects."""
    st = op.st
    fvals, res = least_square_torch(st.traces(rec_rows) - op.dw,
                                    op.obs - op.dw)
    rows = _ca.residual_rows(res, st.r_idx, st.r_w, st.m, st.dt * st.dt,
                             st.z0, st.nsteps, st.seg, st.nseg)
    return torch.sum(fvals), rows


def _finish(op, gradT, illumT, mask):
    g, il = op.fix(0, op.nsrc, gradT.transpose(-1, -2),
                   illumT.transpose(-1, -2))
    grad = fwi._precondition(g, il, True, mask)
    return grad.cpu().numpy().reshape(-1).astype(np.float64)


def pieces(geometry, obs, dw, mask, device="cuda"):
    """(objective, gradient) composed from row 2, the glue and row 3, as
    ``fwi_obj_multi`` computes them on its streamed route in one chunk."""
    op = _Operands(geometry, obs, dw, fwi._resolve_device(device))
    st = op.st
    rec_rows, hist, illumT = _ca.forward_dt2_segments(
        st.mT, st.hdT, st.wav_pad, op.injT, st.dt, **st.kw)
    fval, rows = _residual_rows(op, rec_rows)
    gradT = _ca.gradient_stream_segments(st.mT, st.hdT, hist, rows, st.dt,
                                         **st.kw)
    return float(fval), _finish(op, gradT, illumT, mask)


def checkpoint_gradient(geometry, obs, dw, mask, device="cuda"):
    """The same gradient through the checkpoint pair (rows 4 + 5)."""
    op = _Operands(geometry, obs, dw, fwi._resolve_device(device))
    st = op.st
    rec_rows, pairs, illumT = _ca.forward_ckpt_segments(
        st.mT, st.hdT, st.wav_pad, op.injT, st.dt, **st.kw)
    fval, rows = _residual_rows(op, rec_rows)
    gradT = _ca.gradient_segments(st.mT, st.hdT, st.wav_pad, op.injT, pairs,
                                  rows, st.dt, **st.kw)
    return float(fval), _finish(op, gradT, illumT, mask)


def _events(fn, repeat):
    """Best device milliseconds of ``fn`` over ``repeat`` calls after one."""
    fn()
    best = float("inf")
    for _ in range(repeat):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


def timings(geometry, obs, dw, mask, repeat=5):
    """{piece: best ms} on the card: the whole objective by the host clock
    after a synchronise, the kernels by CUDA events, the glue by
    subtraction."""
    dev = fwi._resolve_device("cuda")
    op = _Operands(geometry, obs, dw, dev)
    st = op.st

    def whole():
        fwi.fwi_obj_multi(geometry, obs, None, dw, mask, True,
                          calc_grad=True, device="cuda")
        torch.cuda.synchronize()

    whole()
    t_whole = float("inf")
    for _ in range(repeat):
        t0 = time.perf_counter()
        whole()
        t_whole = min(t_whole, time.perf_counter() - t0)
    out = {"whole objective": 1e3 * t_whole}
    rec_rows, hist, illumT = _ca.forward_dt2_segments(
        st.mT, st.hdT, st.wav_pad, op.injT, st.dt, **st.kw)
    _, rows = _residual_rows(op, rec_rows)
    out["forward_dt2_segments"] = _events(lambda: _ca.forward_dt2_segments(
        st.mT, st.hdT, st.wav_pad, op.injT, st.dt, **st.kw), repeat)
    out["gradient_stream_segments"] = _events(
        lambda: _ca.gradient_stream_segments(st.mT, st.hdT, hist, rows,
                                             st.dt, **st.kw), repeat)
    del hist
    out["forward_rec_segments"] = _events(lambda: _ca.forward_rec_segments(
        st.mT, st.hdT, st.wav_pad, op.injT, st.dt, **st.kw), repeat)
    _, pairs, _ = _ca.forward_ckpt_segments(st.mT, st.hdT, st.wav_pad,
                                            op.injT, st.dt, **st.kw)

    def pair():
        _ca.forward_ckpt_segments(st.mT, st.hdT, st.wav_pad, op.injT, st.dt,
                                  **st.kw)
        _ca.gradient_segments(st.mT, st.hdT, st.wav_pad, op.injT, pairs,
                              rows, st.dt, **st.kw)
    out["checkpoint pair"] = _events(pair, repeat)
    out["glue"] = out["whole objective"] - out["forward_dt2_segments"] \
        - out["gradient_stream_segments"]
    return out


def report(ms, st, nsrc, out=print):
    """Print each piece's time, per-step time and traffic floor against
    the card's bandwidth, and the glue's share."""
    field = nsrc * st.nz * st.nx * 4
    steps = st.nseg * st.seg
    out("%-26s %10s %10s %12s %8s" % ("piece", "ms", "us/step", "floor B/step",
                                      "TB/s"))
    for name, t in ms.items():
        if name in FIELDS:
            b = FIELDS[name] * field
            out("%-26s %10.3f %10.3f %12d %8.3f" % (
                name, t, 1e3 * t / steps, b, b * steps / (t * 1e-3) / 1e12))
        else:
            out("%-26s %10.3f" % (name, t))
    out("glue share of the whole objective: %.1f%% (host work and idle "
        "device)" % (100 * ms["glue"] / ms["whole objective"]))
    out("peak device-memory rate %.2f TB/s" % (PEAK_BYTES_PER_S / 1e12))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nsrc", type=int, default=SMARMN.nsrc_default)
    p.add_argument("--tn", type=float, default=SMARMN.tn)
    p.add_argument("--repeat", type=int, default=5)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    geometry, obs, dw, mask = build(args.nsrc, args.tn, args.device)
    f, g, _ = fwi.fwi_obj_multi(geometry, obs, None, dw, mask, True,
                                calc_grad=True, device=args.device)
    fp, gp = pieces(geometry, obs, dw, mask, args.device)
    fc, gc = checkpoint_gradient(geometry, obs, dw, mask, args.device)
    print("%d shots, nt %d: pieces equal the objective: %s (f %s), the "
          "checkpoint pair: %s" % (args.nsrc, geometry.nt,
                                   np.array_equal(gp, g), fp == f,
                                   np.array_equal(gc, g)))
    if args.device == "cpu":
        print("device times not measured (cpu)")
        return dict(f=f, g=g, pieces=(fp, gp), checkpoint=(fc, gc))
    print("card:", card_line())
    ms = timings(geometry, obs, dw, mask, args.repeat)
    report(ms, fwi._Setup(geometry, fwi._resolve_device("cuda")), args.nsrc)
    return dict(f=f, g=g, pieces=(fp, gp), checkpoint=(fc, gc), ms=ms)


if __name__ == "__main__":
    main()
