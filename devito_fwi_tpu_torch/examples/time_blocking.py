"""Time blocking and wavefield compression for the FWI gradient:

    python -m devito_fwi_tpu_torch.examples.time_blocking [--device cpu]

Port of ``examples/time_blocking.py`` (the reference tutorial
``seismic/tutorials/12_time_blocking.ipynb``, which writes the forward
wavefield out in time blocks, optionally compressed, reads it back in the
adjoint sweep and checks the result against the gradient from every saved
time step). On a 61 x 61 circle model (nbl 10, 2 shots, 31 receivers,
tn 280 ms, dt 1.2 ms), in float32 on ``--device`` (cuda by default),
against the all-saved gradient (``ops.acoustic.forward(save=True)`` +
``gradient``), each check with the path it takes:

1. segment checkpointing, lossless: the eager ``ops.acoustic.forward_ckpt``
   + ``gradient_from_ckpt`` (7 segments), within 1e-5 of the gradient's
   max;
2. the streamed history: ``ops.cuda_acoustic.forward_dt2_segments`` +
   ``gradient_stream_segments``, the CUDA kernels on the card and their
   plain twins on the CPU, with a float32 history (the JAX example's
   Pallas kernels; the port's kernels keep float32 histories, a
   deliberate divergence from the JAX kernels' bfloat16 option), within
   1e-5;
3. the compressed history, within 1%: the eager ``forward(save=True,
   save_dtype="bfloat16")`` + ``gradient``, a bfloat16 history read back
   in float32.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..fwi import _batched_tables, _damp, _resolve_device, _solver_dt
from ..models.geometry import AcquisitionGeometry
from ..models.presets import demo_model
from ..ops import acoustic as ac
from ..ops import cuda_acoustic as ca
from ..ops.acoustic import _ckpt_layout

__all__ = ["LIMITS", "main"]

# max |g - g_all_saved| / max |g_all_saved| by check
LIMITS = {"checkpoints": 1e-5, "streamed float32": 1e-5,
          "compressed bfloat16": 1e-2}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    dev = _resolve_device(args.device)
    shape, spacing, nbl = (61, 61), (10., 10.), 10
    model = demo_model("circle-isotropic", vp_circle=3.2,
                       vp_background=2.8, r=12, origin=(0., 0.),
                       shape=shape, spacing=spacing, space_order=4,
                       nbl=nbl, dt=1.2)
    nsrc, nrec = 2, 31
    src = np.stack([np.linspace(100, 500, nsrc), np.full(nsrc, 20.)], 1)
    rec = np.stack([np.linspace(0, 600, nrec), np.full(nrec, 30.)], 1)
    geom = AcquisitionGeometry(model, rec, src, 0., 280., f0=0.010,
                               src_type="Ricker")
    s_idx, s_w, r_idx, r_w, wav = _batched_tables(geom)
    vp = torch.as_tensor(np.asarray(model.vp), device=dev)
    damp = _damp(model, dev)
    wav = torch.as_tensor(wav, device=dev)
    dt, nt, nck = float(_solver_dt(geom)), geom.nt, 7
    kw = dict(nt=nt, spacing=model.spacing, space_order=4, kernel="OT2",
              fs=False)
    cells = int(np.prod(model.padded_shape))

    # the reference: every time step saved, the gradient from the full field
    recs, saved = zip(*[ac.forward(vp, damp, wav, s_idx[i], s_w[i], r_idx,
                                   r_w, dt, save=True, **kw)
                        for i in range(nsrc)])
    recs = torch.stack(recs)
    rng = np.random.RandomState(0)
    res = (recs * 0.1 + 0.01 * torch.as_tensor(
        rng.randn(*recs.shape).astype(np.float32), device=dev))
    g_full = torch.stack([ac.gradient(vp, damp, u, r, r_idx, r_w, dt,
                                      **kw)[0]
                          for u, r in zip(saved, res)])
    del saved
    scale = float(g_full.abs().max())
    print(f"all-saved wavefield:   {nt * cells * 4 / 2**20:8.1f} MB/shot "
          "(the reference)")
    diffs = {}

    def report(name, g, mb):
        diffs[name] = float((g - g_full).abs().max()) / scale
        print(f"{name + ':':22s}{mb:8.1f} MB/shot   max rel grad diff "
              f"{diffs[name]:.2e} (limit {LIMITS[name]:g})")

    # 1. time blocking by segment checkpointing (lossless)
    g = []
    for i in range(nsrc):
        _, starts, _ = ac.forward_ckpt(vp, damp, wav, s_idx[i], s_w[i],
                                       r_idx, r_w, dt, n_checkpoints=nck,
                                       **kw)
        g.append(ac.gradient_from_ckpt(vp, damp, wav, s_idx[i], s_w[i],
                                       starts, res[i], r_idx, r_w, dt,
                                       n_checkpoints=nck, **kw)[0])
    nsteps, seg, nseg = _ckpt_layout(nt, nck)
    report("checkpoints", torch.stack(g), nseg * 2 * cells * 4 / 2**20)

    # 2. the streamed float32 history through the 2-D kernels (the twins
    # on the CPU)
    nx, nz = model.padded_shape
    z0 = int(r_idx[..., 1].min())
    m = 1.0 / (vp * vp)
    mT = m.T.contiguous()
    hdT = torch.broadcast_to(dt * damp, vp.shape).T.contiguous()
    injT = ca.source_pattern(s_idx, s_w, m, dt * dt).transpose(
        -1, -2).contiguous()
    wav_pad = ca.pad_wavelet(wav, nt, nseg * seg)
    kkw = dict(nt=nt, nx=nx, nz=nz, space_order=4, spacing=model.spacing,
               z0=z0, n_checkpoints=nck, fs=False)
    _, dt2, _ = ca.forward_dt2_segments(mT, hdT, wav_pad, injT, dt, **kkw)
    rows = ca.residual_rows(res, r_idx, torch.as_tensor(r_w, device=dev), m,
                            dt * dt, z0, nsteps, seg, nseg)
    g = ca.gradient_stream_segments(mT, hdT, dt2, rows, dt, **kkw)
    report("streamed float32", g.transpose(-1, -2),
           nsteps * cells * 4 / 2**20)
    del dt2

    # 3. the compressed history: bfloat16 saved, float32 steps
    g = []
    for i in range(nsrc):
        _, u = ac.forward(vp, damp, wav, s_idx[i], s_w[i], r_idx, r_w, dt,
                          save=True, save_dtype="bfloat16", **kw)
        g.append(ac.gradient(vp, damp, u, res[i], r_idx, r_w, dt, **kw)[0])
    report("compressed bfloat16", torch.stack(g), nt * cells * 2 / 2**20)
    for name, d in diffs.items():
        assert d < LIMITS[name], (name, d)
    print("ok")
    return diffs


if __name__ == "__main__":
    main()
