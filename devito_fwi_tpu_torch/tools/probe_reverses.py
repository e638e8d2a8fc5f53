"""Probe the design choices of the redesigned reverse sweeps on the card.

    python -m devito_fwi_tpu_torch.tools.probe_reverses [--reps 3]

Builds ``csrc/tti2d.cu`` and ``csrc/acoustic3d.cu`` as committed and as
variants (``probe_forwards._build``: a copy of the source with a few
compile-time choices changed: the tile and threads of the TTI reverse
step, the reverse march's blocks an SM), prints each
variant's registers and spills for radius 4, and times with CUDA events
(``reps`` calls after a warm-up, every variant twice in turns) the TTI
reverse sweep at bench config 4's 8 shots and the 3-D reverse sweep at
bench config 5's 4 shots, the latter also at other y-chunk counts than
the launch helper's. Each output is held against the committed kernel's,
which ``chip_smoke.py`` holds against the plain twin. Run from the
repository root (it takes both configurations from ``chip_smoke.py``);
needs one card.
"""
from __future__ import annotations

import argparse
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import fwi
from ..ops import cuda_acoustic3d as c3d
from ..ops import cuda_tti as ct
from .probe_forwards import _build, _equal, _use

_REV2 = "constexpr int kReverseBlocks = 2;"
_REV3 = "constexpr int kReverseBlocks = 3;"
_ATZ = "constexpr int kATZ = 16;"
_ATHREADS = "constexpr int kAThreads = 512;"
# {name: substitutions in csrc/tti2d.cu}
VARIANTS_TTI = {
    "committed": {},
    "32 x 32 tile": {_ATZ: "constexpr int kATZ = 32;"},
    "32 x 16 tile, 256 threads": {_ATHREADS: "constexpr int kAThreads = 256;"},
    "32 x 8 tile, 256 threads": {
        _ATZ: "constexpr int kATZ = 8;",
        _ATHREADS: "constexpr int kAThreads = 256;"},
    "64 x 16 tile, 1024 threads": {
        "constexpr int kATX = 32;": "constexpr int kATX = 64;",
        _ATHREADS: "constexpr int kAThreads = 1024;"},
}
# {name: (substitutions in csrc/acoustic3d.cu, y-chunks or None for the
# launch helper's)}
VARIANTS_3D = {
    "committed": ({}, None),
    "two chunks": ({}, 2),
    "three chunks": ({}, 3),
    "three blocks an SM, three chunks": ({_REV2: _REV3}, 3),
    "three blocks an SM, six chunks": ({_REV2: _REV3}, 6),
}


def _turns(tags, run):
    """Each variant twice, in turns: forward order, then reversed."""
    for tag in tags + tags[::-1]:
        run(tag)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_reverses: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ".")
    import chip_smoke as smoke
    print(smoke.card_line(), flush=True)
    jobs = [("tti2d", t, s) for t, s in VARIANTS_TTI.items()] + \
        [("acoustic3d", t, s) for t, (s, _) in VARIANTS_3D.items()]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(_build, jobs))
    print(f"built {len(built)} variants in {time.perf_counter() - t0:.1f} s")
    libs = {}
    for (name, _, _), (tag, lib, regs) in zip(jobs, built):
        libs[(name, tag)] = lib
        for line in regs:
            print(f"  {name} {tag}: {line}")
    dev = torch.device("cuda", 0)

    # TTI: bench config 4, 8 shots, the streamed reverse sweep
    _use("tti2d", libs[("tti2d", "committed")])
    tc = smoke.TtiCase(dev, smoke.TTI_SHOTS)
    kw = tc.kwargs(1)
    fwd = ct.tti_forward_dt2_segments(*tc.ops, tc.injT(0, smoke.TTI_SHOTS),
                                      tc.wavs[1], tc.dt, **kw)
    res = tc.res_rows(np.random.default_rng(smoke.SEED), smoke.TTI_SHOTS)[0]
    gops = (*tc.ops, fwd[1], fwd[2], res, tc.dt)
    want = ct.tti_gradient_stream_segments(*gops, **kw)
    print(f"TTI: bench config 4, {smoke.TTI_SHOTS} shots, {kw['nz']} x "
          f"{kw['nx']}, {tc.nsteps} reverse steps")

    def tti(tag):
        _use("tti2d", libs[("tti2d", tag)])
        ms, got = smoke.cuda_ms(
            lambda: ct.tti_gradient_stream_segments(*gops, **kw), args.reps)
        print(f"  {tag}: reverse {ms:.3f} ms, equal: {_equal(got, (want,))}",
              flush=True)

    _turns(list(VARIANTS_TTI), tti)
    del fwd, gops, want, res
    torch.cuda.empty_cache()

    # 3-D: bench config 5, 4 shots, the reverse march
    st3 = fwi._Setup3(smoke.config5(1), dev)
    ny, nz, nx = st3.m3.shape
    B = smoke.C5_SHOTS
    _use("acoustic3d", libs[("acoustic3d", "committed")])
    hist = c3d.forward_dt2_stream3(st3.m3, st3.hd3, *st3.planes(0, B),
                                   st3.dt, **st3.kw)[1]
    res = torch.as_tensor(np.random.default_rng(smoke.SEED).standard_normal(
        (B, st3.nt, 48)), dtype=torch.float32, device=dev)
    slabs = c3d.residual_slabs3(res, st3.r_idx, st3.r_w, st3.m,
                                st3.dt * st3.dt, st3.z0, st3.nsteps)
    gops = (st3.m3, st3.hd3, hist, slabs, st3.dt)
    want = c3d.gradient_stream3(*gops, **st3.kw)
    helper = c3d.march_launch
    print(f"3-D: bench config 5, {B} shots, {nx} x {ny} x {nz}, "
          f"{st3.nsteps} reverse steps; the helper's launch "
          f"{helper(B, ny, nz, nx, 4, reverse=True)}")

    def with_chunks(chunks):
        def launch(B, ny, nz, nx, r, **kw):
            out = helper(B, ny, nz, nx, r, **kw)
            out.ylen = -(-ny // chunks)
            return out
        return launch

    def rev3(tag):
        _use("acoustic3d", libs[("acoustic3d", tag)])
        chunks = VARIANTS_3D[tag][1]
        c3d.march_launch = helper if chunks is None else with_chunks(chunks)
        ms, got = smoke.cuda_ms(lambda: c3d.gradient_stream3(*gops,
                                                             **st3.kw),
                                args.reps)
        print(f"  {tag}: reverse {ms:.3f} ms, equal: {_equal(got, (want,))}",
              flush=True)

    try:
        _turns(list(VARIANTS_3D), rev3)
    finally:
        c3d.march_launch = helper
    return 0


if __name__ == "__main__":
    sys.exit(main())
