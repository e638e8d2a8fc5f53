"""Probe the design choices of the redesigned reverse sweeps on the card.

    python -m devito_fwi_tpu_torch.tools.probe_reverses [--reps 3]
        [--only 2d|tti|3d ...]

Builds ``csrc/acoustic2d.cu``, ``csrc/tti2d.cu`` and ``csrc/acoustic3d.cu``
as committed and as variants (``probe_forwards._build``: a copy of the
source with a few choices changed: the 2-D reverse as the first design's
one launch a step instead of the two-step tile; the tile and threads of
the TTI fused steps and their histories' cache hints; the reverse march's
blocks an SM), prints each variant's registers and spills for radius 4,
and times with CUDA events (``reps`` calls after a warm-up, every variant
twice in turns) the 2-D reverse sweeps at
SMARMN's 29 shots (streamed, and the checkpoint route's with its
recompute), the TTI forward and reverse sweeps at bench config 4's 8 shots
and the 3-D reverse sweep at bench config 5's 4 shots, the latter also at
other y-chunk counts than the launch helper's. Each output is held against
the committed kernel's, which ``chip_smoke.py`` holds against the plain
twin. Run from the repository root (it takes the configurations from
``chip_smoke.py``); needs one card.
"""
from __future__ import annotations

import argparse
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import fwi
from ..drivers import _marmousi_common as marm
from ..ops import cuda_acoustic as ca
from ..ops import cuda_acoustic3d as c3d
from ..ops import cuda_tti as ct
from .probe_forwards import _build, _equal, _use

# {name: substitutions in csrc/acoustic2d.cu}
VARIANTS_2D = {
    "committed": {},
    "one launch a step (first design)": {
        "for (; t - 1 >= lo; t -= 2) {":
        "for (; false && t - 1 >= lo; t -= 2) {",
        "  if (t >= lo) {\n    const int err = launch_step<R, FS>(":
        "  for (; t >= lo; --t) {\n    const int err = launch_step<R, FS>("},
}
_REV2 = "constexpr int kReverseBlocks = 2;"
_REV3 = "constexpr int kReverseBlocks = 3;"
_TZ = "constexpr int kTZ = 16;"
_THREADS = "constexpr int kThreads = 512;"
# {name: substitutions in csrc/tti2d.cu}
VARIANTS_TTI = {
    "committed": {},
    "32 x 32 tile": {_TZ: "constexpr int kTZ = 32;"},
    "32 x 16 tile, 256 threads": {_THREADS: "constexpr int kThreads = 256;"},
    "32 x 8 tile, 256 threads": {
        _TZ: "constexpr int kTZ = 8;",
        _THREADS: "constexpr int kThreads = 256;"},
    "64 x 16 tile, 1024 threads": {
        "constexpr int kTX = 32;": "constexpr int kTX = 64;",
        _THREADS: "constexpr int kThreads = 1024;"},
    "plain history stores and loads": {
        "      __stcs(udt2 + h, (un - 2.0f * uo) + po[i]);\n"
        "      __stcs(vdt2 + h, (vn - 2.0f * vo) + qo[i]);":
        "      udt2[h] = (un - 2.0f * uo) + po[i];\n"
        "      vdt2[h] = (vn - 2.0f * vo) + qo[i];",
        "      hu[i] = __ldcs(udt2 + hoff + cell);\n"
        "      hv[i] = __ldcs(vdt2 + hoff + cell);":
        "      hu[i] = udt2[hoff + cell];\n      hv[i] = vdt2[hoff + cell];"},
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


def _acoustic2d(libs, smoke, reps):
    """The 2-D reverse sweeps at SMARMN's 29 shots: streamed (row 3) and
    the checkpoint route's, recompute included (row 5)."""
    dev = torch.device("cuda", 0)
    margs = marm.make_parser(marm.SMARMN).parse_args(["--device", "cuda"])
    _, geoms, _, _ = marm.setup(marm.SMARMN, margs,
                                marm.SMARMN.nsrc_default)
    st = fwi._Setup(geoms[1], dev)
    B = geoms[1].nsrc
    _use("acoustic2d", libs[("acoustic2d", "committed")])
    ops = (st.mT, st.hdT, st.wav_pad, st.injT(0, B), st.dt)
    dt2 = ca.forward_dt2_segments(*ops, **st.kw)[1]
    pairs = ca.forward_ckpt_segments(*ops, **st.kw)[1]
    res = torch.as_tensor(np.random.default_rng(smoke.SEED).standard_normal(
        (B, st.nseg, st.seg, 2, st.nx)), dtype=torch.float32, device=dev)
    calls = {
        "stream": lambda: ca.gradient_stream_segments(st.mT, st.hdT, dt2,
                                                      res, st.dt, **st.kw),
        "checkpoint": lambda: ca.gradient_segments(*ops[:4], pairs, res,
                                                   st.dt, **st.kw)}
    want = {k: fn() for k, fn in calls.items()}
    launch = ca.adjoint_launch(B, st.nz, st.nx, 4)
    print(f"2-D: SMARMN, {B} shots, {st.nz} x {st.nx}, {st.nsteps} reverse "
          f"steps; the helper's launch {launch}")

    def rev2(tag):
        _use("acoustic2d", libs[("acoustic2d", tag)])
        for key, fn in calls.items():
            ms, got = smoke.cuda_ms(fn, reps)
            print(f"  {tag}: {key} reverse {ms:.3f} ms, equal: "
                  f"{_equal(got, (want[key],))}", flush=True)

    _turns(list(VARIANTS_2D), rev2)
    _use("acoustic2d", libs[("acoustic2d", "committed")])
    del dt2, pairs, res, want, calls
    torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", nargs="+", choices=("2d", "tti", "3d"),
                    default=("2d", "tti", "3d"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_reverses: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ".")
    import chip_smoke as smoke
    print(smoke.card_line(), flush=True)
    variants = {"2d": ("acoustic2d", VARIANTS_2D),
                "tti": ("tti2d", VARIANTS_TTI),
                "3d": ("acoustic3d",
                       {t: s for t, (s, _) in VARIANTS_3D.items()})}
    jobs = [(variants[k][0], t, s) for k in args.only
            for t, s in variants[k][1].items()]
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
    if "2d" in args.only:
        _acoustic2d(libs, smoke, args.reps)
    if "tti" in args.only:
        _tti(libs, smoke, args.reps, dev)
    if "3d" in args.only:
        _reverse3(libs, smoke, args.reps, dev)
    return 0


def _tti(libs, smoke, reps, dev):
    """The TTI forward with its histories and the streamed reverse at bench
    config 4's 8 shots."""
    _use("tti2d", libs[("tti2d", "committed")])
    tc = smoke.TtiCase(dev, smoke.TTI_SHOTS)
    kw = tc.kwargs(1)
    fops = (*tc.ops, tc.injT(0, smoke.TTI_SHOTS), tc.wavs[1], tc.dt)
    fwd = ct.tti_forward_dt2_segments(*fops, **kw)
    res = tc.res_rows(np.random.default_rng(smoke.SEED), smoke.TTI_SHOTS)[0]
    gops = (*tc.ops, fwd[1], fwd[2], res, tc.dt)
    want = ct.tti_gradient_stream_segments(*gops, **kw)
    print(f"TTI: bench config 4, {smoke.TTI_SHOTS} shots, {kw['nz']} x "
          f"{kw['nx']}, {tc.nsteps} steps")

    def tti(tag):
        _use("tti2d", libs[("tti2d", tag)])
        ms, got = smoke.cuda_ms(
            lambda: ct.tti_forward_dt2_segments(*fops, **kw), reps)
        same = _equal(got, fwd)
        del got
        torch.cuda.empty_cache()
        print(f"  {tag}: forward {ms:.3f} ms, equal: {same}", flush=True)
        ms, got = smoke.cuda_ms(
            lambda: ct.tti_gradient_stream_segments(*gops, **kw), reps)
        print(f"  {tag}: reverse {ms:.3f} ms, equal: {_equal(got, (want,))}",
              flush=True)

    _turns(list(VARIANTS_TTI), tti)
    _use("tti2d", libs[("tti2d", "committed")])
    del fwd, gops, want, res
    torch.cuda.empty_cache()


def _reverse3(libs, smoke, reps, dev):
    """The 3-D reverse march at bench config 5's 4 shots."""
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
                                reps)
        print(f"  {tag}: reverse {ms:.3f} ms, equal: {_equal(got, (want,))}",
              flush=True)

    try:
        _turns(list(VARIANTS_3D), rev3)
    finally:
        c3d.march_launch = helper


if __name__ == "__main__":
    sys.exit(main())
