"""Probe the design choices of the acoustic forward kernels on the card.

    python -m devito_fwi_tpu_torch.tools.probe_forwards [--reps 3]

Builds ``csrc/acoustic2d.cu`` and ``csrc/acoustic3d.cu`` as committed and
as variants, each a copy of the source with a few compile-time choices
changed (steps a launch, threads, tile, launch bounds, the register
queue's prefetch), built into the git-ignored ``_build/probe/``; prints
each variant's registers and spills (``ptxas -v``) for radius 4, holds
its outputs against the plain twins exactly, and times it with CUDA
events (``reps`` calls after a warm-up, every variant twice in turns) at
the main paths' shapes: the three 2-D forwards at SMARMN's 29 shots, the
two 3-D forwards at bench config 5's 4 shots, the 3-D ones also at other
y-chunk counts than the launch helper's. Run from the repository root
(it takes bench config 5 from ``chip_smoke.py``); needs one card.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from .. import fwi
from ..drivers import _marmousi_common as marm
from ..ops import cuda_acoustic as ca
from ..ops import cuda_acoustic3d as c3d
from ..ops import cuda_build

# the 3-D march's queue: its front loaded a plane ahead (committed) or in
# the plane that uses it
_FRONT_AHEAD = """  float qn = column(y0 + R);
  fetch(y0);
  for (int y = y0; y < y1; ++y) {
#pragma unroll
    for (int k = 0; k < 2 * R; ++k) q[k] = q[k + 1];
    q[2 * R] = qn;
    if (y + 1 < y1) qn = column(y + 1 + R);
"""
_FRONT_IN_PLANE = """  fetch(y0);
  for (int y = y0; y < y1; ++y) {
#pragma unroll
    for (int k = 0; k < 2 * R; ++k) q[k] = q[k + 1];
    q[2 * R] = column(y + R);
"""
_BOUNDS3 = "constexpr int kMarchBlocks = 3;"

# {name: substitutions in csrc/acoustic2d.cu}
VARIANTS_2D = {
    "committed": {},
    "one step a launch": {"constexpr int kSteps = 2;":
                          "constexpr int kSteps = 1;"},
    "256 threads": {"constexpr int kThreads = 512;":
                    "constexpr int kThreads = 256;"},
    "1024 threads": {"constexpr int kThreads = 512;":
                     "constexpr int kThreads = 1024;"},
    "64 x 32 tile": {"constexpr int kTX = 32;": "constexpr int kTX = 64;"},
}
# {name: (substitutions in csrc/acoustic3d.cu, y-chunks or None for the
# launch helper's)}
VARIANTS_3D = {
    "committed": ({}, None),
    "two chunks": ({}, 2),
    "queue front in its plane": ({_FRONT_AHEAD: _FRONT_IN_PLANE}, None),
    "two blocks an SM, two chunks": (
        {_BOUNDS3: "constexpr int kMarchBlocks = 2;"}, 2),
    "32 x 8 tile, four chunks": (
        {"constexpr int kMZ = 16;": "constexpr int kMZ = 8;"}, 4),
    "32 x 32 tile, two chunks": (
        {"constexpr int kMZ = 16;": "constexpr int kMZ = 32;",
         _BOUNDS3: "constexpr int kMarchBlocks = 2;"}, 2),
}


def _build(job):
    """Compile one variant: (name, tag, substitutions) -> (tag, library
    path, ptxas summary lines of its radius-4 kernels)."""
    name, tag, subs = job
    src = (cuda_build.CSRC_DIR / f"{name}.cu").read_text()
    for old, new in subs.items():
        if old not in src:
            raise RuntimeError(f"{tag}: {old!r} not in {name}.cu")
        src = src.replace(old, new)
    out = cuda_build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    slug = re.sub(r"\W+", "_", tag)
    cu = out / f"{name}_{slug}.cu"
    cu.write_text(src)
    lib = out / f"lib{name}_{slug}.so"
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                           "-Xptxas", "-v", "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc {tag}:\n{proc.stdout}{proc.stderr}")
    lines = proc.stderr.splitlines()
    regs = []
    for i, line in enumerate(lines):
        m = re.search(r"entry function '\w*?(forward_tile|forward_fused|"
                      r"march|adjoint_fused|adjoint_tile|"
                      r"adjoint_step)I(Li4E\w*?)EEv", line)
        if m:
            info = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                    if "registers" in x or "spill" in x]
            regs.append(f"{m.group(1)}<{m.group(2)}>: {'; '.join(info)}")
    return tag, lib, regs


def _use(name, lib):
    """Make the wrappers call ``lib`` for ``csrc/<name>.cu``."""
    cuda_build._LOADED[name] = ctypes.CDLL(str(lib))


def _equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    return all(torch.equal(g, w) for g, w in zip(got, want))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_forwards: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ".")
    import chip_smoke as smoke
    print(smoke.card_line(), flush=True)
    jobs = [("acoustic2d", t, s) for t, s in VARIANTS_2D.items()] + \
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

    # 2-D: SMARMN, 29 shots
    margs = marm.make_parser(marm.SMARMN).parse_args(["--device", "cuda"])
    _, geoms, _, _ = marm.setup(marm.SMARMN, margs,
                                marm.SMARMN.nsrc_default)
    st = fwi._Setup(geoms[1], dev)
    B = geoms[1].nsrc
    ops = (st.mT, st.hdT, st.wav_pad, st.injT(0, B), st.dt)
    sweeps = {"rec": (ca.forward_rec_segments, ca.forward_rec_plain),
              "dt2": (ca.forward_dt2_segments, ca.forward_dt2_plain),
              "ckpt": (ca.forward_ckpt_segments, ca.forward_ckpt_plain)}
    want = {}
    for key, (_, twin) in sweeps.items():
        out = twin(*ops, **st.kw)
        want[key] = out if isinstance(out, tuple) else (out,)
    print(f"2-D: SMARMN, {B} shots, {st.nz} x {st.nx}, "
          f"{st.nseg * st.seg} steps a sweep")
    order = list(VARIANTS_2D)
    for tag in order + order[::-1]:
        _use("acoustic2d", libs[("acoustic2d", tag)])
        for key, (kernel, _) in sweeps.items():
            ms, got = smoke.cuda_ms(lambda: kernel(*ops, **st.kw),
                                    args.reps)
            print(f"  {tag}: {key} {ms:.3f} ms, equal to the twin: "
                  f"{_equal(got, want[key])}", flush=True)
            del got
    del want, ops
    torch.cuda.empty_cache()

    # 3-D: bench config 5, 4 shots
    st3 = fwi._Setup3(smoke.config5(1), dev)
    ny, nz, nx = st3.m3.shape
    ops = (st3.m3, st3.hd3, *st3.planes(0, smoke.C5_SHOTS), st3.dt)
    want_rec = c3d.forward_rec3_plain(*ops, **st3.kw)
    want_dt2 = c3d.forward_dt2_stream3_plain(*ops, **st3.kw)
    print(f"3-D: bench config 5, {smoke.C5_SHOTS} shots, {nx} x {ny} x "
          f"{nz}, {st3.nsteps} steps; the helper's launch "
          f"{c3d.march_launch(smoke.C5_SHOTS, ny, nz, nx, 4)}")
    helper = c3d.march_launch

    def with_chunks(chunks):
        def launch(B, ny, nz, nx, r):
            out = helper(B, ny, nz, nx, r)
            out.ylen = -(-ny // chunks)
            return out
        return launch

    order = list(VARIANTS_3D)
    try:
        for tag in order + order[::-1]:
            _use("acoustic3d", libs[("acoustic3d", tag)])
            chunks = VARIANTS_3D[tag][1]
            c3d.march_launch = helper if chunks is None \
                else with_chunks(chunks)
            ms, got = smoke.cuda_ms(lambda: c3d.forward_rec3(*ops,
                                                             **st3.kw),
                                    args.reps)
            same = _equal(got, (want_rec,))
            del got
            ms2, got = smoke.cuda_ms(
                lambda: c3d.forward_dt2_stream3(*ops, **st3.kw), args.reps)
            same2 = _equal(got, want_dt2)
            del got
            torch.cuda.empty_cache()
            print(f"  {tag}: rec3 {ms:.3f} ms ({same}), dt2 {ms2:.3f} ms "
                  f"({same2}), equal to the twins", flush=True)
    finally:
        c3d.march_launch = helper
    return 0


if __name__ == "__main__":
    sys.exit(main())
