"""Probe the design choices of the acoustic forward kernels on the card.

    python -m devito_fwi_tpu_torch.tools.probe_forwards [--reps 3]
        [--only 2d 3d legacy] [--baseline FILE] [--sass]

Builds ``csrc/acoustic2d.cu``, ``csrc/acoustic3d.cu`` and
``csrc/acoustic2d_legacy.cu`` as committed and as variants, each a copy of
the source with a few compile-time choices changed (steps a launch,
threads, tile, launch bounds, the register queue's prefetch; for the
legacy sweep the threads a block, with ``cuda_legacy``'s launch plan
patched beside, and the cluster size of ``cuda_legacy.sweep_launch``),
built into the git-ignored ``_build/probe/``; prints each variant's
registers and spills (``ptxas -v``) for radius 4, holds its outputs
against the plain twins exactly, and times it with CUDA events (``reps``
calls after a warm-up, every variant twice in turns) at the main paths'
shapes: the three 2-D forwards and the legacy sweep at SMARMN's 29 shots,
the two 3-D forwards at bench config 5's 4 shots, the 3-D ones also at
other y-chunk counts than the launch helper's. ``--baseline`` names a
source of the legacy forward's first design (one launch a step, dense
source pattern; ``git show 7070560:devito_fwi_tpu_torch/csrc/
acoustic2d_legacy.cu``), timed in the same turns; ``--sass`` prints the
legacy variants' SASS opcode counts (``cuobjdump``). Run from the
repository root (it takes bench config 5 from ``chip_smoke.py``); needs
one card.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from .. import fwi
from ..drivers import _marmousi_common as marm
from ..ops import cuda_acoustic as ca
from ..ops import cuda_acoustic3d as c3d
from ..ops import cuda_build
from ..ops import cuda_legacy as cl

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


_THREADS_LEGACY = "constexpr int kThreads = 512;"
# {name: (substitutions in csrc/acoustic2d_legacy.cu, {attribute of
# cuda_legacy: value} set beside them)}
VARIANTS_LEGACY = {
    "committed": ({}, {}),
    "384 threads": ({_THREADS_LEGACY: "constexpr int kThreads = 384;"},
                    {"THREADS": 384}),
    "640 threads": ({_THREADS_LEGACY: "constexpr int kThreads = 640;"},
                    {"THREADS": 640}),
    "cluster 8": ({}, {"CLUSTER": 8}),
}


def _sass_counts(lib, kernel):
    """{opcode: count} of the radius-4 instance of ``kernel`` in ``lib``
    (``cuobjdump -sass``), or None where the tool is missing."""
    tool = Path(cuda_build.nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        return None
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True).stdout
    counts, inside = {}, False
    for line in out.splitlines():
        if "Function :" in line:
            inside = f"{kernel}ILi4E" in line
            continue
        op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9_]*)", line)
        if inside and op:
            counts[op.group(1)] = counts.get(op.group(1), 0) + 1
    return counts


def _build(job):
    """Compile one variant: (name, tag, substitutions) -> (tag, library
    path, ptxas summary lines of its radius-4 kernels)."""
    name, tag, subs = job[:3]
    src = (job[3] if len(job) > 3 else
           cuda_build.CSRC_DIR / f"{name}.cu").read_text()
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
                      r"adjoint_step|legacy_sweep|legacy_step)"
                      r"I(Li4E\w*?)EEv", line)
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


def _legacy_baseline(lib, m, hd, wav, inj, dt, kw):
    """The first design's entry point (one launch a step over dense
    patterns, u and up scratch in device memory) on the committed
    wrapper's operands."""
    c0, cx, cz = cl._legacy_constants(kw["space_order"], kw["spacing"], dt)
    mT, hdT = m.T.contiguous(), hd.T.contiguous()
    # held until the launch: a pointer of a dropped temporary may be
    # handed to the next one
    two_m_hd, denom = 2.0 * mT + hdT, 1.0 / (mT + hdT)
    injT = inj.transpose(1, 2).contiguous()
    B, nz, nx = injT.shape
    nt = kw["nt"]
    rec = injT.new_empty((B, nt, 2, nx))
    u, up = injT.new_zeros((B, nz, nx)), injT.new_zeros((B, nz, nx))
    cx32, cz32 = np.asarray(cx, np.float32), np.asarray(cz, np.float32)
    err = lib.acoustic2d_legacy_forward(
        mT.data_ptr(), two_m_hd.data_ptr(), denom.data_ptr(),
        wav.data_ptr(), injT.data_ptr(),
        rec.data_ptr(), u.data_ptr(), up.data_ptr(), B, nz, nx, nt,
        kw["z0"], len(cx) - 1, cx32.ctypes.data, cz32.ctypes.data,
        ctypes.c_float(c0),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"baseline legacy forward: CUDA error {err}")
    return rec


def _legacy(libs, baseline, smoke, reps):
    """The legacy sweep (row 6) at SMARMN's 29 shots: each variant's plan,
    the clusters the card holds at once, its time and its rows against the
    twin's."""
    margs = marm.make_parser(marm.SMARMN).parse_args(["--device", "cuda"])
    _, geoms, _, _ = marm.setup(marm.SMARMN, margs,
                                marm.SMARMN.nsrc_default)
    m, hd, wav, inj, dt, kw = cl.operands(geoms[1], device="cuda")
    B, r = inj.shape[0], kw["space_order"] // 2
    want = cl.forward_rows_plain(m, hd, wav, inj, dt, **kw)
    print(f"legacy: SMARMN, {B} shots, {kw['nz']} x {kw['nx']}, "
          f"{kw['nt'] - 2} steps", flush=True)
    saved = {k: getattr(cl, k) for k in ("CLUSTER", "THREADS")}
    calls = {}
    for tag, (_, attrs) in VARIANTS_LEGACY.items():
        def call(attrs=attrs):
            for k, v in dict(saved, **attrs).items():
                setattr(cl, k, v)
            return cl.forward_rows(m, hd, wav, inj, dt, **kw)
        calls[tag] = call
    if baseline is not None:
        base = ctypes.CDLL(str(libs[("legacy", "baseline")]))
        base.acoustic2d_legacy_forward.argtypes = \
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p] * 2 + [ctypes.c_float, ctypes.c_void_p]
        calls["baseline (one launch a step)"] = \
            lambda: _legacy_baseline(base, m, hd, wav, inj, dt, kw)
    order = list(calls)
    try:
        for tag in order + order[::-1]:
            if tag in VARIANTS_LEGACY:
                _use("acoustic2d_legacy", libs[("legacy", tag)])
                calls[tag]()
                plan = cl.sweep_launch(kw["nz"], kw["nx"], r, 4)
                plan = f"{plan}, {cl.max_clusters(plan, r)} clusters at once"
            else:
                plan = "one launch a step"
            ms, got = smoke.cuda_ms(calls[tag], reps)
            print(f"  {tag}: {ms:.3f} ms ({ms * 1e3 / (kw['nt'] - 2):.2f} us "
                  f"a step), equal to the twin: {torch.equal(got, want)}; "
                  f"{plan}", flush=True)
            del got
    finally:
        for k, v in saved.items():
            setattr(cl, k, v)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", nargs="+", choices=("2d", "3d", "legacy"),
                    default=("2d", "3d", "legacy"))
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--sass", action="store_true",
                    help="print the legacy kernels' SASS opcode counts")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_forwards: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ".")
    import chip_smoke as smoke
    print(smoke.card_line(), flush=True)
    jobs = []
    if "2d" in args.only:
        jobs += [("acoustic2d", t, s) for t, s in VARIANTS_2D.items()]
    if "3d" in args.only:
        jobs += [("acoustic3d", t, s) for t, (s, _) in VARIANTS_3D.items()]
    if "legacy" in args.only:
        jobs += [("acoustic2d_legacy", t, s)
                 for t, (s, _) in VARIANTS_LEGACY.items()]
        if args.baseline:
            jobs.append(("acoustic2d_legacy", "baseline", {},
                         Path(args.baseline)))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(_build, jobs))
    print(f"built {len(built)} variants in {time.perf_counter() - t0:.1f} s")
    libs = {}
    for job, (tag, lib, regs) in zip(jobs, built):
        key = "legacy" if job[0] == "acoustic2d_legacy" else job[0]
        libs[(key, tag)] = lib
        for line in regs:
            print(f"  {job[0]} {tag}: {line}")
        if key == "legacy" and args.sass:
            counts = _sass_counts(lib, "legacy_step" if tag == "baseline"
                                  else "legacy_sweep")
            if counts:
                top = sorted(counts.items(), key=lambda kv: -kv[1])[:12]
                print(f"    SASS of the radius-4 kernel: "
                      f"{sum(counts.values())} instructions; {top}")
    if "2d" in args.only:
        _forwards2d(libs, smoke, args.reps)
    if "3d" in args.only:
        _forwards3d(libs, smoke, args.reps)
    if "legacy" in args.only:
        _legacy(libs, args.baseline, smoke, args.reps)
    return 0


def _forwards2d(libs, smoke, reps):
    """The three 2-D forwards at SMARMN's 29 shots."""
    dev = torch.device("cuda", 0)
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
                                    reps)
            print(f"  {tag}: {key} {ms:.3f} ms, equal to the twin: "
                  f"{_equal(got, want[key])}", flush=True)
            del got
    del want, ops
    torch.cuda.empty_cache()


def _forwards3d(libs, smoke, reps):
    """The two 3-D forwards at bench config 5's 4 shots."""
    dev = torch.device("cuda", 0)
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
                                    reps)
            same = _equal(got, (want_rec,))
            del got
            ms2, got = smoke.cuda_ms(
                lambda: c3d.forward_dt2_stream3(*ops, **st3.kw), reps)
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
