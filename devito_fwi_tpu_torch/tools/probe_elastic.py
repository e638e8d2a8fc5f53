"""Probe the elastic forward march's design choices on the card.

    python -m devito_fwi_tpu_torch.tools.probe_elastic [--reps 3]
        [--baseline FILE] [--segments 4 5] [--hist] [--sass]

Builds ``csrc/elastic2d.cu`` as committed and as variants (the row loop
unrolled, launch bounds for more blocks an SM), each a copy of the source
with a compile-time choice changed, into the git-ignored
``_build/probe/``; prints each variant's registers and spills (``ptxas
-v``) and the blocks an SM holds
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) for radius 4, holds
its modelling rows against the plain twin exactly, and times the modelling
sweep with CUDA events (``reps`` calls after a warm-up, every variant twice
in turns) at the SMARM2 elastic main path (31 shots, 220 x 420 padded,
1420 steps), each variant at the launch helper's segments and at each
count of ``--segments``. ``--baseline`` names an earlier source of
the forward (one 32 x 32 tile a block and step; ``git show
945012f:devito_fwi_tpu_torch/csrc/elastic2d.cu``), timed in the same turns.
``--hist`` times the history sweep too (65 GB; its rows and illumination
held against the committed kernel's, its history by a checksum). Run from
the repository root (it takes the SMARM2 set-up from ``chip_smoke.py``);
needs one card.
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

import torch

from .. import elastic_fwi
from ..drivers import _marmousi_common as marm
from ..ops import cuda_build
from ..ops import cuda_staggered as cs

# {name: substitutions in csrc/elastic2d.cu}
_BOUNDS = "__launch_bounds__(kFThreads)\nforward_step"
_LOOP = "  for (int i = 0; i < iters; ++i) {"
VARIANTS = {
    "committed": {},
    "unrolled by 2": {_LOOP: "#pragma unroll 2\n" + _LOOP},
    "12 blocks an SM": {_BOUNDS: "__launch_bounds__(kFThreads, 12)\n"
                                 "forward_step"},
}

# appended to each built source: the radius-4 modelling step's registers
# and the blocks an SM holds at its threads and shared memory
_QUERY = """
extern "C" int probe_forward_occupancy(int* regs, int* blocks) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, forward_step<4, kRows>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  const int smem = (int)%s;
  err = cudaFuncSetAttribute(forward_step<4, kRows>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, forward_step<4, kRows>, %s, smem);
}
"""


def _build(job):
    """Compile one variant: (tag, source text, bytes expression) -> (tag,
    library path, ptxas lines of its radius-4 forward)."""
    tag, src, smem, threads = job
    out = cuda_build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    slug = re.sub(r"\W+", "_", tag)
    cu = out / f"elastic2d_{slug}.cu"
    cu.write_text(src + _QUERY % (smem, threads))
    lib = out / f"libelastic2d_{slug}.so"
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                           "-Xptxas", "-v", "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc {tag}:\n{proc.stdout}{proc.stderr}")
    lines = proc.stderr.splitlines()
    regs = []
    for i, line in enumerate(lines):
        m = re.search(r"entry function '\w*?forward_stepILi4ELi(\d)E", line)
        if m:
            info = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                    if "registers" in x or "spill" in x]
            regs.append(f"forward_step<4, {m.group(1)}>: {'; '.join(info)}")
    return tag, lib, regs


def _sass(lib, flags):
    """{opcode: count} of forward_step<4, flags> in ``lib`` (``cuobjdump
    -sass``), or None where the tool is missing."""
    tool = Path(cuda_build.nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        return None
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True).stdout
    counts, inside = {}, False
    for line in out.splitlines():
        if "Function :" in line:
            inside = f"forward_stepILi4ELi{flags}E" in line
            continue
        op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9_]*)", line)
        if inside and op:
            counts[op.group(1)] = counts.get(op.group(1), 0) + 1
    return counts


def _variant_sources(baseline):
    committed = (cuda_build.CSRC_DIR / "elastic2d.cu").read_text()
    jobs = []
    for tag, subs in VARIANTS.items():
        src = committed
        for old, new in subs.items():
            if old not in src:
                raise RuntimeError(f"{tag}: {old!r} not in elastic2d.cu")
            src = src.replace(old, new)
        jobs.append((tag, src, "March<4>::kBytes", "kFThreads"))
    if baseline:
        jobs.append(("baseline", open(baseline).read(), "FwdTile<4>::kBytes",
                     "kFThreads"))
    return jobs


def _forward(lib, prm, wav, inj, st, nsteps, z0, hist, plan):
    """One forward sweep through ``lib``'s entry point: the committed
    signature with ``plan`` = (segment rows,), or the baseline's without
    it (plan None)."""
    B, nz, nx = inj.shape
    total = wav.shape[0]
    if hist:
        H = inj.new_empty((B, total, 4, nz, nx))
        rec = inj.new_empty((B, total, 2, nx))
        illum = inj.new_zeros((B, nz, nx))
    else:
        rec = inj.new_empty((B, total, 2, 2, nx))
        H = illum = None
    cells, vals, K = cs._source_list(inj)
    scratch = inj.new_empty((10, B, nz, nx))
    wp, wm, wc = (cs._taps32(st, k) for k in ("P", "M", "C"))
    seg = () if plan is None else plan
    err = lib.elastic2d_forward(
        *(p.data_ptr() for p in prm), wav.data_ptr(), cells.data_ptr(),
        vals.data_ptr(), K, rec.data_ptr(), H.data_ptr() if hist else None,
        illum.data_ptr() if hist else None, scratch.data_ptr(), B, nz, nx,
        total, nsteps, z0, st.r, *seg, wp.ctypes.data, wm.ctypes.data,
        wc.ctypes.data, st.ihx, st.ihz, st.s, st.two_s,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"elastic2d_forward: CUDA error {err}")
    return (rec, H, illum) if hist else (rec,)


def _checksum(t):
    """The sum of a float32 tensor's bit patterns, shot by shot, an exact
    fingerprint."""
    return sum(int(u.view(torch.int32).sum(dtype=torch.int64)) for u in t)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--segments", type=int, nargs="*", default=(4, 5))
    ap.add_argument("--hist", action="store_true")
    ap.add_argument("--sass", action="store_true",
                    help="print the radius-4 modelling step's SASS opcodes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_elastic: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ".")
    import chip_smoke as smoke
    print(smoke.card_line(), flush=True)
    jobs = _variant_sources(args.baseline)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(_build, jobs))
    print(f"built {len(built)} variants in {time.perf_counter() - t0:.1f} s")
    ints, ptrs = ctypes.c_int, ctypes.c_void_p
    libs = {}
    for tag, path, regs in built:
        lib = ctypes.CDLL(str(path))
        # the baseline's entry point lacks the segment rows
        lib.elastic2d_forward.argtypes = (
            [ptrs] * 12 + [ints] + [ptrs] * 4
            + [ints] * (7 if tag == "baseline" else 8)
            + [ptrs] * 3 + [ctypes.c_float] * 4 + [ptrs])
        lib.elastic2d_forward.restype = ints
        r, b = ctypes.c_int(), ctypes.c_int()
        err = lib.probe_forward_occupancy(ctypes.byref(r), ctypes.byref(b))
        libs[tag] = lib
        print(f"  {tag}: {'; '.join(regs)}; cudaFuncGetAttributes "
              f"{r.value} registers, {b.value} blocks an SM (error {err})")
        if args.sass:
            counts = _sass(path, 1)
            if counts:
                top = sorted(counts.items(), key=lambda kv: -kv[1])[:16]
                print(f"    SASS of forward_step<4, 1>: "
                      f"{sum(counts.values())} instructions; {top}")

    dev = torch.device("cuda", 0)
    eargs = marm.make_parser(marm.SMARM2).parse_args(
        ["--physics", "elastic", "--device", "cuda"])
    _, geoms, _, _ = marm.setup_elastic(marm.SMARM2, eargs,
                                        marm.SMARM2.nsrc_default)
    g0 = geoms[1]
    tb = elastic_fwi._Tables(g0, dev)
    vp, vs, rho = elastic_fwi.model_vp_vs_rho(g0.model)
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    prm = cs.stagger_params(T(rho * (vp * vp - 2.0 * vs * vs)),
                            T(rho * vs * vs), T(1.0 / rho), tb.damp)
    kw = tb.kw
    B = g0.nsrc
    inj = tb.injT(0, B)
    wav = tb.wav_pad(tb.nsteps)
    st = cs._stencils(kw["space_order"], kw["spacing"], tb.dt, torch.float32)
    nz, nx, r = tb.nz, tb.nx, st.r
    lib = cs._lib()
    helper = cs.forward_launch(
        B, nz, nx, r, torch.cuda.get_device_properties(dev)
        .multi_processor_count,
        cs._forward_blocks(lib, r))
    print(f"SMARM2 elastic: {B} shots, {nz} x {nx}, {tb.nsteps} steps; the "
          f"helper's launch: {helper}", flush=True)
    want = cs.elastic_segments_plain(*prm, inj, wav, tb.dt, **kw)
    want = want.reshape(B, tb.nsteps, 2, 2, nx)
    calls = {}
    for tag in libs:
        if tag == "baseline":
            calls[tag] = (tag, None)
            continue
        for nseg in sorted(set(args.segments) | {-(-nz // helper.seg)}):
            seg = -(-nz // nseg)
            mark = " (helper)" if seg == helper.seg else ""
            calls[f"{tag}, {nseg} segment(s) of {seg} rows{mark}"] = \
                (tag, (seg,))
    order = list(calls)
    for hist in (False, True) if args.hist else (False,):
        ref = None
        for name in order + order[::-1]:
            tag, plan = calls[name]
            lib = libs[tag]
            ms, got = smoke.cuda_ms(lambda: _forward(
                lib, prm, wav, inj, st, tb.nsteps, tb.z0, hist, plan),
                args.reps)
            if hist:
                sums = (_checksum(got[1]),)
                if ref is None:
                    ref = (got[0].clone(), got[2].clone(), sums)
                same = (torch.equal(got[0], ref[0]) and
                        torch.equal(got[2], ref[1]) and sums == ref[2])
                what = "equal to the first variant's"
            else:
                same = torch.equal(got[0], want)
                what = "equal to the twin"
            del got
            torch.cuda.empty_cache()
            print(f"  {'history' if hist else 'modelling'} {name}: "
                  f"{ms:.3f} ms ({ms * 1e3 / tb.nsteps:.2f} us a step), "
                  f"{what}: {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
