#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero and no
result line is printed:

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. the build: ``nvcc`` compiles ``devito_fwi_tpu_torch/csrc/*.cu`` (timed);
3. kernel vs twin, quick gate: each CUDA kernel against its plain torch
   twin on the card, at the SMARMN Marmousi grid (380 x 186 padded, nt
   1357) with 3 shots, on every output;
4. kernel vs twin at the main path's shapes (29 shots, the history past
   2^31 elements): each kernel beside its twin, CUDA events after a
   warm-up, every output of the timed calls compared, with the card's
   bound;
5. the main path: the SMARMN L2 FWI driver (29 shots, ``--misfit 0
   --maxiter 2``, default ``--maxls 5``) on cuda into a temporary
   ``--odir``: the misfit must be finite and decreasing, every kernel
   launched and no twin called;
6. profile: one steady-state gradient and one line-search trial under
   ``torch.profiler``: wall time, device-busy time and idle share, the
   kernels that take the most device time;
7. a ``kernels`` JSON line; the card's name and power limit; and last
   ``{"ok": true, "device": {...}}``.

Needs one card. Imports nothing of JAX or of the JAX package.
"""
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit): device
# memory bandwidth and float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
NSHOTS_CHECK = 3
SEED = 0
# The kernels are compiled with -fmad=false and repeat the twins'
# operations one for one, so they should agree bitwise; 1e-6 of each
# output's max leaves room only for a compiler or libm difference.
RTOL = 1e-6
SOURCE = "devito_fwi_tpu_torch/csrc/acoustic2d.cu"
REPLACES = {
    "forward_rec_segments": "devito_fwi_tpu/ops/pallas_acoustic.py:221",
    "forward_dt2_segments": "devito_fwi_tpu/ops/pallas_acoustic.py:569",
    "gradient_stream_segments": "devito_fwi_tpu/ops/pallas_acoustic.py:673",
}


def phase(name):
    print(f"== {name}", flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """(mean device ms of ``fn`` over ``reps`` calls after one warm-up,
    the last call's output). Each call's output is dropped before the next
    call, so the caching allocator hands the same block back and no device
    allocation (11 GB for a history) falls inside the timed window."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out = None
    start.record()
    for _ in range(reps):
        out = None
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def compare(name, got, want):
    """Max abs error of each output pair; raises past RTOL * max|want|.
    One temporary of an output's size at most (the history is 11 GB)."""
    worst = 0.0
    for g, w in zip(got, want):
        err = float((g - w).abs_().max())
        scale = float(torch.maximum(w.max(), -w.min()))
        print(f"   {name}: max|kernel-twin| = {err:.3e} "
              f"(max|twin| = {scale:.3e}, limit {RTOL:g} x max)")
        if not np.isfinite(err) or err > RTOL * scale:
            raise AssertionError(f"{name}: kernel disagrees with its twin")
        worst = max(worst, err)
    return worst


def profile_call(fn):
    """Run ``fn`` once under torch.profiler: (wall s, device-busy s, {kernel
    name: device s}). Busy is the union of the kernels' intervals; None
    when the profiler recorded no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return wall, None, {}
    busy, end = 0.0, -np.inf
    by_name = {}
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        lo, hi = e.time_range.start, e.time_range.end
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
        by_name[e.name] = by_name.get(e.name, 0.0) + (hi - lo) * 1e-6
    return wall, busy * 1e-6, by_name


def bounds(st, B):
    """(ms, bound_by) for each kernel at this run's shapes: the larger of
    bytes moved (inputs read once, outputs written once) over the memory
    rate and float32 operations over the f32 rate."""
    f = 4
    cells = B * st.nz * st.nx
    field = st.nz * st.nx
    total, nsteps = st.nseg * st.seg, st.nsteps
    r = st.kw["space_order"] // 2
    lap = 6 * r + 5          # two axes of (1 + 3r) and the two scales
    ops_fwd = lap + 7        # update, source injection
    common_in = (2 * field + total + cells) * f   # m, hd, wav_pad, inj
    # the forward writes every one of the ``total`` steps; the reverse
    # reads only the first ``nsteps`` of the history and the residual rows
    rows = B * total * 2 * st.nx * f
    hist = B * total * field * f
    work = {
        "forward_rec_segments": (common_in + rows, cells * total * ops_fwd),
        "forward_dt2_segments": (common_in + rows + hist + cells * f,
                                 cells * total * (ops_fwd + 3) +
                                 cells * nsteps * 2),
        "gradient_stream_segments": (2 * field * f +
                                     B * nsteps * (field + 2 * st.nx) * f +
                                     cells * f,
                                     cells * nsteps * (lap + 7) +
                                     B * nsteps * 2 * st.nx),
    }
    out = {}
    for name, (nbytes, ops) in work.items():
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_F32_PER_S * 1e3
        out[name] = (max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations",
                     nbytes, ops)
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from devito_fwi_tpu_torch import fwi
    from devito_fwi_tpu_torch.drivers import _marmousi_common as marm
    from devito_fwi_tpu_torch.misfit import least_square
    from devito_fwi_tpu_torch.ops import cuda_acoustic as ca
    from devito_fwi_tpu_torch.ops import cuda_build

    phase("1 card")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"   nvidia-smi: {card}")
    print(f"   torch: {kind}, {torch.cuda.device_count()} device(s), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)

    phase("2 build")
    t0 = time.perf_counter()
    path = cuda_build.build("acoustic2d")
    ca._lib()
    print(f"   nvcc {' '.join(cuda_build.NVCC_FLAGS)}")
    print(f"   built {path.name} in "
          f"{time.perf_counter() - t0:.1f} s")

    args = marm.make_parser(marm.SMARMN).parse_args(["--device", "cuda"])
    _, geoms, _, _ = marm.setup(marm.SMARMN, args, marm.SMARMN.nsrc_default)
    g0 = geoms[1]
    st = fwi._Setup(g0, dev)
    kw = st.kw
    print(f"   SMARMN: padded grid {st.nx} x {st.nz}, nt {st.nt}, "
          f"{st.nseg} x {st.seg} steps, receivers on rows {st.z0}, "
          f"{st.z0 + 1}, space_order {kw['space_order']}")

    phase(f"3 kernel vs twin (quick gate), {NSHOTS_CHECK} shots at the "
          "Marmousi grid")
    print(f"   tolerance {RTOL:g} x max|twin|: the kernels are compiled with "
          "-fmad=false and repeat the twins' float32 operations one for one,"
          " so they should agree bitwise")
    rng = np.random.default_rng(SEED)
    injT = st.injT(0, NSHOTS_CHECK)
    ops = (st.mT, st.hdT, st.wav_pad, injT, st.dt)
    compare("forward_rec_segments",
            [ca.forward_rec_segments(*ops, **kw)],
            [ca.forward_rec_plain(*ops, **kw)])
    got = ca.forward_dt2_segments(*ops, **kw)
    want = ca.forward_dt2_plain(*ops, **kw)
    compare("forward_dt2_segments", got, want)
    dt2 = got[1]
    del got, want
    res = torch.as_tensor(rng.standard_normal(
        (NSHOTS_CHECK, st.nseg, st.seg, 2, st.nx)), dtype=torch.float32,
        device=dev)
    gops = (st.mT, st.hdT, dt2, res, st.dt)
    compare("gradient_stream_segments",
            [ca.gradient_stream_segments(*gops, **kw)],
            [ca.gradient_stream_plain(*gops, **kw)])
    del dt2, res, gops
    torch.cuda.empty_cache()

    B = g0.nsrc
    phase(f"4 kernel vs twin and kernel times, {B} shots (main-path "
          "shapes)")
    injT = st.injT(0, B)
    ops = (st.mT, st.hdT, st.wav_pad, injT, st.dt)
    ms, plain_ms, err = {}, {}, {}

    def timed_pair(name, kernel, twin, args):
        """Time kernel (3 calls) and twin (1 call), compare the outputs of
        the timed calls; returns the kernel's outputs."""
        ms[name], got = cuda_ms(lambda: kernel(*args, **kw), 3)
        plain_ms[name], want = cuda_ms(lambda: twin(*args, **kw), 1)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err[name] = compare(name, got, want)
        del want
        torch.cuda.empty_cache()
        return got

    timed_pair("forward_rec_segments", ca.forward_rec_segments,
               ca.forward_rec_plain, ops)
    dt2 = timed_pair("forward_dt2_segments", ca.forward_dt2_segments,
                     ca.forward_dt2_plain, ops)[1]
    res = torch.as_tensor(rng.standard_normal(
        (B, st.nseg, st.seg, 2, st.nx)), dtype=torch.float32, device=dev)
    timed_pair("gradient_stream_segments", ca.gradient_stream_segments,
               ca.gradient_stream_plain, (st.mT, st.hdT, dt2, res, st.dt))
    del dt2, res, ops, injT
    torch.cuda.empty_cache()
    bound = bounds(st, B)
    for name in ca.KERNELS:
        b_ms, by, nbytes, nops = bound[name]
        print(f"   {name}: kernel {ms[name]:.3f} ms, twin "
              f"{plain_ms[name]:.3f} ms, bound {b_ms:.3f} ms by {by} "
              f"({nbytes:.4g} B, {nops:.4g} f32 ops), "
              f"{b_ms / ms[name]:.1%} of the bound")

    phase(f"5 main path: SMARMN L2 FWI, {B} shots, --maxiter 2, on cuda")
    ca.reset_counters()
    with tempfile.TemporaryDirectory() as odir:
        _, stats = marm.run_fwi(marm.SMARMN, [
            "--misfit", "0", "--maxiter", "2", "--odir", odir,
            "--device", "cuda"])
    torch.cuda.synchronize()
    launches = dict(ca.LAUNCHES)
    twins = dict(ca.TWIN_CALLS)
    calls = stats["calls"]
    f = [c[1] for c in calls if c[0]]
    last = max(i for i, c in enumerate(calls) if c[0])
    last_trials = [c[1] for c in calls[last + 1:]]
    print(f"   misfit at each gradient: {f}")
    print(f"   line-search trials: {[c[1] for c in calls if not c[0]]}")
    print(f"   time per gradient: {[c[2] for c in calls if c[0]]} s")
    print(f"   time per line-search trial: "
          f"{[c[2] for c in calls if not c[0]]} s")
    print(f"   forward modeling of obs + direct wave: {stats['model_s']:.3f}"
          " s")
    print(f"   kernel launches (sweeps): {launches}")
    print(f"   twin calls: {twins}")
    values = [c[1] for c in calls]
    if not (len(f) == 2 and np.all(np.isfinite(values)) and f[1] < f[0]
            and last_trials and min(last_trials) < f[1]):
        raise AssertionError(f"misfit not finite and decreasing: {calls}")
    if min(launches.values()) < 1 or any(twins.values()):
        raise AssertionError("the main path did not run every kernel, or "
                             "ran a twin")

    phase("6 profile: one steady-state gradient and one trial, 29 shots")
    obs = fwi.fm_multi(geoms[0], device="cuda")
    dw = fwi.fm_multi(geoms[2], device="cuda")
    x = 1.0 / np.asarray(g0.model.vp_unpadded, np.float64).reshape(-1) ** 2
    mask = np.ones(g0.model.shape, np.float32)
    mask[:, :marm.SMARMN.bathy_rows] = 0
    for calc_grad in (True, False):
        def call():
            return fwi.fwi_loss(x, g0, obs, least_square, dw, mask,
                                calc_grad=calc_grad, device="cuda")
        call()  # warm: caches, allocator
        wall, busy, by_name = profile_call(call)
        what = "gradient" if calc_grad else "trial"
        if busy is None:
            print(f"   {what}: {wall * 1e3:.3f} ms wall; device busy share "
                  "not measured (the profiler recorded no device events)")
            continue
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        print(f"   {what}: {wall * 1e3:.3f} ms wall, device busy "
              f"{busy * 1e3:.3f} ms, idle share {1 - busy / wall:.1%}")
        for name, sec in top:
            print(f"      {sec * 1e3:9.3f} ms  {name[:90]}")
    del obs, dw

    phase("7 result")
    rows = [dict(name=n, route="cuda", source=SOURCE, replaces=REPLACES[n],
                 launches=launches[n], max_abs_err=err[n], ms=ms[n],
                 plain_ms=plain_ms[n], bound_ms=bound[n][0],
                 bound_by=bound[n][1], library_ms=None)
            for n in ca.KERNELS]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
