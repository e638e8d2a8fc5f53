#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero and no
result line is printed:

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. the build: ``nvcc`` compiles ``devito_fwi_tpu_torch/csrc/*.cu``, one
   process per source, all started together (timed);
3. kernel vs twin, quick gate: each acoustic CUDA kernel against its plain
   torch twin on the card, at the SMARMN Marmousi grid (380 x 186 padded,
   nt 1357) with 3 shots, on every output, exactly;
4. kernel vs twin at the main path's shapes (29 shots, the history past
   2^31 elements): each acoustic kernel beside its twin, CUDA events after
   a warm-up, every output of the timed calls compared (exactly:
   max|kernel-twin| must be 0), with the card's bound; the checkpoint-route
   gradient against the streamed one, bitwise; the two-step tile's
   launches, forward and reverse, and the per-step traffic floors of the
   forwards and both reverses;
5. the slab kernel at the main path's shapes: the subsamples of the last
   pushforward of a live SMARMN W2-2d objective (29 shots, the initial
   model), in the natural and the blocked layout, kernel against twin on
   the first 3 shots and on all 29 (exactly: max|kernel-twin| must be 0),
   kernel beside twin, and one ``index_put_(accumulate=True)`` scatter of
   the same subsamples as the library yardstick;
6. main path, L2: the SMARMN L2 FWI driver (29 shots, ``--misfit 0
   --maxiter 2``) on cuda: finite and decreasing misfit, every kernel of
   the path launched, no twin called; the first logged misfit line
   against the JAX system's ``result_r5/l2_200`` (``FIRST_LINE_RTOL``);
7. main path, W2: the same driver with ``--misfit 1`` (W2-1d) and
   ``--misfit 2`` (W2-2d; the JAX driver's qWasserstein: gamma 1.01, 15
   BFM steps); the same checks, for W2-2d also the slab kernel launched,
   the pushforwards by tier and the Legendre certificate fallbacks
   printed, and the first logged line printed against
   ``result_r5/w2_50``, its f held to the JAX package's float64 value
   (``W2_FIRST_F64``);
8. main path, checkpoint route: 29-shot ``fwi_loss`` gradients with
   ``stream=False``: the L2 one equal to the streamed one bitwise, and a
   W2-2d one with the blocked slab layout;
9. the misfits' device memory per gather sample (peak allocation around
   the batched misfit of the 29 SMARMN gathers), held against the figures
   ``fwi.MISFIT_BYTES_PER_SAMPLE`` sizes shot chunks with;
10. profile: one steady-state gradient and one trial of the L2 objective
   and one trial of the W2-2d objective under ``torch.profiler``: wall
   time, device-busy time and idle share, the kernels that take the most
   device time, and the sweeps and the slab kernel launched, no twin
   called; then the
   W2-2d objective's parts (2-D Legendre transform, pushforward, DCT
   products) timed apart on its live state, times their calls;
11. elastic kernel vs twin, quick gate: each elastic CUDA kernel against
   its twin at the SMARM2 grid (420 x 220 padded, nt 1421, 1420 steps)
   with 3 shots, on every output, all three sweeps exactly; the
   reference's elastic example
   (``ElasticWaveSolver``, golden norms 19.25636 / 0.627606);
12. main path, elastic: the SMARM2 elastic FWI driver (31 shots,
   ``--physics elastic --misfit 0 --maxiter 2``) on cuda: finite and
   decreasing misfit, every elastic kernel launched, no twin called, each
   gradient's shot chunks sized to fit ``fwi._device_budget`` (on an
   85 GB card with nothing else held, the 31 shots' 66.1 GB fit one). It
   runs before the 31-shot comparisons: a small tensor that outlives them
   can pin their 65 GB history's segment;
13. elastic kernel vs twin at the main path's shapes (31 shots; the
   history is 65 GB, 1.6e10 elements): kernel beside twin, CUDA events, with
   the card's bound; the history forward's twin runs in shot chunks, each
   held against its slice of the kernel's output, its time the sum of the
   chunks'; all three sweeps exactly, with the fused steps' launches and
   the per-step traffic floors (fused and first design);
14. elastic profile: one steady-state gradient and one trial under
   ``torch.profiler``, every elastic kernel launched and no twin called;
   the gradient's peak device bytes per shot against
   the figure the chunks are sized with; the gradient in two chunks
   (``shot_chunk=16``, a smaller card's split) against the memory-sized
   one;
15. viscoacoustic kernel vs twin, quick gate: each sls/2 CUDA kernel
   against its twin at the SMARMN viscoacoustic grid (380 x 186 padded,
   nt 1338, 1336 steps) with 3 shots, on every output (all three sweeps
   exactly: max|kernel-twin| must be 0); the reference's sls/2 example
   (``ViscoacousticWaveSolver``, golden norm 684.385);
16. main path, viscoacoustic: the SMARMN viscoacoustic FWI driver (29
   shots, ``--physics viscoacoustic --misfit 0 --maxiter 2``) on cuda:
   finite and decreasing misfit, every visco kernel launched, no twin
   called, the shot chunks of each gradient;
17. viscoacoustic kernel vs twin at the main path's shapes (29 shots; the
   history is 21.9 GB): kernel beside twin, CUDA events, with the card's
   bound; the history forward's twin in shot chunks; all three sweeps
   exactly, with the fused steps' launches and per-step traffic floors;
18. viscoacoustic profile: one steady-state gradient and one trial under
   ``torch.profiler``; the gradient's peak device bytes per shot against
   the figure the chunks are sized with;
19. TTI kernel vs twin, quick gate: each of the four TTI CUDA kernels
   against its twin at bench config 4's grid (``marmousi-tti2d``, 380 x 186
   padded, space order 8, nt 1583) with 3 shots, on every output; the
   zero-anisotropy gate: with eps = delta = theta = 0 the TTI kernel's rows
   equal twice the acoustic ``forward_rec_segments`` rows at the same dt;
20. main path, TTI: bench config 4 (8 shots, 300 receivers, both at 60 m):
   the observed data modeled through ``tti_forward_ckpt_segments``, the
   batched gradient ``tti_gradient_batched`` of ``0.999 obs`` on the
   streamed route (first call and steady state), the same with
   ``stream=False`` (the checkpoint pair; equal bitwise), and
   ``AnisotropicWaveSolver.gradient_checkpointed`` on one shot; every TTI
   kernel launched, no twin called;
21. TTI kernel vs twin at the main path's shapes (8 shots; the streamed
   history is 7.15 GB): kernel beside twin, CUDA events, with the card's
   bound, all four exactly; the checkpoint-route gradient against the
   streamed one, bitwise; the fused steps' launches and per-step traffic
   floors;
22. TTI profile: one steady-state gradient under ``torch.profiler``;
23. banded Legendre kernel vs twin, quick gate: the kernel
   (``cuda_bfm.legendre_banded``, B6) against its twin, output and flag, on
   both 1-D passes of a 2-D transform (rows of 300 traces at W/K = 24/8,
   rows of 1357 samples at 48/16) of the first 3 shots of the live SMARMN
   W2-2d state that phase 10 captured, on rows in band (flag True) and on
   the same rows displaced past the band (flag False): values, NaN
   positions and flag exactly;
24. the banded kernel at the main path's shapes (the 29-shot live state,
   39353 and 8700 rows): the launch the helper chose, kernel beside twin,
   CUDA events, with the card's bound, and the anchored torch route on the
   same inputs, exactly; the anchored kernel (``cuda_bfm.legendre_anchored``,
   the default route) on the same passes: its launch, kernel beside its
   twin (the anchored torch route) and its bound, output and flag with
   ``torch.equal``; one 2-D transform both ways;
25. main path, banded W2-2d: a 29-shot gradient and trial through
   ``fwi_loss`` with ``bfm_options={"legendre": "banded"}``: the kernel
   launched and no twin called, the certificate reads and fallbacks, loss
   and gradient held against the anchored route's, which launched the
   anchored kernel and no twin (its ``COUNTS`` printed); the banded trial
   under ``torch.profiler``;
26. main path, banded W2-2d FWI: the SMARMN driver (``--misfit 2
   --maxiter 2``, ``run_fwi(..., bfm_options={"legendre": "banded"})``):
   finite and decreasing misfit, the banded kernel and the sweeps launched,
   no twin called;
27. the native W2-2d solver: a 1-shot SMARMN gradient (``NATIVE_SHOTS``) with
   ``bfm_backend="native"`` (the host-misfit path, the sweeps on the card)
   against the torch BFM route's;
28. main path, the driver's data options: the SMARMN L2 driver with
   ``--filter 1`` (finite and decreasing misfit) and with ``--resample 4``
   (stops as the JAX driver does, on the observed data's length), and a
   2-iteration L-BFGS of ``fwi_obj_multi(resample_dt=4)`` on the host-misfit
   path at that shot;
29. 3-D kernel vs twin, quick gate: at bench config 5's grid (96^3 at 15
   m, space order 8, nbl 16, padded 128^3, 333 steps) with 3 shots, the
   three streamed 3-D CUDA kernels against their twins on every output,
   without and with the free surface, and the step kernel against its twin
   on one 128^3 step, all exactly;
30. main path, 3-D: bench config 5 (4 shots, 48 receivers, tn 500 ms, L2)
   on cuda: the observed data through ``forward_rec3`` (no reflection
   arrives within tn, so the path inverts them scaled by 0.9), the
   stream-route gradient (first call and steady state) and trial of
   ``fwi_loss``, the saved-history route (``saved3=True``, stepped by the
   step kernel) held against the stream route, and two L-BFGS iterations of
   ``fwi_loss`` (finite, decreasing misfit); every 3-D kernel launched, no
   twin called;
31. 3-D kernel vs twin and kernel times at the main path's 4 shots (the
   history 11.17 GB, 2.79e9 elements): kernel beside twin, CUDA events,
   with the card's bound, all exactly; the y march's launch and the
   forwards' per-step traffic floors; the step kernel's own device time a
   launch (``torch.profiler`` over 300 calls) beside the wrapper's
   event-timed pace; the 3-D phases' own seconds;
32. 3-D profile: one steady-state gradient and one trial under
   ``torch.profiler``;
33. B15 kernel vs twin, quick gate: ``cuda_legacy.forward_rows`` (the
   whole-nt 2-D forward of ``pallas_legacy``: one thread-block cluster a
   shot, the wavefield resident in shared memory) against its twin on the
   operands of the first 3 SMARMN shots, every row bitwise, the two
   trailing rows zero; the launch plan (cluster size, slab rows, shared
   memory) and the clusters the card holds at once;
34. main path, B15: ``cuda_legacy.forward_traces`` on the 29 SMARMN shots
   on cuda (B15 launched, no twin called), its traces against
   ``fm_multi``'s (B1) within 1e-5 of the max; at 29 shots kernel against
   twin bitwise, CUDA events after a warm-up beside the bound, the time a
   step, the issue-rate floor (8r + 8 separate float instructions a
   cell-step at 132 SMs x 128 lanes x 1.98 GHz) and the per-step traffic
   floor (the record rows; the first design's four fields a step);
35. main path, the camembert FWI: ``examples.inversion_fwi.main`` on cuda
   (9 shots, 101 receivers, 5 gradient-descent iterations through
   ``AcousticWaveSolver``) with the reference's goldens 39113 / -821 / 2442
   and 3828 (atol 10); the time per 9-shot gradient; the checkpointed
   ``jacobian_adjoint`` against the saved one on one shot; the born /
   gradient dot test at float32;
36. the solver in 3-D (layers-isotropic 50^3, nbl 40, tn 1000 ms): the
   free-surface forward's norm against 369.955, the fs=False forward
   through the B14 step hook bitwise equal to ``step3=False`` and its norm
   against 459.1678 (rtol 1e-3 each); the seconds of phases 33-36;
37. main path, the eager route: a 1-shot gradient (``EAGER_SHOTS``) of
   ``fwi_loss`` on ``drivers/circle_fwi.py``'s geometry (``BASELINE.json``
   config 0: circle 201 x 201, space order 6, nbl 40, receivers on the
   vertical line x = 1980 m, which no kernel takes) on cuda: the route
   counted in ``fwi.EAGER``, no twin called, a finite gradient;
38. main path, the forward-modeling drivers: ``marmousi_fm`` and
   ``marmousi2_fm`` (``run_fm``, 21 shots each, at SMARMN's and SMARM2's
   full grids) on cuda: the 63 files of each under the JAX driver's names,
   float32 of the JAX shape, the observed data bitwise a direct
   ``fm_multi`` of the true model, row 1's kernel launched, no twin
   called; the driver's wall time;
39. main path, ``circle_fwi`` (``BASELINE.json`` config 0) at its full
   width (201 x 201, nbl 40, space order 6, tn 1000 ms, ``--maxiter 1``;
   1 shot, cut from its 11: ``CIRCLE_SHOTS``) on cuda, the eager route: a
   finite misfit, the log files, every objective call counted in
   ``fwi.EAGER``; the wall time of the iteration and of each objective
   call;
40. the self-adjoint solver at float64 on cuda: the Hankel far field of
   ``examples/sa_far_field.py`` within 2%, with the forward's time, and
   the F and J adjoint dot tests (71 x 61, space order 8; 1e-12, 1e-11);
41. PML and HABC on cuda: the reflection checks of ``tests/test_abc.py``
   (PML under 1% of hard truncation's error, HABC under 5%, Higdon under
   0.5%) and the stability check, with each forward's time;
42. viscoelastic on cuda: the solver's goldens 12.28040 / 0.312461 (atol
   1e-3) and the five-parameter gradient of ``bench.py``'s
   ``_bench_viscoelastic`` workload (SMARM2; its second shot of 4:
   ``VE_SHOTS``; nt cut from 1178 to ``CUT_STEPS`` + 1) through
   ``viscoelastic_value_and_grad``, timed, finite and non-zero;
43. the elastic objective's routes on SMARM2's full grid (420 x 220
   padded, one shot: ``ROUTE_SHOT``; every run of the phase with nt cut
   from 1421 to 301: ``CUT_STEPS``): the "saved" and "vjp" gradients
   against the kernel route's (objective 1e-5 relative, each
   gradient 1e-4 of its max: ``ROUTE_RTOL``), no kernel launched on
   either, each route's time and peak device bytes, and an eager
   route's shot chunk's own peak (``chunk_peaks``), which may not pass
   the figure its chunks are sized with; a
   geometry with its receivers on a vertical line through "auto" on cuda,
   landing on the saved route, counted in ``elastic_fwi.EAGER``;
   ``elastic_born`` timed, its primal against the kernel's traces; the
   Born dot test
   (jvp against ``elastic_adjoint_from_hist``) at float64 on the CPU
   tests' 41 x 36 grid, within 1e-11;
44. the viscoacoustic objective's routes on SMARMN's full grid (380 x 186
   padded, one shot; nt cut from 1338 to 301 as in phase 43): sls/2's
   "saved" and "vjp" against the kernel route's, to the same limits; each
   of the five other kernels: ``visco_fm_multi`` and one "vjp" gradient
   (auto), counted, timed; ``visco_born``'s dot test at
   float64 on the small grid, within 1e-11;
45. main path, viscoacoustic on SMARM2: the SMARM2 driver with
   ``--physics viscoacoustic --misfit 0 --maxiter 2`` at its 31 shots on
   cuda: finite and decreasing misfit at the two gradients, every visco
   kernel launched, no twin called, the gradient and trial times, the
   trials past the pinned dt's CFL speed (a fault of the JAX driver that
   the port mirrors: ``run_visco_smarm2``); the seconds of phases 43-45;
46. the parallel layer, a world of one: ``torch.distributed`` on NCCL in
   this process, ``parallel.fwi_obj_sharded`` of the 29 SMARMN shots (the
   L2 gradient and a trial) bitwise ``fwi_obj_multi``'s, timed;
47. the parallel layer on ``PAR_RANKS`` gloo ranks spawned on the one card
   (``parallel.spawn``, when the script starts; they wait off the card
   until phase 46 is done; NCCL refuses two ranks on a card): the SMARMN L2
   gradient and trial, the SMARM2 elastic (31 shots) and the SMARMN
   viscoacoustic (29) sharded gradients and trials, each within
   ``PAR_RTOL`` of the single-process objective's; every rank launching
   rows 1-3 and 18-23, no twin called, each rank's peak under its part of
   the card's budget (``group.budget_share``);
48. the same ranks: ``tti_fwi_obj_sharded`` at marmousi-tti2d's width
   (``PAR_TTI_SHOTS`` shots, nt cut to ``CUT_STEPS``) against the same
   function on one rank (the eager checkpoint pair),
   ``viscoacoustic_fm_sharded`` (row 19 on every rank) against
   ``visco_fm_multi``, and the viscoelastic and self-adjoint sharded
   gradients of the CPU tests' small cases against one rank;
49. the same ranks: the domain decomposition at SMARMN's padded grid
   (380 x 186, nt cut to ``CUT_STEPS``) on meshes (4, 1) and (2, 2) and
   config 5's 128^3 on (2, 2) (``PAR_C5_STEPS``), the forward and the
   checkpointed gradient each with max|decomposed - undecomposed| = 0
   against the eager operators on the whole grid, computed in this
   process beside the ranks; ``fwi_obj_sharded2d`` on (2, 2) against
   ``fwi_obj_multi`` (``ROUTE_RTOL``); no kernel launched;
50. the same ranks: ``parallel.dryrun.dryrun_multichip(4)`` on the card
   (its lines, from rank 0); the seconds of phases 46-50;
51. the six tutorials (``examples/modeling_families.py``, ``accuracy.py``,
   ``snapshotting.py``, ``rtm.py``, ``abc_methods.py``,
   ``nmo_correction.py``) through their ``main`` on cuda at the cut sizes
   of ``TUTORIAL_ARGS``, each with its own checks and seconds, rows 18 and
   19 launched by the elastic and viscoacoustic families, no twin called;
52. the audit (``tools/audit_gradient.py``): the 29-shot SMARMN L2
   gradient split into its pieces (the whole objective, rows 2, 3, 1, the
   checkpoint pair 4 + 5, the glue), the pieces' gradient bitwise
   ``fwi_obj_multi``'s, each piece's time and traffic floor against the
   card's bandwidth, the glue's share;
53. a ``kernels`` JSON line; the card's name and power limit; the script's
   total seconds; and last ``{"ok": true, "device": {...}}``.

Phases 38-44 run no kernel of their own (the JAX package wrote none for
these modules, and the objectives' saved and vjp routes are its XLA scans
in eager torch) other than row 1 in phase 38 and the kernel route the
routes of phases 43-44 are held against. The ranks of phases 47-50
print nothing; this process joins them before it prints their results.

Needs one card. Imports nothing of JAX or of the JAX package.
"""
import contextlib
import gc
import glob
import importlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
# Phases 6-7 hold the first gradient's logged misfit line, "f max|g|" at
# four significant digits, against the JAX system's SMARMN runs committed
# in result_r5/ (the starting model and the data alone set it): f within
# 5e-4 relative, a unit of the last printed digit or two; max|g| within
# 1e-2, since the JAX package streamed the history in bfloat16 on the TPU
# (its default there, ``stream_hist_dtype``; 3.9e-4 of the gradient's max
# by its own measure), which the port keeps in float32.
FIRST_LINE_RTOL = (5e-4, 1e-2)
# The SMARMN W2-2d objective at the starting model, the JAX package's on
# the CPU in float64 (tests/test_torch_w2_first_line.py, marked slow; the
# port's float64 objective gives the same 4.251941e-06). The JAX run on the TPU logged 4.226e-06, 6.1e-3
# below it: the 15-step BFM's per-shot step-size rule (sigma times or over
# 0.8 at thresholds) and the batch-wide pushforward routes turn float32
# rounding into per-shot misfits that move by up to 20% (median 4%) from
# float64 and 29-shot sums that move by 1.8% with the batch (PERF.md
# section 6). Phase 7 prints the W2-2d
# line against result_r5/w2_50 and holds f to this value within
# FIRST_LINE_RTOL[0].
W2_FIRST_F64 = 4.251941e-06
# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit): device
# memory bandwidth and float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# float32 instructions a second outside the tensor cores when each multiply
# and add issues on its own (the kernels' -fmad=false): 132 SMs x 128
# lanes x the 1.98 GHz boost clock
F32_INSTR_PER_S = 132 * 128 * 1.98e9
NSHOTS_CHECK = 3
# step3 calls profiled for the step kernel's own device time (phase 31)
STEP3_PROFILED = 300
# shots per chunk of the 31-shot history forward's twin: its 8.4 GB history
# beside the kernel's 65 GB
TWIN_CHUNK = 4
SEED = 0
# The kernels are compiled with -fmad=false and repeat the twins'
# operations one for one, so they should agree bitwise; 1e-6 of each
# output's max leaves room only for a compiler or libm difference.
RTOL = 1e-6
SOURCES = ("acoustic2d", "bfm_push", "bfm_legendre", "elastic2d",
           "visco2d", "tti2d", "acoustic3d", "acoustic2d_legacy")
REPLACES = {
    "forward_rec_segments": "devito_fwi_tpu/ops/pallas_acoustic.py:221",
    "forward_dt2_segments": "devito_fwi_tpu/ops/pallas_acoustic.py:569",
    "gradient_stream_segments": "devito_fwi_tpu/ops/pallas_acoustic.py:673",
    "forward_ckpt_segments": "devito_fwi_tpu/ops/pallas_acoustic.py:306",
    "gradient_segments": "devito_fwi_tpu/ops/pallas_acoustic.py:453",
    "pushforward_slabs_nat": "devito_fwi_tpu/ops/pallas_bfm.py:369",
    "pushforward_slabs": "devito_fwi_tpu/ops/pallas_bfm.py:323",
    "legendre_banded": "devito_fwi_tpu/ops/pallas_bfm.py:173",
    "legendre_anchored": "devito_fwi_tpu/misfit/bfm.py:109 (XLA, no "
                         "pl.pallas_call)",
    "elastic_segments": "devito_fwi_tpu/ops/pallas_staggered.py:173",
    "elastic_fwd_hist_segments": "devito_fwi_tpu/ops/pallas_staggered.py:607",
    "elastic_grad_stream_segments":
        "devito_fwi_tpu/ops/pallas_staggered.py:763",
    "visco_sls2_segments": "devito_fwi_tpu/ops/pallas_staggered.py:395",
    "visco_fwd_hist_segments": "devito_fwi_tpu/ops/pallas_staggered.py:924",
    "visco_grad_stream_segments":
        "devito_fwi_tpu/ops/pallas_staggered.py:1052",
    "tti_forward_dt2_segments": "devito_fwi_tpu/ops/pallas_tti.py:539",
    "tti_gradient_stream_segments": "devito_fwi_tpu/ops/pallas_tti.py:590",
    "tti_forward_ckpt_segments": "devito_fwi_tpu/ops/pallas_tti.py:446",
    "tti_jacobian_adjoint_segments": "devito_fwi_tpu/ops/pallas_tti.py:494",
    "step3": "devito_fwi_tpu/ops/pallas_acoustic3.py:143",
    "forward_dt2_stream3": "devito_fwi_tpu/ops/pallas_acoustic3d.py:301",
    "forward_rec3": "devito_fwi_tpu/ops/pallas_acoustic3d.py:444",
    "gradient_stream3": "devito_fwi_tpu/ops/pallas_acoustic3d.py:596",
    "forward_rows": "devito_fwi_tpu/ops/pallas_legacy.py:107",
}
# bench config 4 (``bench.py`` ``_bench_tti``): marmousi-tti2d, 8 shots and
# 300 receivers at 60 m, tn 4000 ms, f0 7 Hz, 16 checkpoints
TTI_SHOTS = 8
TTI_CHECKPOINTS = 16
# the zero-anisotropy gate: TTI rows against twice the acoustic ones, both
# float32 over the same 1581 steps (u + v - 2 u_acoustic is rounding only;
# measured 5e-7 of the max over 811 steps on the CPU twins)
ZERO_ANISOTROPY_RTOL = 1e-4
# the driver's --resample value of phase 28 (ms): 1001 samples of the 4000 ms
# window against the observed data's 1357
RESAMPLE_DT = 4.0
# the SMARMN shots of phases 27 and 28: the native BFM solves its gathers one
# after another on one host thread where OpenMP does not link (about 9 s a
# shot on the card's host), and the host resamples every trace by splines
NATIVE_SHOTS = 1
# bench config 5 (``bench.py`` ``_bench_3d``): layers-isotropic 96^3, 4
# shots and 48 receivers along x at y = extent/2, z = 30 m, tn 500 ms
C5_SHOTS = 4
# the saved route against the stream route on config 5, both float32: the
# two associate the stencil differently (dt^2 folded into the per-axis
# scales, or applied after the Laplacian) and sum the gradient per step or
# at the end, so they agree to float32 rounding over 333 steps, not bitwise
C5_ROUTE_RTOL = (1e-5, 1e-4)     # objective (relative), gradient (of max)
# Config 5's layer interface lies 480 m down: no reflection reaches the
# receivers within tn 500 ms, so its true data equal the starting model's
# to float32 rounding, their L2 misfit measures rounding (1.4e-10), and
# L-BFGS finds no descent from it. The main path inverts the true data
# scaled by this factor instead: a residual of 0.1 of the traces.
C5_DATA_SCALE = 0.9


T_START = time.perf_counter()


def phase(name):
    """A phase's header, with the script's seconds so far."""
    print(f"== {name} (at {time.perf_counter() - T_START:.1f} s)",
          flush=True)


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


# the kernels redesigned for the H100 keep their twins' sums term for term
# and in order: their outputs must equal the twins' exactly; so must the
# 3-D step kernel, which shares their source (row 7)
EXACT = ("pushforward_slabs_nat", "pushforward_slabs", "elastic_segments",
         "elastic_fwd_hist_segments", "elastic_grad_stream_segments",
         "visco_sls2_segments", "visco_fwd_hist_segments",
         "visco_grad_stream_segments", "forward_rec_segments",
         "forward_dt2_segments", "gradient_stream_segments",
         "forward_ckpt_segments", "gradient_segments", "forward_rec3",
         "forward_dt2_stream3", "gradient_stream3", "step3",
         "tti_forward_dt2_segments", "tti_gradient_stream_segments",
         "tti_forward_ckpt_segments", "tti_jacobian_adjoint_segments")


def compare(name, got, want):
    """Max abs error of each output pair; raises past RTOL * max|want|, or
    past 0 for the kernels of ``EXACT``. One temporary of an output's size
    at most (the history is 11 GB)."""
    worst = 0.0
    rtol = 0.0 if name.split(" ")[0] in EXACT else RTOL
    for g, w in zip(got, want):
        err = float((g - w).abs_().max())
        scale = float(torch.maximum(w.max(), -w.min()))
        print(f"   {name}: max|kernel-twin| = {err:.3e} "
              f"(max|twin| = {scale:.3e}, limit {rtol:g} x max)")
        if not np.isfinite(err) or err > rtol * scale:
            raise AssertionError(f"{name}: kernel disagrees with its twin")
        worst = max(worst, err)
    return worst


def device_events(prof):
    """(name, start ns, end ns) of each device event of a finished
    ``torch.profiler`` run, read from the profiler's records as they are:
    the Python event list that ``prof.events()`` builds from them took
    seconds of host time for a call of many small kernels."""
    from torch.autograd import DeviceType
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def profile_call(fn):
    """Run ``fn`` once under torch.profiler: (wall s, device-busy s, {kernel
    name: device s}). Busy is the union of the kernels' intervals; None
    when the profiler recorded no device activity. Device activity only:
    recording the host's operators too costs host time on each of the
    W2-2d trial's many small calls and inflates the wall it measures."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = device_events(prof)
    if not kernels:
        return wall, None, {}
    busy, end = 0, -1
    by_name = {}
    for name, lo, hi in sorted(kernels, key=lambda e: e[1]):
        busy += max(0, hi - max(lo, end))
        end = max(end, hi)
        by_name[name] = by_name.get(name, 0.0) + (hi - lo) * 1e-9
    return wall, busy * 1e-9, by_name


def kernel_device_ms(fn, reps, match):
    """Run ``fn`` ``reps`` times under torch.profiler: (the number of
    device kernels whose name holds ``match``, their summed device ms)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [hi - lo for name, lo, hi in device_events(prof) if match in name]
    return len(hits), sum(hits) * 1e-6


def report_profile(what, call):
    """Warm ``call`` once, run it under the profiler and print its wall
    time, device busy time, idle share and the kernels that take the most
    device time; returns the wall seconds."""
    call()  # warm: caches, allocator
    wall, busy, by_name = profile_call(call)
    if busy is None:
        print(f"   {what}: {wall * 1e3:.3f} ms wall; device busy share not "
              "measured (the profiler recorded no device events)")
        return wall
    print(f"   {what}: {wall * 1e3:.3f} ms wall, device busy "
          f"{busy * 1e3:.3f} ms, idle share {1 - busy / wall:.1%}")
    for name, sec in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"      {sec * 1e3:9.3f} ms  {name[:110]}")
    return wall


def bound(nbytes, ops):
    """(ms, bound_by, bytes, ops): the larger of bytes over the memory rate
    and float32 operations over the f32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def acoustic_bounds(st, B):
    """The acoustic kernels' bounds at this run's shapes: inputs read once,
    outputs written once; 6r+12 operations per cell-step of the update."""
    f = 4
    cells = B * st.nz * st.nx
    field = st.nz * st.nx
    total, nsteps, nseg = st.nseg * st.seg, st.nsteps, st.nseg
    r = st.kw["space_order"] // 2
    lap = 6 * r + 5          # two axes of (1 + 3r) and the two scales
    ops_fwd = lap + 7        # update, source injection
    common_in = (2 * field + total + cells) * f   # m, hd, wav_pad, inj
    # the forward writes every one of the ``total`` steps; the reverse
    # reads only the first ``nsteps`` of the history and the residual rows
    rows = B * total * 2 * st.nx * f
    hist = B * total * field * f
    pairs = B * nseg * 2 * field * f
    res_used = B * nsteps * 2 * st.nx * f
    adj_ops = cells * nsteps * (lap + 7) + B * nsteps * 2 * st.nx
    work = {
        "forward_rec_segments": (common_in + rows, cells * total * ops_fwd),
        "forward_dt2_segments": (common_in + rows + hist + cells * f,
                                 cells * total * (ops_fwd + 3) +
                                 cells * nsteps * 2),
        "gradient_stream_segments": (2 * field * f +
                                     B * nsteps * field * f + res_used +
                                     cells * f, adj_ops),
        "forward_ckpt_segments": (common_in + rows + pairs + cells * f,
                                  cells * total * ops_fwd +
                                  cells * nsteps * 2),
        # the recompute's one-segment history is scratch, not an output
        "gradient_segments": (common_in + pairs + res_used + cells * f,
                              cells * total * (ops_fwd + 3) + adj_ops),
    }
    return {name: bound(*w) for name, w in work.items()}


def push_bound(planes, slabs):
    """The slab kernel's bound: the five planes read once, the slabs
    written once; per cell the two derived weights, per active
    (cell, subsample) four products and four sums."""
    nbytes = sum(p.numel() * p.element_size() for p in planes) + \
        slabs.numel() * slabs.element_size()
    active = int((planes[3] > 0).sum())
    return bound(nbytes, 2 * planes[3].numel() + 8 * active)


def elastic_bounds(tb, B):
    """The elastic kernels' bounds at this run's shapes: inputs read once,
    outputs written once. Per cell-step, with r = space_order/2 and a
    first-derivative stencil of 2r taps costing 4r operations: the forward
    8 derivatives and the updates, 32r + 31; the reverse 12 derivatives
    and the updates and images, 48r + 52; the modeling forward also the
    two centred derivatives (8r + 5) on the two receiver rows."""
    f = 4
    field = tb.nz * tb.nx
    cells = B * field
    r = tb.kw["space_order"] // 2
    nsteps = tb.nsteps
    params = 9 * field * f
    ops_fwd = 32 * r + 31
    rows10 = B * nsteps * 2 * 2 * tb.nx * f
    work = {
        "elastic_segments": (
            params + nsteps * f + cells * f + rows10,
            cells * nsteps * ops_fwd + B * nsteps * 2 * tb.nx * (8 * r + 5)),
        "elastic_fwd_hist_segments": (
            params + nsteps * f + cells * f + B * nsteps * 2 * tb.nx * f
            + B * nsteps * 4 * field * f + cells * f,
            cells * nsteps * (ops_fwd + 4)),
        "elastic_grad_stream_segments": (
            params + B * nsteps * 4 * field * f + B * nsteps * 2 * tb.nx * f
            + 5 * cells * f,
            cells * nsteps * (48 * r + 52)),
    }
    return {name: bound(*w) for name, w in work.items()}


def step_floors(cells, nsteps, fields):
    """Per-step traffic floors: {name: (redesigned ms, first-design ms,
    redesigned fields, first-design fields)}, the fields of ``cells`` cells
    a step through device memory at 3.35 TB/s over ``nsteps`` steps."""
    per_ms = cells * 4 * nsteps / PEAK_BYTES_PER_S * 1e3
    return {name: (new * per_ms, old * per_ms, new, old)
            for name, (new, old) in fields.items()}


def print_floors(floors, ms, nsteps):
    """One line a sweep; ``nsteps`` the steps to count a step's time over,
    one number or {name: steps}."""
    for name, (new, old, nn, no) in floors.items():
        n = nsteps[name] if isinstance(nsteps, dict) else nsteps
        print(f"   {name}: per-step traffic floor {new:.3f} ms (the "
              f"redesign's {nn:g} fields a step, {new / n * 1e3:.1f} "
              f"us a step); {old:.3f} ms for the first design's {no:g} "
              f"fields; kernel {ms[name] / n * 1e3:.1f} us a step, "
              f"{ms[name] / new:.2f}x the redesign's floor")


def acoustic_step_floors(st, B):
    """The 2-D acoustic sweeps' per-step traffic floors, in fields of the
    batch. The forwards over the ``total`` padded steps they run: the fused
    tile runs two steps a launch, reads u and up and writes the two new
    fields, 2 fields a step; the history adds its write (1), the
    illumination its read and write once a launch (1 a step), 4; the
    checkpoint sweep the illumination (the pairs are 2 fields a segment),
    3. The first design's one launch a step moved 4 (u, up and the dense
    source pattern read, up written), 7 with the history and the
    illumination, 6 with the illumination and the pairs. The reverse over
    the ``nsteps`` real steps: the first design read v, vn, the history
    slot and grad and wrote vn and grad, 6 fields a step; the two-step
    tile reads v, vn, grad and two history slots and writes the new pair
    and grad once a launch, 4 fields a step. (A persistent sweep that kept
    v, vn and grad, 24.6 MB at 29 SMARMN shots, in the 50 MB L2 between
    its steps would read only the history slot from device memory: 1
    field a step, under that assumption.) Row 5 adds its recompute on the
    two-step tile with the history (3 fields a step; 5 in the first
    design) over the padded steps."""
    cells = B * st.nz * st.nx
    total, nsteps = st.nseg * st.seg, st.nsteps
    out = step_floors(cells, total, {"forward_rec_segments": (2, 4),
                                     "forward_dt2_segments": (4, 7),
                                     "forward_ckpt_segments": (3, 6)})
    rev = step_floors(cells, nsteps, {"gradient_stream_segments": (4, 6)})
    out.update(rev)
    rec = step_floors(cells, total, {"fwd": (3, 5)})["fwd"]
    r = rev["gradient_stream_segments"]
    out["gradient_segments"] = (rec[0] + r[0], rec[1] + r[1], 3 + 4, 5 + 6)
    return out


def acoustic3d_step_floors(st, B):
    """The 3-D sweeps' per-step traffic floors, in fields of one shot.
    The march reads u and up and writes up for each of the B shots and the
    three parameter fields once (the shots of a tile run together): 3B + 3;
    the history adds its write and the illumination's read and write: 6B +
    3. The reverse march reads v, vn, the history slot and grad and writes
    vn and grad: 6B + 3 as well. The first design had the shot as the
    grid's slowest axis, so the parameters came in once a shot: 6B, 9B and
    9B."""
    ny, nz, nx = st.m3.shape
    return step_floors(ny * nz * nx, st.nsteps,
                       {"forward_rec3": (3 * B + 3, 6 * B),
                        "forward_dt2_stream3": (6 * B + 3, 9 * B),
                        "gradient_stream3": (6 * B + 3, 9 * B)})


def elastic_step_floors(tb, B):
    """The elastic sweeps' per-step traffic floors: the batch state through
    device memory once a step. The fused forward step reads the old state
    (three stresses, two velocities) and writes the new, 10 fields; the
    history adds 4. The first design's two phases moved 16: 7 and 9, the
    dense source pattern among them. The fused reverse step reads the
    history's 4, the five adjoints and the five images and writes the
    adjoints and the images: 24 fields. The first design's two launches
    moved 35: the velocity phase 24 (the history's 4, the five adjoints
    and three derived fields read, the two velocity adjoints and five
    images read and written), the stress phase 11 (the two velocity and
    three stress adjoints read, the three stress adjoints and three
    derived fields written)."""
    return step_floors(B * tb.nz * tb.nx, tb.nsteps,
                       {"elastic_segments": (10, 16),
                        "elastic_fwd_hist_segments": (14, 20),
                        "elastic_grad_stream_segments": (24, 35)})


def tti_step_floors(b, B):
    """The TTI sweeps' per-step traffic floors, in fields of one shot (nz x
    nx) a step. The fused reverse step reads du, dv, dun, dvn, both history
    slots and grad and writes grad, dun and dvn for each of the B shots,
    and the seven coefficients once (the shots of a tile run together):
    10B + 7. The first design's two launches moved 29B: the gz phase 10B
    (du, dv, both history slots and grad read, grad and the four products
    written), the update 10B (du, dv, dun, dvn and the four products read,
    dun and dvn written), and nine coefficient reads a shot (eh, dh, sin,
    cos; eh, dh, m, 2m + hd, 1/(m + hd)). The fused forward step reads u,
    up, v and vp and writes un, vn over up, vp, the seven coefficients
    once: 6B + 7, 8B + 7 with the two history writes (the source's few
    listed cells count nothing). The first design's two phases moved 24B:
    the gz phase 6B (u and v read, four products written), the update 11B
    (u, up, v, vp, the products and the dense source pattern read, up and
    vp written), the seven coefficients once a shot; 26B with the
    histories. The checkpoint forward and the recompute run the ``nseg_ck
    * seg_ck`` padded steps (1584 at config 4, against 1579), the
    checkpoint reverse its recompute (the forward with the histories) and
    then the reverse; their floors count each over its own steps, and
    ``print_floors`` divides by nsteps."""
    field = b.kw["nz"] * b.kw["nx"]
    ns, nt = b.nsteps, b.nseg_ck * b.seg_ck
    rev = step_floors(field, ns, {"rev": (10 * B + 7, 29 * B)})["rev"]
    out = step_floors(field, ns, {
        "tti_forward_dt2_segments": (8 * B + 7, 26 * B),
        "tti_gradient_stream_segments": (10 * B + 7, 29 * B)})
    out.update(step_floors(field, nt, {
        "tti_forward_ckpt_segments": (6 * B + 7, 24 * B)}))
    rec = step_floors(field, nt, {"fwd": (8 * B + 7, 26 * B)})["fwd"]
    out["tti_jacobian_adjoint_segments"] = (
        rec[0] + rev[0], rec[1] + rev[1], 18 * B + 14, 55 * B)
    return out


def visco_step_floors(tb, B):
    """The viscoacoustic sweeps' per-step traffic floors: the state through
    device memory once a step. The fused forward step reads p, pp and r and
    writes pn and rn: 5 fields; the history adds its 2 and the
    illumination's read and write, 9. The first design's two launches moved
    11: the flux launch 3 (p read, two fluxes written), the update 8 (the
    fluxes, r, p, pp and the dense source pattern read, pp and r written);
    15 with the history. The fused reverse step reads lp and lr in both
    buffers, the history's two fields and the four images and writes lp,
    lr and the images: 16 fields. The first design's two launches moved 31:
    the flux launch 6 (lp and lr, four fluxes), the update 25 (the fluxes,
    the history, the dense source weights, lp, lpp, lr, pendR and the five
    images read; lp, lpp, lr, pendR and the images written)."""
    return step_floors(B * tb.nz * tb.nx, tb.nsteps,
                       {"visco_sls2_segments": (5, 11),
                        "visco_fwd_hist_segments": (9, 15),
                        "visco_grad_stream_segments": (16, 31)})


def visco_bounds(tb, B):
    """The viscoacoustic kernels' bounds at this run's shapes: inputs read
    once, outputs written once. Per cell-step, with r = space_order/2 and a
    staggered first derivative of 2r taps costing 4r operations: the
    forward L (four derivatives, two b products, one sum) and the update,
    16r + 18, plus 2 for the illumination; the reverse two L's and the
    pointwise recursion and images, 32r + 31, plus the residual rows."""
    f = 4
    field = tb.nz * tb.nx
    cells = B * field
    r = tb.kw["space_order"] // 2
    nsteps = tb.nsteps
    params = 6 * field * f
    rows = B * nsteps * 2 * tb.nx * f
    hist = B * nsteps * 2 * field * f
    work = {
        "visco_sls2_segments": (
            params + cells * f + nsteps * f + rows + cells * f,
            cells * nsteps * (16 * r + 18)),
        "visco_fwd_hist_segments": (
            params + cells * f + nsteps * f + rows + hist + cells * f,
            cells * nsteps * (16 * r + 20)),
        "visco_grad_stream_segments": (
            params + cells * f + hist + rows + nsteps * f + 5 * cells * f,
            cells * nsteps * (32 * r + 31) + B * nsteps * 2 * tb.nx),
    }
    return {name: bound(*w) for name, w in work.items()}


def cuda_once(fn):
    """(device ms of one call of ``fn``, its output), no warm-up."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def run_driver(marm, cfg, argv, counters, bfm_options=None):
    """Drive a Marmousi driver (``--maxiter 2``, the configuration's shots)
    on cuda with every counter set to 0 just before (``counters``: their
    reset functions); returns the driver's stats."""
    for reset in counters:
        reset()
    with tempfile.TemporaryDirectory() as odir:
        _, stats = marm.run_fwi(cfg, argv + [
            "--maxiter", "2", "--odir", odir, "--device", "cuda"],
            bfm_options=bfm_options)
        logs = sorted(glob.glob(os.path.join(odir, "log*", "misfit")))
        if logs:
            with open(logs[0]) as f:
                stats["first_line"] = f.readline()
    torch.cuda.synchronize()
    return stats


def first_line_check(stats, run, misfit, f_ref=None):
    """The first gradient's logged misfit line (f, max|g|) against the JAX
    system's SMARMN run of ``result_r5/<run>/log<misfit>/misfit`` at the
    printed digits: f within ``FIRST_LINE_RTOL[0]`` relative and max|g|
    within ``FIRST_LINE_RTOL[1]``. With ``f_ref`` the line is printed
    against the run and f is held to ``f_ref`` instead."""
    path = os.path.join(HERE, "result_r5", run, f"log{misfit}", "misfit")
    with open(path) as f:
        want = [float(v) for v in f.readline().split()]
    got = [float(v) for v in stats["first_line"].split()]
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    print(f"   first logged line {got} against result_r5/{run} {want}: "
          f"relative {rel[0]:.2e} (f) [{FIRST_LINE_RTOL[0]}], {rel[1]:.2e} "
          f"(max|g|) [{FIRST_LINE_RTOL[1]}]")
    if f_ref is not None:
        rel_ref = abs(stats["calls"][0][1] - f_ref) / f_ref
        print(f"   f {stats['calls'][0][1]:.6e} against the JAX package's "
              f"float64 objective {f_ref:.6e}: relative {rel_ref:.2e} "
              f"[{FIRST_LINE_RTOL[0]}]")
        if not rel_ref <= FIRST_LINE_RTOL[0]:
            raise AssertionError(f"the first {run} objective parts from the "
                                 "JAX package's float64 value")
        return
    if not (rel[0] <= FIRST_LINE_RTOL[0] and rel[1] <= FIRST_LINE_RTOL[1]):
        raise AssertionError(f"the first misfit line of the {run} run "
                             f"parts from the JAX run's: {got} vs {want}")


def check_history(stats):
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
    values = [c[1] for c in calls]
    if not (len(f) == 2 and np.all(np.isfinite(values)) and f[1] < f[0]
            and last_trials and min(last_trials) < f[1]):
        raise AssertionError(f"misfit not finite and decreasing: {calls}")


def elastic_march_small(dev, cs):
    """Both elastic forwards on a 41 x 41 grid (one strip of the march,
    segments of a few rows) at every radius the kernels take, on random
    parameters and sources of 2 shots, held to their twins exactly."""
    g = torch.Generator().manual_seed(41)
    nz = nx = 41
    B, nt, seg = 2, 13, 5
    for r in range(1, 9):
        prm = tuple((0.5 + torch.rand((nz, nx), generator=g)).to(dev)
                    for _ in range(9))
        inj = torch.zeros((B, nz * nx))
        for b in range(B):
            inj[b, torch.randperm(nz * nx, generator=g)[:4]] = \
                torch.randn(4, generator=g)
        inj = inj.reshape(B, nz, nx).to(dev)
        wav = torch.randn(nt, 1, generator=g).to(dev)
        kw = dict(nt=nt, nx=nx, nz=nz, space_order=2 * r,
                  spacing=(10., 12.), z0=nz // 3)
        wav1 = cs.pad_wavelet(wav, nt - 1, nt - 1)
        wavs = cs.pad_wavelet(wav, nt - 1, seg * -(-(nt - 1) // seg))
        compare(f"elastic_segments 41 x 41 r {r}",
                [cs.elastic_segments(*prm, inj, wav1, 0.9, **kw)],
                [cs.elastic_segments_plain(*prm, inj, wav1, 0.9, **kw)])
        compare(f"elastic_fwd_hist_segments 41 x 41 r {r}",
                cs.elastic_fwd_hist_segments(*prm, inj, wavs, 0.9, seg=seg,
                                             **kw),
                cs.elastic_fwd_hist_plain(*prm, inj, wavs, 0.9, seg=seg,
                                          **kw))


def elastic_phases(dev, rng, marm, elastic_fwi, cs, counters, report, ms,
                   plain_ms, err, bounds):
    """Phases 11-14: the elastic kernels against their twins at 3 SMARM2
    shots, the SMARM2 elastic FWI driver, the kernels against their twins
    at 31 shots with their times and bounds, and the driver's profile."""
    # return what the acoustic phases left cached before the elastic tables
    # are allocated: a small long-lived tensor placed in a large cached
    # block pins that block's whole segment for the rest of the run
    gc.collect()
    torch.cuda.empty_cache()
    eargs = marm.make_parser(marm.SMARM2).parse_args(
        ["--physics", "elastic", "--device", "cuda"])
    _, geoms, fields, mask = marm.setup_elastic(
        marm.SMARM2, eargs, marm.SMARM2.nsrc_default)
    g0 = geoms[1]
    tb = elastic_fwi._Tables(g0, dev)
    vp, vs, rho = elastic_fwi.model_vp_vs_rho(g0.model)

    def T(a):
        return torch.as_tensor(a, device=dev)

    prm = cs.stagger_params(T(rho * (vp * vp - 2.0 * vs * vs)),
                            T(rho * vs * vs), T(1.0 / rho), tb.damp)
    kw = tb.kw
    seg = tb.nsteps   # the objective's layout: one segment of every step
    wav = tb.wav_pad(seg)
    B = g0.nsrc
    print(f"   SMARM2 elastic: padded grid {tb.nx} x {tb.nz}, nt {tb.nt} "
          f"({tb.nsteps} steps, one segment), dt "
          f"{tb.dt:.4f} ms, receivers on rows {tb.z0}, {tb.z0 + 1}, "
          f"space_order {kw['space_order']}, {B} shots")

    def residual_rows(nb):
        return torch.as_tensor(rng.standard_normal((nb, 1, seg, 2, tb.nx)),
                               dtype=torch.float32, device=dev)

    phase(f"11 elastic kernel vs twin (quick gate), {NSHOTS_CHECK} shots at "
          "the SMARM2 grid")
    injT = tb.injT(0, NSHOTS_CHECK)
    compare("elastic_segments",
            [cs.elastic_segments(*prm, injT, wav, tb.dt, **kw)],
            [cs.elastic_segments_plain(*prm, injT, wav, tb.dt, **kw)])
    got = cs.elastic_fwd_hist_segments(*prm, injT, wav, tb.dt, seg=seg,
                                       **kw)
    compare("elastic_fwd_hist_segments", got,
            cs.elastic_fwd_hist_plain(*prm, injT, wav, tb.dt, seg=seg,
                                      **kw))
    res = residual_rows(NSHOTS_CHECK)
    gops = (*prm, got[1], res, tb.dt)
    compare("elastic_grad_stream_segments",
            cs.elastic_grad_stream_segments(*gops, seg=seg, **kw),
            cs.elastic_grad_stream_plain(*gops, seg=seg, **kw))
    del got, res, gops
    torch.cuda.empty_cache()
    elastic_march_small(dev, cs)
    # the reference's elastic example through ElasticWaveSolver on the card
    from devito_fwi_tpu_torch.models.geometry import setup_geometry
    from devito_fwi_tpu_torch.models.presets import demo_model
    from devito_fwi_tpu_torch.ops.elastic_wavesolver import ElasticWaveSolver
    model = demo_model("layers-elastic", space_order=4, shape=(50, 50),
                       nbl=40, dtype=np.float32, spacing=(20., 20.))
    rec1, rec2, _, _, _ = ElasticWaveSolver(
        model, setup_geometry(model, 1000.), space_order=4).forward()
    n1, n2 = np.linalg.norm(rec1.data), np.linalg.norm(rec2.data)
    print(f"   ElasticWaveSolver golden (layers-elastic 50 x 50): |rec1| = "
          f"{n1:.5f} (19.25636), |rec2| = {n2:.6f} (0.627606), atol 1e-3")
    if not (abs(n1 - 19.25636) <= 1e-3 and abs(n2 - 0.627606) <= 1e-3):
        raise AssertionError("the elastic golden norms disagree")

    phase(f"12 main path: SMARM2 elastic FWI, {B} shots, --physics elastic "
          "--misfit 0 --maxiter 2, on cuda")
    # return what the earlier phases left cached, so that the chunks follow
    # the card's memory and not that state; record each sizing decision
    gc.collect()
    torch.cuda.empty_cache()
    sizing = []
    shots_per_batch = elastic_fwi._shots_per_batch

    def spy(nsrc, shot_chunk, per_shot, budget):
        out = shots_per_batch(nsrc, shot_chunk, per_shot, budget)
        sizing.append((per_shot, budget, out))
        return out

    elastic_fwi._shots_per_batch = spy
    try:
        stats = run_driver(marm, marm.SMARM2, ["--physics", "elastic",
                                               "--misfit", "0"], counters)
    finally:
        elastic_fwi._shots_per_batch = shots_per_batch
    check_history(stats)
    ngrad = sum(1 for c in stats["calls"] if c[0])
    per = elastic_fwi._bytes_per_shot(tb, True, "least_square")
    grads = [(budget, n) for p, budget, n in sizing if p == per]
    chunks = [-(-B // n) for _, n in grads]
    print(f"   shot chunks per gradient: {chunks}, sized from {per / 1e9:.3f}"
          " GB per shot and 80% of the largest block the allocator could "
          f"hand out: {[round(b / 0.8 / 1e9, 2) for b, _ in grads]} GB of "
          f"the {torch.cuda.mem_get_info(dev)[1] / 1e9:.2f} GB card")
    if not (len(grads) == ngrad and sum(chunks) ==
            cs.LAUNCHES["elastic_fwd_hist_segments"] and
            all(n == 1 or n * per <= b for b, n in grads)):
        raise AssertionError(f"the gradients' chunks are not memory-sized: "
                             f"{grads}")
    report("elastic", cs.KERNELS)

    phase(f"13 elastic kernel vs twin and kernel times, {B} shots "
          "(main-path shapes)")
    injT = tb.injT(0, B)
    name = "elastic_segments"
    ms[name], got = cuda_ms(
        lambda: cs.elastic_segments(*prm, injT, wav, tb.dt, **kw), 3)
    plain_ms[name], want = cuda_once(
        lambda: cs.elastic_segments_plain(*prm, injT, wav, tb.dt, **kw))
    err[name] = compare(name, [got], [want])
    del got, want
    name = "elastic_fwd_hist_segments"
    ms[name], fwd = cuda_ms(
        lambda: cs.elastic_fwd_hist_segments(*prm, injT, wav, tb.dt,
                                             seg=seg, **kw), 2)
    hist = fwd[1]
    print(f"   history {tuple(hist.shape)}: {hist.numel():.4g} elements, "
          f"{hist.numel() * 4 / 1e9:.2f} GB")
    # the twin in shot chunks (two 65 GB histories do not fit the card),
    # each chunk held against its slice of the kernel's outputs
    torch.cuda.empty_cache()
    plain_ms[name], worst = 0.0, [0.0, 0.0, 0.0]
    scale = [float(torch.maximum(o.max(), -o.min())) for o in fwd]
    for lo in range(0, B, TWIN_CHUNK):
        hi = min(lo + TWIN_CHUNK, B)
        t_ms, want = cuda_once(lambda: cs.elastic_fwd_hist_plain(
            *prm, injT[lo:hi], wav, tb.dt, seg=seg, **kw))
        plain_ms[name] += t_ms
        for k, (g, w) in enumerate(zip(fwd, want)):
            worst[k] = max(worst[k], float(w.sub_(g[lo:hi]).abs_().max()))
        del want
    for k, what in enumerate(("rows", "history", "illumination")):
        print(f"   {name} {what}: max|kernel-twin| = {worst[k]:.3e} "
              f"(max|twin| = {scale[k]:.3e}, limit 0), twin in shot chunks "
              f"of {TWIN_CHUNK}")
        if not worst[k] == 0.0:
            raise AssertionError(f"{name}: kernel disagrees with its twin")
    err[name] = max(worst)
    del fwd
    torch.cuda.empty_cache()
    name = "elastic_grad_stream_segments"
    res = residual_rows(B)
    gops = (*prm, hist, res, tb.dt)
    ms[name], got = cuda_ms(
        lambda: cs.elastic_grad_stream_segments(*gops, seg=seg, **kw), 2)
    plain_ms[name], want = cuda_once(
        lambda: cs.elastic_grad_stream_plain(*gops, seg=seg, **kw))
    err[name] = compare(name, got, want)
    del hist, res, gops, got, want, injT
    torch.cuda.empty_cache()
    bounds.update(elastic_bounds(tb, B))
    for name in cs.KERNELS:
        b_ms, by, nbytes, nops = bounds[name]
        print(f"   {name}: kernel {ms[name]:.3f} ms, twin "
              f"{plain_ms[name]:.3f} ms, bound {b_ms:.3f} ms by {by} "
              f"({nbytes:.4g} B, {nops:.4g} f32 ops), "
              f"{b_ms / ms[name]:.1%} of the bound")
    r = kw["space_order"] // 2
    blocks = cs._forward_blocks(cs._lib(), r)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fwd = cs.forward_launch(B, tb.nz, tb.nx, r, sms, blocks)
    print(f"   forward march: strips of {fwd.strip} columns, segments of "
          f"{fwd.seg} rows, {fwd.threads} threads, grid {fwd.grid}, "
          f"{fwd.smem} bytes of shared memory a block, {blocks} blocks an "
          "SM")
    rev = cs.adjoint_launch(B, tb.nz, tb.nx, r)
    print(f"   fused reverse step: tile {rev.tile}, {rev.threads} threads, "
          f"grid {rev.grid}, {rev.smem} bytes of shared memory a block")
    print_floors(elastic_step_floors(tb, B), ms, tb.nsteps)

    phase(f"14 elastic profile: one steady-state gradient and one trial, "
          f"{B} shots")
    obs, _ = elastic_fwi.elastic_fm_multi(geoms[0], device="cuda")
    dw, _ = elastic_fwi.elastic_fm_multi(geoms[2], device="cuda")
    _, smooth_vp, vs0, rho0 = fields
    loss = elastic_fwi.ElasticFwiLoss(vs0, rho0, device="cuda")
    x0 = 1.0 / smooth_vp.reshape(-1).astype(np.float64) ** 2
    for reset in counters:
        reset()
    for calc_grad in (True, False):
        report_profile(f"elastic {'gradient' if calc_grad else 'trial'}",
                       lambda: loss(x0, g0, obs, None, dw, mask,
                                    calc_grad=calc_grad))
    report("profiled elastic", cs.KERNELS, record=False)
    cs.reset_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    loss(x0, g0, obs, None, dw, mask, calc_grad=True)
    torch.cuda.synchronize()
    chunk = -(-B // cs.LAUNCHES["elastic_fwd_hist_segments"])
    per = (torch.cuda.max_memory_allocated(dev) - base) / chunk
    sized = elastic_fwi._bytes_per_shot(tb, True, "least_square")
    print(f"   gradient peak: {per / 1e9:.4f} GB per shot (chunks of "
          f"{chunk}); sized with {sized / 1e9:.4f} GB")
    if per > sized:
        raise AssertionError("the elastic gradient holds more per shot than "
                             "elastic_fwi._bytes_per_shot says")
    # the chunked route on the card: the same gradient with at most half the
    # shots per chunk (a smaller card's chunks, at least two) against the
    # memory-sized one; each shot's sweep is the same, the traces' products
    # and the shots' sums may round in another order
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    for label, chunk in (("memory-sized", None),
                         (f"shot_chunk={-(-B // 2)}", -(-B // 2))):
        lossc = elastic_fwi.ElasticFwiLoss(vs0, rho0, shot_chunk=chunk,
                                        device="cuda")
        cs.reset_counters()
        t0 = time.perf_counter()
        out[label] = lossc(x0, g0, obs, None, dw, mask)
        sec = time.perf_counter() - t0
        nchunks = cs.LAUNCHES["elastic_fwd_hist_segments"]
        print(f"   gradient, {label}: {nchunks} chunk(s), {sec:.3f} s, "
              f"objective {out[label][0]!r}")
    if nchunks < 2:
        raise AssertionError(f"{label} ran {nchunks} chunk, not two or more")
    (f1, g1, _), (f2, g2, _) = out.values()
    rel = float(np.abs(g2 - g1).max() / np.abs(g1).max())
    print(f"   half-size chunks vs memory-sized: objective "
          f"{abs(f2 - f1) / f1:.2e}, "
          f"gradient {rel:.2e} of its max (limit 1e-5)")
    if not (abs(f2 - f1) <= 1e-5 * f1 and rel <= 1e-5):
        raise AssertionError("the chunked elastic gradient disagrees")
    del obs, dw
    torch.cuda.empty_cache()


def visco_phases(dev, rng, marm, visco_fwi, cv, counters, report, ms,
                 plain_ms, err, bounds):
    """Phases 15-18: the viscoacoustic kernels against their twins at 3
    SMARMN shots and the sls/2 golden, the SMARMN viscoacoustic FWI driver,
    the kernels against their twins at 29 shots with their times and
    bounds, and the driver's profile."""
    gc.collect()
    torch.cuda.empty_cache()
    vargs = marm.make_parser(marm.SMARMN).parse_args(
        ["--physics", "viscoacoustic", "--device", "cuda"])
    _, geoms, smooth_vp, mask = marm.setup_visco(
        marm.SMARMN, vargs, marm.SMARMN.nsrc_default)
    g0 = geoms[1]
    tb = visco_fwi._Tables(g0, dev)
    vp = torch.as_tensor(visco_fwi._field(g0.model, "vp"), device=dev)
    qp = torch.as_tensor(visco_fwi._field(g0.model, "qp"), device=dev)
    prm, vp2 = tb.operands(vp, qp)
    kw = tb.kw
    seg = tb.nsteps   # the objective's layout: one segment of every step
    wav = tb.wav_pad(seg)
    s = torch.as_tensor(tb.dt, dtype=torch.float32, device=dev)
    wavs2 = wav * (s * s)
    B = g0.nsrc
    qpc = g0.model.crop(g0.model.qp)
    print(f"   SMARMN viscoacoustic: padded grid {tb.nx} x {tb.nz}, nt "
          f"{tb.nt} ({tb.nsteps} steps, one segment), dt {tb.dt:.4f} ms, "
          f"receivers on rows {tb.z0}, {tb.z0 + 1}, space_order "
          f"{kw['space_order']}, qp {qpc.min():.1f}-{qpc.max():.1f}, {B} "
          "shots")

    def residual_rows(nb):
        return torch.as_tensor(rng.standard_normal((nb, 1, seg, 2, tb.nx)),
                               dtype=torch.float32, device=dev)

    phase(f"15 viscoacoustic kernel vs twin (quick gate), {NSHOTS_CHECK} "
          "shots at the SMARMN grid")
    injT, injwT = tb.patterns(vp2, 0, NSHOTS_CHECK)
    compare("visco_sls2_segments",
            cv.visco_sls2_segments(*prm, injT, wav, tb.dt, **kw),
            cv.visco_sls2_plain(*prm, injT, wav, tb.dt, **kw))
    got = cv.visco_fwd_hist_segments(*prm, injT, wav, tb.dt, seg=seg, **kw)
    compare("visco_fwd_hist_segments", got,
            cv.visco_fwd_hist_plain(*prm, injT, wav, tb.dt, seg=seg, **kw))
    gops = (*prm, injwT, got[1], residual_rows(NSHOTS_CHECK), wavs2, tb.dt)
    compare("visco_grad_stream_segments",
            cv.visco_grad_stream_segments(*gops, seg=seg, **kw),
            cv.visco_grad_stream_plain(*gops, seg=seg, **kw))
    del got, gops, injT, injwT
    torch.cuda.empty_cache()
    # the reference's sls/2 example through ViscoacousticWaveSolver
    from devito_fwi_tpu_torch.models.geometry import setup_geometry
    from devito_fwi_tpu_torch.models.presets import demo_model
    from devito_fwi_tpu_torch.ops.viscoacoustic_wavesolver import (
        ViscoacousticWaveSolver)
    model = demo_model("layers-viscoacoustic", space_order=4, shape=(50, 50),
                       nbl=40, dtype=np.float32, spacing=(20., 20.))
    before = cv.LAUNCHES["visco_sls2_segments"]
    rec, _, _, _ = ViscoacousticWaveSolver(
        model, setup_geometry(model, 1000.), space_order=4).forward()
    n = np.linalg.norm(rec.data)
    print(f"   ViscoacousticWaveSolver sls/2 golden (layers-viscoacoustic 50 "
          f"x 50): |rec| = {n:.4f} (684.385, atol 1e-2), through the "
          "modeling kernel: "
          f"{cv.LAUNCHES['visco_sls2_segments'] == before + 1}")
    if not (abs(n - 684.385) <= 1e-2 and
            cv.LAUNCHES["visco_sls2_segments"] == before + 1):
        raise AssertionError("the viscoacoustic golden disagrees or did not "
                             "run the kernel")

    phase(f"16 main path: SMARMN viscoacoustic FWI, {B} shots, --physics "
          "viscoacoustic --misfit 0 --maxiter 2, on cuda")
    gc.collect()
    torch.cuda.empty_cache()
    sizing = []
    shots_per_batch = visco_fwi._shots_per_batch

    def spy(nsrc, shot_chunk, per_shot, budget):
        out = shots_per_batch(nsrc, shot_chunk, per_shot, budget)
        sizing.append((per_shot, budget, out))
        return out

    visco_fwi._shots_per_batch = spy
    try:
        stats = run_driver(marm, marm.SMARMN, ["--physics", "viscoacoustic",
                                               "--misfit", "0"], counters)
    finally:
        visco_fwi._shots_per_batch = shots_per_batch
    check_history(stats)
    ngrad = sum(1 for c in stats["calls"] if c[0])
    per = visco_fwi._bytes_per_shot(tb, True, "least_square")
    grads = [(budget, n) for p, budget, n in sizing if p == per]
    chunks = [-(-B // n) for _, n in grads]
    print(f"   shot chunks per gradient: {chunks}, sized from {per / 1e9:.3f}"
          " GB per shot and 80% of the largest block the allocator could "
          f"hand out: {[round(b / 0.8 / 1e9, 2) for b, _ in grads]} GB")
    if not (len(grads) == ngrad and sum(chunks) ==
            cv.LAUNCHES["visco_fwd_hist_segments"] and
            all(n == 1 or n * per <= b for b, n in grads)):
        raise AssertionError(f"the gradients' chunks are not memory-sized: "
                             f"{grads}")
    report("viscoacoustic", cv.KERNELS)

    phase(f"17 viscoacoustic kernel vs twin and kernel times, {B} shots "
          "(main-path shapes)")
    gc.collect()
    torch.cuda.empty_cache()
    injT, injwT = tb.patterns(vp2, 0, B)
    name = "visco_sls2_segments"
    ms[name], got = cuda_ms(
        lambda: cv.visco_sls2_segments(*prm, injT, wav, tb.dt, **kw), 3)
    plain_ms[name], want = cuda_once(
        lambda: cv.visco_sls2_plain(*prm, injT, wav, tb.dt, **kw))
    err[name] = compare(name, got, want)
    del got, want
    name = "visco_fwd_hist_segments"
    ms[name], fwd = cuda_ms(
        lambda: cv.visco_fwd_hist_segments(*prm, injT, wav, tb.dt, seg=seg,
                                           **kw), 2)
    hist = fwd[1]
    print(f"   history {tuple(hist.shape)}: {hist.numel():.4g} elements, "
          f"{hist.numel() * 4 / 1e9:.2f} GB")
    torch.cuda.empty_cache()
    plain_ms[name], worst = 0.0, [0.0, 0.0, 0.0]
    scale = [float(torch.maximum(o.max(), -o.min())) for o in fwd]
    for lo in range(0, B, TWIN_CHUNK):
        hi = min(lo + TWIN_CHUNK, B)
        t_ms, want = cuda_once(lambda: cv.visco_fwd_hist_plain(
            *prm, injT[lo:hi], wav, tb.dt, seg=seg, **kw))
        plain_ms[name] += t_ms
        for k, (g, w) in enumerate(zip(fwd, want)):
            worst[k] = max(worst[k], float(w.sub_(g[lo:hi]).abs_().max()))
        del want
    for k, what in enumerate(("rows", "history", "illumination")):
        print(f"   {name} {what}: max|kernel-twin| = {worst[k]:.3e} "
              f"(max|twin| = {scale[k]:.3e}, limit 0), twin in shot chunks "
              f"of {TWIN_CHUNK}")
        if not worst[k] == 0.0:
            raise AssertionError(f"{name}: kernel disagrees with its twin")
    err[name] = max(worst)
    del fwd
    torch.cuda.empty_cache()
    name = "visco_grad_stream_segments"
    gops = (*prm, injwT, hist, residual_rows(B), wavs2, tb.dt)
    ms[name], got = cuda_ms(
        lambda: cv.visco_grad_stream_segments(*gops, seg=seg, **kw), 2)
    plain_ms[name], want = cuda_once(
        lambda: cv.visco_grad_stream_plain(*gops, seg=seg, **kw))
    err[name] = compare(name, got, want)
    del hist, gops, got, want, injT, injwT
    torch.cuda.empty_cache()
    bounds.update(visco_bounds(tb, B))
    for name in cv.KERNELS:
        b_ms, by, nbytes, nops = bounds[name]
        print(f"   {name}: kernel {ms[name]:.3f} ms, twin "
              f"{plain_ms[name]:.3f} ms, bound {b_ms:.3f} ms by {by} "
              f"({nbytes:.4g} B, {nops:.4g} f32 ops), "
              f"{b_ms / ms[name]:.1%} of the bound")
    r = kw["space_order"] // 2
    for what, launch in (("forward", cv.forward_launch(B, tb.nz, tb.nx, r)),
                         ("reverse", cv.adjoint_launch(B, tb.nz, tb.nx, r))):
        print(f"   fused {what} step: tile {launch.tile}, {launch.threads} "
              f"threads, grid {launch.grid}, {launch.smem} bytes of shared "
              "memory a block")
    print_floors(visco_step_floors(tb, B), ms, tb.nsteps)

    phase(f"18 viscoacoustic profile: one steady-state gradient and one "
          f"trial, {B} shots")
    obs = visco_fwi.visco_fm_multi(geoms[0], device="cuda")
    dw = visco_fwi.visco_fm_multi(geoms[2], device="cuda")
    loss = visco_fwi.ViscoFwiLoss(device="cuda")
    x0 = 1.0 / smooth_vp.reshape(-1).astype(np.float64) ** 2
    for calc_grad in (True, False):
        report_profile(
            f"viscoacoustic {'gradient' if calc_grad else 'trial'}",
            lambda: loss(x0, g0, obs, None, dw, mask, calc_grad=calc_grad))
    cv.reset_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    loss(x0, g0, obs, None, dw, mask, calc_grad=True)
    torch.cuda.synchronize()
    chunk = -(-B // cv.LAUNCHES["visco_fwd_hist_segments"])
    per = (torch.cuda.max_memory_allocated(dev) - base) / chunk
    sized = visco_fwi._bytes_per_shot(tb, True, "least_square")
    print(f"   gradient peak: {per / 1e9:.4f} GB per shot (chunks of "
          f"{chunk}); sized with {sized / 1e9:.4f} GB")
    if per > sized:
        raise AssertionError("the viscoacoustic gradient holds more per shot "
                             "than visco_fwi._bytes_per_shot says")
    del obs, dw
    torch.cuda.empty_cache()


def tti_bounds(b, B):
    """The TTI kernels' bounds at this run's shapes: inputs read once,
    outputs written once, plus the histories. Per cell-step, with R =
    space_order/2 and n1 the non-zero taps of the centred first derivative
    (a D1 costs 2 n1 operations, a D2 6R/2 + 2): forward and reverse alike
    16 n1 + 6R + 43 (four D1 in the gz phase, four D1 and two D2 in the
    update, the products, sums and the two leapfrog updates), +6 for the
    two d2/dt2 histories; u + v on the two receiver rows, and the residual
    added to both fields there. The checkpoint reverse counts its recompute
    too."""
    f = 4
    nx, nz = b.kw["nx"], b.kw["nz"]
    field = nz * nx
    cells = B * field
    R = b.kw["space_order"] // 2
    n1 = sum(1 for w in b.st.w1 if w != 0.0)
    ops = 16 * n1 + 6 * R + 43
    nsteps = b.nsteps
    total_ck = b.nseg_ck * b.seg_ck
    coeffs = 6 * field * f
    inj = cells * f
    row = B * 2 * nx
    work = {
        "tti_forward_dt2_segments": (
            coeffs + (nsteps + 1) * f + inj + row * nsteps * f
            + 2 * B * nsteps * field * f,
            cells * nsteps * (ops + 6) + row * nsteps),
        "tti_gradient_stream_segments": (
            coeffs + 2 * B * nsteps * field * f + row * nsteps * f
            + cells * f,
            cells * nsteps * ops + 2 * row * nsteps),
        "tti_forward_ckpt_segments": (
            coeffs + (total_ck + 1) * f + inj + row * total_ck * f
            + B * b.nseg_ck * 4 * field * f,
            cells * total_ck * ops + row * total_ck),
        "tti_jacobian_adjoint_segments": (
            coeffs + (total_ck + 1) * f + inj
            + B * b.nseg_ck * 4 * field * f + row * nsteps * f + cells * f,
            cells * total_ck * (ops + 6) + cells * nsteps * ops
            + 2 * row * nsteps),
    }
    return {name: bound(*w) for name, w in work.items()}


def tti_config4(nsrc, model=None):
    """Bench config 4's geometry (``bench.py`` ``_bench_tti``) with ``nsrc``
    shots on ``model`` (default the port's marmousi-tti2d at space order
    8, nbl 40): sources and receivers at 60 m along the surface, a
    receiver a column, tn 4000 ms, f0 7 Hz."""
    from devito_fwi_tpu_torch.models.geometry import AcquisitionGeometry
    from devito_fwi_tpu_torch.models.presets import demo_model
    if model is None:
        model = demo_model("marmousi-tti2d", space_order=8, nbl=40)
    xmax = model.domain_size[0]
    src = np.stack([np.linspace(0., xmax, nsrc), np.full(nsrc, 60.)], 1)
    nrec = model.shape[0]
    rec = np.stack([np.linspace(0., xmax, nrec), np.full(nrec, 60.)], 1)
    return AcquisitionGeometry(model, rec, src, 0.0, 4000.0, f0=0.007,
                               src_type="Ricker")


class TtiCase:
    """One marmousi-tti2d configuration on the card (bench config 4's grid
    and acquisition, ``nsrc`` shots): the fields, the tables, and the
    kernels' operands for shots lo..hi-1 on both layouts."""

    def __init__(self, dev, nsrc, zero_anisotropy=False):
        from devito_fwi_tpu_torch.models.model import SeismicModel
        from devito_fwi_tpu_torch.models.presets import demo_model
        from devito_fwi_tpu_torch.ops import cuda_tti as ct
        from devito_fwi_tpu_torch.ops.acoustic import _ckpt_layout
        from devito_fwi_tpu_torch.ops.interp import interp_table
        model = demo_model("marmousi-tti2d", space_order=8, nbl=40)
        if zero_anisotropy:
            z = np.zeros(model.shape, np.float32)
            model = SeismicModel(origin=model.origin, spacing=model.spacing,
                                 shape=model.shape, space_order=8,
                                 vp=model.crop(model.vp), nbl=40,
                                 bcs="damp", epsilon=z, delta=z, theta=z)
        self.model = model
        self.geom = tti_config4(nsrc, model)
        self.dev = dev
        s_idx, s_w = interp_table(self.geom.src_positions, model.origin_pml,
                                  model.spacing)
        self.r_idx, self.r_w = interp_table(self.geom.rec_positions,
                                            model.origin_pml, model.spacing)
        self.s_idx, self.s_w = s_idx[:, None], s_w[:, None]
        self.fields = [torch.as_tensor(np.asarray(getattr(model, n),
                                                  np.float32), device=dev)
                       for n in ("vp", "damp", "epsilon", "delta", "theta")]
        self.wav = torch.as_tensor(self.geom.src.data[:, :1], device=dev)
        self.dt = float(model.critical_dt)
        self.nt = self.geom.nt
        self.m, self.ops = ct.operands(*self.fields, self.dt)
        nx, nz = model.padded_shape
        self.z0 = int(self.r_idx[..., 1].min())
        self.nsteps, _, _ = _ckpt_layout(self.nt, 1)
        _, self.seg_ck, self.nseg_ck = _ckpt_layout(self.nt, TTI_CHECKPOINTS)
        self.st = ct._statics(8, model.spacing, self.dt, torch.float32)
        self.kw = dict(nt=self.nt, nx=nx, nz=nz, space_order=8,
                       spacing=model.spacing, z0=self.z0)
        s2 = self.dt ** 2
        self.wavs = {1: ct.pack_wavelet(self.wav, s2, self.nt, self.nsteps),
                     TTI_CHECKPOINTS: ct.pack_wavelet(
                         self.wav, s2, self.nt, self.nseg_ck * self.seg_ck)}

    def injT(self, lo, hi):
        from devito_fwi_tpu_torch.ops import cuda_acoustic as ca
        inj = ca.source_pattern(self.s_idx[lo:hi], self.s_w[lo:hi], self.m,
                                self.dt ** 2)
        return inj.transpose(1, 2).contiguous()

    def kwargs(self, nck):
        return dict(self.kw, n_checkpoints=nck)

    def batched(self):
        """The arguments of ``cuda_tti.tti_gradient_batched`` before obs."""
        return (*self.fields, self.wav, self.s_idx, self.s_w, self.r_idx,
                self.r_w)

    def res_rows(self, rng, B):
        """Seeded residual rows of nsteps steps on both layouts: (B, 1,
        nsteps, 2, nx) and the same steps zero-padded to (B, nseg, seg, 2,
        nx)."""
        nx = self.kw["nx"]
        r = torch.as_tensor(rng.standard_normal((B, self.nsteps, 2, nx)),
                            dtype=torch.float32, device=self.dev)
        ck = r.new_zeros((B, self.nseg_ck * self.seg_ck, 2, nx))
        ck[:, :self.nsteps] = r
        return (r.reshape(B, 1, self.nsteps, 2, nx),
                ck.reshape(B, self.nseg_ck, self.seg_ck, 2, nx))


def tti_phases(dev, rng, ct, ca, counters, report, ms, plain_ms, err,
               bounds):
    """Phases 19-22: the TTI kernels against their twins at 3 shots and the
    zero-anisotropy gate, bench config 4's gradient on cuda, the kernels
    against their twins at its 8 shots with their times and bounds, and a
    profile of the gradient."""
    gc.collect()
    torch.cuda.empty_cache()
    tc = TtiCase(dev, TTI_SHOTS)
    kw1, kwc = tc.kwargs(1), tc.kwargs(TTI_CHECKPOINTS)
    w1, wc = tc.wavs[1], tc.wavs[TTI_CHECKPOINTS]
    print(f"   marmousi-tti2d: padded grid {kw1['nx']} x {kw1['nz']}, nt "
          f"{tc.nt} ({tc.nsteps} steps; checkpoint route {tc.nseg_ck} x "
          f"{tc.seg_ck}), dt {tc.dt:.4f} ms, receivers on rows {tc.z0}, "
          f"{tc.z0 + 1}, space_order 8, {TTI_SHOTS} shots")

    phase(f"19 TTI kernel vs twin (quick gate), {NSHOTS_CHECK} shots at the "
          "marmousi-tti2d grid")
    injT = tc.injT(0, NSHOTS_CHECK)
    fwd = ct.tti_forward_dt2_segments(*tc.ops, injT, w1, tc.dt, **kw1)
    compare("tti_forward_dt2_segments", fwd,
            ct.tti_forward_dt2_plain(*tc.ops, injT, w1, tc.dt, **kw1))
    res1, resc = tc.res_rows(rng, NSHOTS_CHECK)
    g_s = ct.tti_gradient_stream_segments(*tc.ops, fwd[1], fwd[2], res1,
                                          tc.dt, **kw1)
    compare("tti_gradient_stream_segments", [g_s],
            [ct.tti_gradient_stream_plain(*tc.ops, fwd[1], fwd[2], res1,
                                          tc.dt, **kw1)])
    del fwd
    ck = ct.tti_forward_ckpt_segments(*tc.ops, injT, wc, tc.dt, **kwc)
    compare("tti_forward_ckpt_segments", ck,
            ct.tti_forward_ckpt_plain(*tc.ops, injT, wc, tc.dt, **kwc))
    g_c = ct.tti_jacobian_adjoint_segments(*tc.ops, injT, wc, ck[1], resc,
                                           tc.dt, **kwc)
    compare("tti_jacobian_adjoint_segments", [g_c],
            [ct.tti_jacobian_adjoint_plain(*tc.ops, injT, wc, ck[1], resc,
                                           tc.dt, **kwc)])
    same = torch.equal(g_c, g_s)
    print(f"   checkpoint-route gradient == streamed gradient ({NSHOTS_CHECK}"
          f" shots, same residual rows): {same}")
    if not same:
        raise AssertionError("the TTI recompute gradient differs from the "
                             "streamed one")
    del ck, g_c, g_s, res1, resc, injT
    zc = TtiCase(dev, NSHOTS_CHECK, zero_anisotropy=True)
    zkw = zc.kwargs(1)
    injT = zc.injT(0, NSHOTS_CHECK)
    rows_tti = ct.tti_forward_ckpt_segments(*zc.ops, injT, zc.wavs[1],
                                            zc.dt, **zkw)[0]
    rows_ac = ca.forward_rec_segments(
        zc.ops[0], zc.ops[1], ca.pad_wavelet(zc.wav, zc.nt, zc.nsteps), injT,
        zc.dt, **zkw)
    e = float((rows_tti - 2.0 * rows_ac).abs().max())
    scale = float((2.0 * rows_ac).abs().max())
    print(f"   zero anisotropy (eps = delta = theta = 0, dt {zc.dt:.4f} ms, "
          f"{zc.nsteps} steps): max|TTI rows - 2 acoustic rows| = {e:.3e} "
          f"(max {scale:.3e}, limit {ZERO_ANISOTROPY_RTOL:g} x max)")
    if not e <= ZERO_ANISOTROPY_RTOL * scale:
        raise AssertionError("the isotropic limit of the TTI kernel "
                             "disagrees with the acoustic kernel")
    del zc, rows_tti, rows_ac, injT
    torch.cuda.empty_cache()

    phase(f"20 main path: bench config 4, marmousi-tti2d TTI gradient, "
          f"{TTI_SHOTS} shots, on cuda")
    for reset in counters:
        reset()
    common = dict(nt=tc.nt, spacing=tc.model.spacing, space_order=8,
                  n_checkpoints=TTI_CHECKPOINTS)
    t0 = time.perf_counter()
    obs = ct.tti_forward_batched(*tc.batched(), tc.dt, **common)
    torch.cuda.synchronize()
    print(f"   observed data {tuple(obs.shape)} through "
          f"tti_forward_ckpt_segments: {time.perf_counter() - t0:.3f} s")
    obs_scaled = 0.999 * obs
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        grad = ct.tti_gradient_batched(*tc.batched(), obs_scaled, tc.dt,
                                       **common)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    streamed = ct.LAUNCHES["tti_forward_dt2_segments"] == 3
    print(f"   tti_gradient_batched (streamed route: {streamed}): first call "
          f"{walls[0]:.4f} s, steady state {walls[1]:.4f}, {walls[2]:.4f} s;"
          f" {tuple(grad.shape)}, finite: {bool(grad.isfinite().all())}")
    t0 = time.perf_counter()
    grad_c = ct.tti_gradient_batched(*tc.batched(), obs_scaled, tc.dt,
                                     stream=False, **common)
    torch.cuda.synchronize()
    same = torch.equal(grad, grad_c)
    print(f"   stream=False (checkpoint pair, {tc.nseg_ck} segments): "
          f"{time.perf_counter() - t0:.4f} s; == streamed gradient: {same}")
    if not (streamed and same and grad.isfinite().all()
            and float(grad.abs().max()) > 0):
        raise AssertionError("the TTI gradient is not finite, not streamed "
                             "or differs between the routes")
    from devito_fwi_tpu_torch.models.geometry import AcquisitionGeometry
    from devito_fwi_tpu_torch.ops.tti_wavesolver import AnisotropicWaveSolver
    g1 = AcquisitionGeometry(tc.model, tc.geom.rec_positions,
                             tc.geom.src_positions[:1], 0.0, 4000.0,
                             f0=0.007, src_type="Ricker")
    solver = AnisotropicWaveSolver(tc.model, g1, space_order=8)
    res = g1.new_rec()
    res.data[:] = (obs[0] - obs_scaled[0]).cpu().numpy()
    t0 = time.perf_counter()
    g_solver, _ = solver.gradient_checkpointed(
        res, n_checkpoints=TTI_CHECKPOINTS)
    g0 = grad[0].cpu().numpy()
    rel = float(np.abs(g_solver - g0).max() / np.abs(g0).max())
    print(f"   AnisotropicWaveSolver(device='cuda').gradient_checkpointed, "
          f"one shot: {time.perf_counter() - t0:.3f} s; against shot 0 of "
          f"the batch: {rel:.2e} of its max (limit 1e-5: the residual rows' "
          "products sum one shot apart)")
    if not rel <= 1e-5:
        raise AssertionError("the solver's TTI gradient disagrees")
    report("TTI", ct.KERNELS)
    del grad, grad_c, obs_scaled, obs
    torch.cuda.empty_cache()

    phase(f"21 TTI kernel vs twin and kernel times, {TTI_SHOTS} shots "
          "(main-path shapes)")
    B = TTI_SHOTS
    injT = tc.injT(0, B)
    res1, resc = tc.res_rows(rng, B)
    name = "tti_forward_dt2_segments"
    ms[name], fwd = cuda_ms(lambda: ct.tti_forward_dt2_segments(
        *tc.ops, injT, w1, tc.dt, **kw1), 2)
    print(f"   histories 2 x {tuple(fwd[1].shape)}: "
          f"{2 * fwd[1].numel():.4g} elements, "
          f"{2 * fwd[1].numel() * 4 / 1e9:.2f} GB")
    plain_ms[name], want = cuda_once(lambda: ct.tti_forward_dt2_plain(
        *tc.ops, injT, w1, tc.dt, **kw1))
    err[name] = compare(name, fwd, want)
    del want
    torch.cuda.empty_cache()
    name = "tti_gradient_stream_segments"
    gops = (*tc.ops, fwd[1], fwd[2], res1, tc.dt)
    ms[name], g_s = cuda_ms(lambda: ct.tti_gradient_stream_segments(
        *gops, **kw1), 2)
    plain_ms[name], want = cuda_once(lambda: ct.tti_gradient_stream_plain(
        *gops, **kw1))
    err[name] = compare(name, [g_s], [want])
    del fwd, gops, want
    torch.cuda.empty_cache()
    name = "tti_forward_ckpt_segments"
    ms[name], ck = cuda_ms(lambda: ct.tti_forward_ckpt_segments(
        *tc.ops, injT, wc, tc.dt, **kwc), 3)
    plain_ms[name], want = cuda_once(lambda: ct.tti_forward_ckpt_plain(
        *tc.ops, injT, wc, tc.dt, **kwc))
    err[name] = compare(name, ck, want)
    del want
    name = "tti_jacobian_adjoint_segments"
    jops = (*tc.ops, injT, wc, ck[1], resc, tc.dt)
    ms[name], g_c = cuda_ms(lambda: ct.tti_jacobian_adjoint_segments(
        *jops, **kwc), 2)
    plain_ms[name], want = cuda_once(lambda: ct.tti_jacobian_adjoint_plain(
        *jops, **kwc))
    err[name] = compare(name, [g_c], [want])
    same = torch.equal(g_c, g_s)
    print(f"   checkpoint-route gradient == streamed gradient ({B} shots, "
          f"same residual rows): {same}")
    if not same:
        raise AssertionError("the TTI recompute gradient differs from the "
                             "streamed one")
    del ck, jops, want, g_c, g_s, res1, resc, injT
    torch.cuda.empty_cache()
    bounds.update(tti_bounds(tc, B))
    for name in ct.KERNELS:
        b_ms, by, nbytes, nops = bounds[name]
        print(f"   {name}: kernel {ms[name]:.3f} ms, twin "
              f"{plain_ms[name]:.3f} ms, bound {b_ms:.3f} ms by {by} "
              f"({nbytes:.4g} B, {nops:.4g} f32 ops), "
              f"{b_ms / ms[name]:.1%} of the bound")
    for what, helper in (("forward", ct.forward_launch),
                         ("reverse", ct.adjoint_launch)):
        launch = helper(B, kw1["nz"], kw1["nx"], 4)
        print(f"   fused {what} step: tile {launch.tile}, {launch.threads} "
              f"threads, grid {launch.grid}, {launch.smem} bytes of shared "
              "memory a block, one launch a step")
    print_floors(tti_step_floors(tc, B), ms, tc.nsteps)

    phase(f"22 TTI profile: one steady-state gradient, {TTI_SHOTS} shots")
    obs = ct.tti_forward_batched(*tc.batched(), tc.dt, **common)
    obs_scaled = 0.999 * obs
    report_profile("TTI gradient", lambda: ct.tti_gradient_batched(
        *tc.batched(), obs_scaled, tc.dt, **common))
    del obs, obs_scaled
    torch.cuda.empty_cache()


def legendre_bound(rows, n, W, K):
    """(bytes, ops) of one banded Legendre launch: u read and the output
    written once, the slope table and the row flags; per output the 2W+1
    band taps and per row and certificate sample the n lanes, a product, a
    difference and a max each (the hit test and the first/last update fold
    into maxima of the regions left and right of the band)."""
    nsamp = -(-(n - 1) // K) + 1
    return ((2 * rows * n + n + rows) * 4,
            rows * n * (2 * W + 1) * 3 + rows * nsamp * n * 3)


def anchored_bound(rows, n, A, Wside):
    """(bytes, ops) of one anchored Legendre launch: u read and the output
    written once, the slopes and the flag; per row the npad = A ceil(n/A)
    outputs over their block's window of W = A ceil((2 Wside + A)/A) taps
    and the ceil(n/A) + 1 anchors over the row's n lanes, a product, a
    difference and a max each."""
    npad = -(-n // A) * A
    W = -(-(2 * Wside + A) // A) * A
    return ((2 * rows * n + n) * 4 + 1,
            rows * npad * W * 3 + rows * (npad // A + 1) * n * 3)


def anchor_geometry(n):
    """The anchored route's A/Wside for rows of n (``misfit.bfm``)."""
    return (32, 64) if n >= 512 else (8, 32)


def bands(n):
    """The banded route's W/K for rows of n (``misfit.bfm``)."""
    return (48, 16) if n >= 512 else (24, 8)


def legendre_passes(bfm, cb, u):
    """The inputs of the two 1-D passes of one 2-D transform of the BFM
    state u (B, nt, nrec), as ``bfm._legendre_2d`` forms them: rows of nrec,
    then, from the first pass's output (the anchored route), rows of nt."""
    B, nt, nrec = u.shape
    a = bfm._legendre_last_anchor_fast(u, cb._grid(nrec, u.device))
    return (u.reshape(-1, nrec).contiguous(),
            (-a.transpose(-1, -2)).reshape(-1, nt).contiguous())


def legendre_compare(cb, name, u, expect=None):
    """The banded kernel against its twin on rows u: output (NaN where the
    twin has NaN), flag and values bitwise (limit 0: a max is exact, so the
    redesign's order of taps changes no value); ``expect``: the flag it
    must give."""
    W, K = bands(u.shape[1])
    out, ok = cb.legendre_banded(u, W, K)
    want, ok_want = cb.legendre_banded_plain(u, W, K)
    same_nan = torch.equal(torch.isnan(out), torch.isnan(want))
    err = float((torch.nan_to_num(out) - torch.nan_to_num(want)).abs().max())
    scale = float(torch.nan_to_num(want).abs().max())
    print(f"   {name}: {tuple(u.shape)} at W/K {W}/{K}: max|kernel-twin| = "
          f"{err:.3e} (max|twin| = {scale:.3e}, limit 0), flag "
          f"{bool(ok)} (twin {bool(ok_want)}), NaN positions equal "
          f"{same_nan}")
    if not (same_nan and err == 0.0 and bool(ok) == bool(ok_want)):
        raise AssertionError(f"{name}: the banded Legendre kernel disagrees "
                             "with its twin")
    if expect is not None and bool(ok) != expect:
        raise AssertionError(f"{name}: flag {bool(ok)}, expected {expect}")
    return err


def w2_host_phases(dev, marm, fwi, bfm, cb, ca, qWasserstein, least_square,
                   w2_state, counters, report, modules, ms, plain_ms, err,
                   bounds):
    """Phases 23-28: the banded Legendre kernel against its twin at 3 shots
    and on the 29-shot live W2 state with its times and bound, the banded
    W2-2d gradient and trial against the anchored route, the banded W2-2d
    FWI driver, the native W2-2d gradient, and the driver with --filter 1
    and --resample, and L-BFGS on the host-misfit path with resampling."""
    gc.collect()
    torch.cuda.empty_cache()
    phase(f"23 banded Legendre kernel vs twin (quick gate), {NSHOTS_CHECK} "
          "shots of the live W2-2d state")
    u = w2_state.to(dev)
    B, nt, nrec = u.shape
    print(f"   live state: the input of the last 2-D transform of a W2-2d "
          f"trial, {tuple(u.shape)}")
    small = legendre_passes(bfm, cb, u[:NSHOTS_CHECK].contiguous())
    for k, rows in enumerate(small):
        legendre_compare(cb, f"pass {k + 1}, live", rows)
        legendre_compare(cb, f"pass {k + 1}, displaced 40 samples",
                         torch.roll(rows, 40, dims=1).contiguous(), False)
        n = rows.shape[1]
        sg = cb._grid(n, dev)
        # noise of 5e-4 (300/n)^2 moves an argmax of 0.5 s^2 by up to ~9
        # samples, inside both bands
        noise = torch.rand(rows.shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(SEED))
        inband = (0.5 * sg * sg + 5e-4 * (300 / n) ** 2 * noise).contiguous()
        legendre_compare(cb, f"pass {k + 1} shape, in band (0.5 s^2 + "
                         "noise)", inband, True)
    del small

    phase(f"24 banded and anchored Legendre kernels vs twins and kernel "
          f"times, {B} shots "
          "(main-path shapes)")
    name = "legendre_banded"
    passes = legendre_passes(bfm, cb, u)
    ms[name] = plain_ms[name] = err[name] = 0.0
    nbytes = nops = 0
    anchor_ms = 0.0
    for k, rows in enumerate(passes):
        W, K = bands(rows.shape[1])
        launch = cb.legendre_launch(rows.shape[0], rows.shape[1], W, K)
        print(f"   pass {k + 1} launch: {launch.grid} blocks of "
              f"{launch.threads} threads, {launch.rows_a_block} rows a "
              f"block, {launch.tiles} column tile(s) of {launch.tile} lanes:"
              f" {launch.band_blocks} band blocks ({launch.band_smem} bytes "
              f"of shared memory), {launch.cert_blocks} certificate blocks "
              f"({launch.samples} samples a lane, {launch.passes} group(s) "
              f"a row block, {launch.cert_smem} bytes)")
        k_ms, _ = cuda_ms(lambda: cb.legendre_banded(rows, W, K), 10)
        t_ms, _ = cuda_ms(lambda: cb.legendre_banded_plain(rows, W, K), 1)
        n = rows.shape[1]
        sg = cb._grid(n, dev)
        a_ms, _ = cuda_ms(lambda: bfm._legendre_last_anchor_fast(rows, sg),
                          3)
        e = legendre_compare(cb, f"pass {k + 1}", rows)
        b = legendre_bound(rows.shape[0], n, W, K)
        nbytes, nops = nbytes + b[0], nops + b[1]
        ms[name] += k_ms
        plain_ms[name] += t_ms
        anchor_ms += a_ms
        err[name] = max(err[name], e)
        print(f"   pass {k + 1}: kernel {k_ms:.3f} ms, twin {t_ms:.3f} ms, "
              f"anchored route (its kernel) {a_ms:.3f} ms, bound "
              f"{bound(*b)[0]:.3f} ms by {bound(*b)[1]} ({b[0]:.4g} B, "
              f"{b[1]:.4g} f32 ops)")
    bounds[name] = bound(nbytes, nops)
    print(f"   one 2-D transform (both passes): kernel {ms[name]:.3f} ms, "
          f"twin {plain_ms[name]:.3f} ms, anchored route "
          f"{anchor_ms:.3f} ms, bound {bounds[name][0]:.3f} ms by "
          f"{bounds[name][1]}, {bounds[name][0] / ms[name]:.1%} of the bound")
    # the anchored kernel, the default route's, on the same passes; its
    # twin is the anchored torch route (36.3 ms a 2-D transform in the
    # W2 cell's first measurement)
    name = "legendre_anchored"
    ms[name] = plain_ms[name] = err[name] = 0.0
    nbytes = nops = 0
    for k, rows in enumerate(passes):
        n = rows.shape[1]
        A, Wside = anchor_geometry(n)
        sg = cb._grid(n, dev)
        launch = cb.legendre_anchored_launch(rows.shape[0], n, A, Wside)
        print(f"   pass {k + 1} anchored launch: {launch.grid} blocks of "
              f"{launch.threads} threads at A/Wside {A}/{Wside} (window "
              f"{launch.window}), {launch.tiles} tile(s) of {launch.tile} "
              f"outputs: {launch.band_blocks} band blocks "
              f"({launch.band_smem} bytes of shared memory), "
              f"{launch.cert_blocks} certificate blocks ({launch.anchors} "
              f"anchors, {launch.samples} a lane, {launch.cert_smem} bytes)")
        k_ms, got = cuda_ms(lambda: cb.legendre_anchored(rows, sg, A, Wside),
                            10)
        t_ms, want = cuda_ms(lambda: cb.legendre_anchored_plain(
            rows, sg, A, Wside), 1)
        same = (torch.equal(torch.isnan(got[0]), torch.isnan(want[0]))
                and torch.equal(torch.nan_to_num(got[0]),
                                torch.nan_to_num(want[0]))
                and bool(got[1]) == bool(want[1]))
        b = anchored_bound(rows.shape[0], n, A, Wside)
        nbytes, nops = nbytes + b[0], nops + b[1]
        ms[name] += k_ms
        plain_ms[name] += t_ms
        print(f"   pass {k + 1} anchored: kernel {k_ms:.3f} ms, twin (the "
              f"torch route) {t_ms:.3f} ms, bound {bound(*b)[0]:.3f} ms by "
              f"{bound(*b)[1]} ({b[0]:.4g} B, {b[1]:.4g} f32 ops); flag "
              f"{bool(got[1])} (twin {bool(want[1])}), output and flag "
              f"torch.equal {same}")
        if not same:
            raise AssertionError(f"pass {k + 1}: the anchored Legendre "
                                 "kernel disagrees with its twin")
        del got, want
    bounds[name] = bound(nbytes, nops)
    print(f"   one 2-D transform, anchored: kernel {ms[name]:.3f} ms, twin "
          f"(the torch route) {plain_ms[name]:.3f} ms, bound "
          f"{bounds[name][0]:.3f} ms by {bounds[name][1]}: "
          f"{ms[name] / bounds[name][0]:.2f}x the bound")
    xs, ys = cb._grid(nrec, dev), cb._grid(nt, dev)
    two_d = {}
    for leg in ("banded", "anchor"):
        t_ms, two_d[leg] = cuda_ms(lambda: bfm._legendre_2d(
            u, xs, ys, 32_000_000, leg), 3)
        print(f"   _legendre_2d, legendre={leg!r}: {t_ms:.3f} ms")
    if not torch.equal(two_d["banded"], two_d["anchor"]):
        raise AssertionError("the banded 2-D transform differs from the "
                             "anchored one")
    del passes, two_d, u
    torch.cuda.empty_cache()

    phase(f"25 main path: banded W2-2d gradient and trial, {B} shots")
    args = marm.make_parser(marm.SMARMN).parse_args(["--device", "cuda"])
    _, geoms, vps, mask = marm.setup(marm.SMARMN, args, B)
    g0 = geoms[1]
    obs = fwi.fm_multi(geoms[0], device="cuda")
    dw = fwi.fm_multi(geoms[2], device="cuda")
    x0 = 1.0 / np.asarray(g0.model.vp_unpadded, np.float64).reshape(-1) ** 2
    banded = marm.misfits(marm.SMARMN, {"legendre": "banded"})[2]
    anchor = marm.misfits(marm.SMARMN)[2]
    out = {}
    for label, misfit in (("banded", banded), ("anchor", anchor)):
        for reset in counters:
            reset()
        for calc_grad in (True, False):
            t0 = time.perf_counter()
            out[label, calc_grad] = fwi.fwi_loss(
                x0, g0, obs, misfit, dw, mask, precond=False,
                calc_grad=calc_grad, device="cuda")[:2]
            print(f"   {label} {'gradient' if calc_grad else 'trial'}: "
                  f"objective {out[label, calc_grad][0]!r}, "
                  f"{time.perf_counter() - t0:.3f} s")
        print(f"   {label}: legendre_banded launches "
              f"{cb.LAUNCHES['legendre_banded']}, twin calls "
              f"{sum(cb.TWIN_CALLS.values())}, certificate reads "
              f"{bfm.COUNTS['legendre_reads']}, fallbacks "
              f"{bfm.COUNTS['legendre_fallbacks']}")
        if label == "banded" and (cb.LAUNCHES["legendre_banded"] < 1
                                  or any(cb.TWIN_CALLS.values())):
            raise AssertionError("the banded W2-2d objective did not launch "
                                 "the banded kernel, or called a twin")
        if label == "anchor":
            print(f"   anchor: legendre_anchored launches "
                  f"{cb.LAUNCHES['legendre_anchored']}; BFM counts "
                  f"{dict(bfm.COUNTS)}")
            if cb.LAUNCHES["legendre_anchored"] < 1 \
                    or any(cb.TWIN_CALLS.values()):
                raise AssertionError("the anchored W2-2d objective did not "
                                     "launch the anchored kernel, or called "
                                     "a twin")
    for calc_grad in (True, False):
        (fb, gb), (fa, ga) = out["banded", calc_grad], out["anchor",
                                                           calc_grad]
        rel_f = abs(fb - fa) / abs(fa)
        rel_g = float(np.abs(gb - ga).max() / max(np.abs(ga).max(), 1e-300))
        print(f"   banded vs anchored {'gradient' if calc_grad else 'trial'}"
              f": objective {rel_f:.3e}, unpreconditioned gradient "
              f"{rel_g:.3e} of its max (limit 1e-6)")
        if not (rel_f <= 1e-6 and rel_g <= 1e-6):
            raise AssertionError("the banded W2-2d objective disagrees with "
                                 "the anchored one")
    del out
    report_profile("banded W2-2d trial", lambda: fwi.fwi_loss(
        x0, g0, obs, banded, dw, mask, calc_grad=False, device="cuda"))

    phase(f"26 main path: SMARMN W2-2d FWI with the banded Legendre kernel, "
          f"{B} shots, --misfit 2 --maxiter 2, on cuda")
    check_history(run_driver(marm, marm.SMARMN, ["--misfit", "2"], counters,
                             bfm_options={"legendre": "banded"}))
    print(f"   BFM host reads and branches: {dict(bfm.COUNTS)}")
    reads = bfm.COUNTS["legendre_reads"]
    print(f"   Legendre certificate fallbacks "
          f"{bfm.COUNTS['legendre_fallbacks']} of {reads} reads "
          f"({bfm.COUNTS['legendre_fallbacks'] / max(reads, 1):.1%})")
    if min(ca.LAUNCHES[n] for n in ca.KERNELS[:3]) < 1:
        raise AssertionError("the banded W2-2d path did not run the sweeps")
    report("banded W2-2d", ("legendre_banded",))

    phase(f"27 native W2-2d: a {NATIVE_SHOTS}-shot SMARMN gradient, the "
          "sweeps on cuda")
    args4 = marm.make_parser(marm.SMARMN).parse_args(["--device", "cuda"])
    _, geoms4, _, mask4 = marm.setup(marm.SMARMN, args4, NATIVE_SHOTS)
    obs4 = fwi.fm_multi(geoms4[0], device="cuda")
    dw4 = fwi.fm_multi(geoms4[2], device="cuda")
    native = qWasserstein(gamma=1.01, method="2d",
                          num_steps=marm.SMARMN.w2_num_steps,
                          step_scale=marm.SMARMN.w2_step_scale,
                          bfm_backend="native")
    got = {}
    for label, misfit in (("native", native), ("torch", anchor)):
        for reset in counters:
            reset()
        t0 = time.perf_counter()
        got[label] = fwi.fwi_loss(x0, geoms4[1], obs4, misfit, dw4, mask4,
                                  precond=False, device="cuda")[:2]
        sec = time.perf_counter() - t0
        la = {k: v for mod in modules for k, v in mod.LAUNCHES.items()
              if v}
        twins = sum(v for mod in modules for v in mod.TWIN_CALLS.values())
        print(f"   {label} BFM gradient: objective {got[label][0]!r}, "
              f"{sec:.3f} s; kernel launches {la}, twin calls {twins}")
        if twins or min(ca.LAUNCHES[n] for n in (
                "forward_dt2_segments", "gradient_stream_segments")) < 1:
            raise AssertionError(f"the {label} W2-2d gradient did not run "
                                 "its sweeps on the card")
    (fn, gn), (ft, gt) = got["native"], got["torch"]
    rel_f = abs(fn - ft) / abs(ft)
    rel_g = float(np.abs(gn - gt).max() / np.abs(gt).max())
    # the W2 value is a small difference of O(1) terms, float64 in the C++
    # solver and float32 in the torch one: the objectives are printed, the
    # gradients held to tests/test_misfit.py's limit for the JAX native
    # route against its device BFM
    print(f"   native vs torch BFM: objective {rel_f:.3e} (not held), "
          f"unpreconditioned gradient {rel_g:.3e} of its max (limit 1e-2)")
    if not (np.isfinite(fn) and fn > 0 and np.isfinite(gn).all()
            and rel_g <= 1e-2):
        raise AssertionError("the native W2-2d gradient disagrees with the "
                             "torch BFM's")
    del got

    phase(f"28 main path: SMARMN L2 FWI with --filter 1 and --resample "
          f"{RESAMPLE_DT:g}, {B} shots, on cuda")
    sweeps = ("forward_rec_segments", "forward_dt2_segments",
              "gradient_stream_segments")
    check_history(run_driver(marm, marm.SMARMN, ["--misfit", "0", "--filter",
                                                 "1"], counters))
    report("L2 --filter 1", sweeps, record=False)
    try:
        run_driver(marm, marm.SMARMN, ["--misfit", "0", "--resample",
                                       str(RESAMPLE_DT)], counters)
    except ValueError as e:
        print(f"   --resample {RESAMPLE_DT:g}: stops as the JAX driver does: "
              f"{e}")
    else:
        raise AssertionError("--resample ran where the JAX driver stops on "
                             "the observed data's length")
    from devito_fwi_tpu_torch.optimize import LBFGS, minimize

    def resampled(x, geometry, obs, misfit_func, direct_wave=None,
                  mask=None, precond=True, calc_grad=True,
                  shot_indices=None):
        geometry.model.update("vp", (1.0 / np.sqrt(x)).reshape(
            geometry.model.shape))
        return fwi.fwi_obj_multi(geometry, obs, misfit_func, direct_wave,
                                 mask, precond, calc_grad,
                                 resample_dt=RESAMPLE_DT,
                                 shot_indices=shot_indices, device="cuda")

    # the host resamples every trace by splines (~14 s an objective at 29
    # shots on the card's host): phase 27's NATIVE_SHOTS keep it short
    loss = marm.TimedLoss("cuda", resampled)
    m0 = 1.0 / vps[1].reshape(-1).astype(np.float64) ** 2
    for reset in counters:
        reset()
    with tempfile.TemporaryDirectory() as odir:
        opt = LBFGS(memory=10, ls_method="Bracket", step_len_init=0.1,
                    max_ls=5, log_path=odir)
        minimize(opt, maxIter=2, ftol=1e-5, gtol=1e-10, loss_fn=loss,
                 log_path=odir).run(m0, geoms4[1], obs4, least_square, dw4,
                                    mask4, 1, [1.0 / 5.2 ** 2,
                                               1.0 / 1.5 ** 2])
    torch.cuda.synchronize()
    print(f"   L-BFGS of fwi_obj_multi(resample_dt={RESAMPLE_DT:g}) on the "
          f"host-misfit path, {NATIVE_SHOTS} shots:")
    check_history(dict(calls=loss.calls, model_s=0.0))
    report("L2 resample_dt", sweeps, record=False)
    del obs, dw, obs4, dw4
    torch.cuda.empty_cache()


def acoustic3d_bounds(st, B):
    """The 3-D kernels' bounds at this run's shapes: inputs read once,
    outputs written once. Per cell-step, r = space_order/2: the Laplacian
    three axes of (1 + 3r) and the three scales and two sums, 9r + 8; the
    update 5; the history 3 and the illumination 2; the reverse the
    gradient's product and sum 2; the step kernel s2 lap and 2m + hd, 2
    more."""
    f = 4
    ny, nz, nx = st.m3.shape
    field = nx * ny * nz
    cells = B * field
    r = st.kw["space_order"] // 2
    lap = 9 * r + 8
    nsteps = st.nsteps
    common_in = (2 * field + B * nsteps + B * 2 * nz * nx) * f
    slab = B * nsteps * ny * 2 * nx * f
    hist = B * nsteps * field * f
    work = {
        "forward_rec3": (common_in + slab, cells * nsteps * (lap + 5)),
        "forward_dt2_stream3": (common_in + slab + hist + cells * f,
                                cells * nsteps * (lap + 10)),
        "gradient_stream3": (2 * field * f + hist + slab + cells * f,
                             cells * nsteps * (lap + 7)),
        # one step of one field: u, u_prev, m, hd, 1/(m + hd) in, one out
        "step3": (6 * field * f, field * (lap + 7)),
    }
    return {name: bound(*w) for name, w in work.items()}


def config5(nlayers):
    """Bench config 5's geometry (``bench.py`` ``_bench_3d``) on the
    port's models: ``nlayers`` 3 for the true model, 1 for the start."""
    from devito_fwi_tpu_torch.models.geometry import AcquisitionGeometry
    from devito_fwi_tpu_torch.models.presets import demo_model
    model = demo_model("layers-isotropic", nlayers=nlayers,
                       shape=(96, 96, 96), spacing=(15., 15., 15.),
                       space_order=8, nbl=16, dt=1.5)
    ext = model.domain_size[0]
    src = np.stack([np.linspace(0, ext, C5_SHOTS),
                    np.full(C5_SHOTS, ext / 2), np.full(C5_SHOTS, 30.0)], 1)
    rec = np.stack([np.linspace(0, ext, 48), np.full(48, ext / 2),
                    np.full(48, 30.0)], 1)
    return AcquisitionGeometry(model, rec, src, 0.0, 500.0, f0=0.012,
                               src_type="Ricker")


def acoustic3d_phases(dev, rng, marm, fwi, c3, c3d, least_square, counters,
                      report, ms, plain_ms, err, bounds):
    """Phases 29-32: the 3-D kernels against their twins at 3 config-5
    shots, config 5's gradient, trial, saved route and L-BFGS on cuda, the
    kernels against their twins at 4 shots with their times and bounds,
    and a profile of the gradient and the trial."""
    t_3d = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    g1, g0 = config5(3), config5(1)
    st = fwi._Setup3(g0, dev)
    ny, nz, nx = st.m3.shape
    print(f"   bench config 5: padded grid {nx} x {ny} x {nz}, nt {st.nt} "
          f"({st.nsteps} steps), dt {st.dt:.4f} ms, receivers on z-planes "
          f"{st.z0}, {st.z0 + 1}, space_order {st.kw['space_order']}, "
          f"{C5_SHOTS} shots, 48 receivers")

    def res_slabs(B):
        res = torch.as_tensor(rng.standard_normal((B, st.nt, 48)),
                              dtype=torch.float32, device=dev)
        return c3d.residual_slabs3(res, st.r_idx, st.r_w, st.m,
                                   st.dt * st.dt, st.z0, st.nsteps)

    # the step kernel's operands on the main path: one (nx, ny, nz) field
    # pair and the eager update's constants
    w, ih2, _, s2, hd, inv_mhd = fwi._ac._prep(
        st.vp, st.damp, st.dt, st.kw["spacing"], st.kw["space_order"])
    u, up = (torch.as_tensor(rng.standard_normal((nx, ny, nz)),
                             dtype=torch.float32, device=dev)
             for _ in range(2))
    step_ops = (u, up, st.m, hd, float(s2))
    step_kw = dict(w=tuple(float(v) for v in w),
                   inv_h2=tuple(float(v) for v in ih2), inv_mhd=inv_mhd)

    phase(f"29 3-D kernel vs twin (quick gate), {NSHOTS_CHECK} shots at "
          "bench config 5's grid")
    ops = (st.m3, st.hd3, *st.planes(0, NSHOTS_CHECK), st.dt)
    for fs in (False, True):
        kw = dict(st.kw, fs=fs)
        compare(f"forward_rec3 (fs {fs})", [c3d.forward_rec3(*ops, **kw)],
                [c3d.forward_rec3_plain(*ops, **kw)])
        got = c3d.forward_dt2_stream3(*ops, **kw)
        compare(f"forward_dt2_stream3 (fs {fs})", got,
                c3d.forward_dt2_stream3_plain(*ops, **kw))
        slabs = res_slabs(NSHOTS_CHECK)
        gops = (st.m3, st.hd3, got[1], slabs, st.dt)
        compare(f"gradient_stream3 (fs {fs})",
                [c3d.gradient_stream3(*gops, **kw)],
                [c3d.gradient_stream3_plain(*gops, **kw)])
        del got, gops, slabs
        torch.cuda.empty_cache()
    compare("step3", [c3.step3(*step_ops, **step_kw)],
            [c3.step3_plain(*step_ops, **step_kw)])

    phase(f"30 main path: bench config 5, 3-D L2 FWI, {C5_SHOTS} shots, on "
          "cuda")
    for reset in counters:
        reset()
    t0 = time.perf_counter()
    obs = fwi.fm_multi(g1, device="cuda")
    print(f"   observed data ({C5_SHOTS} x {st.nt} x 48) through "
          f"forward_rec3: {time.perf_counter() - t0:.3f} s")
    x0 = 1.0 / np.asarray(g0.model.vp_unpadded, np.float64).reshape(-1) ** 2
    f_true, _, _ = fwi.fwi_loss(x0, g0, obs, least_square, calc_grad=False,
                                device="cuda")
    from devito_fwi_tpu_torch.models.sources import PointSource
    data = []
    for shot in obs:
        p = PointSource(name="rec", time_range=g0.time_axis,
                        coordinates=g0.rec_positions, dtype=g0.model.dtype)
        p.data[:] = C5_DATA_SCALE * shot.data
        data.append(p)
    print(f"   misfit of the true data at the starting model {f_true!r} "
          "(no reflection within tn: float32 rounding); the main path "
          f"inverts the true data scaled by {C5_DATA_SCALE:g}")
    out = {}
    for label, kw in (("stream", {}), ("saved", dict(saved3=True))):
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            f, g, _ = fwi.fwi_loss(x0, g0, data, least_square,
                                   device="cuda", **kw)
            walls.append(time.perf_counter() - t0)
        out[label] = fwi.fwi_obj_multi(g0, data, least_square,
                                       precond=False, calc_grad=True,
                                       device="cuda", **kw)
        print(f"   {label} route gradient: first {walls[0]:.4f} s, steady "
              f"{walls[1]:.4f} s; objective {f!r}, finite: "
              f"{bool(np.isfinite(g).all())}")
    t0 = time.perf_counter()
    f_t, _, _ = fwi.fwi_loss(x0, g0, data, least_square, calc_grad=False,
                             device="cuda")
    print(f"   trial (forward_rec3): {time.perf_counter() - t0:.4f} s, "
          f"objective {f_t!r}")
    (f_s, g_s, _), (f_v, g_v, _) = out["stream"], out["saved"]
    rel_f = abs(f_v - f_s) / abs(f_s)
    rel_g = float(np.abs(g_v - g_s).max() / np.abs(g_s).max())
    print(f"   saved route against stream route (unpreconditioned; "
          f"objectives {f_s!r}, {f_v!r}): objective {rel_f:.3e} relative "
          f"[{C5_ROUTE_RTOL[0]:g}], gradient {rel_g:.3e} of its max "
          f"[{C5_ROUTE_RTOL[1]:g}]")
    if not (np.isfinite(g_s).all() and np.abs(g_s).max() > 0
            and rel_f <= C5_ROUTE_RTOL[0] and rel_g <= C5_ROUTE_RTOL[1]):
        raise AssertionError("the 3-D routes disagree or the gradient is "
                             "not finite")
    del out, g_s, g_v
    from devito_fwi_tpu_torch.optimize import LBFGS, minimize
    loss = marm.TimedLoss("cuda")
    with tempfile.TemporaryDirectory() as odir:
        opt = LBFGS(memory=10, ls_method="Bracket", step_len_init=0.1,
                    max_ls=5, log_path=odir)
        minimize(opt, maxIter=2, ftol=1e-5, gtol=1e-10, loss_fn=loss,
                 log_path=odir).run(x0, g0, data, least_square, None, None,
                                    1, [1.0 / 3.5 ** 2, 1.0 / 1.5 ** 2])
    torch.cuda.synchronize()
    print(f"   L-BFGS of fwi_loss, {C5_SHOTS} shots, 2 iterations:")
    check_history(dict(calls=loss.calls, model_s=0.0))
    report("3-D", c3d.KERNELS + c3.KERNELS)
    g0.model.update("vp", (1.0 / np.sqrt(x0)).reshape(g0.model.shape))
    del loss
    gc.collect()
    torch.cuda.empty_cache()

    B = C5_SHOTS
    phase(f"31 3-D kernel vs twin and kernel times, {B} shots (main-path "
          "shapes)")
    st = fwi._Setup3(g0, dev)
    ops = (st.m3, st.hd3, *st.planes(0, B), st.dt)
    kw = st.kw
    name = "forward_rec3"
    ms[name], got = cuda_ms(lambda: c3d.forward_rec3(*ops, **kw), 3)
    plain_ms[name], want = cuda_once(lambda: c3d.forward_rec3_plain(*ops,
                                                                     **kw))
    err[name] = compare(name, [got], [want])
    del got, want
    name = "forward_dt2_stream3"
    ms[name], fwd = cuda_ms(lambda: c3d.forward_dt2_stream3(*ops, **kw), 2)
    print(f"   history {tuple(fwd[1].shape)}: {fwd[1].numel():.4g} "
          f"elements, {fwd[1].numel() * 4 / 1e9:.2f} GB")
    plain_ms[name], want = cuda_once(lambda: c3d.forward_dt2_stream3_plain(
        *ops, **kw))
    err[name] = compare(name, fwd, want)
    del want
    torch.cuda.empty_cache()
    name = "gradient_stream3"
    gops = (st.m3, st.hd3, fwd[1], res_slabs(B), st.dt)
    ms[name], got = cuda_ms(lambda: c3d.gradient_stream3(*gops, **kw), 2)
    plain_ms[name], want = cuda_once(lambda: c3d.gradient_stream3_plain(
        *gops, **kw))
    err[name] = compare(name, [got], [want])
    del fwd, gops, got, want
    torch.cuda.empty_cache()
    # the reverse march under a free surface at the main path's shots
    kwf = dict(kw, fs=True)
    gops = (st.m3, st.hd3, c3d.forward_dt2_stream3(*ops, **kwf)[1],
            res_slabs(B), st.dt)
    compare(f"{name} (fs True)", [c3d.gradient_stream3(*gops, **kwf)],
            [c3d.gradient_stream3_plain(*gops, **kwf)])
    del gops
    torch.cuda.empty_cache()
    name = "step3"
    ms[name], got = cuda_ms(lambda: c3.step3(*step_ops, **step_kw), 50)
    plain_ms[name], want = cuda_ms(lambda: c3.step3_plain(*step_ops,
                                                          **step_kw), 5)
    err[name] = compare(name, [got], [want])
    del got, want
    # the wrapper's event-timed span holds its host work (operand checks,
    # 1/(m + hd), ctypes) between launches; the profiler's device time of
    # the kernel alone, over STEP3_PROFILED back-to-back calls
    n, dev_ms = kernel_device_ms(
        lambda: c3.step3(*step_ops, **step_kw), STEP3_PROFILED,
        "step_kernel")
    step3_device_ms = dev_ms / n if n else None
    print(f"   step3: {ms[name]:.4f} ms a call between CUDA events (the "
          f"wrapper's pace, 50 calls); step_kernel device time "
          + (f"{step3_device_ms:.4f} ms a launch over {n} launches "
             f"(torch.profiler, {STEP3_PROFILED} calls)" if n else
             "not measured (the profiler recorded no step_kernel)"))
    bounds.update(acoustic3d_bounds(st, B))
    for name in c3d.KERNELS + c3.KERNELS:
        b_ms, by, nbytes, nops = bounds[name]
        print(f"   {name}: kernel {ms[name]:.3f} ms, twin "
              f"{plain_ms[name]:.3f} ms, bound {b_ms:.3f} ms by {by} "
              f"({nbytes:.4g} B, {nops:.4g} f32 ops), "
              f"{b_ms / ms[name]:.1%} of the bound")
    ny, nz, nx = st.m3.shape
    for what, reverse in (("forwards", False), ("reverse", True)):
        launch = c3d.march_launch(B, ny, nz, nx, kw["space_order"] // 2,
                                  reverse=reverse)
        print(f"   y march, the {what}: tile {launch.tile}, "
              f"{launch.threads} threads, grid {launch.grid}, "
              f"{launch.chunks} y-chunks of {launch.ylen} planes, "
              f"{launch.smem} bytes of shared memory a block")
    print_floors(acoustic3d_step_floors(st, B), ms, st.nsteps)

    phase(f"32 3-D profile: one steady-state gradient and one trial, {B} "
          "shots")
    for calc_grad in (True, False):
        report_profile(f"config 5 {'gradient' if calc_grad else 'trial'}",
                       lambda: fwi.fwi_loss(x0, g0, data, least_square,
                                            calc_grad=calc_grad,
                                            device="cuda"))
    report_profile("config 5 saved-route gradient", lambda: fwi.fwi_loss(
        x0, g0, data, least_square, device="cuda", saved3=True))
    del obs, data, st, ops, step_ops
    gc.collect()
    torch.cuda.empty_cache()
    print(f"   3-D phases 29-32: {time.perf_counter() - t_3d:.1f} s")


def legacy_bound(m, inj, nt, r):
    """B15's bound at this run's shapes: m, hd, the wavelet and the
    patterns read once, the record written once; 8r + 8 operations per
    cell-step (the stencil c0 u and four products and sums a tap, 8r + 1;
    the update and the injection, 7)."""
    f = 4
    B, nx, nz = inj.shape
    nbytes = (2 * m.numel() + (nt - 2) + inj.numel() + B * nt * 2 * nx) * f
    return bound(nbytes, B * (nt - 2) * nx * nz * (8 * r + 8))


def legacy_floors(inj, nt, r, ms_kernel):
    """B15's floors at this run's shapes, printed beside the kernel's
    time: the issue-rate floor (its 8r + 8 float operations a cell-step as
    separate instructions at ``F32_INSTR_PER_S``, and on the SMs the
    clusters hold) and the per-step traffic floor (what crosses device
    memory a step: the cluster design's record rows, the first design's u
    and up read, up written and the dense pattern read)."""
    B, nx, nz = inj.shape
    steps = nt - 2
    cells = B * nx * nz
    issue = cells * steps * (8 * r + 8) / F32_INSTR_PER_S * 1e3
    rows_ms = B * 2 * nx * 4 * steps / PEAK_BYTES_PER_S * 1e3
    first_ms = 4 * cells * 4 * steps / PEAK_BYTES_PER_S * 1e3
    print(f"   forward_rows: issue-rate floor {issue:.3f} ms "
          f"({issue * 1e3 / steps:.2f} us a step, {8 * r + 8} separate "
          f"float instructions a cell-step at {F32_INSTR_PER_S:.3g}/s); "
          f"per-step traffic floor {rows_ms:.3f} ms (the record rows, "
          f"{B * 2 * nx * 4 / 1e3:.1f} KB a step), {first_ms:.3f} ms for "
          f"the first design's 4 fields a step; kernel "
          f"{ms_kernel * 1e3 / steps:.2f} us a step, "
          f"{ms_kernel / issue:.2f}x the issue-rate floor")
    return issue


def legacy_solver_phases(dev, g0, fwi, cl, c3, counters, report, ms,
                         plain_ms, err, bounds):
    """Phases 33-36: B15 against its twin at 3 SMARMN shots;
    ``forward_traces`` on the 29 SMARMN shots on cuda, against B1 and
    against the twin, timed beside its bound; the camembert FWI through
    ``AcousticWaveSolver`` with its goldens, the checkpointed gradient and
    the born/gradient dot test; the solver's 3-D forwards."""
    from devito_fwi_tpu_torch import AcousticWaveSolver
    from devito_fwi_tpu_torch.examples import inversion_fwi as ex
    from devito_fwi_tpu_torch.models.geometry import setup_geometry
    from devito_fwi_tpu_torch.models.presets import demo_model
    t_new = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    name = "forward_rows"
    m, hd, wav, inj, dt, kw = cl.operands(g0, device="cuda")
    B = inj.shape[0]

    def rows_pair(shots):
        """kernel and twin rows of the first ``shots`` shots, bitwise."""
        ops = (m, hd, wav, inj[:shots].contiguous(), dt)
        got = cl.forward_rows(*ops, **kw)
        want = cl.forward_rows_plain(*ops, **kw)
        same = torch.equal(got, want)
        e = float((got - want).abs().max())
        print(f"   {name}, {shots} shots: kernel == twin on every row: "
              f"{same} (max|kernel-twin| {e:.3e}); rows nt-2, nt-1 zero: "
              f"{not got[:, kw['nt'] - 2:].any()}")
        if not same or got[:, kw["nt"] - 2:].any():
            raise AssertionError(f"{name} differs from its twin")
        return e

    phase(f"33 B15 kernel vs twin (quick gate), {NSHOTS_CHECK} SMARMN shots")
    rows_pair(NSHOTS_CHECK)
    r = kw["space_order"] // 2
    plan = cl.sweep_launch(kw["nz"], kw["nx"], r,
                           cl._source_list(inj.transpose(1, 2))[2])
    print(f"   design: one thread-block cluster a shot, u resident in "
          f"shared memory; cluster of {plan.cluster} blocks of {plan.rows} "
          f"rows, {plan.threads} threads, {plan.smem} bytes of shared "
          f"memory a block; {cl.max_clusters(plan, r)} clusters at once")

    phase(f"34 main path: cuda_legacy.forward_traces, {B} SMARMN shots, on "
          "cuda")
    for reset in counters:
        reset()
    t0 = time.perf_counter()
    tr = cl.forward_traces(g0, device="cuda")
    print(f"   forward_traces ({B} x {kw['nt']} x {tr.shape[2]}): "
          f"{time.perf_counter() - t0:.3f} s (first call)")
    report("forward_traces", cl.KERNELS)
    ref = np.stack([s.data for s in fwi.fm_multi(g0, device="cuda")])
    rel = float(np.abs(tr - ref).max() / np.abs(ref).max())
    print(f"   traces against fm_multi's (B1): {rel:.3e} of the max "
          "[1e-5; the two kernels associate the stencil differently]")
    if not (np.isfinite(tr).all() and rel <= 1e-5):
        raise AssertionError("forward_traces disagrees with fm_multi")
    err[name] = rows_pair(B)
    ops = (m, hd, wav, inj, dt)
    ms[name], _ = cuda_ms(lambda: cl.forward_rows(*ops, **kw), 5)
    plain_ms[name], _ = cuda_ms(lambda: cl.forward_rows_plain(*ops, **kw), 1)
    bounds[name] = legacy_bound(m, inj, kw["nt"], kw["space_order"] // 2)
    b_ms, by, nbytes, nops = bounds[name]
    print(f"   {name}: kernel {ms[name]:.3f} ms, twin {plain_ms[name]:.3f} "
          f"ms, bound {b_ms:.3f} ms by {by} ({nbytes:.4g} B, {nops:.4g} f32 "
          f"ops), {b_ms / ms[name]:.1%} of the bound; "
          f"{ms[name] * 1e3 / (kw['nt'] - 2):.2f} us a step")
    legacy_floors(inj, kw["nt"], r, ms[name])
    del m, hd, wav, inj, ops, tr, ref
    torch.cuda.empty_cache()

    phase("35 main path: the camembert FWI (examples.inversion_fwi, 9 "
          "shots, 5 iterations) on cuda")
    for reset in counters:
        reset()
    walls = []
    gradient = ex.fwi_gradient

    def timed_gradient(*a, **k):
        t0 = time.perf_counter()
        out = gradient(*a, **k)
        walls.append(time.perf_counter() - t0)
        return out

    ex.fwi_gradient = timed_gradient
    try:
        t0 = time.perf_counter()
        history, gmin, gmax, ff = ex.main(device="cuda")
        wall = time.perf_counter() - t0
    finally:
        ex.fwi_gradient = gradient
    got = dict(objective=ff, grad_min=gmin, grad_max=gmax,
               last_misfit=history[-1])
    print(f"   misfit history {history.tolist()}; {wall:.2f} s")
    print(f"   time per gradient (9 shots): first {walls[0]:.3f} s (with "
          f"the observed data), then {[round(w, 3) for w in walls[1:]]} s")
    for key, want in ex.GOLDEN.items():
        print(f"   {key}: {got[key]!r} (golden {want:g}, atol {ex.ATOL:g})")
        if not abs(got[key] - want) <= ex.ATOL:
            raise AssertionError(f"camembert {key} off its golden")
    report("camembert", (), record=False)
    model, model0, solver, locs = ex.setup("cuda")
    solver.geometry.src_positions[0, :] = locs[4]
    d_obs = solver.forward(vp=model.vp)[0]
    d_syn, u0, _ = solver.forward(vp=model0.vp, save=True)
    res = solver.geometry.rec
    res.data[:] = d_syn.data - d_obs.data
    g_saved, _ = solver.jacobian_adjoint(res, u0, vp=model0.vp)
    g_ck, _ = solver.jacobian_adjoint(res, None, vp=model0.vp,
                                      checkpointing=True)
    rel = float(np.abs(g_ck - g_saved).max() / np.abs(g_saved).max())
    print(f"   checkpointed gradient against the saved one (shot 5): "
          f"{rel:.3e} of the max [1e-5; float32, the two routes sum "
          "d2u/dt2 v in another association]")
    rng = np.random.default_rng(SEED)
    dm = np.zeros(model.padded_shape, np.float32)
    nbl = model.nbl
    dm[nbl:-nbl, nbl:-nbl] = rng.standard_normal(model.shape)
    rec_lin, _ = solver.jacobian(dm, vp=model0.vp)
    rec_res = solver.geometry.rec
    rec_res.data[:] = rng.standard_normal(rec_res.data.shape)
    grad, _ = solver.jacobian_adjoint(rec_res, u0, vp=model0.vp)
    term1 = float(np.dot(rec_lin.data.ravel().astype(np.float64),
                         rec_res.data.ravel().astype(np.float64)))
    term2 = float(np.dot(dm.ravel().astype(np.float64),
                         grad.ravel().astype(np.float64)))
    dot = abs(term1 - term2) / abs(term1)
    print(f"   born/gradient dot test at float32: <J dm, r> {term1!r}, "
          f"<dm, J^T r> {term2!r}, {dot:.3e} relative [1e-4]")
    if not (rel <= 1e-5 and dot <= 1e-4):
        raise AssertionError("the checkpointed gradient or the dot test "
                             "is off")
    del solver, u0, d_obs
    gc.collect()
    torch.cuda.empty_cache()

    phase("36 the solver in 3-D: layers-isotropic 50^3 at 20 m, nbl 40, "
          "tn 1000 ms, on cuda")
    norms = {}
    for fs in (True, False):
        model = demo_model("layers-isotropic", space_order=4,
                           shape=(50, 50, 50), nbl=40, dtype=np.float32,
                           spacing=(20., 20., 20.), fs=fs)
        geometry = setup_geometry(model, 1000.0)
        solver = AcousticWaveSolver(model, geometry, kernel="OT2",
                                    space_order=4, device="cuda")
        for reset in counters:
            reset()
        rec, _, summary = solver.forward()
        norms[fs] = float(np.linalg.norm(rec.data))
        print(f"   fs {fs}: padded {model.padded_shape}, nt {solver.nt}, "
              f"norm(rec) {norms[fs]!r}, {summary.elapsed:.3f} s, step "
              f"kernel launches {c3.LAUNCHES['step3']}")
        if fs:
            continue
        report("3-D solver forward", c3.KERNELS, record=False)
        eager = solver.forward(step3=False)[0].data
        same = np.array_equal(rec.data, eager)
        print(f"   the forward through the step kernel == step3=False: "
              f"{same}")
        if not same:
            raise AssertionError("the step hook changes the 3-D forward")
    for fs, want in ((True, 369.955), (False, 459.1678)):
        rel = abs(norms[fs] - want) / want
        print(f"   fs {fs}: norm {norms[fs]!r} against the reference's "
              f"{want} ({'f32' if fs else 'f64'} golden): {rel:.3e} "
              "relative [1e-3]")
        if not rel <= 1e-3:
            raise AssertionError("3-D forward norm off the golden")
    print(f"   phases 33-36: {time.perf_counter() - t_new:.1f} s")


# phase 37's shots, the first of its two for the script's time (9.2 s at 2)
EAGER_SHOTS = 1


def eager_route_phase(dev, fwi, counters, report):
    """Phase 37: a gradient of ``EAGER_SHOTS`` shots on
    ``drivers/circle_fwi.py``'s geometry, whose receivers on the vertical
    line x = 1980 m no kernel takes, through the eager route on cuda."""
    from devito_fwi_tpu_torch.misfit import least_square
    from devito_fwi_tpu_torch.models.geometry import AcquisitionGeometry
    from devito_fwi_tpu_torch.models.presets import demo_model
    phase("37 main path: the eager route, circle_fwi's geometry (receivers "
          f"on x = 1980 m), {EAGER_SHOTS} shot, on cuda")
    kw = dict(vp_background=3, r=60, origin=(0, 0), shape=(201, 201),
              spacing=(10., 10.), space_order=6, nbl=40, dt=1.)
    true = demo_model("circle-isotropic", vp_circle=3.6, **kw)
    init = demo_model("circle-isotropic", vp_circle=3, **kw)
    src = np.stack([np.full(2, 20.), np.linspace(0, 2000., 2)],
                   1)[:EAGER_SHOTS]
    rec = np.stack([np.full(201, 1980.), np.linspace(10., 1990., 201)], 1)
    g1, g0 = (AcquisitionGeometry(m, rec, src, 0., 1000., f0=0.010,
                                  src_type="Ricker") for m in (true, init))
    obs = fwi.fm_multi(g1, device="cuda")
    for reset in counters:
        reset()
    x = 1.0 / np.asarray(g0.model.vp_unpadded, np.float64).reshape(-1) ** 2
    t0 = time.perf_counter()
    f, g, _ = fwi.fwi_loss(x, g0, obs, least_square, device="cuda")
    wall = time.perf_counter() - t0
    print(f"   padded {g0.model.padded_shape}, nt {g0.nt}: objective "
          f"{f!r}, max|grad| {np.abs(g).max():.4e}, {wall:.3f} s; eager "
          f"route calls {fwi.EAGER}")
    report("eager route", (), record=False)
    if not (fwi.EAGER["objective"] == 1 and np.isfinite(f) and f > 0
            and np.isfinite(g).all() and np.abs(g).max() > 0):
        raise AssertionError("the eager route did not give a gradient")


# the fm drivers' default --nsrc
FM_SHOTS = 21
# phase 39's shots, cut from circle_fwi's 11: at 11 shots one iteration
# took 92.6-133.0 s on the card (host-bound eager steps, the host's speed
# sets it) and the whole script 1039.7 s of its 1200 s; at 4 shots 45.6 s,
# at 2 25.4 s; shots are the batch, not the width
CIRCLE_SHOTS = 1


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def fm_driver_phase(dev, marm, fwi, ca, counters, report, workdir):
    """Phase 38: ``marmousi_fm`` and ``marmousi2_fm`` (``run_fm``) at their
    full grids and default shots: the files of the JAX driver's names,
    float32 and shape, the observed data bitwise a direct ``fm_multi`` of
    the true model, row 1's kernel launched and no twin called."""
    phase(f"38 main path: marmousi_fm and marmousi2_fm, {FM_SHOTS} shots "
          f"each, on {dev.type}")
    t_phase = time.perf_counter()
    for cfg in (marm.SMARMN, marm.SMARM2):
        odir = f"{workdir}/{cfg.name}"
        for reset in counters:
            reset()
        t0 = time.perf_counter()
        obs, syn, dw = marm.run_fm(cfg, ["--odir", odir, "--device",
                                         dev.type])
        sync(dev)
        wall = time.perf_counter() - t0
        launched = ca.LAUNCHES["forward_rec_segments"]
        report(f"{cfg.name} fm", ("forward_rec_segments",), record=False)
        nt, nrec = obs[0].data.shape
        args = marm.make_parser(cfg, fm=True).parse_args(["--device",
                                                          dev.type])
        _, geoms, _, _ = marm.setup(cfg, args, FM_SHOTS)
        direct = fwi.fm_multi(geoms[0], device=dev.type)
        for i in range(FM_SHOTS):
            for name, shots in (("obs", obs), ("syn", syn), ("dw", dw)):
                data = np.fromfile(f"{odir}/data/{name}{i}", np.float32)
                if data.size != nt * nrec or not np.array_equal(
                        data.reshape(nt, nrec), shots[i].data):
                    raise AssertionError(f"{cfg.name} data/{name}{i} is "
                                         "not the gather it modeled")
                if not (np.isfinite(data).all() and np.abs(data).max() > 0):
                    raise AssertionError(f"{cfg.name} data/{name}{i} not "
                                         "finite and non-zero")
            if not np.array_equal(np.fromfile(
                    f"{odir}/data/obs{i}", np.float32).reshape(nt, nrec),
                    direct[i].data):
                raise AssertionError(f"{cfg.name} data/obs{i} differs from "
                                     "a direct fm_multi of the true model")
        print(f"   {cfg.name}: padded {geoms[0].model.padded_shape}, nt {nt},"
              f" {nrec} receivers; {3 * FM_SHOTS} files of {nt} x {nrec} "
              f"float32; forward_rec_segments launched {launched} times; "
              f"obs == direct fm_multi bitwise; the driver {wall:.3f} s")
    print(f"   phase 38: {time.perf_counter() - t_phase:.1f} s")


def circle_phase(dev, fwi, counters, report, workdir):
    """Phase 39: ``drivers/circle_fwi.py`` at its full width, one L-BFGS
    iteration on the eager route: a finite misfit, the log files, every
    objective call counted in ``fwi.EAGER``, the wall time of the iteration
    and of each objective call."""
    from devito_fwi_tpu_torch.drivers import circle_fwi
    phase(f"39 main path: circle_fwi, 201 x 201 at 10 m, nbl 40, space "
          f"order 6, tn 1000 ms, {CIRCLE_SHOTS} shots (cut from its 11 for "
          f"the script's time limit), --maxiter 1, on {dev.type}")
    t_phase = time.perf_counter()
    odir = f"{workdir}/circle"
    for reset in counters:
        reset()
    t0 = time.perf_counter()
    m, stats = circle_fwi.main(["--maxiter", "1", "--nsrc",
                                str(CIRCLE_SHOTS), "--odir", odir,
                                "--device", dev.type])
    sync(dev)
    wall = time.perf_counter() - t0
    report("circle_fwi", (), record=False)
    calls = stats["calls"]
    for i, (grad, f, secs) in enumerate(calls):
        print(f"   objective call {i + 1}: "
              f"{'gradient' if grad else 'trial'}, {f!r}, {secs:.3f} s")
    print(f"   observed data (fm_multi, {CIRCLE_SHOTS} shots) "
          f"{stats['model_s']:.3f} s; the iteration {stats['fwi_s']:.3f} s;"
          f" the driver {wall:.3f} s; eager route calls {fwi.EAGER}")
    with open(f"{odir}/log0/misfit") as fh:
        log = fh.read().split()
    result = np.fromfile(f"{odir}/circle_result_misfit_0", np.float32)
    values = [c[1] for c in calls]
    if not (len(calls) >= 2 and calls[0][0]
            and fwi.EAGER["objective"] == len(calls)
            and fwi.EAGER["fm_multi"] == 1
            and np.all(np.isfinite(values)) and min(values) > 0
            and len(log) == 2 and np.isfinite(float(log[0]))
            and float(log[0]) == float(f"{calls[0][1]:10.3e}")
            and result.size == m.size and np.isfinite(result).all()
            and np.isfinite(m).all()):
        raise AssertionError("circle_fwi did not run its iteration on the "
                             "eager route, or its logs are off")
    with open(f"{odir}/log0/optim_info") as fh:
        print(f"   log0/misfit: {' '.join(log)}; log0/optim_info:")
        print("   " + fh.read().strip().replace("\n", "\n   "))
    print(f"   phase 39: {time.perf_counter() - t_phase:.1f} s")


def self_adjoint_phase(dev):
    """Phase 40: the self-adjoint solver at float64: the analytic far field
    (``examples/sa_far_field.py``) and the F and J adjoint dot tests of
    ``tests/test_self_adjoint.py`` at their size and tolerance."""
    from devito_fwi_tpu_torch.examples import sa_far_field
    from devito_fwi_tpu_torch.ops.sa_wavesolver import acoustic_sa_setup
    phase(f"40 the self-adjoint solver at float64 on {dev.type}: the Hankel "
          "far field (401 x 401 at 0.5 m, npad 50, nt 1001) and the F and J "
          "dot tests (71 x 61, space order 8)")
    t_phase = time.perf_counter()
    got, want, summary, padded = sa_far_field.far_field(dev.type)
    err = float(np.abs(got - want).max() / np.abs(want).max())
    cells = padded[0] * padded[1]
    print(f"   far field: max|numerical - analytic| / max = {err:.4e} "
          f"[{sa_far_field.TOLERANCE}]; the forward {summary.elapsed:.3f} s "
          f"for 1001 steps of {padded[0]} x {padded[1]} "
          f"({1001 * cells / summary.elapsed / 1e6:.1f} Mcell-steps/s)")
    if not err < sa_far_field.TOLERANCE:
        raise AssertionError("the self-adjoint far field is off the "
                             "analytic trace")
    solver = acoustic_sa_setup(shape=(71, 61), spacing=(10., 10.), tn=500.,
                               space_order=8, nbl=10, dtype=np.float64,
                               device=dev.type)
    rng = np.random.default_rng(SEED)
    src1 = solver.geometry.src
    rec1 = solver.geometry.new_rec()
    rec1.data[:] = rng.random(rec1.data.shape)
    rec2, _, _ = solver.forward(src1)
    src2, _, _ = solver.adjoint(rec1)
    sum_s = np.dot(src1.data.ravel(), src2.data.ravel())
    sum_r = np.dot(rec1.data.ravel(), rec2.data.ravel())
    diff_f = (sum_s - sum_r) / (sum_s + sum_r)
    m0 = np.full(solver.model.padded_shape, 1.5)
    dm1 = np.zeros(solver.model.padded_shape)
    ctr = [n // 2 for n in solver.model.padded_shape]
    dm1[ctr[0] - 5:ctr[0] + 6, ctr[1] - 5:ctr[1] + 6] = \
        -1 + 2 * rng.random((11, 11))
    rec3, u0, _, _ = solver.jacobian(dm1, src=src1, vp=m0, save=True)
    dm2, _, _, _ = solver.jacobian_adjoint(rec1, u0, vp=m0)
    sum_m = np.dot(dm1.ravel(), dm2.ravel())
    sum_d = np.dot(rec1.data.ravel(), rec3.data.ravel())
    diff_j = (sum_m - sum_d) / (sum_m + sum_d)
    print(f"   F dot test {diff_f:.3e} [1e-12], J dot test {diff_j:.3e} "
          f"[1e-11]; phase 40: {time.perf_counter() - t_phase:.1f} s")
    if not (abs(diff_f) <= 1e-12 and abs(diff_j) <= 1e-11):
        raise AssertionError("a self-adjoint dot test failed")


def abc_phase(dev):
    """Phase 41: the PML and HABC reflection checks of
    ``tests/test_abc.py`` (a 101 x 101 interior at 10 m, 1.5 km/s, tn 800
    ms, against a boundary-free trace with a 200-cell margin) and the
    stability check (tn 8000 ms), float32."""
    from devito_fwi_tpu_torch.models.sources import RickerSource, TimeAxis
    from devito_fwi_tpu_torch.ops import abc
    from devito_fwi_tpu_torch.ops.interp import interp_table
    phase(f"41 PML and HABC on {dev.type}: the reflection checks and the "
          "stability check")
    t_phase = time.perf_counter()
    h, n = 10.0, 101

    def case(margin, tn=800.0):
        v = abc.extend_velocity(np.full((n, n), 1.5, np.float32), margin)
        dt = 0.4 * h / 1.5
        ta = TimeAxis(start=0.0, stop=tn, step=dt)
        src = RickerSource(name="src", f0=0.015, time_range=ta,
                           coordinates=np.array([[n // 2 * h, 3 * h]]))
        rc = np.array([[n // 2 * h + 200.0, 400.0],
                       [n // 2 * h - 300.0, 150.0]])
        si, sw = interp_table(src.coordinates, (-margin * h, 0.0), (h, h))
        ri, rw = interp_table(rc, (-margin * h, 0.0), (h, h))
        return (torch.as_tensor(v, device=dev),
                torch.as_tensor(src.data, device=dev), si, sw, ri, rw, dt,
                dict(nt=ta.num, spacing=(h, h), npml=margin))

    def run(fwd, margin, tn=800.0, **kw):
        v, wav, si, sw, ri, rw, dt, static = case(margin, tn)
        t0 = time.perf_counter()
        rec, _ = fwd(v, wav, si, sw, ri, rw, dt, **static, **kw)
        sync(dev)
        return rec.cpu().numpy(), time.perf_counter() - t0, static["nt"]

    ref, t_ref, nt = run(abc.pml_acoustic_forward, 200, quibar=0.0)
    hard, _, _ = run(abc.pml_acoustic_forward, 20, quibar=0.0)

    def err(rec):
        return np.linalg.norm(rec - ref) / np.linalg.norm(ref)
    err_hard = err(hard)
    print(f"   boundary-free reference (501 x 301, {nt} steps) "
          f"{t_ref:.3f} s; hard truncation error {err_hard:.4e} [> 0.1]")
    fails = [] if err_hard > 0.1 else ["hard truncation"]
    pml, secs, _ = run(abc.pml_acoustic_forward, 20, quibar=0.05)
    print(f"   PML (141 x 121): error {err(pml):.4e}, "
          f"{err(pml) / err_hard:.4e} of hard [0.01]; {secs:.3f} s")
    if not err(pml) < 0.01 * err_hard:
        fails.append("PML")
    for habctype in (1, 2, 3):
        rec, secs, _ = run(abc.habc_acoustic_forward, 20, habctype=habctype,
                           habcw=2)
        limit = 0.005 if habctype == 3 else 0.05
        print(f"   HABC type {habctype}: error {err(rec):.4e}, "
              f"{err(rec) / err_hard:.4e} of hard [{limit}]; {secs:.3f} s")
        if not err(rec) < limit * err_hard:
            fails.append(f"HABC {habctype}")
    for name, fwd, kw in (("PML", abc.pml_acoustic_forward,
                           dict(quibar=0.05)),
                          ("HABC type 3", abc.habc_acoustic_forward,
                           dict(habctype=3))):
        rec, secs, nt = run(fwd, 20, tn=8000.0, **kw)
        norm = float(np.linalg.norm(rec))
        print(f"   stability, {name}, {nt} steps: |rec| {norm:.4e}, "
              f"{secs:.3f} s")
        if not np.isfinite(norm):
            fails.append(f"{name} stability")
    print(f"   phase 41: {time.perf_counter() - t_phase:.1f} s")
    if fails:
        raise AssertionError(f"boundary checks failed: {fails}")


# phase 42's shots of bench.py's 4 (a slice): about 10 s a shot for the
# gradient and 5 s for its observed data, host-bound eager steps
VE_SHOTS = slice(1, 2)


def viscoelastic_phase(dev, marm):
    """Phase 42: the viscoelastic solver's goldens and a timed
    five-parameter gradient on ``bench.py``'s ``_bench_viscoelastic``
    workload."""
    from scipy.ndimage import gaussian_filter
    from devito_fwi_tpu_torch.elastic_fwi import model_vp_vs_rho
    from devito_fwi_tpu_torch.misfit import least_square_torch
    from devito_fwi_tpu_torch.models.geometry import (AcquisitionGeometry,
                                                      setup_geometry)
    from devito_fwi_tpu_torch.models.model import SeismicModel
    from devito_fwi_tpu_torch.models.presets import demo_model, load_velocity
    from devito_fwi_tpu_torch.ops import staggered as st
    from devito_fwi_tpu_torch.ops import staggered_grad as sg
    from devito_fwi_tpu_torch.ops.elastic_wavesolver import (
        ViscoelasticWaveSolver)
    from devito_fwi_tpu_torch.ops.interp import interp_table
    phase(f"42 viscoelastic on {dev.type}: the solver's goldens and the "
          "five-parameter gradient of bench.py's viscoelastic workload")
    t_phase = time.perf_counter()
    model = demo_model("layers-viscoelastic", space_order=4, shape=(50, 50),
                       nbl=40, dtype=np.float32, spacing=(20., 20.))
    geometry = setup_geometry(model, 1000.)
    rec1, rec2, _, _, summary = ViscoelasticWaveSolver(
        model, geometry, space_order=4, device=dev.type).forward()
    n1, n2 = np.linalg.norm(rec1.data), np.linalg.norm(rec2.data)
    print(f"   goldens: |rec1| {n1:.6f} [12.28040], |rec2| {n2:.6f} "
          f"[0.312461] (atol 1e-3); forward {summary.elapsed:.3f} s, "
          f"nt {geometry.nt}")
    if not (abs(n1 - 12.28040) <= 1e-3 and abs(n2 - 0.312461) <= 1e-3):
        raise AssertionError("the viscoelastic goldens are off")

    # bench.py _bench_viscoelastic: SMARM2, vp smoothed at sigma 20, vs
    # floored at 0.6, qp = 3.516 vp^2.2 1e-6, qs = 0.6 qp, 4 shots,
    # receivers and sources at 60 m, space order 4
    cfg = marm.SMARM2
    v_true = load_velocity(f"{marm.default_data_dir()}/{cfg.name}/vp.true",
                           cfg.shape)
    v_init = gaussian_filter(v_true, sigma=20).astype(np.float32)
    vs_t, rho_t = marm.elastic_fields(cfg, v_true)
    vs_t = np.maximum(vs_t, 0.6).astype(np.float32)
    qp = (3.516 * ((v_true * 1000.0) ** 2.2) * 1e-6).astype(np.float32)
    qs = (qp * 0.6).astype(np.float32)

    def mk(vp, dt=None):
        return SeismicModel(origin=(0., 0.), spacing=cfg.spacing,
                            shape=cfg.shape, space_order=4, vp=vp, vs=vs_t,
                            b=(1.0 / rho_t), qp=qp, qs=qs, nbl=cfg.nbl,
                            dt=dt, bcs="mask")

    dt_e = min(float(mk(v_true).critical_dt), float(mk(v_init).critical_dt))
    m1, m0 = mk(v_true, dt_e), mk(v_init, dt_e)
    nsrc, nrec = 4, cfg.shape[0]
    src = np.stack([np.linspace(0, m1.domain_size[0], nsrc),
                    np.full(nsrc, 60.0)], 1)
    rec = np.stack([np.linspace(cfg.spacing[0],
                                m1.domain_size[0] - cfg.spacing[0], nrec),
                    np.full(nrec, 60.0)], 1)
    # nt cut to CUT_STEPS (from 1178) for the script's time
    g0 = AcquisitionGeometry(m0, rec, src, 0.0,
                             min(cfg.tn, CUT_STEPS * dt_e), f0=cfg.f0,
                             src_type="Ricker")
    nt = g0.nt
    run = range(nsrc)[VE_SHOTS]

    def T(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    damp = T(m0.damp if np.ndim(m0.damp) else
             np.ones(m0.padded_shape, np.float32))
    r_idx, r_w = interp_table(g0.rec_positions, m0.origin_pml, m0.spacing)
    # one shot a call: its source point and its column of the wavelets
    tables = [interp_table(src[i:i + 1], m0.origin_pml, m0.spacing) +
              (T(g0.src.data[:, i:i + 1]),) for i in run]
    kw = dict(nt=nt, spacing=m0.spacing, space_order=4)
    t0 = time.perf_counter()
    obs = [st.viscoelastic_forward(T(m1.lam), T(m1.mu), T(m0.b), T(m0.qp),
                                   T(m0.qs), damp, g0.f0, wav, si, sw, r_idx,
                                   r_w, dt_e, **kw)[0]
           for si, sw, wav in tables]
    sync(dev)
    t_obs = time.perf_counter() - t0
    params = [T(x) for x in model_vp_vs_rho(m0)] + [T(m0.qp), T(m0.qs)]
    zeros = torch.zeros_like(obs[0])
    t0 = time.perf_counter()
    fval, grads, shot_s = 0.0, None, []
    for (si, sw, wav), o in zip(tables, obs):
        t1 = time.perf_counter()
        f, g, _, _ = sg.viscoelastic_value_and_grad(
            *params, damp, g0.f0, wav, si, sw, r_idx, r_w, o, zeros, dt_e,
            least_square_torch, **kw)
        fval += float(f)
        grads = list(g) if grads is None else [a + b for a, b in
                                               zip(grads, g)]
        shot_s.append(time.perf_counter() - t1)
    sync(dev)
    t_grad = time.perf_counter() - t0
    cells = m0.padded_shape[0] * m0.padded_shape[1]
    print(f"   workload: padded {m0.padded_shape}, nt {nt}, dt {dt_e:.4f} "
          f"ms, shots {list(run)} of {nsrc} (VE_SHOTS); observed data "
          f"{t_obs:.3f} s")
    per_shot = [round(x, 3) for x in shot_s]
    print(f"   gradient: objective {fval!r}, {t_grad:.3f} s ({per_shot} s "
          f"a shot; {2 * len(run) * nt * cells / t_grad / 1e6:.1f} "
          "Mcell-steps/s)")
    ok = np.isfinite(fval) and fval > 0
    for name, g in zip(("vp", "vs", "rho", "qp", "qs"), grads):
        gmax = float(g.abs().max())
        print(f"   max|g_{name}| = {gmax:.4e}")
        ok = ok and bool(torch.isfinite(g).all()) and gmax > 0
    print(f"   phase 42: {time.perf_counter() - t_phase:.1f} s")
    if not ok:
        raise AssertionError("the viscoelastic gradient is not finite and "
                             "non-zero")


# phases 43-44: the shot of the full-width geometry the routes run (the
# middle one of SMARM2's 31 and near SMARMN's middle), the routes' limits
# against the kernel route (float32: the same discrete gradient rounded in
# another order; objective relative, gradient of its max), and the steps
# every eager run of the two phases (and of phases 42, 48 and 49) is cut to
# (the time limit's cut, about 0.2 of the drivers' nt; the widths stay): at
# full nt the two phases took 143.4 s of a script that ran past its limit
# on a slower host, at 400 steps 72.5 s, at 300 63.0-68.4 s
ROUTE_SHOT = 15
ROUTE_RTOL = (1e-5, 1e-4)
CUT_STEPS = 300
DOT_RTOL = 1e-11


# the functions that run one shot chunk of an eager route
EAGER_CHUNKS = {"elastic": ("_eager_chunk",),
                "visco": ("_saved_grads", "_vjp_grads")}


@contextlib.contextmanager
def chunk_peaks(fwi_mod, names, dev):
    """Within the block, each call of ``fwi_mod``'s functions ``names``
    records its peak device bytes above those allocated at its entry:
    yields (those peaks, the call's whole peak in absolute bytes). The
    shots of a chunk hold what the chunk allocates; what the objective
    holds around its chunks (the observed data, the parameters, the
    illumination masks, which it forms before the first chunk and frees)
    is not a shot's."""
    peaks, before = [], []
    originals = {n: getattr(fwi_mod, n) for n in names}

    def spy(*a, _orig, **k):
        torch.cuda.synchronize()
        before.append(torch.cuda.max_memory_allocated(dev))
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = _orig(*a, **k)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated(dev) - base)
        return out

    for n, orig in originals.items():
        setattr(fwi_mod, n, lambda *a, _orig=orig, **k: spy(
            *a, _orig=_orig, **k))
    whole = []
    try:
        yield peaks, whole
    finally:
        for n, orig in originals.items():
            setattr(fwi_mod, n, orig)
        torch.cuda.synchronize()
        whole.append(max(before + [torch.cuda.max_memory_allocated(dev)]))


def run_routes(family, fwi_mod, mod, geometry, obs, counters, dev, **kw):
    """The objective of ``fwi_mod`` on ``geometry`` on the kernel route
    ("auto") and the eager "saved" and "vjp" routes, one shot: each route's
    (fval, grads), seconds and peak device bytes; on an eager route also
    its shot chunk's own peak, held against the bytes a shot its chunks
    are sized with; the kernels of ``mod`` launched on the kernel route
    alone, nothing counted as a fallback."""
    out = {}
    # the observed data's device copy first (cached across calls), so the
    # peaks below are the routes' own
    fwi_mod._device_stack(obs, dev)
    for route in ("auto", "saved", "vjp"):
        for reset in counters:
            reset()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        with chunk_peaks(fwi_mod, EAGER_CHUNKS[family], dev) as (
                chunks, whole):
            f, g, _ = getattr(fwi_mod, f"{family}_fwi_obj_multi")(
                geometry, obs, calc_grad=True, shot_indices=[ROUTE_SHOT],
                grad_route=route, device="cuda", **kw)
        sec = time.perf_counter() - t0
        peak = whole[0] - base
        launched = sum(mod.LAUNCHES.values())
        st = fwi_mod._Setup(geometry, dev, [ROUTE_SHOT])
        if route == "auto":
            sized = fwi_mod._bytes_per_shot(fwi_mod._Tables(
                geometry, dev, [ROUTE_SHOT]), True, "least_square")
        elif family == "elastic":
            sized = fwi_mod._eager_bytes_per_shot(st, True, "least_square",
                                                  route, 0)
        else:
            sized = fwi_mod._eager_bytes_per_shot(st, True, "least_square",
                                                  route, ("sls", 2), 0)
        held = f", its chunk {chunks[0] / 1e9:.4f} GB" if chunks else ""
        print(f"   {route}: objective {f!r}, {sec:.3f} s, peak "
              f"{peak / 1e9:.4f} GB{held} (sized {sized / 1e9:.4f} GB a "
              f"shot), kernel launches {launched}")
        if (launched > 0) != (route == "auto") or \
                fwi_mod.EAGER["objective"] != 0 or \
                (route != "auto") != (len(chunks) == 1):
            raise AssertionError(f"{family} {route}: the route ran the wrong "
                                 "path")
        # the kernel route's figure is a shot's share of a chunk, the fixed
        # operands apart (held against a 31-shot chunk in phase 14)
        if route != "auto" and chunks[0] > sized:
            raise AssertionError(f"{family} {route}: the shot holds more "
                                 "than its chunks are sized with")
        if not np.isfinite(f) or any(not np.isfinite(v).all()
                                     for v in g.values()):
            raise AssertionError(f"{family} {route}: not finite")
        out[route] = (f, g, sec, peak, sized)
    f0, g0 = out["auto"][:2]
    ok = True
    for route in ("saved", "vjp"):
        f, g = out[route][:2]
        rel_f = abs(f - f0) / abs(f0)
        rel_g = {k: float(np.abs(g[k] - g0[k]).max() / np.abs(g0[k]).max())
                 for k in g}
        print(f"   {route} vs kernels: objective {rel_f:.3e} (limit "
              f"{ROUTE_RTOL[0]:g}), gradients "
              f"{ {k: f'{v:.3e}' for k, v in rel_g.items()} } of their max "
              f"(limit {ROUTE_RTOL[1]:g})")
        ok = ok and rel_f <= ROUTE_RTOL[0] and \
            max(rel_g.values()) <= ROUTE_RTOL[1]
    if not ok:
        raise AssertionError(f"the {family} routes disagree with the kernel "
                             "route")
    return out


def dot_check(name, lhs, rhs):
    rel = abs(lhs - rhs) / max(abs(lhs), abs(rhs))
    print(f"   {name} dot test at float64: <J dm, dr> = {lhs!r}, "
          f"<dm, J^T dr> = {rhs!r}, relative {rel:.3e} (limit {DOT_RTOL:g})")
    if not rel <= DOT_RTOL:
        raise AssertionError(f"the {name} dot test fails")


def small_model(dev, visco):
    """The CPU tests' small case on ``dev`` at float64: a two-layer 41 x 36
    model at 10 m (nbl 8, space order 4, dt 1 ms, the mask boundary), one
    source at (80, 20) m, 21 receivers at 30 m, tn 140 ms; its padded
    fields as tensors, the wavelet, the tables and the op keywords."""
    from devito_fwi_tpu_torch.elastic_fwi import model_vp_vs_rho
    from devito_fwi_tpu_torch.models.geometry import AcquisitionGeometry
    from devito_fwi_tpu_torch.models.model import SeismicModel
    from devito_fwi_tpu_torch.ops.interp import interp_table
    shape = (41, 36)
    vp = np.full(shape, 2.0)
    vp[:, 18:] = 2.4
    rho = 0.31 * (1e3 * vp) ** 0.25
    extra = dict(qp=np.where(vp > 2.2, 90.0, 60.0)) if visco else \
        dict(vs=vp / 2.0)
    model = SeismicModel(origin=(0., 0.), spacing=(10., 10.), shape=shape,
                         space_order=4, vp=vp, b=1.0 / rho, nbl=8,
                         bcs="mask", dtype=np.float64, dt=1.0, **extra)
    rec = np.stack([np.linspace(0., 400., 21), np.full(21, 30.0)], 1)
    g = AcquisitionGeometry(model, rec, np.array([[80., 20.]]), 0., 140.,
                            f0=0.015, src_type="Ricker")
    tables = (*interp_table(g.src_positions, model.origin_pml,
                            model.spacing, dtype=np.float64),
              *interp_table(g.rec_positions, model.origin_pml,
                            model.spacing, dtype=np.float64))

    def T(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)
    if visco:
        fields = tuple(T(getattr(model, n)) for n in ("vp", "b", "qp",
                                                      "damp"))
    else:
        fields = tuple(T(x) for x in model_vp_vs_rho(model))
    kw = dict(nt=g.nt, spacing=model.spacing, space_order=4)
    return g, fields, T(g.src.data), tables, kw, float(model.critical_dt)


def cut_geometries(*geometries):
    """Each geometry with its sources and receivers, its tn cut to
    ``CUT_STEPS`` of its model's dt."""
    from devito_fwi_tpu_torch.models.geometry import AcquisitionGeometry
    return [AcquisitionGeometry(g.model, g.rec_positions, g.src_positions,
                                0., CUT_STEPS * float(g.model.critical_dt),
                                f0=g.f0, src_type="Ricker")
            for g in geometries]


def smooth_perturbation(field, seed):
    """A smooth random perturbation of 1% of the field's mean."""
    from scipy.ndimage import gaussian_filter
    d = gaussian_filter(np.random.RandomState(seed).randn(*field.shape), 3)
    d *= 1e-2 * float(field.abs().mean()) / np.abs(d).max()
    return torch.as_tensor(d, device=field.device)


def elastic_routes_phase(dev, marm, elastic_fwi, cs, counters):
    """Phase 43: the elastic objective's routes, Born and the Born dot
    test."""
    from devito_fwi_tpu_torch.models.geometry import AcquisitionGeometry
    from devito_fwi_tpu_torch.ops import staggered_grad as sg
    from devito_fwi_tpu_torch.ops.interp import interp_table
    phase(f"43 elastic routes on SMARM2's full grid, shot {ROUTE_SHOT}: "
          "saved and vjp against the kernels, auto off the kernels, Born")
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    eargs = marm.make_parser(marm.SMARM2).parse_args(
        ["--physics", "elastic", "--device", "cuda"])
    _, geoms, fields, _ = marm.setup_elastic(
        marm.SMARM2, eargs, marm.SMARM2.nsrc_default)
    g1, g0 = geoms[:2]
    _, smooth_vp, vs0, rho0 = fields
    c1, c0 = cut_geometries(g1, g0)
    print(f"   the routes at nt {c0.nt}, cut from {g0.nt}: CUT_STEPS")
    obs, _ = elastic_fwi.elastic_fm_multi(c1, device="cuda")
    run_routes("elastic", elastic_fwi, cs, c0, obs, counters, dev,
               vp=smooth_vp, vs=vs0, rho=rho0)

    # receivers on a vertical line: no kernel takes it, auto runs "saved"
    m0, m1 = g0.model, g1.model
    xs, zs = m0.domain_size
    rec = np.stack([np.full(60, 0.5 * xs), np.linspace(
        2 * m0.spacing[1], zs - m0.spacing[1], 60)], 1)
    src = g0.src_positions[ROUTE_SHOT:ROUTE_SHOT + 1]
    gv1, gv0 = (AcquisitionGeometry(m, rec, src, 0.,
                                    CUT_STEPS * float(m0.critical_dt),
                                    f0=g0.f0, src_type="Ricker")
                for m in (m1, m0))
    for reset in counters:
        reset()
    elastic_fwi.reset_counters()
    t0 = time.perf_counter()
    obs_v, _ = elastic_fwi.elastic_fm_multi(gv1, device="cuda")
    t_fm = time.perf_counter() - t0
    t0 = time.perf_counter()
    f_v, g_v, _ = elastic_fwi.elastic_fwi_obj_multi(
        gv0, obs_v, calc_grad=True, vp=smooth_vp, vs=vs0, rho=rho0,
        device="cuda")
    t_obj = time.perf_counter() - t0
    print(f"   vertical line (60 receivers at x = {0.5 * xs:.0f} m, nt "
          f"{gv0.nt}, cut from {g0.nt}: CUT_STEPS): "
          f"elastic_fm_multi {t_fm:.3f} s, auto gradient {t_obj:.3f} s, "
          f"objective {f_v!r}; elastic_fwi.EAGER {elastic_fwi.EAGER}, "
          f"kernel launches {sum(cs.LAUNCHES.values())}")
    if not (elastic_fwi.EAGER == {"objective": 1, "fm_multi": 1} and
            sum(cs.LAUNCHES.values()) == 0 and np.isfinite(f_v) and
            all(np.isfinite(v).all() and np.abs(v).max() > 0
                for v in g_v.values())):
        raise AssertionError("the vertical line did not take the counted "
                             "saved route, or its gradient is not finite")

    # Born on the full grid, nt cut to CUT_STEPS: the primal against the
    # kernel's traces
    gb = AcquisitionGeometry(m0, g0.rec_positions, src, 0.,
                             CUT_STEPS * float(m0.critical_dt), f0=g0.f0,
                             src_type="Ricker")
    vp, vs, rho = (torch.as_tensor(x, device=dev)
                   for x in elastic_fwi.model_vp_vs_rho(m0))
    s_idx, s_w = interp_table(src, m0.origin_pml, m0.spacing)
    r_idx, r_w = interp_table(g0.rec_positions, m0.origin_pml, m0.spacing)
    damp = torch.as_tensor(elastic_fwi._damp_field(m0), device=dev)
    # the shots share one wavelet: the first column of the geometry's
    wav = torch.as_tensor(gb.src.data, device=dev)
    dvp = 0.01 * vp
    sync(dev)
    t0 = time.perf_counter()
    (rec1, _), (drec1, drec2) = sg.elastic_born(
        vp, vs, rho, dvp, None, None, damp, wav, s_idx, s_w, r_idx, r_w,
        float(m0.critical_dt), nt=gb.nt, spacing=m0.spacing,
        space_order=m0.space_order)
    sync(dev)
    t_born = time.perf_counter() - t0
    kern = elastic_fwi.elastic_fm_multi(gb, device="cuda")[0][0]
    want = torch.as_tensor(kern.data, device=dev)
    rel = float((rec1 - want).abs().max() / want.abs().max())
    print(f"   elastic_born (1% vp): {t_born:.3f} s ({gb.nt - 1} steps, cut "
          f"from {g0.nt - 1}: CUT_STEPS), "
          f"max|drec1| {float(drec1.abs().max()):.4e}, primal vs the "
          f"kernel's traces {rel:.3e} of the max (limit {ROUTE_RTOL[1]:g})")
    if not (rel <= ROUTE_RTOL[1] and bool(torch.isfinite(drec1).all()) and
            bool(torch.isfinite(drec2).all()) and drec1.abs().max() > 0):
        raise AssertionError("elastic_born disagrees or is not finite")
    del rec1, drec1, drec2, obs

    # the Born dot test at float64 on the small grid
    g, (vp, vs, rho), wav, tables, kw, dt = small_model(dev, visco=False)
    damp = torch.ones_like(vp)
    dvp = smooth_perturbation(vp, 9)
    (_, _), (drec1, _) = sg.elastic_born(vp, vs, rho, dvp, None, None, damp,
                                         wav, *tables, dt, **kw)
    dr = torch.as_tensor(np.random.RandomState(2).randn(*drec1.shape),
                         device=dev)
    lam, mu, b = rho * (vp * vp - 2.0 * vs * vs), rho * vs * vs, 1.0 / rho
    _, _, hist = sg.elastic_forward_hist(lam, mu, b, damp, wav, *tables, dt,
                                         **kw)
    glam, _, _ = sg.elastic_adjoint_from_hist(lam, mu, b, damp, tables[2],
                                              tables[3], dr, hist, dt, **kw)
    dot_check("elastic Born", float(torch.sum(drec1 * dr)),
              float(torch.sum(2.0 * rho * vp * glam * dvp)))
    print(f"   phase 43: {time.perf_counter() - t_phase:.1f} s")


def visco_routes_phase(dev, marm, visco_fwi, cv, counters):
    """Phase 44: the viscoacoustic objective's routes, the five other
    kernels and the Born dot test."""
    from devito_fwi_tpu_torch.models.geometry import AcquisitionGeometry
    from devito_fwi_tpu_torch.ops import visco_grad as vg
    from devito_fwi_tpu_torch.ops.viscoacoustic import KERNELS
    phase(f"44 viscoacoustic routes on SMARMN's full grid, shot "
          f"{ROUTE_SHOT}: sls/2 saved and vjp against the kernels, the five "
          "other kernels, Born")
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    vargs = marm.make_parser(marm.SMARMN).parse_args(
        ["--physics", "viscoacoustic", "--device", "cuda"])
    _, geoms, smooth_vp, _ = marm.setup_visco(
        marm.SMARMN, vargs, marm.SMARMN.nsrc_default)
    g1, g0 = geoms[:2]
    c1, c0 = cut_geometries(g1, g0)
    print(f"   the routes and the five other kernels at nt {c0.nt}, cut from "
          f"{g0.nt}: CUT_STEPS")
    obs = visco_fwi.visco_fm_multi(c1, device="cuda")
    run_routes("visco", visco_fwi, cv, c0, obs, counters, dev, vp=smooth_vp)
    del obs

    m1, m0 = g1.model, g0.model
    src = g0.src_positions[ROUTE_SHOT:ROUTE_SHOT + 1]
    dt = float(m0.critical_dt)

    def one_shot(m, tn):
        return AcquisitionGeometry(m, g0.rec_positions, src, 0., tn,
                                   f0=g0.f0, src_type="Ricker")

    cut1, cut0 = (one_shot(m, CUT_STEPS * dt) for m in (m1, m0))
    for kind in sorted(KERNELS - {("sls", 2)}):
        for reset in counters:
            reset()
        visco_fwi.reset_counters()
        t0 = time.perf_counter()
        obs_c = visco_fwi.visco_fm_multi(cut1, *kind, device="cuda")
        t_fm = time.perf_counter() - t0
        rec = obs_c[0].data
        t0 = time.perf_counter()
        f, g, _ = visco_fwi.visco_fwi_obj_multi(
            cut0, obs_c, calc_grad=True, vp=smooth_vp, kernel=kind[0],
            time_order=kind[1], device="cuda")
        t_grad = time.perf_counter() - t0
        print(f"   {kind[0]}/{kind[1]}: visco_fm_multi {t_fm:.3f} s "
              f"(max|rec| {np.abs(rec).max():.4e}), vjp gradient "
              f"{t_grad:.3f} s (objective {f!r}); visco_fwi.EAGER "
              f"{visco_fwi.EAGER}, kernel launches "
              f"{sum(cv.LAUNCHES.values())}")
        if not (visco_fwi.EAGER == {"objective": 1, "fm_multi": 1} and
                sum(cv.LAUNCHES.values()) == 0 and np.isfinite(rec).all()
                and np.abs(rec).max() > 0 and np.isfinite(f) and f > 0 and
                all(np.isfinite(v).all() for v in g.values())):
            raise AssertionError(f"{kind}: not the counted eager route, or "
                                 "not finite")

    # visco_born's dot test at float64 on the small grid
    g, (vp, b, qp, damp), wav, tables, kw, dt = small_model(dev, visco=True)
    dvp, dqp = smooth_perturbation(vp, 4), smooth_perturbation(qp, 5)
    rec, drec = vg.visco_born(vp, b, qp, dvp, dqp, damp, wav, *tables, dt,
                              g.f0, **kw)
    dr = torch.as_tensor(np.random.RandomState(6).randn(*rec.shape),
                         device=dev)
    _, _, hist = vg.visco_sls2_forward_hist(vp, b, qp, damp, wav, *tables,
                                            dt, g.f0, **kw)
    g_vp, g_qp = vg.visco_sls2_adjoint_from_hist(
        vp, b, qp, damp, wav, *tables, dr, hist, dt, g.f0, **kw)
    dot_check("viscoacoustic sls/2 Born", float(torch.sum(drec * dr)),
              float(torch.sum(g_vp * dvp) + torch.sum(g_qp * dqp)))
    print(f"   phase 44: {time.perf_counter() - t_phase:.1f} s")


def run_visco_smarm2(marm, counters):
    """Phase 45's driver run. A fault of the JAX driver that the port
    mirrors (ROADMAP.md queue C): ``setup_visco`` pins dt at the true
    model's CFL speed (4.66 km/s at SMARM2) while the inversion's bounds
    reach 5.2 km/s, so a trial at the bound diverges (a NaN objective);
    when the finite trials keep descending toward it the line search fails,
    and ``minimize`` retries the same direction without end. The run here
    allows the one retry and then lets the optimizer stop."""
    from devito_fwi_tpu_torch.optimize import optimizers
    retry = optimizers.base.retry_status
    retries = []

    def retry_once(self, g, p):
        retries.append(1)
        return retry(self, g, p) if len(retries) == 1 else 0

    optimizers.base.retry_status = retry_once
    try:
        stats = run_driver(marm, marm.SMARM2, [
            "--physics", "viscoacoustic", "--misfit", "0"], counters)
    finally:
        optimizers.base.retry_status = retry
    stats["retries"] = len(retries)
    return stats


def visco_smarm2_check(stats):
    """Finite, decreasing misfit at the two gradients; the trials printed,
    the non-finite ones (the dt fault) counted."""
    calls = stats["calls"]
    f = [c[1] for c in calls if c[0]]
    trials = [c[1] for c in calls if not c[0]]
    print(f"   misfit at each gradient: {f}")
    print(f"   line-search trials: {trials}")
    print(f"   time per gradient: {[c[2] for c in calls if c[0]]} s")
    print(f"   time per line-search trial: "
          f"{[c[2] for c in calls if not c[0]]} s")
    print(f"   forward modeling of obs + direct wave: {stats['model_s']:.3f}"
          " s")
    bad = sum(1 for v in trials if not np.isfinite(v))
    print(f"   non-finite trials (past the pinned dt's CFL speed): {bad}; "
          f"failed searches retried or stopped: {stats['retries']}")
    if not (len(f) == 2 and np.all(np.isfinite(f)) and f[1] < f[0]):
        raise AssertionError(f"misfit not finite and decreasing: {calls}")


# ---------------------------------------------------------------------------
# phases 46-50: the parallel layer (devito_fwi_tpu_torch.parallel)
# ---------------------------------------------------------------------------

# ranks spawned on the one card (gloo: NCCL refuses two ranks on a card)
PAR_RANKS = 4
# phase 47's limits against the single-process objectives: the ranks' sums
# meet in another order (objective relative, gradient of its max)
PAR_RTOL = (1e-6, 1e-5)
# phase 48's TTI shots (one a rank), phase 49's shots x domain shots (one a
# shot group), both at CUT_STEPS
PAR_TTI_SHOTS = 4
PAR_HIER_SHOTS = 2
# phase 49's 3-D steps (config 5's 333, cut in depth)
PAR_C5_STEPS = 100


def par_geometries(marm):
    """The parallel phases' geometries, the same in this process and every
    rank: SMARMN acoustic and viscoacoustic and SMARM2 elastic (true,
    initial) at their shots; marmousi-tti2d at PAR_TTI_SHOTS shots and
    CUT_STEPS; SMARMN (true, initial) at CUT_STEPS with PAR_HIER_SHOTS
    shots; config 5 at PAR_C5_STEPS, one shot; the CPU tests' small
    viscoelastic case (33 x 29, qp 60, qs 40, nbl 6, 2 shots) and
    self-adjoint case (41 x 36, space order 8, w/Q damping, 3 shots)."""
    from devito_fwi_tpu_torch.models.geometry import AcquisitionGeometry
    from devito_fwi_tpu_torch.models.model import SeismicModel
    from devito_fwi_tpu_torch.ops.self_adjoint import setup_w_over_q

    def parse(cfg, *argv):
        return marm.make_parser(cfg).parse_args([*argv, "--device", "cuda"])

    def cut(g, steps, pick):
        return AcquisitionGeometry(g.model, g.rec_positions,
                                   g.src_positions[pick], 0.,
                                   steps * float(g.model.critical_dt),
                                   f0=g.f0, src_type="Ricker")
    out = {}
    _, geoms, _, _ = marm.setup(marm.SMARMN, parse(marm.SMARMN),
                                marm.SMARMN.nsrc_default)
    out["smarmn"] = geoms[:2]
    _, geoms, _, _ = marm.setup_elastic(
        marm.SMARM2, parse(marm.SMARM2, "--physics", "elastic"),
        marm.SMARM2.nsrc_default)
    out["elastic"] = geoms[:2]
    _, geoms, _, _ = marm.setup_visco(
        marm.SMARMN, parse(marm.SMARMN, "--physics", "viscoacoustic"),
        marm.SMARMN.nsrc_default)
    out["visco"] = geoms[:2]
    out["tti"], = cut_geometries(tti_config4(PAR_TTI_SHOTS))
    g0 = out["smarmn"][1]
    pick = np.linspace(0, g0.nsrc - 1, PAR_HIER_SHOTS).round().astype(int)
    out["cut"] = [cut(g, CUT_STEPS, pick) for g in out["smarmn"]]
    out["c5"] = cut(config5(1), PAR_C5_STEPS, [0])
    shape = (33, 29)
    vp = np.full(shape, 2.0, np.float32)
    vp[:, 14:] = 2.2
    rho = (0.31 * (1e3 * vp) ** 0.25).astype(np.float32)
    ve = SeismicModel(origin=(0., 0.), spacing=(10., 10.), shape=shape,
                      space_order=4, vp=vp, vs=vp / 2.0, b=1.0 / rho,
                      qp=np.full(shape, 60.0, np.float32),
                      qs=np.full(shape, 40.0, np.float32), nbl=6,
                      bcs="mask", dt=1.0)
    out["ve"] = AcquisitionGeometry(
        ve, np.stack([np.linspace(0., 320., 17), np.full(17, 30.)], 1),
        np.stack([np.linspace(60., 260., 2), np.full(2, 20.)], 1), 0., 160.,
        f0=0.015, src_type="Ricker")
    shape = (41, 36)
    vp = np.full(shape, 2.0, np.float32)
    vp[:, 18:] = 2.4
    sa = SeismicModel(origin=(0., 0.), spacing=(10., 10.), shape=shape,
                      space_order=8, vp=vp, b=np.ones(shape, np.float32),
                      nbl=8, bcs="damp", dt=0.8)
    sa.damp[:] = setup_w_over_q(sa.padded_shape, w=2 * np.pi * 0.015,
                                qmin=0.1, qmax=100.0, npad=8,
                                dtype=np.float32)
    out["sa"] = AcquisitionGeometry(
        sa, np.stack([np.linspace(0., 400., 21), np.full(21, 30.)], 1),
        np.stack([np.linspace(50., 350., 3), np.full(3, 20.)], 1), 0., 160.,
        f0=0.015, src_type="Ricker")
    return out


def zero_obs(g):
    return np.zeros((g.nsrc, g.nt, g.rec_positions.shape[0]), np.float32)


def par_rank(work):
    """One spawned rank of phases 47-50 (gloo on the card): its results,
    counts, times and peak, returned to this process, which prints them;
    the rank prints nothing. Spawned when the script starts, it builds its
    geometries and waits for ``work/go`` before it touches the card: the
    earlier phases and phase 46 hold the card until then."""
    import contextlib
    import io
    import warnings
    warnings.simplefilter("ignore")
    from devito_fwi_tpu_torch import fwi
    from devito_fwi_tpu_torch.drivers import _marmousi_common as marm
    from devito_fwi_tpu_torch.misfit import least_square
    from devito_fwi_tpu_torch.ops import (cuda_acoustic, cuda_acoustic3,
                                          cuda_acoustic3d, cuda_bfm,
                                          cuda_legacy, cuda_staggered,
                                          cuda_tti, cuda_visco)
    from devito_fwi_tpu_torch.parallel import group
    from devito_fwi_tpu_torch.parallel import sharding as sh
    from devito_fwi_tpu_torch.parallel.dryrun import dryrun_multichip
    modules = (cuda_acoustic, cuda_bfm, cuda_staggered, cuda_visco,
               cuda_tti, cuda_acoustic3, cuda_acoustic3d, cuda_legacy)
    laps = {}

    def lap(what, t0):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        laps[what] = time.perf_counter() - t0
        return time.perf_counter()

    def reset():
        for mod in modules:
            mod.reset_counters()

    def counts():
        return ({k: v for mod in modules for k, v in mod.LAUNCHES.items()},
                {k: v for mod in modules for k, v in mod.TWIN_CALLS.items()})

    t = time.perf_counter()
    geoms = par_geometries(marm)
    t = lap("setup", t)
    while not os.path.exists(f"{work}/go"):
        time.sleep(0.05)
    t = lap("wait", t)
    mesh = sh.shot_mesh()
    dev = mesh.device
    t = lap("cuda", t)
    data = np.load(f"{work}/payload.npz")
    out = dict(rank=mesh.rank, device=str(dev), share=mesh.share)
    with group.budget_share(mesh):
        out["budget"] = fwi._device_budget(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset()
    g1, g0 = geoms["smarmn"]
    obs = fwi._shot_records(data["smarmn"], g1)
    out["smarmn"] = sh.fwi_obj_sharded(g0, obs, least_square,
                                       calc_grad=True, mesh=mesh)
    out["smarmn_trial"] = sh.fwi_obj_sharded(g0, obs, least_square,
                                             mesh=mesh)[0]
    t = lap("47 SMARMN", t)
    e0 = geoms["elastic"][1]
    out["elastic"] = sh.elastic_fwi_obj_sharded(
        e0, data["elastic"], least_square, calc_grad=True, mesh=mesh)
    out["elastic_trial"] = sh.elastic_fwi_obj_sharded(
        e0, data["elastic"], least_square, mesh=mesh)[0]
    t = lap("47 elastic", t)
    v1, v0 = geoms["visco"]
    out["visco"] = sh.viscoacoustic_fwi_obj_sharded(
        v0, data["visco"], least_square, calc_grad=True, mesh=mesh)
    out["visco_trial"] = sh.viscoacoustic_fwi_obj_sharded(
        v0, data["visco"], least_square, mesh=mesh)[0]
    t = lap("47 visco", t)
    out["counts47"] = counts()
    out["peak47"] = torch.cuda.max_memory_allocated(dev)

    reset()
    out["tti"] = sh.tti_fwi_obj_sharded(
        geoms["tti"], zero_obs(geoms["tti"]), least_square, calc_grad=True,
        mesh=mesh, n_checkpoints=TTI_CHECKPOINTS)
    t = lap("48 TTI", t)
    fm = sh.viscoacoustic_fm_sharded(v1, mesh=mesh)
    out["visco_fm"] = fm if mesh.rank == 0 else None
    t = lap("48 visco fm", t)
    for name, fn in (("ve", sh.viscoelastic_fwi_obj_sharded),
                     ("sa", sh.sa_fwi_obj_sharded)):
        out[name] = fn(geoms[name], zero_obs(geoms[name]), least_square,
                       calc_grad=True, mesh=mesh)
        t = lap(f"48 {name}", t)
    out["counts48"] = counts()

    reset()
    c0 = geoms["cut"][1]
    for axes in ((4, 1), (2, 2)):
        dmesh = sh.domain_mesh(axes)
        rec = sh.forward_domain_sharded(c0, mesh=dmesh)
        grad = sh.gradient_domain_sharded(c0, 0.5 * rec, mesh=dmesh)
        out[f"domain{axes}"] = (rec, grad)
        t = lap(f"49 domain {axes}", t)
    dmesh = sh.domain_mesh((2, 2))
    rec = sh.forward_domain_sharded(geoms["c5"], mesh=dmesh)
    grad = sh.gradient_domain_sharded(geoms["c5"], 0.5 * rec, mesh=dmesh)
    out["domain3d"] = (rec, grad)
    t = lap("49 domain 3-D (2, 2)", t)
    out["hier"] = sh.fwi_obj_sharded2d(c0, data["cut"], least_square,
                                       calc_grad=True,
                                       mesh=sh.hier_mesh((2, 2)))
    t = lap("49 shots x domain (2, 2)", t)
    out["counts49"] = counts()

    lines = io.StringIO()
    with contextlib.redirect_stdout(lines):
        out["dryrun"] = dryrun_multichip(PAR_RANKS, "cuda")
    out["dryrun_lines"] = lines.getvalue()
    lap("50 dry run", t)
    out["laps"] = laps
    return out


def par_check(what, got, want, rtol):
    """Print and hold (fval, grad) or (fval, {name: grad}) against a
    reference: the objective relative, each gradient of its max."""
    f, g = got
    fr, gr = want
    ferr = abs(f - fr) / abs(fr)
    pairs = g.items() if isinstance(g, dict) else [("grad", g)]
    ref = gr if isinstance(gr, dict) else {"grad": gr}
    gerr = {k: float(np.abs(np.asarray(v).reshape(-1) - np.asarray(
        ref[k]).reshape(-1)).max() / np.abs(ref[k]).max()) for k, v in pairs}
    errs = ", ".join(f"{k} {e:.2e}" for k, e in gerr.items())
    print(f"   {what}: objective {f!r} against {fr!r} ({ferr:.2e} "
          f"relative){'; gradients ' + errs + ' of their max' if errs else ''}"
          f" (limits {rtol[0]:g}, {rtol[1]:g})")
    if not (ferr <= rtol[0] and all(e <= rtol[1] for e in gerr.values())):
        raise AssertionError(f"{what} disagrees with its reference")


def undecomposed(geometry, axes):
    """The eager operators of ``ops.acoustic`` on the whole (edge-padded)
    grid on the card: the traces of ``forward`` and the checkpointed
    gradient of half of them, cropped to the padded grid, the references
    of phase 49."""
    from devito_fwi_tpu_torch import fwi
    from devito_fwi_tpu_torch.ops import acoustic as ac
    from devito_fwi_tpu_torch.parallel.domain import _padded_fields
    model = geometry.model
    dev = torch.device("cuda", 0)
    vp, damp, _ = _padded_fields(model, axes)
    es = fwi._EagerSetup(geometry, dev)
    vp = torch.as_tensor(vp, device=dev)
    damp = torch.as_tensor(damp, device=dev) \
        if isinstance(damp, np.ndarray) else damp
    shot = (vp, damp, es.src_wav, es.s_idx[0], es.s_w[0])
    kw = dict(nt=geometry.nt, spacing=model.spacing,
              space_order=model.space_order, fs=model.fs, step3=False)
    nck = fwi._default_checkpoints(geometry.nt)
    dt = float(fwi._solver_dt(geometry))
    rec = ac.forward(*shot, es.r_idx, es.r_w_np, dt, **kw)[0]
    _, starts, _ = ac.forward_ckpt(*shot, es.r_idx, es.r_w_np, dt,
                                   n_checkpoints=nck, **kw)
    g, _ = ac.gradient_from_ckpt(*shot, starts, 0.5 * rec, es.r_idx,
                                 es.r_w_np, dt, n_checkpoints=nck, **kw)
    crop = tuple(slice(0, n) for n in model.padded_shape)
    return rec.cpu().numpy(), g[crop].cpu().numpy()


class ParallelRanks:
    """The PAR_RANKS gloo ranks of phases 47-50 on the card, spawned when
    the script starts (a spawned rank takes seconds to reach its
    function), waiting for ``go``. A daemon thread runs ``parallel.spawn``,
    so a failed earlier phase ends the script and its ranks with it."""

    def __init__(self):
        import threading
        from devito_fwi_tpu_torch.parallel import group
        self.work = tempfile.mkdtemp(prefix="chip_smoke_par_")
        self.out = {}

        def run():
            try:
                self.out["ranks"] = group.spawn(
                    par_rank, PAR_RANKS, "gloo", "cuda", (self.work,), 1500)
            except BaseException as err:
                self.out["error"] = err
        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def go(self):
        open(f"{self.work}/go", "w").close()

    def join(self):
        """The ranks' results; raises what failed in them."""
        self.go()
        self.thread.join()
        shutil.rmtree(self.work, ignore_errors=True)
        if "error" in self.out:
            raise self.out["error"]
        return self.out["ranks"]


def parallel_phases(dev, marm, fwi, elastic_fwi, visco_fwi, card, world):
    """Phases 46-50: the parallel layer on the card. This process runs
    phase 46 (a world of one on NCCL) and the single-process references
    that need the card's memory, then lets the ranks of ``world`` (a
    ``ParallelRanks``) run phases 47-50 and computes the eager references
    beside them."""
    import torch.distributed as dist
    from devito_fwi_tpu_torch.misfit import least_square
    from devito_fwi_tpu_torch.parallel import sharding as sh

    t_all = time.perf_counter()
    phase("46 parallel: a world of one on NCCL, SMARMN "
          f"{marm.SMARMN.nsrc_default} shots, fwi_obj_sharded against "
          "fwi_obj_multi")
    gc.collect()
    torch.cuda.empty_cache()
    work = world.work
    try:
        geoms = par_geometries(marm)
        # NCCL's bootstrap needs an interface even for one rank
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        dist.init_process_group("nccl", store=dist.FileStore(
            f"{work}/store46", 1), rank=0, world_size=1)
        try:
            mesh = sh.shot_mesh()
            g1, g0 = geoms["smarmn"]
            obs = fwi.fm_multi(g1)
            ref = fwi.fwi_obj_multi(g0, obs, least_square, calc_grad=True)
            ref_trial = fwi.fwi_obj_multi(g0, obs, least_square)[0]
            sync(dev)
            t0 = time.perf_counter()
            got = sh.fwi_obj_sharded(g0, obs, least_square, calc_grad=True,
                                     mesh=mesh)
            sync(dev)
            t_grad = time.perf_counter() - t0
            t0 = time.perf_counter()
            got_trial = sh.fwi_obj_sharded(g0, obs, least_square,
                                           mesh=mesh)[0]
            t_trial = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
        same = got[0] == ref[0] and got_trial == ref_trial and \
            np.array_equal(got[1].reshape(-1), ref[1])
        print(f"   {mesh}: gradient {t_grad:.3f} s, trial {t_trial:.3f} s "
              f"(host clock, the kernels' first calls in this process "
              f"were earlier phases'; {card}); objective {got[0]!r}, "
              f"trial {got_trial!r}; bitwise fwi_obj_multi's: {same}")
        if not same:
            raise AssertionError("a world of one is not fwi_obj_multi "
                                 "bitwise")

        # the single-process references that need the card's memory, before
        # the ranks allocate theirs
        e1, e0 = geoms["elastic"]
        eobs = np.stack([o.data for o in
                         elastic_fwi.elastic_fm_multi(e1)[0]])
        eref = elastic_fwi.elastic_fwi_obj_multi(e0, eobs, least_square,
                                                 calc_grad=True)[:2]
        eref_trial = elastic_fwi.elastic_fwi_obj_multi(e0, eobs,
                                                       least_square)[0]
        v1, v0 = geoms["visco"]
        vobs = np.stack([o.data for o in visco_fwi.visco_fm_multi(v1)])
        vref = visco_fwi.visco_fwi_obj_multi(v0, vobs, least_square,
                                             calc_grad=True)[:2]
        vref_trial = visco_fwi.visco_fwi_obj_multi(v0, vobs,
                                                   least_square)[0]
        c1, c0 = geoms["cut"]
        cobs = np.stack([o.data for o in fwi.fm_multi(c1)])
        np.savez(f"{work}/payload.npz",
                 smarmn=np.stack([o.data for o in obs]), elastic=eobs,
                 visco=vobs, cut=cobs)
        del obs
        gc.collect()
        torch.cuda.empty_cache()
        t_go = time.perf_counter() - t_all
        world.go()
        # the eager references of phases 48-49, beside the ranks (a world
        # of one: the same functions on every shot)
        t0 = time.perf_counter()
        tti_ref = sh.tti_fwi_obj_sharded(
            geoms["tti"], zero_obs(geoms["tti"]), least_square,
            calc_grad=True, n_checkpoints=TTI_CHECKPOINTS)
        t_tti = time.perf_counter() - t0
        small_ref = {name: fn(geoms[name], zero_obs(geoms[name]),
                              least_square, calc_grad=True)
                     for name, fn in (("ve", sh.viscoelastic_fwi_obj_sharded),
                                      ("sa", sh.sa_fwi_obj_sharded))}
        dom_ref = undecomposed(c0, (2, 2))
        c5_ref = undecomposed(geoms["c5"], (2, 2))
        hier_ref = fwi.fwi_obj_multi(c0, fwi._shot_records(cobs, c1),
                                     least_square, calc_grad=True)[:2]
        t_refs = time.perf_counter() - t0
    finally:
        # the ranks run (or, after a failure here, fail) and end
        ranks = world.join()
    t_ranks = time.perf_counter() - t_all
    laps = ranks[0]["laps"]
    print(f"   phase 46 and the references before the ranks' go: "
          f"{t_go:.1f} s; the ranks (spawned at the script's start) built "
          f"their geometries in {laps['setup']:.1f} s, waited "
          f"{laps['wait']:.1f} s, then reached the card in "
          f"{laps['cuda']:.1f} s")

    phase(f"47 parallel: {PAR_RANKS} gloo ranks on the card, fwi_obj_sharded "
          f"(SMARMN), elastic (SMARM2 {e0.nsrc} shots) and viscoacoustic "
          f"(SMARMN {v0.nsrc}) sharded gradients and trials")
    print(f"   the ranks: {[r['device'] for r in ranks]}, {ranks[0]['share']}"
          f" a card; phase 46 to joined {t_ranks:.1f} s; this process's "
          f"references beside them {t_refs:.1f} s (TTI {t_tti:.1f})")
    r0 = ranks[0]
    par_check("SMARMN L2 gradient", r0["smarmn"], (got[0], got[1]), PAR_RTOL)
    par_check("SMARMN L2 trial", (r0["smarmn_trial"], {}), (got_trial, {}),
              PAR_RTOL)
    par_check("SMARM2 elastic gradient", r0["elastic"], eref, PAR_RTOL)
    par_check("SMARM2 elastic trial", (r0["elastic_trial"], {}),
              (eref_trial, {}), PAR_RTOL)
    par_check("SMARMN viscoacoustic gradient", r0["visco"], vref, PAR_RTOL)
    par_check("SMARMN viscoacoustic trial", (r0["visco_trial"], {}),
              (vref_trial, {}), PAR_RTOL)
    rows = ("forward_rec_segments", "forward_dt2_segments",
            "gradient_stream_segments", "elastic_segments",
            "elastic_fwd_hist_segments", "elastic_grad_stream_segments",
            "visco_sls2_segments", "visco_fwd_hist_segments",
            "visco_grad_stream_segments")
    total = {n: sum(r["counts47"][0][n] for r in ranks) for n in rows}
    print(f"   launches summed over the ranks: {total}")
    for r in ranks:
        la, tw = r["counts47"]
        print(f"   rank {r['rank']}: SMARMN {r['laps']['47 SMARMN']:.2f} s, "
              f"elastic {r['laps']['47 elastic']:.2f} s, visco "
              f"{r['laps']['47 visco']:.2f} s; peak "
              f"{r['peak47'] / 1e9:.3f} GB of its budget share "
              f"{r['budget'] / 1e9:.3f} GB; twin calls {sum(tw.values())}")
        if min(la[n] for n in rows) < 1 or any(tw.values()) or \
                r["peak47"] > r["budget"]:
            raise AssertionError(f"rank {r['rank']} did not launch every "
                                 "row, called a twin, or passed its budget "
                                 "share")

    phase(f"48 parallel: TTI (marmousi-tti2d, {PAR_TTI_SHOTS} shots, nt "
          f"{geoms['tti'].nt}: CUT_STEPS), viscoacoustic_fm_sharded (SMARMN "
          f"{v1.nsrc} shots), the viscoelastic and self-adjoint objectives "
          "(the CPU tests' small cases)")
    par_check("TTI gradient, against one rank's (the eager pair shot by "
              "shot)", r0["tti"], tti_ref, PAR_RTOL)
    fm_err = float(np.abs(r0["visco_fm"] - vobs).max() /
                   np.abs(vobs).max())
    print(f"   viscoacoustic_fm_sharded against visco_fm_multi: "
          f"{fm_err:.2e} of the max (limit {RTOL:g})")
    for name, what in (("ve", "viscoelastic"), ("sa", "self-adjoint")):
        par_check(f"{what} gradient, against one rank's", r0[name],
                  small_ref[name], PAR_RTOL)
    la = [r["counts48"][0] for r in ranks]
    tti_rows = [n for n in la[0] if n.startswith("tti_")]
    print("   rank 0: " + ", ".join(f"{k[3:]} {v:.2f} s" for k, v in
                                     laps.items() if k.startswith("48")) +
          f"; visco_sls2_segments launches "
          f"{[x['visco_sls2_segments'] for x in la]}, TTI kernel launches "
          f"{sum(x[n] for x in la for n in tti_rows)}")
    if not (fm_err <= RTOL and all(x["visco_sls2_segments"] >= 1
                                   for x in la) and
            not any(any(r["counts48"][1].values()) for r in ranks)):
        raise AssertionError("phase 48: the sharded modeling disagrees, a "
                             "rank did not launch row 19, or a twin ran")

    phase(f"49 parallel: domain decomposition at SMARMN's padded grid "
          f"({c0.model.padded_shape[0]} x {c0.model.padded_shape[1]}, nt "
          f"{c0.nt}: CUT_STEPS) on (4, 1) and (2, 2), config 5 (nt "
          f"{geoms['c5'].nt}) on (2, 2), fwi_obj_sharded2d on (2, 2)")
    for key, want, lapk in (
            ("domain(4, 1)", dom_ref, "49 domain (4, 1)"),
            ("domain(2, 2)", dom_ref, "49 domain (2, 2)"),
            ("domain3d", c5_ref, "49 domain 3-D (2, 2)")):
        rec, grad = r0[key]
        errs = [float(np.abs(a - b).max()) for a, b in zip((rec, grad),
                                                          want)]
        print(f"   {lapk[3:]}: forward and gradient {laps[lapk]:.2f} s; "
              f"max|decomposed - undecomposed| = {errs[0]!r} (traces), "
              f"{errs[1]!r} (gradient); |grad|max "
              f"{np.abs(want[1]).max():.3e}")
        if any(errs) or not np.isfinite(grad).all():
            raise AssertionError(f"{key}: not the undecomposed operators")
    par_check(f"fwi_obj_sharded2d (2, 2), {c0.nsrc} shots, against "
              "fwi_obj_multi (the kernel route)", r0["hier"],
              (hier_ref[0], hier_ref[1].reshape(c0.model.shape)),
              ROUTE_RTOL)
    launched = sum(sum(r["counts49"][0].values()) for r in ranks)
    print(f"   shots x domain {laps['49 shots x domain (2, 2)']:.2f} s; "
          f"kernel launches {launched} (the domain paths are eager)")
    if launched:
        raise AssertionError("a domain path launched a kernel")

    phase(f"50 parallel: dryrun_multichip({PAR_RANKS}) on the cuda ranks")
    print("".join(f"   {line}\n" for line in
                  r0["dryrun_lines"].splitlines()), end="")
    print(f"   dry run {laps['50 dry run']:.1f} s; phases 46-50: "
          f"{time.perf_counter() - t_all:.1f} s")

# the tutorials' cuts for phase 51 (their widths stay): the families at a
# short recording time, accuracy whole (its errors must fall with the
# order over the full 800 ms), snapshots to 300 ms, RTM at one shot of
# 21 to 500 ms (the first interface's reflection is back by about 330
# ms), the ABC box to 600 ms (the wave reaches the 20-cell layers after
# about 470 ms)
TUTORIAL_ARGS = {
    "modeling_families": ["-tn", "150"],
    "accuracy": [],
    "snapshotting": ["--tn", "300"],
    "rtm": ["--nshots", "1", "--tn", "500"],
    "abc_methods": ["--tn", "600"],
    "nmo_correction": [],
}


def tutorial_phase(dev, counters, report):
    """Phase 51: the six tutorials' ``main`` on cuda at their cut sizes
    (``TUTORIAL_ARGS``), each one's own checks, its seconds; the elastic
    and viscoacoustic families through their modeling kernels (rows 18 and
    19), no twin called."""
    phase("51 the six tutorials on cuda: modeling_families, accuracy, "
          "snapshotting, rtm, abc_methods, nmo_correction")
    t_phase = time.perf_counter()
    for reset in counters:
        reset()
    with tempfile.TemporaryDirectory() as odir:
        for name, argv in TUTORIAL_ARGS.items():
            mod = importlib.import_module(
                f"devito_fwi_tpu_torch.examples.{name}")
            if name in ("snapshotting", "rtm"):
                argv = argv + ["--odir", odir]
            if name != "nmo_correction":
                argv = argv + ["--device", "cuda"]
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as out:
                mod.main(argv)
            sync(dev)
            lines = out.getvalue().strip().splitlines()
            print(f"   {name} {' '.join(argv)}: "
                  f"{time.perf_counter() - t0:.2f} s; {lines[-1]}")
    report("tutorials", ("elastic_segments", "visco_sls2_segments"),
           record=False)
    print(f"   phase 51: {time.perf_counter() - t_phase:.1f} s")


def audit_phase(dev, counters, report):
    """Phase 52: ``tools/audit_gradient.py``'s split of the 29-shot SMARMN
    L2 gradient: the pieces' gradient bitwise ``fwi_obj_multi``'s, each
    piece's time (CUDA events; the whole objective by the host clock after
    a synchronise; best of 3), its traffic floor against the card's
    bandwidth and the glue's (the host's) share."""
    from devito_fwi_tpu_torch import fwi
    from devito_fwi_tpu_torch.tools import audit_gradient as audit
    phase("52 the audit: the SMARMN L2 gradient split into its pieces, "
          "29 shots")
    t_phase = time.perf_counter()
    geometry, obs, dw, mask = audit.build(device="cuda")
    for reset in counters:
        reset()
    f, g, _ = fwi.fwi_obj_multi(geometry, obs, None, dw, mask, True,
                                calc_grad=True, device="cuda")
    fp, gp = audit.pieces(geometry, obs, dw, mask, device="cuda")
    if not (fp == f and np.array_equal(gp, g)):
        raise AssertionError("the audit's pieces do not give "
                             "fwi_obj_multi's gradient")
    ms = audit.timings(geometry, obs, dw, mask, repeat=3)
    report("audit", ("forward_rec_segments", "forward_dt2_segments",
                     "gradient_stream_segments", "forward_ckpt_segments",
                     "gradient_segments"), record=False)
    print("   the pieces' gradient is fwi_obj_multi's, bitwise")
    audit.report(ms, fwi._Setup(geometry, dev), geometry.nsrc,
                 out=lambda line: print("   " + line))
    del obs, dw, g, gp
    gc.collect()
    torch.cuda.empty_cache()
    print(f"   phase 52: {time.perf_counter() - t_phase:.1f} s")


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from devito_fwi_tpu_torch import elastic_fwi, fwi, visco_fwi
    from devito_fwi_tpu_torch.drivers import _marmousi_common as marm
    from devito_fwi_tpu_torch.misfit import least_square, qWasserstein
    # the module: the package exports the class ``bfm`` under the same name
    bfm = importlib.import_module("devito_fwi_tpu_torch.misfit.bfm")
    from devito_fwi_tpu_torch.ops import cuda_acoustic as ca
    from devito_fwi_tpu_torch.ops import cuda_acoustic3 as c3
    from devito_fwi_tpu_torch.ops import cuda_acoustic3d as c3d
    from devito_fwi_tpu_torch.ops import cuda_bfm as cb
    from devito_fwi_tpu_torch.ops import cuda_build
    from devito_fwi_tpu_torch.ops import cuda_legacy as cl
    from devito_fwi_tpu_torch.ops import cuda_staggered as cs
    from devito_fwi_tpu_torch.ops import cuda_tti as ct
    from devito_fwi_tpu_torch.ops import cuda_visco as cv

    phase("1 card")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"   nvidia-smi: {card}")
    print(f"   torch: {kind}, {torch.cuda.device_count()} device(s), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    # the ranks of phases 47-50 start now and wait, off the card
    world = ParallelRanks()

    phase("2 build")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        paths = list(pool.map(cuda_build.build, SOURCES))
    ca._lib()
    cb._lib()
    cb._legendre_lib()
    cs._lib()
    cv._lib()
    ct._lib()
    c3._lib()
    c3d._lib()
    cl._lib()
    print(f"   nvcc {' '.join(cuda_build.NVCC_FLAGS)}")
    print(f"   built {', '.join(p.name for p in paths)} in "
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
    print(f"   tolerance 0 (the acoustic kernels are in EXACT): they are "
          "compiled with -fmad=false and repeat the twins' float32 "
          "operations one for one")
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
    got = ca.forward_ckpt_segments(*ops, **kw)
    compare("forward_ckpt_segments", got, ca.forward_ckpt_plain(*ops, **kw))
    sops = (st.mT, st.hdT, st.wav_pad, injT, got[1], res, st.dt)
    compare("gradient_segments", [ca.gradient_segments(*sops, **kw)],
            [ca.gradient_segments_plain(*sops, **kw)])
    del dt2, res, gops, got, sops
    torch.cuda.empty_cache()

    B = g0.nsrc
    phase(f"4 kernel vs twin and kernel times, {B} shots (main-path "
          "shapes)")
    injT = st.injT(0, B)
    ops = (st.mT, st.hdT, st.wav_pad, injT, st.dt)
    ms, plain_ms, err, library_ms, bounds = {}, {}, {}, {}, {}

    def timed_pair(name, kernel, twin, args, reps=3):
        """Time kernel (``reps`` calls) and twin (1 call), compare the
        outputs of the timed calls; returns the kernel's outputs."""
        ms[name], got = cuda_ms(lambda: kernel(*args, **kw), reps)
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
    streamed = timed_pair("gradient_stream_segments",
                          ca.gradient_stream_segments,
                          ca.gradient_stream_plain,
                          (st.mT, st.hdT, dt2, res, st.dt))[0]
    del dt2
    torch.cuda.empty_cache()
    pairs = timed_pair("forward_ckpt_segments", ca.forward_ckpt_segments,
                       ca.forward_ckpt_plain, ops)[1]
    recomputed = timed_pair("gradient_segments", ca.gradient_segments,
                            ca.gradient_segments_plain,
                            (st.mT, st.hdT, st.wav_pad, injT, pairs, res,
                             st.dt))[0]
    same = torch.equal(recomputed, streamed)
    print(f"   checkpoint-route gradient == streamed gradient (same "
          f"residual rows, {B} shots): {same}")
    if not same:
        raise AssertionError("the recompute gradient differs from the "
                             "streamed one")
    del pairs, recomputed, streamed, res, ops, injT
    torch.cuda.empty_cache()
    bounds.update(acoustic_bounds(st, B))
    for name in ca.KERNELS:
        b_ms, by, nbytes, nops = bounds[name]
        print(f"   {name}: kernel {ms[name]:.3f} ms, twin "
              f"{plain_ms[name]:.3f} ms, bound {b_ms:.3f} ms by {by} "
              f"({nbytes:.4g} B, {nops:.4g} f32 ops), "
              f"{b_ms / ms[name]:.1%} of the bound")
    launch = ca.forward_launch(B, st.nz, st.nx, kw["space_order"] // 2)
    print(f"   fused forward tile: {launch.steps} steps a launch, tile "
          f"{launch.tile}, {launch.threads} threads, grid {launch.grid}, "
          f"{launch.smem} bytes of shared memory a block")
    launch = ca.adjoint_launch(B, st.nz, st.nx, kw["space_order"] // 2)
    print(f"   reverse tile: {launch.steps} steps a launch, tile "
          f"{launch.tile}, {launch.threads} threads, grid {launch.grid}, "
          f"{launch.smem} bytes of shared memory a block")
    total = st.nseg * st.seg
    print_floors(acoustic_step_floors(st, B), ms, dict(
        forward_rec_segments=total, forward_dt2_segments=total,
        forward_ckpt_segments=total, gradient_stream_segments=st.nsteps,
        gradient_segments=st.nsteps))

    phase(f"5 slab kernel at the main-path shapes, {B} shots")
    obs = fwi.fm_multi(geoms[0], device="cuda")
    dw = fwi.fm_multi(geoms[2], device="cuda")
    x0 = 1.0 / np.asarray(g0.model.vp_unpadded, np.float64).reshape(-1) ** 2
    mask = np.ones(g0.model.shape, np.float32)
    mask[:, :marm.SMARMN.bathy_rows] = 0
    qw2d = marm.misfits(marm.SMARMN)[2]
    captured = {}
    slab_push = bfm._slab_push

    def spy(subs, *a, **k):
        captured["subs"] = tuple(t.clone() for t in subs)
        return slab_push(subs, *a, **k)

    bfm._slab_push = spy
    try:
        bfm.reset_counts()
        fwi.fwi_loss(x0, g0, obs, qw2d, dw, mask, calc_grad=False,
                     device="cuda")
    finally:
        bfm._slab_push = slab_push
    print(f"   subsamples of the last of {bfm.COUNTS['push_slab']} slab "
          "pushforwards of a W2-2d trial at the initial model")
    subs = captured.pop("subs")
    n2, n1 = subs[-1].shape[2:]
    pkw = dict(G=24, dxmax=7, R=16)
    push_pairs = (("pushforward_slabs_nat", "nat", cb.pushforward_slabs_nat,
                   cb.pushforward_slabs_nat_plain),
                  ("pushforward_slabs", "blocked", cb.pushforward_slabs,
                   cb.pushforward_slabs_plain))
    # quick gate: the first shots' planes, kernel against twin, exactly
    for name, prep, kernel, twin in push_pairs:
        planes, _, _ = bfm._slab_planes(
            tuple(t[:NSHOTS_CHECK] for t in subs), margin=128, prep=prep,
            **pkw)
        compare(f"{name} ({NSHOTS_CHECK} shots)", [kernel(*planes, **pkw)],
                [twin(*planes, **pkw)])
        del planes
    for name, prep, kernel, twin in push_pairs:
        planes, bases, lanes = bfm._slab_planes(subs, margin=128, prep=prep,
                                                **pkw)
        ms[name], got = cuda_ms(lambda: kernel(*planes, **pkw), 10)
        plain_ms[name], want = cuda_ms(lambda: twin(*planes, **pkw), 1)
        err[name] = compare(name, [got], [want])
        bounds[name] = push_bound(planes, got)
        print(f"   {name}: planes {tuple(planes[0].shape)}, slabs "
              f"{tuple(got.shape)}; kernel {ms[name]:.3f} ms, twin "
              f"{plain_ms[name]:.3f} ms, bound {bounds[name][0]:.3f} ms "
              f"by {bounds[name][1]}")
        del want, got, planes
    # kernel + overlap-add from the planes, the whole slab pushforward
    # from the subsamples, and the library scatter of the same subsamples
    xI, xO, xf, yI, yO, yf, mass = subs
    idx = (torch.arange(B, device=dev).reshape(B, 1, 1, 1).expand(
        B, 4 * mass.shape[1], n2, n1),
        torch.cat([yI, yO, yI, yO], 1).long(),
        torch.cat([xI, xI, xO, xO], 1).long())
    vals = torch.cat([(1 - xf) * (1 - yf) * mass, (1 - xf) * yf * mass,
                      xf * (1 - yf) * mass, xf * yf * mass], 1)
    lib_ms, rho_lib = cuda_ms(lambda: mass.new_zeros((B, n2, n1)).index_put_(
        idx, vals, accumulate=True), 3)
    push_ms, rho = cuda_ms(lambda: bfm._slab_push(
        subs, n1, n2, margin=128, **pkw), 3)
    planes, bases, lanes = bfm._slab_planes(subs, margin=128, prep="nat",
                                            **pkw)
    fold_ms, _ = cuda_ms(lambda: bfm._overlap_add(
        cb.pushforward_slabs_nat(*planes, **pkw), bases, 16, 128,
        bases.shape[1] * 16 + 256 + 24, lanes), 3)
    library_ms["pushforward_slabs_nat"] = library_ms["pushforward_slabs"] \
        = lib_ms
    rel = float((rho - rho_lib).abs().max() / rho_lib.abs().max())
    print(f"   library index_put_(accumulate=True) of the "
          f"{vals.numel() / 1e6:.1f} M contributions: {lib_ms:.3f} ms; "
          f"kernel + overlap-add {fold_ms:.3f} ms; the whole slab "
          f"pushforward from the subsamples {push_ms:.3f} ms; "
          f"max|slab - scatter| / max = {rel:.2e}")
    if not rel < 1e-5:
        raise AssertionError("the slab pushforward disagrees with the "
                             "scatter")
    del subs, idx, vals, rho, rho_lib, planes, xI, xO, xf, yI, yO, yf, mass
    torch.cuda.empty_cache()

    counters = (ca.reset_counters, cb.reset_counters, cs.reset_counters,
                cv.reset_counters, ct.reset_counters, c3.reset_counters,
                c3d.reset_counters, cl.reset_counters, bfm.reset_counts,
                fwi.reset_counters, elastic_fwi.reset_counters,
                visco_fwi.reset_counters)
    modules = (ca, cb, cs, cv, ct, c3, c3d, cl)
    launches = {}

    def report(path, names, record=True):
        """Read the counts just after a path: every kernel of ``names``
        launched, no twin called; with ``record``, the path's launches of
        ``names`` go into the kernels line."""
        la = {k: v for mod in modules for k, v in mod.LAUNCHES.items()}
        twins = {k: v for mod in modules for k, v in mod.TWIN_CALLS.items()}
        print(f"   kernel launches: {la}")
        print(f"   twin calls: {twins}")
        if any(twins.values()) or min((la[n] for n in names),
                                      default=1) < 1:
            raise AssertionError(f"the {path} path did not run every "
                                 f"kernel of {names}, or ran a twin")
        if record:
            for n in names:
                launches[n] = la[n]

    phase(f"6 main path: SMARMN L2 FWI, {B} shots, --maxiter 2, on cuda")
    stats = run_driver(marm, marm.SMARMN, ["--misfit", "0"], counters)
    check_history(stats)
    first_line_check(stats, "l2_200", 0)
    report("L2", ("forward_rec_segments", "forward_dt2_segments",
                  "gradient_stream_segments"))

    phase(f"7 main path: SMARMN W2-1d and W2-2d FWI, {B} shots, --misfit "
          "1 and 2, --maxiter 2, on cuda")
    check_history(run_driver(marm, marm.SMARMN, ["--misfit", "1"], counters))
    report("W2-1d", ())
    if min(ca.LAUNCHES[n] for n in ca.KERNELS[:3]) < 1:
        raise AssertionError("the W2-1d path did not run the sweeps")
    stats = run_driver(marm, marm.SMARMN, ["--misfit", "2"], counters)
    check_history(stats)
    first_line_check(stats, "w2_50", 2, f_ref=W2_FIRST_F64)
    print(f"   BFM host reads and branches: {dict(bfm.COUNTS)}")
    print(f"   pushforwards by tier: slab {bfm.COUNTS['push_slab']}, "
          f"banded {bfm.COUNTS['push_banded']}, scatter "
          f"{bfm.COUNTS['push_scatter']}; Legendre certificate fallbacks "
          f"{bfm.COUNTS['legendre_fallbacks']} of "
          f"{bfm.COUNTS['legendre_reads']}")
    if min(ca.LAUNCHES[n] for n in ca.KERNELS[:3]) < 1:
        raise AssertionError("the W2-2d path did not run the sweeps")
    report("W2-2d", ("pushforward_slabs_nat", "legendre_anchored"))

    phase(f"8 main path: the checkpoint route, {B}-shot gradients")
    for reset in counters:
        reset()
    f_s, g_s, _ = fwi.fwi_loss(x0, g0, obs, least_square, dw, mask,
                               device="cuda", stream=True)
    f_c, g_c, _ = fwi.fwi_loss(x0, g0, obs, least_square, dw, mask,
                               device="cuda", stream=False)
    same = f_s == f_c and np.array_equal(g_s, g_c)
    print(f"   L2: objective {f_c!r} (streamed {f_s!r}); checkpoint-route "
          f"gradient == streamed gradient: {same}")
    if not same:
        raise AssertionError("the checkpoint-route L2 gradient differs "
                             "from the streamed one")
    qw2d_blocked = qWasserstein(gamma=1.01, method="2d", num_steps=15,
                                step_scale=1.0,
                                bfm_options=dict(prep="blocked"))
    t0 = time.perf_counter()
    f_w, g_w, _ = fwi.fwi_loss(x0, g0, obs, qw2d_blocked, dw, mask,
                               device="cuda", stream=False)
    print(f"   W2-2d (blocked slab layout): objective {f_w!r}, gradient "
          f"finite: {bool(np.isfinite(g_w).all())}, "
          f"{time.perf_counter() - t0:.3f} s")
    if not (np.isfinite(f_w) and np.isfinite(g_w).all()):
        raise AssertionError("checkpoint-route W2-2d gradient not finite")
    report("checkpoint", ("forward_ckpt_segments", "gradient_segments",
                          "pushforward_slabs"))

    phase(f"9 misfit memory per gather sample, {B} shots")
    syn = fwi.fm_multi(g0, device="cuda")
    stack = [torch.as_tensor(np.stack([s.data for s in d]), device=dev)
             for d in (syn, obs, dw)]
    nt, nrec = stack[0].shape[1:]
    over = []
    for key, misfit in (("least_square", fwi.least_square_torch),
                        ("1d", marm.misfits(marm.SMARMN)[1].torch_batch),
                        ("2d", qw2d.torch_batch)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        out = misfit(stack[0] - stack[2], stack[1] - stack[2])
        torch.cuda.synchronize()
        per = (torch.cuda.max_memory_allocated(dev) - base) / (B * nt * nrec)
        del out
        limit = fwi.MISFIT_BYTES_PER_SAMPLE[key]
        print(f"   {key}: {per:.1f} B per sample at its peak ({B} x {nt} x "
              f"{nrec}); sized with {limit} B")
        if per > limit:
            over.append(key)
    if over:
        raise AssertionError(f"misfits {over} hold more than "
                             "fwi.MISFIT_BYTES_PER_SAMPLE says")
    del syn, stack

    phase(f"10 profile: one steady-state gradient and one trial, {B} shots")
    walls = {}
    for reset in counters:
        reset()
    # W2-2d: the trial only; its gradient adds one sweep pair to the same
    # kernels (both profiles read within 4% of each other on the H100)
    for label, misfit, grads in (("L2", least_square, (True, False)),
                                 ("W2-2d", qw2d, (False,))):
        for calc_grad in grads:
            what = f"{label} {'gradient' if calc_grad else 'trial'}"
            walls[what] = report_profile(what, lambda: fwi.fwi_loss(
                x0, g0, obs, misfit, dw, mask, calc_grad=calc_grad,
                device="cuda"))
    report("profiled L2 and W2-2d", ("forward_rec_segments",
                                     "forward_dt2_segments",
                                     "gradient_stream_segments",
                                     "pushforward_slabs_nat"), record=False)

    # the W2-2d objective's parts, each timed apart (CUDA events) on the
    # live state of its last call in a trial, times its calls per objective
    live, originals = {}, {}
    for fn_name in ("_legendre_2d", "_sampling_pushforward_batch"):
        originals[fn_name] = getattr(bfm, fn_name)

        def spy(*a, _orig=originals[fn_name], _name=fn_name, **k):
            live[_name] = (a, k)
            return _orig(*a, **k)

        setattr(bfm, fn_name, spy)
    try:
        fwi.fwi_loss(x0, g0, obs, qw2d, dw, mask, calc_grad=False,
                     device="cuda")
    finally:
        for fn_name, orig in originals.items():
            setattr(bfm, fn_name, orig)
    steps = qw2d.num_steps
    nt, nrec = st.nt, st.r_idx.shape[0]
    C1, C2 = (bfm._dct_mat(n, torch.float32, dev) for n in (nrec, nt))
    C1T, C2T = C1.T.contiguous(), C2.T.contiguous()
    dens = torch.rand((B, nt, nrec), device=dev)
    mm = ca.matmul_full
    parts = {
        "Legendre, one 2-D transform": (bfm._legendre_2d, live[
            "_legendre_2d"], 4 * steps),
        "pushforward (subsamples, tier choice, slabs, fold)": (
            bfm._sampling_pushforward_batch,
            live["_sampling_pushforward_batch"], 2 * steps),
        "DCT-II + DCT-III products of one Poisson step": (
            lambda r: mm(mm(C2T, mm(mm(C2, r), C1T)), C1), ((dens,), {}),
            2 * steps),
    }
    total = 0.0
    for label, (fn, (a, k), count) in parts.items():
        t_ms, _ = cuda_ms(lambda: fn(*a, **k), 3)
        total += t_ms * count
        print(f"   W2-2d part: {label}: {t_ms:.3f} ms x {count} per "
              f"objective = {t_ms * count:.1f} ms "
              f"({t_ms * count / (walls['W2-2d trial'] * 1e3):.1%} of the "
              "trial's wall)")
    print(f"   W2-2d parts in all: {total:.1f} ms of the trial's "
          f"{walls['W2-2d trial'] * 1e3:.1f} ms wall")
    # the banded Legendre phases take this state again; on the host, so that
    # it pins no device block the later phases' histories need
    w2_state = live["_legendre_2d"][0][0].cpu()
    del obs, dw, live, dens

    elastic_phases(dev, rng, marm, elastic_fwi, cs, counters, report, ms,
                   plain_ms, err, bounds)
    visco_phases(dev, rng, marm, visco_fwi, cv, counters, report, ms,
                 plain_ms, err, bounds)
    tti_phases(dev, rng, ct, ca, counters, report, ms, plain_ms, err,
               bounds)
    w2_host_phases(dev, marm, fwi, bfm, cb, ca, qWasserstein, least_square,
                   w2_state, counters, report, modules, ms, plain_ms, err,
                   bounds)
    acoustic3d_phases(dev, rng, marm, fwi, c3, c3d, least_square, counters,
                      report, ms, plain_ms, err, bounds)
    legacy_solver_phases(dev, g0, fwi, cl, c3, counters, report, ms,
                         plain_ms, err, bounds)
    eager_route_phase(dev, fwi, counters, report)
    with tempfile.TemporaryDirectory() as workdir:
        fm_driver_phase(dev, marm, fwi, ca, counters, report, workdir)
        circle_phase(dev, fwi, counters, report, workdir)
    self_adjoint_phase(dev)
    abc_phase(dev)
    viscoelastic_phase(dev, marm)

    t_new = time.perf_counter()
    elastic_routes_phase(dev, marm, elastic_fwi, cs, counters)
    visco_routes_phase(dev, marm, visco_fwi, cv, counters)
    phase(f"45 main path: SMARM2 viscoacoustic FWI, "
          f"{marm.SMARM2.nsrc_default} shots, --physics viscoacoustic "
          "--misfit 0 --maxiter 2, on cuda")
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    visco_smarm2_check(run_visco_smarm2(marm, counters))
    report("SMARM2 viscoacoustic", cv.KERNELS, record=False)
    print(f"   phase 45: {time.perf_counter() - t_phase:.1f} s; phases "
          f"43-45: {time.perf_counter() - t_new:.1f} s")

    parallel_phases(dev, marm, fwi, elastic_fwi, visco_fwi, card, world)
    tutorial_phase(dev, counters, report)
    audit_phase(dev, counters, report)

    phase("53 result")
    rows = []
    sources = (("acoustic2d", ca), ("bfm_push", cb), ("elastic2d", cs),
               ("visco2d", cv), ("tti2d", ct), ("acoustic3d", c3d),
               ("acoustic3d", c3), ("acoustic2d_legacy", cl))
    for src, mod in sources:
        for n in mod.KERNELS:
            rows.append(dict(
                name=n, route="cuda",
                source="devito_fwi_tpu_torch/csrc/"
                       f"{'bfm_legendre' if 'legendre' in n else src}"
                       ".cu",
                replaces=REPLACES[n], launches=launches[n],
                max_abs_err=err[n], ms=ms[n], plain_ms=plain_ms[n],
                bound_ms=bounds[n][0], bound_by=bounds[n][1],
                library_ms=library_ms.get(n)))
    print(json.dumps({"kernels": rows}))
    print(f"   total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
