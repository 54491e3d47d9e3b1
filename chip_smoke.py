#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Runs from the root of a checkout; needs one CUDA card, ``nvcc`` and
``nvidia-smi``, and no network. Phases, each of which fails the run:

1. require CUDA; print the card's name and power limit (``nvidia-smi``);
2. build the six kernel sources at once, each by its own nvcc: the fused
   Woodbury kernels of ``csrc/woodbury.cu`` (slab and streaming), those
   of ``csrc/heat_woodbury.cu`` (slab and streaming), the two routes
   of the bf16x3 GEMM (phase 42) and the packed FFT's pack, split, merge
   and unpack (``csrc/time_pack.cu``, phase 46) and CGS2's passes
   (``csrc/cgs2.cu``, phase 47), beside the variant
   builds used for measurement only (``-DWOODBURY_PROFILE``,
   ``-DHEAT_WOODBURY_PROFILE``, the same with ``-DHEAT_WOODBURY_SKIP_B``,
   ``-DHEAT_WOODBURY_PLANES``, ``-DBF16X3_PROFILE``); print each kernel's ptxas registers and
   spills;
3. hold both kernels against their plain PyTorch twin on the card, at the
   main path's shapes (K = 513, n = 2047), float32 and float64, on the
   main-path input and on a seeded random one, with the schedule each
   dtype takes (columns per block, shared memory); and the schedule's own
   choice at a long K (N_t = 10000, T = 20, float64), the streaming kernel;
4. drive the main path once through the user entry point at the headline
   shape (N_x = 2048, N_t = 1024, float32, ``method='woodbury',
   use_pallas=True``), with the kernel's launch count set to 0 just before
   and read just after, and gate it on the float64 oracle residual
   (<= 8e-4); solve the reference's default problem in float64 on the card
   and on the CPU and require the same error;
5. time the solve, the slab kernel, the streaming kernel, the slab narrowed
   to two columns per block (two blocks per SM), the twin, the DST matmul and the packed FFT
   round trip with CUDA events (median of 20 runs after warm-up, each run
   started with a cold L2 cache; both kernels warm too); with the slab
   kernel's profile variant (``-DWOODBURY_PROFILE``) print the median
   clock64 cycles of each phase of a block (copies, passes, store);
6. print the heat schedule (``fused.schedule``) of both heat shapes in
   float32 and float64: the slab kernel at each;
7. hold the heat slab kernel and the heat streaming kernel against their
   plain twin at both heat shapes (1D, K = 513, n = 2047; 2D lumped, K = 33,
   n = 65025), on the main-path input and on a seeded random one, in
   float32 and float64;
8. drive the heat 1D headline solve (N_x = 2048, N_t = 1024, float32)
   through ``HeatControlProblem(...).solve(SolverConfig(method='woodbury',
   use_pallas=True))`` with the heat kernel's launch counts (all, and by
   kind) set to 0 just before and read just after: every launch must be the
   slab kernel's; gate its float64 residual (<= 2.24e-2) and that of the
   polished two-float (dword) solve (<= 1e-6);
9. the same for the heat 2D lumped solve (N_x = 256, N_t = 64): dword gate;
10. solve two small heat problems in float64 on the card and on the CPU and
    require the same ``error_vs_analytic``;
11. drive the wave headline solve with ``polish=1``: residual <= 8e-4 and
    no higher than without polish;
12. time the heat and polished paths at both heat shapes, and there the
    heat slab kernel, the streaming kernel and the slab built to load its
    constants from the (K, n) planes (cold and warm); print the heat slab's
    per-phase profile at both shapes, and that of a build whose load sweep
    leaves b out;
13. GMRES with the ParaDiag preconditioner, the reference's own algorithm:
    its default run (``reference_1d_default()``, float64, rtol 1e-8) on the
    card and on the CPU, the same iterations (<= 10) and ``error_aligned``
    (1e-10 apart), residual below 1e-8; then on the card the ``eig``
    variant with each inner solver (dst, Thomas, PCR, COCG), each within
    one iteration of ``fulldiag`` and its u within 1e-6;
14. GMRES at the wave headline width (N_x = 2048, N_t = 1024, float64,
    rtol 1e-8): at most 30 iterations, float64 oracle residual <= 1e-6;
    every Arnoldi step on CGS2's kernels (four launches a step, phase
    47); the clamped restart; the right-preconditioned run (printed);
15. heat GMRES (float64, rtol 1e-10) at both heat shapes: at most 5
    iterations, float64 residual <= 1e-8;
16. time the GMRES solves (device and host wall), one Arnoldi step, one
    ``fulldiag`` apply and one float64 matvec, and count the host
    synchronisations of a step and of a solve (torch's CUDA sync debug
    mode, and a count of ``.cpu()``/``.item()``/``synchronize`` calls);
17. the transforms: the 'fft' and 'mxu4' DST against the matmul DST on
    (2, 1024, 2047) and 2D (N_x = 256) states (float64 <= 1e-12, float32
    <= 2e-5); the wave headline candidates of the JAX bench (B1 with the
    packed FFT, plain 'fft', plain 'mxu', 'mxu4' with 'mxu') and B1 with the
    FFT DST, without and with polish=1, each timed; the matmul-DST ones and
    the polished one gated at 8e-4, the others (which miss it in the JAX
    package too) at 1.6e-3; the DST and time round trips alone; heat 2D
    lumped on B2 with the FFT DST; GMRES at the float64
    headline with each DST (the ``fulldiag`` apply timed); ``'auto'`` past
    the 64 MB matrix budget (N_x = 4096, float64) takes the FFT;
18. the CLI (``optimal_control_paradiag_torch.run.main``): the reference's
    default run on the card and the CPU (5 iterations each, the same
    ``error_aligned_metric``), the heat headline in float64, the wave
    direct solve at N_x = 4096, and the float64 GMRES headline under
    ``--profile``, whose ``torch.profiler`` trace is read back into the
    ``gmres_profile`` line (window, the device's busy share, the top device
    ops, the longest idle gaps and the host op over each);
19. the batch axis of both kernels at the headline (B = 8 right-hand
    sides: the problem's own times seeded factors, mirrored in space on odd
    lanes; float32): B1 and B2, slab and streaming, one launch
    for the batch, each lane bitwise equal to a launch on it alone and
    within the twin's tolerance of the batched twin;
20. the batched solves through the user entry points (wave:
    ``make_batched_solver_fn``; heat: its builder on the batch), with the
    launch count set to 0 just before and read just after (one launch):
    each lane's float64 residual (wave <= 8e-4, heat <= 2.24e-2) and its
    distance from its single solve (<= 1e-5); then a batch of B seeded
    noise right-hand sides (one launch; each lane <= 1e-5 from its single
    solve, its residual <= 5e-3 and <= 1.25 times that of the plain batch,
    ``use_pallas=False``, on the same lane); the batched, sequential and
    plain batched solves, the batched kernel (with its bound) and the
    batched transforms timed;
21. GMRES in spectral coordinates at the wave headline (float32, rtol 1e-5,
    restart 50, maxiter 150: converged, oracle <= 2e-3, where the JAX
    package's bench records 1.75e-3), timed;
22. MINRES on the symmetrized system: the reference run (float64, rtol
    1e-10) on card and CPU, the same iterations and x 1e-10 apart; the
    float64 wave headline (rtol 1e-8, maxiter 1000): converged, oracle
    <= 1e-6, timed;
23. the dense direct solve at the reference shape (float64, cuSOLVER LU)
    against GMRES at rtol 1e-10 (<= 1e-7), with ``operator_nnz`` and the
    dense build, LU and solve times;
24. batched GMRES at the reference shape (float64, B = 4): per-lane
    iterations equal to the sequential solves', and one lock-step Arnoldi
    step synchronising the host as often as one step of a single solve;
25. the 2D consistent mass at the JAX bench's shape (N_x = 192, N_t = 128,
    float32, 9,339,136 unknowns) through ``WaveControlProblem(...).solve(
    SolverConfig(method='woodbury'))``, the tensor GMRES: at most 3
    iterations, float64 oracle <= 5e-4 (the JAX bench: 1 and 8.52e-5),
    every Arnoldi step on CGS2's kernels, device and host wall time, peak
    memory;
26. the same for ``HeatControlProblem``: at most 3 iterations, oracle
    <= 2e-3 (the JAX bench: 1 and 5.16e-4);
27. GMRES with ``inner='auto'`` (blockline) on the 2D consistent mass at
    N_x = N_t = 64, float64, rtol 1e-8: at most 320 iterations, residual
    / ||b|| < 1e-6, with the host factor time, the factors' bytes, one
    preconditioner apply and the solve timed; the SMW solve over blockline
    (``method='woodbury', pc_variant='blockline'``) at N = 16: at most 22
    capacity iterations, residual < 1e-8;
28. card against CPU, float64: the auto route at N = 16 (iterations within
    1, u 1e-8 apart), tensor GMRES at N = 32 (the same iterations), 'block'
    against 'blockline' at N = 16 (1e-6) and 'blockdense' against
    'blockline' at N_x = 7, N_t = 8 (1e-9) on the card;
29. the JAX bench's unstructured problem (a perturbed N = 32 triangle mesh,
    n = 961, N_t = 32, float32, ``pc_variant='blockband'``, restart 80):
    converged, oracle <= 5e-4 (the JAX bench: 69 iterations, 2.07e-4), RCM
    bandwidth 31, timed; the blockdense auto route on a small mesh, card
    against CPU (float64): the same iterations;
30. the CLI: ``--dim 2`` at the reference defaults (N_x = 80, N_t = 81,
    float64, blockline) and ``--mesh-file`` on an .npz mesh written to a
    temporary directory: converged, iterations and seconds printed;
31. batched tensor GMRES (N_x = N_t = 32, float64, B = 3): per-lane
    iterations equal to the sequential solves', each lane within 1e-10,
    every Arnoldi step on CGS2's kernels;
32. the pencil eigenbases of the JAX bench's perturbed N = 32 mesh (n =
    961, float32): 'host', 'torch', 'device' (cuSOLVER) and 'sdc'
    (``base_size=256``, so it splits), each with its setup seconds,
    ||K V - M V lam|| / ||K|| (<= 5e-3), ||V^T M V - I|| (<= 5e-3) and its
    eigenvalues' distance from the host float64 ones (<= 1e-3 lam_max); and
    the accuracy of torch's float32 CUDA ``eigh`` of the standard form at
    n = 400 (cuSOLVER's Jacobi solver) and 961 against the port's route;
33. the JAX bench's production tier of that mesh (bench.py
    stage_unstructured): eig GMRES on the host basis (N_t = 32, rtol 1e-5,
    maxiter 20): <= 2 iterations, float64 oracle <= 5e-4, timed;
34. the wall through the entry point: N = 144 (n = 20449), N_t = 64,
    float32, ``WaveControlProblem(...).solve(SolverConfig(method=
    'woodbury'))``, whose 'auto' basis is 'device': the setup seconds by
    phase, Richardson steps, converged, the float64 oracle (<= 5e-4), the
    cached solve's device ms against its roofline and host wall, the peak
    device memory;
35. SDC on the card at N = 72 (n = 5041, default ``base_size=2048``):
    ``last_stats``, the gates of phase 32 against the 'device' basis, and
    the 8-step Richardson solve on the SDC basis (oracle <= 5e-4);
36. the CLI's ``--rebuild-eig-cache --nx 48 --eig-method device`` into a
    temporary directory, its file loaded back with its quality ('f32'),
    and the autodiff-Lagrangian 'direct' solve (1D, N_x = N_t = 8, float64)
    on the card and the CPU, u <= 1e-10 apart.

37-41. the sharded layer (``parallel/``) on a 1x1 grid of one NCCL rank
    (the machine has one card, and NCCL refuses two ranks on one card), so
    every stage move and reduction is issued as on a larger grid; halo
    exchanges are not (an axis that one rank holds whole posts none), so
    NCCL's ``batch_isend_irecv`` runs only under ``--cards N``. No scaling
    claim. At ``bench_multichip.py``'s on-chip shape
    (N_x = 2049, N_t = 1024, float32): the sharded wave Woodbury solve
    against the unsharded one with the same 'dft' time transform (<= 1e-5
    relative max-abs; float64 oracle <= 1.6e-3, the transform candidates'
    gate), the sharded heat Woodbury solve likewise (<= 1e-5; <= 2.24e-2),
    and ``shardmap_ops``' matvec (the layout's matvec) and its
    reduce-scatter fulldiag preconditioner against the unsharded ones (<= 1e-6, <= 2e-4); on the reference run (80 x 81,
    float64) sharded GMRES with ``fulldiag`` (rtol 1e-8: the unsharded
    iteration count, 5, and x 1e-10 apart) and sharded MINRES (rtol 1e-10:
    within one iteration, x 1e-8 apart, as ``tests/test_parallel.py``
    holds them). Each route's collective counts from the layout's counter
    (the direct solves: 6 all_to_all and 3 all_reduce, no all_gather) and
    its device ms beside the unsharded solve's.

42. (in phase 2) the bf16x3 GEMM B3 built with the other sources: both
    routes, ``csrc/bf16x3_gemm.cu`` ('mma', PR 12's mma.sync kernel) and
    ``csrc/bf16x3_wgmma.cu`` ('wgmma': the split pass and the TMA-fed,
    warp-specialised wgmma GEMM), each kernel's ptxas registers, spills and
    warnings printed, beside the GEMM's profile build
    (``-DBF16X3_PROFILE``); and the wgmma GEMM's SASS (``cuobjdump
    -sass``): it fails without HGMMA (wgmma) and UTMALDG (TMA) in it, and
    fails, saying why, where the SASS cannot be read;
43. B3 against its plain twin on the card in float32 (relative max-abs
    <= 1e-5) and against the float64 product (<= 2e-5): the headline DST
    (2048 x 2047 x 2047) on the main path's right-hand side and on a
    seeded random one, the batched DST (M = 16384), both on each route,
    both axes of the heat 2D lumped DST (255; the x axis on each route),
    one row, M = 129, odd shapes (1 x 1 x 1, 17 x 33 x 9; on 'wgmma' K =
    65 and N = 1), and an all-positive 512 x 2047 x 512 product on each
    route (the drift case); the split pass bitwise against ``split_bf16``;
    and the crossover table of the two routes (M = 2048, N = K in {32, 64,
    96, 128, 255, 512, 1023, 2047}, and the heat 2D axis shape, each timed
    in turns and held to the twin) beside the route the shape rule
    (``bf16x3_route``) picks;
44. ``dst_precision='high'`` through the entry points, the JAX bench's
    stage_woodbury_polished: ``WaveControlProblem(ProblemConfig(N_x=2048,
    N_t=1024, dtype=float32, dst_precision='high')).solve(SolverConfig(
    method='woodbury', use_pallas=True, polish=1))`` with the counts of B3,
    of its 'wgmma' route, of the split pass and of B1 set to 0 just before
    and read just after (4, 4, 4 and 2), float64 oracle <= 5e-4 and <= 1.25 x the 'highest'
    polished solve's (phase 11); the same without polish (2, 2, 2 and 1,
    printed, ungated); the heat 1D headline (4, 4, 4 and 2 B2, <= 2.24e-2)
    and heat 2D lumped (8 on the axis shape's route, and 2; <= 1.25 x its
    'highest' polished residual);
45. times: B3 at the headline, batched and on the heat 2D axis, the
    'wgmma' route and PR 12's 'mma' kernel in turns ('mma', 'wgmma',
    'wgmma', 'mma'), beside the bound (bf16 tensor-core operations); the
    split pass alone and its plain twin; the profile build's per-block
    split of the time (``b3_profile``); the twin,
    the same function as the split and three cuBLAS bf16 products
    (``torch.mm(..., out_dtype=torch.float32)``, null with the reason where
    torch lacks it), the FP32 cuBLAS DST, B3 on a 2D axis, the polished
    wave and heat solves with 'high' against 'highest'; the wrapper's host
    cost per call (each route and one FP32 ``torch.mm``); and the polished
    wave solves' host wall, 'high' and 'highest' interleaved, 30 each.

46. the packed time FFT's pack, split, merge and unpack kernels
    (``csrc/time_pack.cu``, built in phase 2): at the wave headline
    (N = 1024, n = 2047) and on a B = 8 batch, float32 and float64, each
    against its plain twin bitwise (``torch.equal`` and the bit patterns;
    pack's output in the layout cuFFT's plan reads, and cuFFT on it bitwise
    cuFFT on the twin's), timed L2 cold and warm beside its bound (bytes:
    the input read once, the output written once), beside the twin and,
    for pack, beside the torch calls it replaces; the whole time transform
    each way, kernels and the eager composition before them; and the
    float32 direct solves of the headline (wave single, heat B = 8) and of
    the 2D heat cell (B = 8) with the kernels, with the eager composition
    and with two real rffts (:func:`rfft_solver`), each timed (device, L2
    cold; host wall, in turns), bitwise against the eager composition, with
    the counters held to one launch of each kernel per solve, and with the
    kernel launches of a ``torch.profiler`` trace printed (not held: after
    the earlier phases' profiles the trace can drop events). The
    ``kernels`` line gains T1 (split), T2 (merge), T3 (pack) and T4
    (unpack): float32 headline L2 cold and warm, the twin's time, the
    bound.
47. CGS2's kernels (``csrc/cgs2.cu``, built in phase 2: three split-K
    passes and a scale a step) at both GMRES cells' shapes (the 2D
    consistent cell's B = 8, m = 9,339,136 and the float64 GMRES cell's
    B = 1, m = 4,192,256; float64) and at phase 25's (B = 1, m =
    9,339,136, float32), on a basis the twin orthonormalised, at k = 1, 5
    and 9: the Hessenberg column and the new row against the twin
    (``krylov/gmres.py`` ``cgs2_reference``, <= 1e-12 relative in
    float64, 1e-5 in float32), four counted launches a step, each step
    timed L2 cold and warm beside its bound (bytes: (3 (k + 1) + 7) m B
    itemsize), beside the twin's time (the profiler's count of the
    kernels is the card test's: late in this run torch.profiler misses
    kernels). The ``kernels`` line gains C1, with the
    launches a step counted in this run: phase 47's, and those of the
    GMRES solves of phases 14, 25 and 31, whose lines carry
    ``cgs2_launches`` and ``krylov_steps`` (both set to 0 before the solve;
    the phase fails unless launches = 4 x steps).

``python3 chip_smoke.py --time-pack`` runs phases 1, 2 and 46 alone;
``python3 chip_smoke.py --cgs2`` runs phase 1, the build of
``csrc/cgs2.cu`` and phase 47 alone;
``python3 chip_smoke.py --sharded`` runs phase 1 and phases 37-41 alone;
``python3 chip_smoke.py --bf16x3`` runs phases 1, 2, 42 and 43-45 (with
phase 11's 'highest' polished wave solve for their gate).
``python3 chip_smoke.py --cards N`` (a machine with N cards) runs the
sharded CLI (``run.py --mesh``) under ``torch.distributed.run``, one NCCL
rank per card, on every grid of N ranks and on 1x1, for each route at
the on-chip shape or the reference run, and gates each record's float64
oracle residual (and the reference run's iteration counts).
``python3 chip_smoke.py --sdc-wall`` instead times SDC once at the wall
(n = 20449): the 'device' and the 'sdc' basis, the gates of phase 32
between them, ``last_stats``, and the 8-step Richardson solve on the SDC
basis at N_t = 64 (oracle <= 5e-4); it builds no kernel.

It prints one JSON line per timing, then the kernels line, and last the
device line ``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import dataclasses
import itertools
import json
import os
import statistics
import subprocess
import sys
import time
import unittest.mock
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))

N_X, N_T = 2048, 1024  # the headline shape (bench.py of the JAX package)
MAX_REL_RESIDUAL = 8e-4  # the headline accuracy gate, float64 oracle
# Kernel vs twin at refine=1 (the main path), relative max-abs error. The
# kernel sums each column's 513 bins in 32 strided partial sums, torch
# pairwise, and the capacity correction G_j (Phi* D^-1 r) amplifies the
# reordering: in float32 the two differ by about as much as either differs
# from the float64 solve of the same input (phase 3 prints both).
TOL_F32 = 2e-4
TOL_F64 = 1e-12
ERROR_ALIGNED_TOL = 1e-10  # reference problem, card vs CPU, float64
# Heat family (bench.py stage_heat / stage_heat_2d of the JAX package).
HEAT_1D = dict(N_x=2048, N_t=1024)  # n = 2047, K = 513
HEAT_2D = dict(N_x=256, N_t=64, dim=2, mass="lumped")  # n = 65025, K = 33
HEAT_MAX_REL_RESIDUAL = 2 * 1.12e-2  # twice the float32 representation floor
DWORD_MAX_REL_RESIDUAL = 1e-6
# Heat kernel vs twin, float32, relative max-abs. Measured on the H100 at
# both shapes, refine 0-2, main-path and random input: at most 1.0e-7, and
# each float32 solve (kernel or twin) lies at most 1.3e-7 from the float64
# one on the same input (phase 7 prints both). The rank-2 capacity
# correction hardly amplifies the reordering; the gate leaves a margin of 8.
HEAT_TOL_F32 = 1e-6
DEVICE = "cuda"  # where the GMRES phases run their card side
# GMRES (float64): the SKILL run's gates, the mesh-independence bound of the
# JAX package's tests/test_endtoend.py:89, and tests/test_heat.py:23.
GMRES_REF_MAX_ITERS = 10
GMRES_REF_MAX_RESIDUAL = 1e-8
GMRES_INNER_U_TOL = 1e-6
GMRES_HEADLINE_MAX_ITERS = 30
GMRES_HEADLINE_MAX_REL_RESIDUAL = 1e-6
HEAT_GMRES_MAX_ITERS = 5
HEAT_GMRES_MAX_REL_RESIDUAL = 1e-8
RUNS, WARMUP = 20, 5
# ~20 ms at the H100's 1.98 GHz: longer than any enqueue timed here, the
# polished solves included
SPIN_CYCLES = 40_000_000
L2_FLUSH_BYTES = 128 * 2**20  # written before each timed run: over twice the H100's 50 MB L2
# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12  # dense tensor cores
# B3, the bf16x3 GEMM (phases 42-45). Kernel vs twin, relative max-abs: the
# same exact bf16 products, summed in another float32 order. Against the
# float64 DST: the twin reads 3.55e-6 at the headline on the CPU.
B3_TOL = 1e-5
B3_F64_TOL = 2e-5
WAVE_HIGH_MAX_REL_RESIDUAL = 5e-4  # bench.py stage_woodbury_polished of the JAX package
HIGH_RESIDUAL_FACTOR = 1.25  # a 'high' polished solve against the 'highest' one
# CGS2 (phase 47): the two GMRES cells' (lanes, m) in float64 and phase
# 25's float32 tensor GMRES shape, and the steps timed. Kernels against the
# twin: the same products summed in another order, ~1e-15 relative in
# float64 (tests/test_torch_cuda_cgs2.py), so 1e-12; float32 1e-5.
CGS2_CASES = {"wave2d_consistent": (8, 9_339_136, "float64"), "gmres_f64": (1, 4_192_256, "float64"),
              "consistent_2d_f32": (1, 9_339_136, "float32")}
CGS2_KS = (1, 5, 9)
CGS2_TOL = {"float64": 1e-12, "float32": 1e-5}
# CGS2's launches and Arnoldi steps in the GMRES solves of phases 14, 25
# and 31 (cgs2_route), for the kernels line.
CGS2_ROUTE = {}


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def device_ms(torch, fn, flush, runs=RUNS, warmup=WARMUP):
    """Device time of ``fn()`` in ms (median, min, max over ``runs``), one
    CUDA-event pair per run. A spin kernel queued before each run keeps the
    host ahead of the card, so the events time the card's work and not the
    host's launch rate. Writing ``flush`` before each run empties the L2
    cache: inside a solve, the DST and FFT traffic has evicted the kernel's
    constants by the time it runs, and the timed work would otherwise fit
    in L2 from the previous run. ``flush=None`` times the warm case."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        if flush is not None:
            flush.zero_()
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times), min(times), max(times)


def wall_ms(torch, fn, runs=RUNS, warmup=WARMUP):
    """Host wall time of ``fn()`` ending in a synchronize, in ms (median,
    min, max): what a caller waits for one solve."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), min(times), max(times)


def timed(torch, smi, flush, name, fn, runs=RUNS, warmup=WARMUP, **extra):
    """:func:`device_ms` of ``fn`` (L2 cold), printed as a ``timing`` line;
    returns the median."""
    med, lo, hi = device_ms(torch, fn, flush, runs, warmup)
    print(json.dumps({"timing": name, "clock": "device", "l2": "cold", "median_ms": med, "min_ms": lo,
                      "max_ms": hi, "runs": runs, "card": smi, **extra}), flush=True)
    return med


def count_syncs(torch, fn):
    """``fn()`` and the host synchronisations it made, counted two ways:
    the synchronizing CUDA operations torch's sync debug mode reports, and
    the calls of ``Tensor.cpu``/``Tensor.item`` on CUDA tensors and of
    ``torch.cuda.synchronize``."""
    calls = {"n": 0}

    def counted(orig, on_cuda=True):
        def wrapper(*args, **kwargs):
            if not on_cuda or (args and getattr(args[0], "is_cuda", False)):
                calls["n"] += 1
            return orig(*args, **kwargs)
        return wrapper

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec, \
            unittest.mock.patch.object(torch.Tensor, "cpu", counted(torch.Tensor.cpu)), \
            unittest.mock.patch.object(torch.Tensor, "item", counted(torch.Tensor.item)), \
            unittest.mock.patch.object(torch.cuda, "synchronize", counted(torch.cuda.synchronize, False)):
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    sites = collections.Counter(f"{os.path.basename(w.filename)}:{w.lineno}" for w in rec
                                if "synchroniz" in str(w.message))
    return out, {"sync_debug": sum(sites.values()), "explicit_calls": calls["n"], "sync_sites": dict(sites)}


def cgs2_route(label: str, fn):
    """``fn()`` with ``counters['cgs2.launches']`` and
    ``counters['krylov/step']`` set to 0 just before it: its result, the
    two counts (also kept in ``CGS2_ROUTE[label]``), and what failed where
    the Arnoldi steps did not all take CGS2's kernels (four launches a
    step), else None."""
    from optimal_control_paradiag_torch.ops.cgs2 import LAUNCHES_PER_STEP
    from optimal_control_paradiag_torch.utils.timing import counters

    counters["cgs2.launches"] = counters["krylov/step"] = 0
    out = fn()
    counts = {"cgs2_launches": counters["cgs2.launches"], "krylov_steps": counters["krylov/step"]}
    CGS2_ROUTE[label] = counts
    if counts["krylov_steps"] >= 1 and counts["cgs2_launches"] == LAUNCHES_PER_STEP * counts["krylov_steps"]:
        return out, counts, None
    return out, counts, (f"{label}: {counts['cgs2_launches']} CGS2 launches in {counts['krylov_steps']} "
                         f"Arnoldi steps, not {LAUNCHES_PER_STEP} a step")


def roofline(nbytes: int, flops: int, flops_per_s: float = FP32_FLOPS_PER_S) -> dict:
    """The least time the card could take: bytes over the HBM rate or the
    operations over their peak (by default float32 outside the tensor
    cores), whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def rel_err(torch, a, b) -> float:
    return (a - b).abs().max().item() / b.abs().max().item()


def print_ptxas(log: str) -> None:
    """ptxas's registers and spills of each kernel in a build log, with the
    kernel's name (template arguments: real type f/d, then lanes)."""
    import re

    name = "?"
    for line in log.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?(\w+)", line)
        if m:
            d = re.search(r"\d+([a-z0-9_]+_kernel)(?:I([fd])(?:Li(\d+)E)?)?", m.group(1))
            if d is None:
                name = m.group(1)
            elif d.group(2) is None:
                name = d.group(1)
            else:
                name = f"{d.group(1)}<{d.group(2)}{',' + d.group(3) if d.group(3) else ''}>"
        elif "registers" in line or "spill" in line or "warning" in line or "Performance Loss" in line:
            print(f"ptxas: {name}: {line.strip()}", flush=True)


_VARIANT_BUILDS = []  # nvcc processes started by start_variant, stopped at exit


def start_variant(source: str, *defines: str):
    """Start an nvcc build of ``csrc/<source>`` with ``-D`` of each of
    ``defines`` (a measurement-only variant); returns (process, library
    path)."""
    from optimal_control_paradiag_torch.cuda_build import NVCC_FLAGS, _nvcc
    from optimal_control_paradiag_torch.utils.compilation_cache import build_dir

    csrc = os.path.join(HERE, "optimal_control_paradiag_torch", "csrc")
    tag = "-".join(d.lower() for d in defines)
    out = os.path.join(build_dir(), f"{os.path.splitext(source)[0]}-{tag}.so")
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", out, os.path.join(csrc, source)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _VARIANT_BUILDS.append(proc)
    return proc, out


def finish_variant(build):
    """Wait for a variant build and load it."""
    proc, out = build
    log, _ = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {out}:\n{log}")
    return ctypes.CDLL(out)


def block_profile(torch, launch, read, blocks: int) -> dict:
    """Median clock64 cycles of each phase of a slab block, from a profile
    build: ``launch()`` runs its slab kernel, ``read(ptr)`` copies its
    (8192, 8) marks to host memory."""
    import numpy as np

    for _ in range(3):
        launch()
        torch.cuda.synchronize()
    marks = np.zeros((8192, 8), dtype=np.int64)
    if read(marks.ctypes.data) != 0:
        raise RuntimeError("reading the slab profile failed")
    marks = marks[: min(blocks, 8192)]
    steps = np.diff(marks, axis=1)
    names = ("copy_start", "copy_wait", "pass1", "pass2", "pass3", "pass4", "store")
    total = float(np.median(marks[:, 7] - marks[:, 0]))
    return {"blocks": int(marks.shape[0]), "block_cycles_median": total,
            **{f"{k}_cycles": float(np.median(steps[:, j])) for j, k in enumerate(names)}}


def streaming(kernel):
    """The family's streaming kernel at any shape, through the shared
    launch: the yardstick the slab kernel is held against. No solver
    reaches it."""
    from optimal_control_paradiag_torch.paradiag import fused

    return lambda b_hat, c, refine: fused.launch(
        kernel, b_hat, c, refine, fused.streaming_schedule(kernel, c.a11r.element_size()))


def rfft_solver(space, N_t: int, dtype, fused_fn, consts):
    """A direct solve with the fused kernel ``fused_fn`` between two real
    rffts (``time_transform='fft'``) instead of the packed FFT: the
    candidate the packed FFT is measured against."""
    from optimal_control_paradiag_torch.paradiag.spectral import make_halfspectrum_transforms

    to_spectral, from_spectral = make_halfspectrum_transforms(space, N_t, dtype, time_transform="fft")
    return lambda b: from_spectral(fused_fn(to_spectral(b), consts, 1))


def slab_profile(torch, cw, lib, b_hat, consts, sched) -> dict:
    """The wave slab kernel's block profile (``-DWOODBURY_PROFILE`` build of
    ``csrc/woodbury.cu``) on the main path's input."""
    from optimal_control_paradiag_torch.paradiag import fused

    lib = fused.declare_library(cw.KERNEL, lib)
    lib.woodbury_profile_read.argtypes = [ctypes.c_void_p]
    launch = lambda: fused.launch(cw.KERNEL, b_hat, consts, 1, sched, lib)
    return block_profile(torch, launch, lib.woodbury_profile_read, -(-consts.a11r.shape[1] // sched.cols))


def gmres_phases(torch, smi, flush):
    """Phases 13-16: GMRES with the ParaDiag preconditioner, both families.
    Prints one JSON line per result and timing; returns None, or what failed."""
    import numpy as np

    from optimal_control_paradiag_torch import (
        HeatControlProblem,
        ProblemConfig,
        SolverConfig,
        WaveControlProblem,
        reference_1d_default,
    )
    from optimal_control_paradiag_torch.krylov.gmres import arnoldi_step, clamp_restart, givens_update
    from optimal_control_paradiag_torch.paradiag.pc import build_preconditioner
    from optimal_control_paradiag_torch.utils.timing import counters

    # 13. the reference's default run, card and CPU; the eig inner solvers
    ref = {}
    for dev in (DEVICE, "cpu"):
        rp = WaveControlProblem(reference_1d_default(), device=dev)
        rs = rp.solve(SolverConfig(rtol=1e-8))
        ref[dev] = (rp, rs, int(rs.result.iterations), bool(rs.result.converged), rp.error_aligned(rs),
                    float(rp.residual_norm(rs)))
    (rp, rs, it_g, conv_g, e_g, res_g), (_, _, it_c, conv_c, e_c, res_c) = ref[DEVICE], ref["cpu"]
    print(json.dumps({"phase": "gmres_reference_default", "dtype": "float64", "rtol": 1e-8,
                      "iterations_cuda": it_g, "iterations_cpu": it_c, "converged_cuda": conv_g,
                      "converged_cpu": conv_c, "error_aligned_cuda": e_g, "error_aligned_cpu": e_c,
                      "residual_norm_cuda": res_g, "residual_norm_cpu": res_c,
                      "gates": {"iterations": GMRES_REF_MAX_ITERS, "error_aligned": ERROR_ALIGNED_TOL,
                                "residual_norm": GMRES_REF_MAX_RESIDUAL}}), flush=True)
    if not (conv_g and conv_c and it_g == it_c <= GMRES_REF_MAX_ITERS):
        return f"reference GMRES: converged {conv_g}/{conv_c}, iterations {it_g} (card) vs {it_c} (CPU)"
    if not abs(e_g - e_c) <= ERROR_ALIGNED_TOL:
        return f"reference GMRES error_aligned differs between card and CPU: {e_g!r} vs {e_c!r}"
    if not (res_g < GMRES_REF_MAX_RESIDUAL and res_c < GMRES_REF_MAX_RESIDUAL):
        return f"reference GMRES residual_norm {res_g:.3e} (card), {res_c:.3e} (CPU)"
    for inner in ("dst", "tridiag_thomas", "tridiag_pcr", "cocg"):
        es = rp.solve(SolverConfig(rtol=1e-8, inner=inner))
        it_e, du = int(es.result.iterations), (es.u - rs.u).abs().max().item()
        print(json.dumps({"phase": "gmres_eig_inner", "inner": inner, "iterations": it_e,
                          "iterations_fulldiag": it_g, "converged": bool(es.result.converged),
                          "max_abs_u_diff": du, "tol": GMRES_INNER_U_TOL}), flush=True)
        if not (bool(es.result.converged) and abs(it_e - it_g) <= 1 and du <= GMRES_INNER_U_TOL):
            return f"eig GMRES with inner={inner}: {it_e} iterations vs {it_g}, u differs by {du:.3e}"
    del ref, rp, rs, es

    # 14. GMRES at the wave headline width, float64
    gprob = WaveControlProblem(ProblemConfig(N_x=N_X, N_t=N_T, dtype=torch.float64), device=DEVICE)
    gop = gprob.operator
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        restart = clamp_restart(SolverConfig().restart, gop.shape, torch.float64, SolverConfig().maxiter)
    warnings.filterwarnings("ignore", message="GMRES restart")  # printed once here
    gcfg = SolverConfig(method="gmres", rtol=1e-8)
    half0 = counters["pc.fulldiag.half_spectrum"]
    t0 = time.perf_counter()
    gsol, route, route_err = cgs2_route("gmres_headline", lambda: gprob.solve(gcfg))
    torch.cuda.synchronize()
    first_solve_s = time.perf_counter() - t0
    half_applies = counters["pc.fulldiag.half_spectrum"] - half0
    g_its, g_conv = int(gsol.result.iterations), bool(gsol.result.converged)
    g_rel = gprob.relative_residual_f64(gsol)
    finite = bool(torch.isfinite(gsol.u).all() and torch.isfinite(gsol.p).all())
    rsol = gprob.solve(SolverConfig(method="gmres", rtol=1e-8, pc_side="right"))
    print(json.dumps({"phase": "gmres_headline", "N_x": N_X, "N_t": N_T, "dtype": "float64", "rtol": 1e-8,
                      "restart": restart, "restart_requested": SolverConfig().restart,
                      "clamp_warning": str(rec[0].message) if rec else None,
                      "iterations": g_its, "converged": g_conv, "first_solve_s": first_solve_s,
                      "relative_residual_f64": g_rel, "final_residual_norm": float(gsol.result.residual_norm),
                      "pc_half_spectrum_applies": half_applies, **route,
                      "gates": {"iterations": GMRES_HEADLINE_MAX_ITERS,
                                "relative_residual_f64": GMRES_HEADLINE_MAX_REL_RESIDUAL},
                      "right_iterations": int(rsol.result.iterations),
                      "right_converged": bool(rsol.result.converged),
                      "right_relative_residual_f64": gprob.relative_residual_f64(rsol)}), flush=True)
    if gsol.u.shape != (N_T, gprob.space.n) or gsol.u.device.type != DEVICE or not finite:
        return f"headline GMRES u has {tuple(gsol.u.shape)} on {gsol.u.device}, finite {finite}"
    if not (g_conv and g_its <= GMRES_HEADLINE_MAX_ITERS):
        return f"headline GMRES: converged {g_conv} in {g_its} iterations (gate {GMRES_HEADLINE_MAX_ITERS})"
    if not g_rel <= GMRES_HEADLINE_MAX_REL_RESIDUAL:
        return f"headline GMRES residual {g_rel:.3e} > {GMRES_HEADLINE_MAX_REL_RESIDUAL}"
    if half_applies != g_its + 1:  # left preconditioning: each step and the starting residual
        return f"headline GMRES ran {half_applies} half-spectrum PC applies in {g_its} iterations"
    if route_err:
        return route_err
    del rsol

    # 15. heat GMRES at both heat shapes, float64
    heat_gm = {}
    for label, shape in (("1d", HEAT_1D), ("2d", HEAT_2D)):
        hp = HeatControlProblem(ProblemConfig(**shape), device=DEVICE)
        hs = hp.solve(SolverConfig(method="gmres", rtol=1e-10))
        h_its, h_conv, h_rel = int(hs.result.iterations), bool(hs.result.converged), hp.relative_residual_f64(hs)
        print(json.dumps({"phase": f"heat_gmres_{label}", **shape, "dtype": "float64", "rtol": 1e-10,
                          "iterations": h_its, "converged": h_conv, "relative_residual_f64": h_rel,
                          "gates": {"iterations": HEAT_GMRES_MAX_ITERS,
                                    "relative_residual_f64": HEAT_GMRES_MAX_REL_RESIDUAL}}), flush=True)
        if not (h_conv and h_its <= HEAT_GMRES_MAX_ITERS and h_rel <= HEAT_GMRES_MAX_REL_RESIDUAL):
            return f"heat {label} GMRES: converged {h_conv} in {h_its} iterations, residual {h_rel:.3e}"
        heat_gm[label] = (hp, h_its)

    # 16. GMRES timings and host synchronisations
    gm_solve = gprob.make_solver_fn(gcfg)
    grhs = gprob.rhs
    pc = build_preconditioner(gop)
    k = g_its - 1  # the solve's last (widest) Arnoldi step
    V = torch.empty((1, k + 2, grhs.numel()), dtype=torch.float64, device=DEVICE)  # one lane
    V[0, : k + 1].normal_()  # the step's work does not depend on the rows' values
    V[0, : k + 1] /= V[0, : k + 1].norm(dim=1, keepdim=True)
    left_op = lambda v: pc(gop.matvec(v[0]))[None]  # as gmres hands its one lane on
    R, cs = np.zeros((k + 1, k + 1)), np.ones(k + 1)
    sn, g = np.zeros(k + 1), np.ones(k + 2)
    hcol = arnoldi_step(left_op, V, k, gop.shape).cpu().numpy()[0]

    def full_step():  # what the solve does per step: device part, the copy, the host part
        givens_update(arnoldi_step(left_op, V, k, gop.shape).cpu().numpy()[0], k, R, cs, sn, g)

    host = []
    for _ in range(200):
        h = hcol.copy()
        t0 = time.perf_counter()
        givens_update(h, k, R, cs, sn, g)
        host.append((time.perf_counter() - t0) * 1e3)
    timings = {
        "gmres_wave_headline_solve": lambda: gm_solve(grhs),
        "gmres_arnoldi_step": lambda: arnoldi_step(left_op, V, k, gop.shape),
        "gmres_fulldiag_pc_apply": lambda: pc(grhs),
        "gmres_wave_matvec_f64": lambda: gop.matvec(grhs),
        "gmres_heat_1d_solve": lambda p=heat_gm["1d"][0]: p.solve(SolverConfig(method="gmres", rtol=1e-10)),
        "gmres_heat_2d_solve": lambda p=heat_gm["2d"][0]: p.solve(SolverConfig(method="gmres", rtol=1e-10)),
    }
    for name, fn in timings.items():
        med, lo, hi = device_ms(torch, fn, flush)
        print(json.dumps({"timing": name, "clock": "device", "l2": "cold", "median_ms": med, "min_ms": lo,
                          "max_ms": hi, "runs": RUNS, "card": smi}), flush=True)
    for name, fn in (("gmres_wave_headline_solve", timings["gmres_wave_headline_solve"]),
                     ("gmres_arnoldi_step_with_host_part", full_step),
                     ("gmres_heat_1d_solve", timings["gmres_heat_1d_solve"]),
                     ("gmres_heat_2d_solve", timings["gmres_heat_2d_solve"])):
        med, lo, hi = wall_ms(torch, fn)
        print(json.dumps({"timing": name, "clock": "host_wall", "median_ms": med, "min_ms": lo,
                          "max_ms": hi, "runs": RUNS, "card": smi}), flush=True)
    print(json.dumps({"timing": "gmres_givens_update_host", "clock": "host", "k": k,
                      "median_ms": statistics.median(host), "min_ms": min(host), "max_ms": max(host),
                      "runs": len(host), "card": smi}), flush=True)
    _, step_syncs = count_syncs(torch, full_step)
    syncs = {"arnoldi_step": step_syncs}
    for name in ("gmres_wave_headline_solve", "gmres_heat_1d_solve", "gmres_heat_2d_solve"):
        _, syncs[name] = count_syncs(torch, timings[name])
    print(json.dumps({"phase": "gmres_host_syncs", "k": k, "iterations": {"wave": g_its, "heat_1d": heat_gm["1d"][1],
                      "heat_2d": heat_gm["2d"][1]}, "restart": restart, **syncs}), flush=True)
    return None


# past the 64 MB matrix budget of dst_method='auto' in float64 (n1d > 2896)
PAST_BUDGET = dict(N_x=4096, N_t=256)
# The float32 'fft' and 'mxu4' sine transforms put the headline's residual
# above the bench gate at refine = 1, in the JAX package as in the port
# (tests/test_torch_transforms.py holds the two to each other): the inverse
# transform's rounding, which spectral refinement cannot see and polish=1
# removes. Those candidates are held to twice the gate, and B1 with the FFT
# DST and polish=1 to the gate itself.
TRANSFORM_DST_MAX_REL_RESIDUAL = 2 * MAX_REL_RESIDUAL
DST_TOL = {"float64": 1e-12, "float32": 2e-5}  # fft/mxu4 vs matmul DST (tests/test_transforms.py:72)
HEAT_CLI_MAX_REL_RESIDUAL = 1e-10  # tests/test_tools.py:159, float64
WOODBURY_F64_MAX_RESIDUAL = 1e-8  # residual_norm_true / ||b|| of a float64 direct solve


def dst_matrix_extended(N_x: int):
    """The DST-I matrix ``sin(pi i j / N_x)`` in numpy longdouble, its angles
    reduced exactly (``i j mod 2 N_x`` in integers) before the multiply by pi."""
    import numpy as np

    i = np.arange(1, N_x)
    pi = np.arccos(np.longdouble(-1))
    return np.sin(pi * (np.outer(i, i) % (2 * N_x)).astype(np.longdouble) / N_x)


def transform_phases(torch, smi, flush, headline):
    """Phase 17: the DST methods ('matmul', 'fft', 'mxu4') and the time
    transforms ('fft2', 'fft', 'mxu') on the card: accuracy, the wave
    headline candidates of the JAX bench (``bench.py:949-963``) plus B1 with
    the FFT DST, the heat 2D solve on B2 with the FFT DST, GMRES in float64
    with each DST, and 'auto' past the 64 MB budget. ``headline`` holds the
    main path's solve ms and residual (phases 4-5). Prints one JSON line per
    result; returns None, or what failed."""
    import numpy as np

    from optimal_control_paradiag_torch import HeatControlProblem, ProblemConfig, SolverConfig, WaveControlProblem
    from optimal_control_paradiag_torch.fem.space import make_space
    from optimal_control_paradiag_torch.models.wave import WaveSolution
    from optimal_control_paradiag_torch.ops.transforms import (
        FourStepPlan,
        time_irfft_conj_mm4,
        time_irfft_conj_packed,
        time_rfft_conj_mm4,
        time_rfft_conj_packed,
    )
    from optimal_control_paradiag_torch.paradiag import cuda_heat as ch
    from optimal_control_paradiag_torch.paradiag import cuda_woodbury as cw
    from optimal_control_paradiag_torch.paradiag.pc import build_preconditioner
    from optimal_control_paradiag_torch.paradiag.spectral import build_woodbury_solver
    from optimal_control_paradiag_torch.utils.timing import counters

    def timed_(name, fn, **extra):
        return timed(torch, smi, flush, name, fn, **extra)

    # 17a. accuracy of the fft and mxu4 DST against the matmul DST
    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    for dtype, name in ((torch.float64, "float64"), (torch.float32, "float32")):
        for dim, N_x, N_t in ((1, N_X, N_T), (2, 256, 64)):
            spaces = {m: make_space(dim, N_x, mass="lumped" if dim == 2 else "consistent", dtype=dtype,
                                    device=DEVICE, dst_method=m) for m in ("matmul", "fft", "mxu4")}
            n = spaces["matmul"].n
            x = torch.from_numpy(rng.standard_normal((2, N_t, n))).to(dtype).to(DEVICE)
            cases = [("real", x)]
            if dim == 1:
                cases.append(("complex", torch.complex(x, torch.roll(x, 1, dims=1))))
            for kind, v in cases:
                ref = spaces["matmul"].dst(v)
                for m in ("fft", "mxu4"):
                    err = rel_err(torch, spaces[m].dst(v), ref)
                    print(json.dumps({"phase": "dst_accuracy", "method": m, "dtype": name, "dim": dim, "N_x": N_x,
                                      "shape": list(v.shape), "input": kind, "rel_max_abs_err_vs_matmul": err,
                                      "tol": DST_TOL[name]}), flush=True)
                    if not err <= DST_TOL[name]:
                        return f"dst_method={m!r} {name} {dim}D {kind}: {err:.3e} from the matmul DST"
            if dim == 1 and name == "float64":
                # each method against the DST in extended precision (numpy
                # longdouble) on 16 rows, and the float64 sine matrix's own
                # error: its angles pi*i*j/N_x, formed in float64, reach 6400
                V = dst_matrix_extended(N_x)
                rows = x[0, :16]
                exact = rows.cpu().numpy().astype(np.longdouble) @ V
                scale = float(np.abs(exact).max())
                ext = {m: float(np.abs(sp.dst(rows).cpu().numpy() - exact).max()) / scale
                       for m, sp in spaces.items()}
                v_err = float(np.abs(spaces["matmul"].dst_matrix.cpu().numpy() - V).max())
                print(json.dumps({"phase": "dst_accuracy_vs_extended", "dtype": name, "N_x": N_x, "rows": 16,
                                  "rel_max_abs_err": ext, "dst_matrix_max_abs_err": v_err,
                                  "longdouble_eps": float(np.finfo(np.longdouble).eps)}), flush=True)
            del spaces, x, cases, ref

    # 17b. the wave headline candidates (float32, refine = 1)
    rhs = None
    cands = {}
    for dst_method in ("matmul", "fft", "mxu4"):
        wp = WaveControlProblem(ProblemConfig(N_x=N_X, N_t=N_T, dtype=torch.float32, dst_method=dst_method),
                                device=DEVICE)
        rhs = wp.rhs
        timed_(f"dst_{dst_method}_f32", lambda sp=wp.space: sp.dst(rhs), dst_method=dst_method,
              shape=list(rhs.shape))
        if dst_method == "matmul":
            s = wp.space.dst(rhs)
            plan4 = FourStepPlan(N_T, torch.float32, device=DEVICE)
            timed_("time_roundtrip_fft2", lambda: time_irfft_conj_packed(time_rfft_conj_packed(s, N_T), N_T))
            timed_("time_roundtrip_fft", lambda: torch.fft.irfft(torch.fft.rfft(s, dim=1), n=N_T, dim=1))
            timed_("time_roundtrip_mxu", lambda: time_irfft_conj_mm4(time_rfft_conj_mm4(s, plan4), plan4))
            for tt in ("fft", "mxu"):
                cands[f"plain_{tt}"] = (wp, build_woodbury_solver(wp.operator, time_transform=tt))
            # B1 between two real rffts instead of the packed FFT
            cands["cuda_kernel_rfft_dst_matmul"] = (wp, rfft_solver(wp.space, N_T, torch.float32, cw.fused_woodbury,
                                                                    cw.pack_constants(wp.operator)))
        elif dst_method == "fft":
            cands["cuda_kernel_dst_fft"] = (wp, wp.make_solver_fn(SolverConfig(method="woodbury", use_pallas=True)))
            cands["cuda_kernel_dst_fft_polish1"] = (
                wp, wp.make_solver_fn(SolverConfig(method="woodbury", use_pallas=True, polish=1)))
        else:
            cands["plain_mxu4_mxu"] = (wp, build_woodbury_solver(wp.operator, time_transform="mxu"))
    print(json.dumps({"phase": "wave_headline_candidate", "name": "cuda_kernel_packed_fft_dst_matmul",
                      "ms": headline["ms"], "relative_residual_f64": headline["rel"], "gate": MAX_REL_RESIDUAL,
                      "source": "phases 4-5"}), flush=True)
    for name, (wp, fn) in cands.items():
        direct = fn if name.startswith(("plain", "cuda_kernel_rfft")) else (lambda b, f=fn: f(b)[0])
        before = counters["b1.launches"]
        x = direct(wp.rhs)
        torch.cuda.synchronize()
        launches = counters["b1.launches"] - before
        u, p = wp._unscale(x)
        rel = wp.relative_residual_f64(WaveSolution(u=u, p=p, result=None))
        med = timed_(f"wave_solve_{name}", lambda f=direct, b=wp.rhs: f(b))
        polished = name.endswith("polish1")
        gate = TRANSFORM_DST_MAX_REL_RESIDUAL if wp.space.dst_method != "matmul" and not polished else MAX_REL_RESIDUAL
        print(json.dumps({"phase": "wave_headline_candidate", "name": name, "dst_method": wp.space.dst_method,
                          "ms": med, "relative_residual_f64": rel, "gate": gate,
                          "meets_bench_gate": rel <= MAX_REL_RESIDUAL, "b1_launches": launches}), flush=True)
        if not rel <= gate:
            return f"wave headline candidate {name}: residual {rel:.3e} > {gate}"
        if name.startswith("cuda") and launches < 1:
            return f"wave headline candidate {name} did not launch B1"
    del cands, wp, x, u, p, rhs, s

    # 17c. heat 2D lumped on B2 with the FFT DST (float32)
    hp = HeatControlProblem(ProblemConfig(**HEAT_2D, dtype=torch.float32, dst_method="fft"), device=DEVICE)
    hfn = ch.build_cuda_heat_solver(hp)
    before = counters["b2.launches"]
    hsol = hp.solve(SolverConfig(method="woodbury", use_pallas=True))
    torch.cuda.synchronize()
    hl = counters["b2.launches"] - before
    hrel = hp.relative_residual_f64(hsol)
    hms = timed_("heat_2d_solve_cuda_kernel_dst_fft", lambda: hfn(hp.rhs))
    timed_("heat_2d_dst_fft", lambda: hp.space.dst(hp.rhs))
    print(json.dumps({"phase": "heat_2d_dst_fft", **HEAT_2D, "dtype": "float32", "ms": hms, "b2_launches": hl,
                      "relative_residual_f64": hrel, "gate": HEAT_MAX_REL_RESIDUAL}), flush=True)
    if hl < 1 or not hrel <= HEAT_MAX_REL_RESIDUAL:
        return f"heat 2D with the FFT DST: {hl} B2 launches, residual {hrel:.3e}"
    del hp, hfn, hsol

    # 17d. GMRES, float64 headline, left side, rtol 1e-8, by DST method; and
    # the matmul with its sine matrix formed from exactly reduced angles
    # (measurement only: the port builds the matrix as the JAX package does)
    gits = {}
    for dst_method in ("matmul", "fft", "mxu4", "matmul_exact_matrix"):
        gp = WaveControlProblem(ProblemConfig(N_x=N_X, N_t=N_T, dtype=torch.float64,
                                              dst_method=dst_method.replace("_exact_matrix", "")), device=DEVICE)
        if dst_method == "matmul_exact_matrix":
            gp.space.__dict__["dst_matrix"] = torch.from_numpy(dst_matrix_extended(N_X).astype(np.float64)).to(DEVICE)
        gsol = gp.solve(SolverConfig(rtol=1e-8))
        its, conv, grel = int(gsol.result.iterations), bool(gsol.result.converged), gp.relative_residual_f64(gsol)
        gits[dst_method] = its
        pc = build_preconditioner(gp.operator)
        apply_ms = timed_(f"gmres_fulldiag_pc_apply_dst_{dst_method}", lambda: pc(gp.rhs))
        dst_ms = timed_(f"dst_{dst_method}_f64", lambda: gp.space.dst(gp.rhs))
        solve = gp.make_solver_fn(SolverConfig(rtol=1e-8))
        solve_ms = timed_(f"gmres_wave_headline_solve_dst_{dst_method}", lambda: solve(gp.rhs))
        hist = gsol.result.residual_history.numpy()
        print(json.dumps({"phase": "gmres_headline_dst", "dst_method": dst_method, "iterations": its,
                          "iterations_matmul": gits["matmul"], "converged": conv, "relative_residual_f64": grel,
                          "gate": GMRES_HEADLINE_MAX_REL_RESIDUAL, "fulldiag_apply_ms": apply_ms,
                          "dst_ms": dst_ms, "solve_ms": solve_ms,
                          "residual_history_relative": (hist[: its + 1] / hist[0]).tolist()}), flush=True)
        if not (conv and grel <= GMRES_HEADLINE_MAX_REL_RESIDUAL):
            return f"GMRES headline with dst_method={dst_method!r}: converged {conv}, residual {grel:.3e}"
        del gp, gsol, pc, solve

    # 17e. 'auto' past the 64 MB budget takes the FFT sine transform
    big = make_space(1, PAST_BUDGET["N_x"], dtype=torch.float64, device=DEVICE)
    v = torch.from_numpy(rng.standard_normal((2, 8, big.n))).to(DEVICE)
    mxu4 = make_space(1, PAST_BUDGET["N_x"], dtype=torch.float64, device=DEVICE, dst_method="mxu4")
    err = rel_err(torch, big.dst(v), mxu4.dst(v))
    picked = "fft" if big._use_fft_dst else "matmul"
    print(json.dumps({"phase": "dst_auto_past_budget", "N_x": PAST_BUDGET["N_x"], "dtype": "float64", "picked": picked,
                      "matrix_built": "dst_matrix" in big.__dict__, "rel_max_abs_err_vs_mxu4": err,
                      "seconds": time.perf_counter() - t0}), flush=True)
    if picked != "fft" or "dst_matrix" in big.__dict__ or not err <= DST_TOL["float64"]:
        return f"P1Space(N_x={big.N_x}, float64) with 'auto' took {picked} (error {err:.3e} vs mxu4)"
    return None


def trace_summary(path: str, top: int = 5) -> dict:
    """Read a Chrome trace of ``torch.profiler``: the window (first to last
    event), the device's busy share (union of kernel, memcpy and memset
    intervals over the window) overall and in each StageTimer range, the
    device ops with the most total time, and the longest idle gaps between
    device work, each with the host op (``cpu_op`` or ``cuda_runtime``)
    that overlaps it most."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    dev = sorted((e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")), key=lambda e: e["ts"])
    if not any(e.get("cat") == "kernel" for e in dev):
        raise RuntimeError(f"{path} holds no GPU kernel event: the profiler did not trace the card")
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    busy = []  # union of the device intervals
    for e in dev:
        a, b = e["ts"], e["ts"] + e["dur"]
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])

    def busy_in(a, b):
        return sum(max(0.0, min(b, y) - max(a, x)) for x, y in busy)

    # the StageTimer ranges; the port's own spans have a '/' in their names
    stages = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "user_annotation" and "/" not in e["name"]}
    per_op = collections.defaultdict(lambda: [0.0, 0])
    for e in dev:
        per_op[e["name"]][0] += e["dur"]
        per_op[e["name"]][1] += 1
    host = [e for e in events if e.get("cat") in ("cpu_op", "cuda_runtime")]

    def idle_gaps(lo, hi):
        """The longest gaps between device work inside [lo, hi], each with
        the host op that overlaps it most (its share of the gap: the rest
        is host time no traced op covers, i.e. Python)."""
        inner = [(max(lo, x[1]), min(hi, y[0])) for x, y in zip(busy, busy[1:]) if x[1] < hi and y[0] > lo]
        out = []
        for a, b in sorted(inner, key=lambda ab: ab[0] - ab[1])[:top]:
            over = [(min(b, e["ts"] + e["dur"]) - max(a, e["ts"]), -e["dur"], e) for e in host
                    if e["ts"] < b and e["ts"] + e["dur"] > a]
            ov, _, e = max(over, key=lambda o: o[:2]) if over else (0.0, 0, {})
            out.append({"gap_ms": (b - a) / 1e3, "host_op": e.get("name"), "host_cat": e.get("cat"),
                        "host_op_ms": e.get("dur", 0.0) / 1e3, "overlap_share": ov / (b - a) if b > a else None})
        return out

    return {
        "window_ms": (t1 - t0) / 1e3,
        "device_busy_ms": busy_in(t0, t1) / 1e3,
        "device_busy_share": busy_in(t0, t1) / (t1 - t0),
        "stages": {k: {"ms": (b - a) / 1e3, "device_busy_share": busy_in(a, b) / (b - a),
                       "longest_idle_gaps": idle_gaps(a, b)} for k, (a, b) in stages.items()},
        "device_events": len(dev),
        "top_device_ops": [{"name": k[:160], "total_ms": v[0] / 1e3, "launches": v[1]}
                           for k, v in sorted(per_op.items(), key=lambda kv: -kv[1][0])[:top]],
        "longest_idle_gaps": idle_gaps(t0, t1),
    }


def cli_phases(torch, smi):
    """Phase 18: the CLI (``python -m optimal_control_paradiag_torch.run``),
    called in-process with ``--out`` in a temporary directory: the
    reference's default run on the card and on the CPU, the heat headline,
    the wave direct solve past the DST budget, and the float64 GMRES
    headline under ``--profile`` with its trace read back. Prints one JSON
    line per run; returns None, or what failed."""
    import contextlib
    import io
    import tempfile

    from optimal_control_paradiag_torch import ProblemConfig, WaveControlProblem
    from optimal_control_paradiag_torch.run import main as cli

    def run(argv, out):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rec = cli(argv + ["--out", out])
        rec = {k: v for k, v in rec.items() if k != "config"}
        return rec, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        # 18a. the reference's default run, card and CPU
        recs = {}
        for platform in ("auto", "cpu"):
            out = os.path.join(tmp, f"ref_{platform}")
            rec, secs = run(["--nx", "80", "--nt", "81", "--rtol", "1e-8", "--platform", platform], out)
            files = {f: os.path.exists(os.path.join(out, f)) for f in ("solution.npz", "residuals.out")}
            recs[platform] = rec
            print(json.dumps({"phase": "cli_reference_default", "platform": platform, **rec, "files": files,
                              "seconds": secs}), flush=True)
            if not (rec["converged"] and rec["iterations"] == 5 and rec["residual_norm_true"] < 1e-8
                    and all(files.values())):
                return f"CLI default run on --platform {platform}: {rec}, files {files}"
        da = abs(recs["auto"]["error_aligned_metric"] - recs["cpu"]["error_aligned_metric"])
        if not da <= ERROR_ALIGNED_TOL:
            return f"CLI error_aligned_metric differs between card and CPU by {da:.3e}"

        # 18b. heat at its headline, float64
        rec, secs = run(["--model", "heat", "--method", "woodbury", "--nx", str(HEAT_1D["N_x"]),
                         "--nt", str(HEAT_1D["N_t"])], os.path.join(tmp, "heat"))
        print(json.dumps({"phase": "cli_heat_headline", **rec, "gate": HEAT_CLI_MAX_REL_RESIDUAL,
                          "seconds": secs}), flush=True)
        if not rec["relative_residual"] <= HEAT_CLI_MAX_REL_RESIDUAL:
            return f"CLI heat headline residual {rec['relative_residual']:.3e}"

        # 18c. the wave direct solve past the DST matrix budget ('auto' -> fft)
        rec, secs = run(["--nx", str(PAST_BUDGET["N_x"]), "--nt", str(PAST_BUDGET["N_t"]), "--method", "woodbury"],
                        os.path.join(tmp, "big"))
        bnorm = float(torch.linalg.norm(WaveControlProblem(ProblemConfig(**PAST_BUDGET), device=DEVICE).rhs))
        print(json.dumps({"phase": "cli_woodbury_past_budget", **rec, "rhs_norm": bnorm,
                          "gate": WOODBURY_F64_MAX_RESIDUAL * bnorm, "seconds": secs}), flush=True)
        if not rec["residual_norm_true"] <= WOODBURY_F64_MAX_RESIDUAL * bnorm:
            return f"CLI woodbury N_x=4096 residual {rec['residual_norm_true']:.3e} (||b|| = {bnorm:.3e})"

        # 18d. the float64 GMRES headline under --profile
        prof = os.path.join(tmp, "prof")
        rec, secs = run(["--nx", str(N_X), "--nt", str(N_T), "--rtol", "1e-8", "--profile", prof],
                        os.path.join(tmp, "gmres"))
        print(json.dumps({"phase": "cli_gmres_headline_profiled", **rec, "seconds": secs,
                          "trace_mb": os.path.getsize(os.path.join(prof, "trace.json")) / 2**20}), flush=True)
        if not rec["converged"]:
            return f"CLI GMRES headline under --profile did not converge: {rec}"
        summary = trace_summary(os.path.join(prof, "trace.json"))
        print(json.dumps({"phase": "gmres_profile", "N_x": N_X, "N_t": N_T, "dtype": "float64",
                          "iterations": rec["iterations"], "card": smi, **summary}), flush=True)
        if not summary["top_device_ops"]:
            return "the GMRES trace lists no device op"
    return None


# Batched solves: stage_batched of the JAX bench (bench.py:375-387), B right-
# hand sides in one call, a fused solve ONE kernel launch for the batch.
BATCH = 8
# A lane of a batched float32 solve against the single solve of its right-
# hand side, relative max-abs: the batched cuFFT and cuBLAS calls may round
# otherwise than the single ones (the kernels' lanes are bitwise, phase 19).
BATCH_LANE_TOL = 1e-5
# Seeded noise right-hand sides meet a float32 floor of their own, above
# the wave gate that the problem's data meet: 2.3e-3 - 3.6e-3 on an H100,
# wave and heat (PERF.md section 6). A noise lane is held to its single
# solve, to a cap set from those readings, and to the plain batch
# (``use_pallas=False``: no kernel) on the same lane, the witness that the
# floor is float32's and not the kernel's.
NOISE_MAX_REL_RESIDUAL = 5e-3
NOISE_VS_PLAIN = 1.25
SPECTRAL_GMRES = dict(rtol=1e-5, restart=50, maxiter=150)  # stage_spectral_gmres, bench.py:313-315
# Spectral GMRES misses the 8e-4 gate in float32 in the JAX package too: its
# own bench records 1.75e-3 at this configuration (artifacts/bench_suite.json,
# ``spectral_gmres.rel_f64``). rtol bounds the D^-1-preconditioned residual
# in spectral coordinates; the float32 inverse transforms add rounding that
# no iteration sees. Held to 2.5 times the bench gate.
SPECTRAL_GMRES_MAX_REL_RESIDUAL = 2.5 * MAX_REL_RESIDUAL
MINRES_X_TOL = 1e-10  # the reference run, card vs CPU, float64, relative max-abs
MINRES_HEADLINE = dict(rtol=1e-8, maxiter=1000)
MINRES_HEADLINE_MAX_REL_RESIDUAL = 1e-6
DIRECT_VS_GMRES_TOL = 1e-7  # dense LU vs GMRES at rtol 1e-10, float64, relative max-abs
BATCHED_GMRES_B = 4
LONG_RUNS, LONG_WARMUP = 5, 1  # solves of 0.1-1 s: fewer timed runs keep the smoke short


def batch_rhs(torch, rhs, B: int, seed: int):
    """B distinct right-hand sides ``(B, 2, N_t, n)`` made from the
    problem's own ``rhs``: lane i is ``rhs`` times a seeded factor (size in
    [0.5, 2], seeded sign), mirrored in space on the odd lanes. Their
    float32 solves share the problem's accuracy floor; other data need not
    (:func:`noise_rhs`)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.5, 2.0, B) * rng.choice((-1.0, 1.0), B)
    return torch.stack([float(scale[i]) * (torch.flip(rhs, dims=(-1,)) if i % 2 else rhs)
                        for i in range(B)]).contiguous()


def noise_rhs(torch, rhs, B: int, seed: int):
    """B right-hand sides of seeded standard normal noise, scaled to the
    largest magnitude of ``rhs``, on its device."""
    import numpy as np

    noise = np.random.default_rng(seed).standard_normal((B,) + tuple(rhs.shape))
    return (rhs.abs().max() * torch.from_numpy(noise).to(rhs.dtype).to(rhs.device)).contiguous()


def noise_breakdown(torch, prob, consts, kernel, twin, nb, residual):
    """The float64 residuals of the noise lanes ``nb`` solved with the
    kernel or its twin (both float32, on the card) between the half-spectrum
    transforms in float32 (the solve's own) or in float64 (then cast to and
    from the kernel's complex64): which part sets the lanes' float32 floor.
    Printed, not gated."""
    from optimal_control_paradiag_torch import ProblemConfig
    from optimal_control_paradiag_torch.paradiag.spectral import make_halfspectrum_transforms

    out = {}
    for label, dt in (("f32", torch.float32), ("f64", torch.float64)):
        space = prob.space if dt == torch.float32 else type(prob)(
            ProblemConfig(N_x=N_X, N_t=N_T, dtype=dt), device=DEVICE).space
        to_s, from_s = make_halfspectrum_transforms(space, N_T, dt, time_transform="fft2")
        bh = to_s(nb.to(dt)).to(torch.complex64).contiguous()
        for name, fn in (("kernel", kernel), ("twin", twin)):
            x = from_s(fn(bh, consts, 1).to(torch.complex128 if dt == torch.float64 else torch.complex64))
            out[f"{name}_{label}_transforms"] = [residual(x[i].double().cpu().numpy(), nb[i].double().cpu().numpy())
                                                 for i in range(nb.shape[0])]
        del space, bh, x
    return out


def batched_phases(torch, smi, flush):
    """Phases 19-20: the batched direct solves at the headline shape
    (float32, B = 8 right-hand sides from :func:`batch_rhs`, refine = 1),
    wave through B1
    (``make_batched_solver_fn(SolverConfig(method='woodbury',
    use_pallas=True))``) and heat 1D through B2 (its builder on the batch).
    For each family: both kernels (slab, streaming) on the batched kernel
    input, ONE launch each, every lane bitwise equal to a launch on that
    lane alone and within the twin's tolerance of the batched twin; the
    batched solve with the launch count set to 0 just before and read just
    after (one launch), each lane's float64 residual gated and within
    ``BATCH_LANE_TOL`` of its single solve; the same for B seeded noise
    right-hand sides (:func:`noise_rhs`), whose residuals are held to
    ``NOISE_MAX_REL_RESIDUAL`` and to the plain batch's on the same lanes
    (``NOISE_VS_PLAIN``); timings of the batched solve,
    of the B single solves in sequence, of the plain batched solve and of
    the batched kernel, and its bound. Returns (what failed or None, the
    kernels' batched figures by family)."""
    import numpy as np

    from optimal_control_paradiag_torch import HeatControlProblem, ProblemConfig, SolverConfig, WaveControlProblem
    from optimal_control_paradiag_torch.ops.transforms import time_irfft_conj_packed, time_rfft_conj_packed
    from optimal_control_paradiag_torch.paradiag import cuda_heat as ch
    from optimal_control_paradiag_torch.paradiag import cuda_woodbury as cw
    from optimal_control_paradiag_torch.paradiag.spectral import spectral_relative_residual
    from optimal_control_paradiag_torch.utils.timing import counters

    figures = {}
    for family in ("wave", "heat"):
        cfg = ProblemConfig(N_x=N_X, N_t=N_T, dtype=torch.float32)
        if family == "wave":
            prob = WaveControlProblem(cfg, device=DEVICE)
            consts = cw.pack_constants(prob.operator)
            kernels = {"slab": cw.fused_woodbury, "streaming": streaming(cw.KERNEL)}
            twin, counter, tol, gate = cw.fused_woodbury_reference, "b1.launches", TOL_F32, MAX_REL_RESIDUAL
            wb = SolverConfig(method="woodbury", use_pallas=True)
            batched = lambda b, f=prob.make_batched_solver_fn(wb): f(b)[0]
            single = lambda b, f=prob.make_solver_fn(wb): f(b)[0]
            plain = lambda b, f=prob.make_batched_solver_fn(SolverConfig(method="woodbury")): f(b)[0]
            residual = lambda x, b: spectral_relative_residual(prob.operator, x, b)
            # refine = 1: W (80 flops per element) + A_hat and W again (140);
            # besides b and x, a11r/a11i/invdet (K, n), colc (4, n), gc (16, n), phases (K, 16)
            flops, small = 80 + 140, 20 * prob.space.n + 16 * (N_T // 2 + 1)
        else:
            prob = HeatControlProblem(cfg, device=DEVICE)
            consts = ch.pack_heat_constants(prob)
            kernels = {"slab": ch.fused_heat, "streaming": streaming(ch.KERNEL)}
            twin, counter, tol, gate = ch.fused_heat_reference, "b2.launches", HEAT_TOL_F32, HEAT_MAX_REL_RESIDUAL
            batched = single = ch.build_cuda_heat_solver(prob)  # the builder takes (2, N_t, n) or a batch
            plain = prob.build_woodbury_solver()

            def residual(x, b, p=prob):
                return float(np.linalg.norm(p.matvec_host_f64(x) - b) / np.linalg.norm(b))

            # refine = 1: W (64 flops per element) + A_hat and W again (108);
            # colc (6, n), phases (K, 8)
            flops, small = 64 + 108, 6 * prob.space.n + 8 * (N_T // 2 + 1)
        bs = batch_rhs(torch, prob.rhs, BATCH, 8)
        bh = time_rfft_conj_packed(prob.space.dst(bs), N_T)  # the batched kernel input (B, 2, K, n)
        K, n = consts.a11r.shape

        # 19. the kernels: one launch for the batch, each lane bitwise
        x_twin = twin(bh, consts, 1)
        lane_tw = []
        for kind, fn in kernels.items():
            before = counters[counter]
            xb = fn(bh, consts, 1)
            torch.cuda.synchronize()
            launches = counters[counter] - before
            bitwise = all(torch.equal(xb[i], fn(bh[i], consts, 1)) for i in range(BATCH))
            errs = [rel_err(torch, xb[i], x_twin[i]) for i in range(BATCH)]
            print(json.dumps({"phase": "batched_kernel", "family": family, "kernel": kind, "B": BATCH, "K": K,
                              "n": n, "launches": launches, "lanes_bitwise_equal_single_launch": bitwise,
                              "rel_max_abs_err_vs_twin": max(errs), "tol": tol}), flush=True)
            if launches != 1 or not bitwise or not max(errs) <= tol:
                return (f"batched {family} {kind} kernel: {launches} launches, lanes bitwise {bitwise}, "
                        f"{max(errs):.3e} from the batched twin (tol {tol:.0e})"), None
            if kind == "slab":
                lane_tw = errs
        del x_twin, xb

        # 20. the batched solve through the entry point: one launch
        counters[counter] = 0
        xs = batched(bs)
        torch.cuda.synchronize()
        launches = counters[counter]
        if xs.shape != bs.shape or xs.dtype != torch.float32 or not bool(torch.isfinite(xs).all()):
            return f"batched {family} solve: {tuple(xs.shape)} {xs.dtype}, finite {bool(torch.isfinite(xs).all())}", None
        rels, lane = [], []
        for i in range(BATCH):
            lane.append(rel_err(torch, xs[i], single(bs[i])))
            rels.append(residual(xs[i].double().cpu().numpy(), bs[i].double().cpu().numpy()))
        # B seeded noise right-hand sides: one launch, each lane against its
        # single solve and against the plain batch on the same lane
        nb = noise_rhs(torch, prob.rhs, BATCH, 9)
        counters[counter] = 0
        xn = batched(nb)
        torch.cuda.synchronize()
        noise_launches = counters[counter]
        xp = plain(nb)
        noise_lane, noise_rels, plain_rels = [], [], []
        for i in range(BATCH):
            noise_lane.append(rel_err(torch, xn[i], single(nb[i])))
            b64 = nb[i].double().cpu().numpy()
            noise_rels.append(residual(xn[i].double().cpu().numpy(), b64))
            plain_rels.append(residual(xp[i].double().cpu().numpy(), b64))
        noise_vs_plain = max(r / q for r, q in zip(noise_rels, plain_rels))
        breakdown = noise_breakdown(torch, prob, consts, kernels["slab"], twin, nb[:4], residual)
        del nb, xn, xp
        ms = {
            "batched": timed(torch, smi, flush, f"{family}_batched_solve_cuda_kernel", lambda: batched(bs), B=BATCH),
            "sequential": timed(torch, smi, flush, f"{family}_sequential_solves_cuda_kernel",
                                lambda: [single(bs[i]) for i in range(BATCH)], B=BATCH),
            "plain": timed(torch, smi, flush, f"{family}_batched_solve_plain_torch", lambda: plain(bs), B=BATCH),
            "kernel": timed(torch, smi, flush, f"{family}_batched_kernel", lambda: kernels["slab"](bh, consts, 1),
                            B=BATCH),
        }
        if family == "wave":  # the batched transforms against B single ones
            sp = prob.space
            s = sp.dst(bs)
            for name, fn in (("dst_matmul", sp.dst), ("packed_fft_roundtrip",
                                                      lambda v: time_irfft_conj_packed(time_rfft_conj_packed(v, N_T), N_T))):
                v = bs if name == "dst_matmul" else s
                timed(torch, smi, flush, f"wave_batched_{name}", lambda f=fn, v=v: f(v), B=BATCH)
                timed(torch, smi, flush, f"wave_sequential_{name}", lambda f=fn, v=v: [f(v[i]) for i in range(BATCH)],
                      B=BATCH)
            del s
        # each lane's b and x (eight real (K, n) planes) once; the constants
        # once (the least: L2 keeps them across lanes) or once per lane
        itemsize = 4
        lane_bytes, const_bytes = 8 * K * n * itemsize, (3 * K * n + small) * itemsize
        bound = roofline(BATCH * lane_bytes + const_bytes, BATCH * K * n * flops)
        bound_per_lane = roofline(BATCH * (lane_bytes + const_bytes), BATCH * K * n * flops)
        print(json.dumps({"phase": f"batched_{family}_headline", "N_x": N_X, "N_t": N_T, "dtype": "float32",
                          "B": BATCH, "launches": launches, "relative_residual_f64": rels, "gate": gate,
                          "noise_launches": noise_launches, "noise_lanes_relative_residual_f64": noise_rels,
                          "noise_gate": NOISE_MAX_REL_RESIDUAL, "noise_lane_vs_single_rel_max_abs": noise_lane,
                          "plain_noise_lanes_relative_residual_f64": plain_rels,
                          "noise_vs_plain_max_ratio": noise_vs_plain, "noise_vs_plain_gate": NOISE_VS_PLAIN,
                          "noise_breakdown_first_4_lanes": breakdown,
                          "lane_vs_single_rel_max_abs": lane, "lane_gate": BATCH_LANE_TOL,
                          "kernel_lane_vs_twin_rel_max_abs": lane_tw,
                          "batched_ms": ms["batched"], "sequential_ms": ms["sequential"],
                          "solves_per_s": BATCH / (ms["batched"] / 1e3),
                          "sequential_solves_per_s": BATCH / (ms["sequential"] / 1e3),
                          "plain_batched_ms": ms["plain"], "kernel_batched_ms": ms["kernel"],
                          "kernel_bytes": BATCH * lane_bytes + const_bytes, **bound,
                          "bound_ms_constants_per_lane": bound_per_lane["bound_ms"], "card": smi}), flush=True)
        if launches != 1:
            return f"the batched {family} solve made {launches} kernel launches, not one", None
        if not max(rels) <= gate:
            return f"batched {family} headline: a lane's residual {max(rels):.3e} > {gate}", None
        if not max(lane) <= BATCH_LANE_TOL:
            return f"batched {family} headline: a lane {max(lane):.3e} from its single solve", None
        if noise_launches != 1 or not max(noise_lane) <= BATCH_LANE_TOL:
            return (f"batched {family} noise: {noise_launches} launches, a lane {max(noise_lane):.3e} "
                    "from its single solve"), None
        if not (max(noise_rels) <= NOISE_MAX_REL_RESIDUAL and noise_vs_plain <= NOISE_VS_PLAIN):
            return (f"batched {family} noise: a lane's residual {max(noise_rels):.3e} (cap "
                    f"{NOISE_MAX_REL_RESIDUAL}), {noise_vs_plain:.3f} times the plain batch's"), None
        figures[family] = {"batched_launches": launches, "batched_ms": ms["kernel"],
                           "batched_bound_ms": bound["bound_ms"], "batched_bound_by": bound["bound_by"]}
        del prob, consts, bs, bh, xs
    return None, figures


def krylov_direct_phases(torch, smi, flush):
    """Phases 21-24: GMRES in spectral coordinates at the wave headline
    (float32, the JAX bench's configuration: converged, oracle <= 2e-3);
    MINRES on the symmetrized system, the reference run (float64, rtol
    1e-10) on the card and the CPU (the same iterations, x 1e-10 apart) and
    the float64 wave headline (rtol 1e-8: converged, oracle <= 1e-6); the
    dense direct solve at the reference shape (cuSOLVER LU of the assembled
    matrix, against GMRES at rtol 1e-10: 1e-7), with ``operator_nnz`` and
    the dense build's time; batched GMRES at the reference shape (float64,
    B = 4): per-lane iterations as the sequential solves', and the host
    synchronisations of one lock-step Arnoldi step as those of a single
    solve's step. Prints one JSON line per result; returns None, or what
    failed."""
    import numpy as np

    from optimal_control_paradiag_torch import ProblemConfig, SolverConfig, WaveControlProblem, reference_1d_default
    from optimal_control_paradiag_torch.krylov.gmres import arnoldi_step, givens_update
    from optimal_control_paradiag_torch.ops.allatonce import operator_nnz
    from optimal_control_paradiag_torch.paradiag.pc import build_preconditioner

    def lanes_rel(a, b):
        return rel_err(torch, torch.stack([a.u, a.p]).cpu(), torch.stack([b.u, b.p]).cpu())

    # 21. spectral GMRES at the headline, float32
    wp = WaveControlProblem(ProblemConfig(N_x=N_X, N_t=N_T, dtype=torch.float32), device=DEVICE)
    scfg = SolverConfig(method="spectral", **SPECTRAL_GMRES)
    t0 = time.perf_counter()
    sol = wp.solve(scfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    its, conv, rel = int(sol.result.iterations), bool(sol.result.converged), wp.relative_residual_f64(sol)
    run = wp.make_solver_fn(scfg)
    ms = timed(torch, smi, flush, "spectral_gmres_headline_solve", lambda: run(wp.rhs), LONG_RUNS, LONG_WARMUP)
    wall, _, _ = wall_ms(torch, lambda: run(wp.rhs), LONG_RUNS, LONG_WARMUP)
    print(json.dumps({"phase": "spectral_gmres_headline", "N_x": N_X, "N_t": N_T, "dtype": "float32",
                      **SPECTRAL_GMRES, "iterations": its, "converged": conv, "relative_residual_f64": rel,
                      "gate": SPECTRAL_GMRES_MAX_REL_RESIDUAL, "first_solve_s": first_s, "ms": ms, "host_wall_ms": wall,
                      "card": smi}), flush=True)
    if not (conv and rel <= SPECTRAL_GMRES_MAX_REL_RESIDUAL):
        return f"spectral GMRES headline: converged {conv} in {its} iterations, residual {rel:.3e}"
    del wp, sol, run

    # 22. MINRES: the reference run on card and CPU; the float64 headline
    mcfg = SolverConfig(method="minres", rtol=1e-10)
    ref = {dev: WaveControlProblem(reference_1d_default(), device=dev) for dev in (DEVICE, "cpu")}
    msol = {dev: p.solve(mcfg) for dev, p in ref.items()}
    its = {dev: int(s.result.iterations) for dev, s in msol.items()}
    conv = all(bool(s.result.converged) for s in msol.values())
    dx = lanes_rel(msol[DEVICE], msol["cpu"])
    print(json.dumps({"phase": "minres_reference_default", "dtype": "float64", "rtol": 1e-10,
                      "iterations_cuda": its[DEVICE], "iterations_cpu": its["cpu"], "converged": conv,
                      "x_rel_max_abs_card_vs_cpu": dx, "tol": MINRES_X_TOL,
                      "error_aligned_cuda": ref[DEVICE].error_aligned(msol[DEVICE])}), flush=True)
    if not (conv and its[DEVICE] == its["cpu"] and dx <= MINRES_X_TOL):
        return f"reference MINRES: converged {conv}, iterations {its}, x {dx:.3e} apart"
    mp = WaveControlProblem(ProblemConfig(N_x=N_X, N_t=N_T, dtype=torch.float64), device=DEVICE)
    hcfg = SolverConfig(method="minres", **MINRES_HEADLINE)
    t0 = time.perf_counter()
    sol = mp.solve(hcfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    its, conv, rel = int(sol.result.iterations), bool(sol.result.converged), mp.relative_residual_f64(sol)
    run = mp.make_solver_fn(hcfg)
    ms = timed(torch, smi, flush, "minres_headline_solve", lambda: run(mp.rhs), LONG_RUNS, LONG_WARMUP)
    print(json.dumps({"phase": "minres_headline", "N_x": N_X, "N_t": N_T, "dtype": "float64", **MINRES_HEADLINE,
                      "iterations": its, "converged": conv, "relative_residual_f64": rel,
                      "gate": MINRES_HEADLINE_MAX_REL_RESIDUAL, "first_solve_s": first_s, "ms": ms,
                      "ms_per_iteration": ms / max(its, 1), "card": smi}), flush=True)
    if not (conv and rel <= MINRES_HEADLINE_MAX_REL_RESIDUAL):
        return f"MINRES headline: converged {conv} in {its} iterations, residual {rel:.3e}"
    del ref, msol, mp, sol, run

    # 23. the dense direct solve at the reference shape
    dp = WaveControlProblem(reference_1d_default(), device=DEVICE)
    op = dp.operator
    t0 = time.perf_counter()
    A = op.dense()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    nnz, dense_nnz = operator_nnz(op), int((A != 0).sum())
    build_ms = timed(torch, smi, flush, "direct_dense_build", op.dense, size=op.size)
    lu_ms = timed(torch, smi, flush, "direct_lu_factor", lambda: torch.linalg.lu_factor(A), size=op.size)
    del A
    dsol = dp.solve(SolverConfig(method="direct"))
    gsol = dp.solve(SolverConfig(rtol=1e-10))
    run = dp.make_solver_fn(SolverConfig(method="direct"))
    solve_ms = timed(torch, smi, flush, "direct_lu_solve", lambda: run(dp.rhs), size=op.size)
    dx = lanes_rel(dsol, gsol)
    print(json.dumps({"phase": "direct", "N_x": 80, "N_t": 81, "dtype": "float64", "size": op.size,
                      "dense_gb": op.size ** 2 * 8 / 1e9, "operator_nnz": nnz, "dense_nnz": dense_nnz,
                      "first_build_s": build_s, "dense_build_ms": build_ms, "lu_factor_ms": lu_ms,
                      "lu_solve_ms": solve_ms, "x_rel_max_abs_vs_gmres": dx, "tol": DIRECT_VS_GMRES_TOL,
                      "gmres_iterations": int(gsol.result.iterations), "error_aligned": dp.error_aligned(dsol),
                      "card": smi}), flush=True)
    if not dx <= DIRECT_VS_GMRES_TOL:
        return f"direct solve {dx:.3e} from GMRES at rtol 1e-10"
    del dsol, gsol, run

    # 24. batched GMRES at the reference shape, float64, B = 4
    B = BATCHED_GMRES_B  # two lanes of the problem's own data, two of noise (more steps)
    bs = torch.cat([batch_rhs(torch, dp.rhs, B // 2, 4), noise_rhs(torch, dp.rhs, B - B // 2, 4)])
    gcfg = SolverConfig(rtol=1e-8)
    bfn, sfn = dp.make_batched_solver_fn(gcfg), dp.make_solver_fn(gcfg)
    bfn(bs)  # the first call builds the preconditioner
    (xs, res), syncs = count_syncs(torch, lambda: bfn(bs))
    seq = [count_syncs(torch, lambda i=i: sfn(bs[i])) for i in range(B)]
    its_b = [int(v) for v in res.iterations]
    its_s = [int(r.iterations) for (_, r), _ in seq]
    dx = max(rel_err(torch, xs[i], seq[i][0][0]) for i in range(B))
    # one lock-step Arnoldi step (device part, its one copy, Givens per lane)
    # against one step of a single solve, at the batch's last step
    k, shape = max(its_b) - 1, op.shape
    pc = build_preconditioner(op)
    left = lambda v: pc(op.matvec(v))
    V = torch.randn((B, k + 2, op.size), dtype=torch.float64, device=DEVICE)
    R, cs = np.zeros((B, k + 1, k + 1)), np.ones((B, k + 1))
    sn, g = np.zeros((B, k + 1)), np.ones((B, k + 2))

    def batched_step():
        h = arnoldi_step(left, V, k, shape).cpu().numpy()
        for i in range(B):
            givens_update(h[i], k, R[i], cs[i], sn[i], g[i])

    def single_step():
        one = arnoldi_step(lambda v: left(v[0])[None], V[:1], k, shape)  # as gmres hands its one lane on
        givens_update(one.cpu().numpy()[0], k, R[0], cs[0], sn[0], g[0])

    _, step_b = count_syncs(torch, batched_step)
    _, step_1 = count_syncs(torch, single_step)
    ms_b = timed(torch, smi, flush, "batched_gmres_solve", lambda: bfn(bs), LONG_RUNS, LONG_WARMUP, B=B)
    ms_s = timed(torch, smi, flush, "sequential_gmres_solves", lambda: [sfn(bs[i]) for i in range(B)], LONG_RUNS,
                 LONG_WARMUP, B=B)
    print(json.dumps({"phase": "batched_gmres", "N_x": 80, "N_t": 81, "dtype": "float64", "rtol": 1e-8, "B": B,
                      "iterations": its_b, "iterations_sequential": its_s,
                      "converged": [bool(c) for c in res.converged], "x_rel_max_abs_vs_sequential": dx,
                      "syncs_batched_solve": syncs, "syncs_sequential_solves": [s for _, s in seq],
                      "syncs_batched_step": step_b, "syncs_single_step": step_1, "batched_ms": ms_b,
                      "sequential_ms": ms_s, "card": smi}), flush=True)
    if not (its_b == its_s and all(bool(c) for c in res.converged)):
        return f"batched GMRES: per-lane iterations {its_b} vs sequential {its_s}"
    if step_b["sync_debug"] != step_1["sync_debug"] or step_b["explicit_calls"] != step_1["explicit_calls"]:
        return f"a batched Arnoldi step synchronises {step_b}, a single one {step_1}"
    return None


# The spaces the sine transform does not diagonalize (phases 25-31). The JAX
# bench's shapes and its own records (artifacts/bench_suite.json: iterations
# and residuals only, never a time): stage_consistent_2d and
# stage_heat_2d_consistent, 1 iteration each, rel_f64 8.52e-5 and 5.16e-4;
# stage_unstructured, 69 iterations, 2.07e-4, RCM bandwidth 31.
CONSISTENT_2D = dict(N_x=192, N_t=128, dim=2, mass="consistent")  # 9,339,136 unknowns
CONSISTENT_MAX_ITERS = 3
CONSISTENT_WAVE_MAX_REL = 5e-4
CONSISTENT_HEAT_MAX_REL = 2e-3
BLOCKLINE_AUTO = dict(N_x=64, N_t=64, dim=2)  # tests/test_blockline.py:143-161
BLOCKLINE_MAX_ITERS = 320
BLOCKLINE_MAX_REL = 1e-6
SMW_CAP_MAX_ITERS = 22  # tests/test_woodbury2d.py:45-82, N = 16, cap_rtol 1e-10
SMW_MAX_REL = 1e-8
CARD_VS_CPU_U_TOL = 1e-8  # the auto route at N = 16, float64, relative max-abs
BLOCK_VS_BLOCKLINE_TOL = 1e-6  # tests/test_blockline.py:113-127
BLOCKDENSE_VS_BLOCKLINE_TOL = 1e-9  # tests/test_blockline.py:53-66
UNSTRUCTURED_N, UNSTRUCTURED_N_T, UNSTRUCTURED_AMP = 32, 32, 0.18  # bench.py:493-504
UNSTRUCTURED_SOLVER = dict(rtol=1e-5, pc_variant="blockband", restart=80, maxiter=160)
UNSTRUCTURED_MAX_REL = 5e-4
UNSTRUCTURED_BANDWIDTH = 31
BATCHED_TENSOR_B, BATCHED_TENSOR_TOL = 3, 1e-10


def perturbed_mesh(N: int, amp: float, seed: int):
    """The JAX bench's perturbed unit square (bench.py:493-498): interior
    nodes moved by ``default_rng(seed).uniform(+-amp/N)``."""
    import numpy as np

    from optimal_control_paradiag_torch import native
    from optimal_control_paradiag_torch.fem.general import boundary_nodes

    pts, tris = native.unit_square_mesh(N, diagonal="left")
    bnd = boundary_nodes(pts.shape[0], tris)
    pts = pts.copy()
    pts[~bnd] += np.random.default_rng(seed).uniform(-amp / N, amp / N, size=pts[~bnd].shape)
    return pts, tris


def nondiagonal_phases(torch, smi, flush):
    """Phases 25-31: the spaces the sine transform does not diagonalize.
    25-26: the wave and heat 2D consistent-mass direct solves at the JAX
    bench's shape (N_x = 192, N_t = 128, float32; tensor GMRES: <= 3
    iterations, float64 oracle <= 5e-4 / 2e-3), timed; 27: the GMRES auto
    route (blockline) at N_x = N_t = 64, float64, rtol 1e-8 (<= 320
    iterations, residual < 1e-6) with the host factor time, the factors'
    bytes and one apply timed, and the SMW solve over blockline at N = 16
    (<= 22 capacity iterations, residual < 1e-8); 28: card against CPU in
    float64 (auto route, tensor GMRES, block against blockline, blockdense
    against blockline); 29: the JAX bench's unstructured problem (n = 961,
    N_t = 32, float32, blockband GMRES: converged, oracle <= 5e-4, RCM
    bandwidth 31), then the blockdense auto route card against CPU; 30: the
    CLI's --dim 2 at its defaults (N_x = 80, N_t = 81, blockline) and
    --mesh-file; 31: batched tensor GMRES (N = 32, B = 3): per-lane
    iterations and solutions as the sequential ones. Prints one JSON line
    per result; returns None, or what failed."""
    import contextlib
    import io
    import tempfile

    import numpy as np

    from optimal_control_paradiag_torch import HeatControlProblem, ProblemConfig, SolverConfig, WaveControlProblem
    from optimal_control_paradiag_torch.fem.general import make_general_space
    from optimal_control_paradiag_torch.krylov.gmres import gmres
    from optimal_control_paradiag_torch.paradiag.blockband import band_profile, blockband_entries
    from optimal_control_paradiag_torch.paradiag.blockline import blockline_entries
    from optimal_control_paradiag_torch.paradiag.pc import build_preconditioner
    from optimal_control_paradiag_torch.paradiag.spectral import _capacity_CW, _spectral_plan
    from optimal_control_paradiag_torch.paradiag.woodbury2d import build_tensor_gmres_solver, time_corner_maps
    from optimal_control_paradiag_torch.run import main as cli

    f32, f64 = torch.float32, torch.float64

    def first(fn):
        """``fn()`` and its host wall seconds, to the card's last op."""
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def rel_b(prob, sol):
        scale = (prob.config.gamma ** 0.5) if prob.config.scaled else 1.0
        r = prob.operator.matvec(torch.stack([sol.u * scale, sol.p])) - prob.rhs
        return float(torch.linalg.norm(r.reshape(-1)) / torch.linalg.norm(prob.rhs.reshape(-1)))

    # 25. wave 2D consistent mass at the JAX bench's shape: the tensor GMRES
    torch.cuda.reset_peak_memory_stats()
    wp = WaveControlProblem(ProblemConfig(**CONSISTENT_2D, dtype=f32), device=DEVICE)
    wcfg = SolverConfig(method="woodbury")
    (sol, route, route_err), first_s = first(lambda: cgs2_route("consistent_2d_woodbury", lambda: wp.solve(wcfg)))
    rel = wp.relative_residual_f64(sol)
    # the route's own settings (rtol 1e-5 in float32, maxiter 60), with its record
    (_, res), _ = first(lambda: build_tensor_gmres_solver(wp.operator, rtol=1e-5, with_result=True)(wp.rhs))
    its, conv = int(res.iterations), bool(res.converged)
    run = wp.make_solver_fn(wcfg)
    ms = timed(torch, smi, flush, "consistent_2d_woodbury_solve", lambda: run(wp.rhs), LONG_RUNS, LONG_WARMUP)
    wall, _, _ = wall_ms(torch, lambda: run(wp.rhs), LONG_RUNS, LONG_WARMUP)
    print(json.dumps({"phase": "consistent_2d_woodbury", **CONSISTENT_2D, "dtype": "float32",
                      "unknowns": wp.operator.size, "iterations": its, "converged": conv, "relative_residual_f64": rel,
                      "jax_bench_iterations": 1, "jax_bench_rel_f64": 8.52e-5, "gate_iterations": CONSISTENT_MAX_ITERS,
                      "gate": CONSISTENT_WAVE_MAX_REL, "first_solve_s": first_s, "ms": ms, "host_wall_ms": wall,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9, **route, "card": smi}), flush=True)
    if not (conv and its <= CONSISTENT_MAX_ITERS and rel <= CONSISTENT_WAVE_MAX_REL):
        return f"wave 2D consistent: converged {conv} in {its} iterations, residual {rel:.3e}"
    if route_err:
        return route_err
    del wp, sol, run, res

    # 26. heat 2D consistent mass, the same shape
    hp = HeatControlProblem(ProblemConfig(**CONSISTENT_2D, dtype=f32), device=DEVICE)
    hcfg = SolverConfig(method="woodbury")
    sol, first_s = first(lambda: hp.solve(hcfg))
    its, conv, rel = int(sol.result.iterations), bool(sol.result.converged), hp.relative_residual_f64(sol)
    ms = timed(torch, smi, flush, "heat_2d_consistent_solve", lambda: hp.solve(hcfg), LONG_RUNS, LONG_WARMUP)
    wall, _, _ = wall_ms(torch, lambda: hp.solve(hcfg), LONG_RUNS, LONG_WARMUP)
    print(json.dumps({"phase": "heat_2d_consistent", **CONSISTENT_2D, "dtype": "float32", "iterations": its,
                      "converged": conv, "relative_residual_f64": rel, "jax_bench_iterations": 1,
                      "jax_bench_rel_f64": 5.16e-4, "gate_iterations": CONSISTENT_MAX_ITERS,
                      "gate": CONSISTENT_HEAT_MAX_REL, "first_solve_s": first_s, "ms": ms, "host_wall_ms": wall,
                      "card": smi}), flush=True)
    if not (conv and its <= CONSISTENT_MAX_ITERS and rel <= CONSISTENT_HEAT_MAX_REL):
        return f"heat 2D consistent: converged {conv} in {its} iterations, residual {rel:.3e}"
    del hp, sol

    # 27. the GMRES auto route (blockline) at N = 64, float64; the SMW at N = 16
    bp = WaveControlProblem(ProblemConfig(**BLOCKLINE_AUTO), device=DEVICE)
    op = bp.operator
    pc, factor_s = first(lambda: build_preconditioner(op, variant="blockline"))
    r = torch.randn(op.shape, dtype=f64, device=DEVICE, generator=torch.Generator(DEVICE).manual_seed(0))
    apply_ms = timed(torch, smi, flush, "blockline_apply", lambda: pc(r), 5, 2, **BLOCKLINE_AUTO)
    apply_wall, _, _ = wall_ms(torch, lambda: pc(r), 5, 2)
    del pc
    gcfg = SolverConfig(rtol=1e-8)
    run, route_factor_s = first(lambda: bp.make_solver_fn(gcfg))
    (x, res), solve_s = first(lambda: run(bp.rhs))
    its, conv = int(res.iterations), bool(res.converged)
    relb = float(torch.linalg.norm((op.matvec(x) - bp.rhs).reshape(-1)) / torch.linalg.norm(bp.rhs.reshape(-1)))
    print(json.dumps({"phase": "blockline_auto_route", **BLOCKLINE_AUTO, "dtype": "float64", "rtol": 1e-8,
                      "iterations": its, "converged": conv, "residual_over_b": relb, "gate_iterations": BLOCKLINE_MAX_ITERS,
                      "gate": BLOCKLINE_MAX_REL, "factor_host_s": factor_s, "route_build_s": route_factor_s,
                      "factor_bytes": blockline_entries(op.N_t, bp.space.n1d) * 16, "apply_ms": apply_ms,
                      "apply_host_wall_ms": apply_wall, "line_steps_per_apply": 2 * bp.space.n1d, "solve_s": solve_s,
                      "card": smi}), flush=True)
    if not (conv and its <= BLOCKLINE_MAX_ITERS and relb < BLOCKLINE_MAX_REL):
        return f"blockline auto route: converged {conv} in {its} iterations, residual {relb:.3e}"
    del bp, op, run, x, res
    sp16 = WaveControlProblem(ProblemConfig(N_x=16, N_t=16, dim=2), device=DEVICE)
    ssol, smw_s = first(lambda: sp16.solve(SolverConfig(method="woodbury", pc_variant="blockline", rtol=1e-10)))
    srel = rel_b(sp16, ssol)
    op = sp16.operator
    Pinv = build_preconditioner(op, variant="blockline")
    phi_star, R, psi = time_corner_maps(op)
    C, W = _capacity_CW(_spectral_plan(op, mass_surrogate=True))
    Minv = torch.from_numpy(np.linalg.inv(np.eye(4)[None] + C @ W).real).to(DEVICE)
    cres = gmres(lambda q: q + R(phi_star(Pinv(psi(q)))), R(phi_star(Pinv(sp16.rhs))),
                 M=lambda q: sp16.space.idst(torch.einsum("nab,bn->an", Minv, sp16.space.dst(q))),
                 restart=100, rtol=1e-10, maxiter=100)
    cits, cconv = int(cres.iterations), bool(cres.converged)
    print(json.dumps({"phase": "smw_blockline", "N_x": 16, "N_t": 16, "dtype": "float64", "cap_rtol": 1e-10,
                      "capacity_iterations": cits, "converged": cconv, "residual_over_b": srel,
                      "gate_iterations": SMW_CAP_MAX_ITERS, "gate": SMW_MAX_REL, "first_solve_s": smw_s}), flush=True)
    if not (cconv and cits <= SMW_CAP_MAX_ITERS and srel < SMW_MAX_REL):
        return f"SMW over blockline: {cits} capacity iterations (converged {cconv}), residual {srel:.3e}"
    del sp16, ssol, Pinv

    # 28. card against CPU, float64
    out = {}
    for dev in (DEVICE, "cpu"):
        p = WaveControlProblem(ProblemConfig(N_x=16, N_t=16, dim=2), device=dev)
        s = p.solve(SolverConfig(rtol=1e-8))
        q = WaveControlProblem(ProblemConfig(N_x=32, N_t=32, dim=2), device=dev)
        _, tres = build_tensor_gmres_solver(q.operator, rtol=1e-10, with_result=True)(q.rhs)
        out[dev] = (int(s.result.iterations), s.u.cpu(), int(tres.iterations))
    du = rel_err(torch, out[DEVICE][1], out["cpu"][1])
    p = WaveControlProblem(ProblemConfig(N_x=16, N_t=16, dim=2), device=DEVICE)
    rr = torch.randn(p.operator.shape, dtype=f64, device=DEVICE, generator=torch.Generator(DEVICE).manual_seed(2))
    y_line = build_preconditioner(p.operator, variant="blockline")(rr)
    y_block = build_preconditioner(p.operator, variant="block", inner_tol=1e-12, inner_maxiter=300)(rr)
    d_block = rel_err(torch, y_block, y_line)
    p = WaveControlProblem(ProblemConfig(N_x=7, N_t=8, dim=2), device=DEVICE)
    rr = torch.randn(p.operator.shape, dtype=f64, device=DEVICE, generator=torch.Generator(DEVICE).manual_seed(0))
    d_dense = rel_err(torch, build_preconditioner(p.operator, variant="blockdense")(rr),
                      build_preconditioner(p.operator, variant="blockline")(rr))
    print(json.dumps({"phase": "nondiagonal_card_vs_cpu", "dtype": "float64",
                      "auto_route_N16_iterations": [out[DEVICE][0], out["cpu"][0]], "auto_route_u_rel": du,
                      "tensor_gmres_N32_iterations": [out[DEVICE][2], out["cpu"][2]],
                      "block_vs_blockline_N16": d_block, "blockdense_vs_blockline_7x8": d_dense,
                      "tols": [CARD_VS_CPU_U_TOL, BLOCK_VS_BLOCKLINE_TOL, BLOCKDENSE_VS_BLOCKLINE_TOL]}), flush=True)
    if not (abs(out[DEVICE][0] - out["cpu"][0]) <= 1 and du <= CARD_VS_CPU_U_TOL and out[DEVICE][2] == out["cpu"][2]
            and d_block <= BLOCK_VS_BLOCKLINE_TOL and d_dense <= BLOCKDENSE_VS_BLOCKLINE_TOL):
        return "2D consistent card vs CPU: see the nondiagonal_card_vs_cpu line"

    # 29. the JAX bench's unstructured problem: blockband GMRES, float32
    pts, tris = perturbed_mesh(UNSTRUCTURED_N, UNSTRUCTURED_AMP, 0)
    usp = make_general_space(pts, tris, dtype=f32, device=DEVICE)
    up = WaveControlProblem(ProblemConfig(N_x=UNSTRUCTURED_N, N_t=UNSTRUCTURED_N_T, dim=2, dtype=f32), device=DEVICE,
                            space=usp)
    ucfg = SolverConfig(**UNSTRUCTURED_SOLVER)
    sol, first_s = first(lambda: up.solve(ucfg))
    its, conv, rel = int(sol.result.iterations), bool(sol.result.converged), up.relative_residual_f64(sol)
    _, bw = band_profile(usp)
    run = up.make_solver_fn(ucfg)
    ms = timed(torch, smi, flush, "unstructured_blockband_solve", lambda: run(up.rhs), 3, 1)
    wall, _, _ = wall_ms(torch, lambda: run(up.rhs), 3, 1)
    pc = build_preconditioner(up.operator, variant="blockband")
    apply_ms = timed(torch, smi, flush, "blockband_apply", lambda: pc(up.rhs), 5, 2, n=usp.n, N_t=UNSTRUCTURED_N_T)
    apply_wall, _, _ = wall_ms(torch, lambda: pc(up.rhs), 5, 2)
    mv_ms = timed(torch, smi, flush, "unstructured_matvec_accurate", lambda: up.operator.matvec_accurate(up.rhs))
    print(json.dumps({"phase": "unstructured_blockband", "N": UNSTRUCTURED_N, "n": usp.n, "N_t": UNSTRUCTURED_N_T,
                      "dtype": "float32", **UNSTRUCTURED_SOLVER, "iterations": its, "converged": conv,
                      "relative_residual_f64": rel, "rcm_bandwidth": bw,
                      "factor_entries": blockband_entries(UNSTRUCTURED_N_T, usp.n, bw), "jax_bench_iterations": 69,
                      "jax_bench_rel_f64": 2.07e-4, "gate": UNSTRUCTURED_MAX_REL, "first_solve_s": first_s, "ms": ms,
                      "ms_per_iteration": ms / max(its, 1), "host_wall_ms": wall, "apply_ms": apply_ms,
                      "apply_host_wall_ms": apply_wall, "level_steps_per_apply": 2 * -(-usp.n // bw),
                      "matvec_accurate_ms": mv_ms, "card": smi}), flush=True)
    if not (conv and rel <= UNSTRUCTURED_MAX_REL and bw == UNSTRUCTURED_BANDWIDTH):
        return f"unstructured blockband: converged {conv} in {its} iterations, residual {rel:.3e}, bandwidth {bw}"
    del up, usp, sol, run, pc
    pts, tris = perturbed_mesh(8, UNSTRUCTURED_AMP, 1)
    its = {}
    for dev in (DEVICE, "cpu"):
        p = WaveControlProblem(ProblemConfig(N_x=8, N_t=8, dim=2), device=dev,
                               space=make_general_space(pts, tris, device=dev))
        s = p.solve(SolverConfig(rtol=1e-10))
        its[dev] = (int(s.result.iterations), bool(s.result.converged), s.u.cpu())
    du = rel_err(torch, its[DEVICE][2], its["cpu"][2])
    print(json.dumps({"phase": "unstructured_blockdense_card_vs_cpu", "N": 8, "N_t": 8, "dtype": "float64",
                      "iterations": [its[DEVICE][0], its["cpu"][0]], "u_rel": du}), flush=True)
    if not (its[DEVICE][:2] == its["cpu"][:2] and its[DEVICE][1] and du <= CARD_VS_CPU_U_TOL):
        return f"blockdense auto route card vs CPU: {its[DEVICE][:2]} vs {its['cpu'][:2]}, u {du:.3e} apart"

    # 30. the CLI: --dim 2 at the reference defaults, and --mesh-file
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv in (("cli_dim2_default", ["--dim", "2"]),
                           ("cli_mesh_file", ["--mesh-file", os.path.join(tmp, "mesh.npz"), "--nt", "16"])):
            if name == "cli_mesh_file":
                pts, tris = perturbed_mesh(16, UNSTRUCTURED_AMP, 2)
                np.savez(os.path.join(tmp, "mesh.npz"), points=pts, triangles=tris)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rec = cli(argv + ["--out", os.path.join(tmp, name)])
            rec = {k: v for k, v in rec.items() if k != "config"}
            print(json.dumps({"phase": name, "argv": argv[:1], **rec, "seconds": time.perf_counter() - t0,
                              "card": smi}), flush=True)
            if not rec["converged"]:
                return f"{name}: {rec}"

    # 31. batched tensor GMRES, float64, B = 3
    p = WaveControlProblem(ProblemConfig(N_x=32, N_t=32, dim=2), device=DEVICE)
    g = torch.Generator(DEVICE).manual_seed(6)
    bs = torch.stack([p.rhs] + [p.rhs * (1.0 + 0.5 * torch.randn(p.rhs.shape, dtype=f64, device=DEVICE, generator=g))
                                for _ in range(BATCHED_TENSOR_B - 1)])
    solve = build_tensor_gmres_solver(p.operator, rtol=1e-10, with_result=True)
    (xs, res), route, route_err = cgs2_route("batched_tensor_gmres", lambda: solve(bs))
    seq = [solve(bs[i]) for i in range(BATCHED_TENSOR_B)]
    its_b, its_s = [int(v) for v in res.iterations], [int(r.iterations) for _, r in seq]
    dx = max(rel_err(torch, xs[i], seq[i][0]) for i in range(BATCHED_TENSOR_B))
    print(json.dumps({"phase": "batched_tensor_gmres", "N_x": 32, "N_t": 32, "dtype": "float64", "B": BATCHED_TENSOR_B,
                      "iterations": its_b, "iterations_sequential": its_s, "x_rel_max_abs_vs_sequential": dx,
                      "tol": BATCHED_TENSOR_TOL, **route}), flush=True)
    if not (its_b == its_s and dx <= BATCHED_TENSOR_TOL and all(bool(c) for c in res.converged)):
        return f"batched tensor GMRES: iterations {its_b} vs {its_s}, lanes {dx:.3e} apart"
    if route_err:
        return route_err
    return None


# The generalized-eigenbasis solve of triangle meshes (phases 32-36): the
# gates of the JAX package's tests/test_sdc.py:51-79 for a float32 basis,
# and its bench's stage_unstructured (bench.py:523-548: host basis, eig
# GMRES, 1 iteration and rel_f64 1.99e-5 in its record) and
# stage_unstructured_eig (bench.py:704-822: n = 20449, N_t = 64, gate 5e-4;
# its SDC basis recorded 6.63e-5 at 8 steps).
EIG_BASIS_MAX_RES = 5e-3  # ||K V - M V lam||_F / ||K||_F
EIG_BASIS_MAX_ORTH = 5e-3  # ||V^T M V - I||_F
EIG_BASIS_MAX_LAM = 1e-3  # max |lam - lam_ref| / lam_max
EIG_GMRES = dict(rtol=1e-5, maxiter=20)
EIG_GMRES_MAX_ITERS, EIG_MAX_REL = 2, 5e-4
EIG_WALL_N, EIG_WALL_N_T = 144, 64  # n = 20449: 2,617,472 unknowns
EIG_SDC_N = 72  # n = 5041, past the default base_size of 2048
LAGRANGIAN_TOL = 1e-10


def basis_gates(torch, basis, M, K, lam_ref) -> dict:
    """The float32-basis gates of one pencil basis, in float64 on the card:
    ``res`` = ||K V - M V lam|| / ||K||, ``orth`` = ||V^T M V - I||, ``lam``
    = max |lam - lam_ref| / max lam_ref."""
    import numpy as np

    V = basis.V.double()
    lam = torch.from_numpy(basis.lam).to(V.device)
    MV = M @ V
    res = float(torch.linalg.norm(K @ V - MV * lam[None, :]) / torch.linalg.norm(K))
    G = V.mT @ MV
    G.diagonal().sub_(1.0)
    out = {"res": res, "orth": float(torch.linalg.norm(G)),
           "lam": float(np.abs(basis.lam - lam_ref).max() / lam_ref.max())}
    out["ok"] = out["res"] <= EIG_BASIS_MAX_RES and out["orth"] <= EIG_BASIS_MAX_ORTH and out["lam"] <= EIG_BASIS_MAX_LAM
    return out


def eig_richardson_roofline(n: int, N_t: int, steps: int) -> dict:
    """Roofline of one Richardson solve over an n x n float32 basis: ``steps
    + 1`` Woodbury applies, each two (2 N_t x n) @ (n x n) GEMMs (the
    residual-side V^T and the solution-side V) that read V once; the
    time-FFT, per-mode and matvec work is O(N_t n) and left out."""
    gemms = 2 * (steps + 1)
    return {"gemms": gemms, **roofline(gemms * (4 * n * n + 2 * 4 * 2 * N_t * n), gemms * 2 * (2 * N_t) * n * n)}


def eigbasis_phases(torch, smi, flush):
    """Phases 32-36 (module docstring): the pencil eigenbases of a triangle
    mesh on the card and the solves they drive. Prints one JSON line per
    result; returns None, or what failed."""
    import contextlib
    import io
    import tempfile
    import unittest.mock

    from optimal_control_paradiag_torch import LagrangianWaveProblem, ProblemConfig, SolverConfig, WaveControlProblem
    from optimal_control_paradiag_torch import run as cli_run
    from optimal_control_paradiag_torch.fem.general import make_general_space
    from optimal_control_paradiag_torch.models.wave import WaveSolution
    from optimal_control_paradiag_torch.paradiag import eigbasis as eigbasis_mod
    from optimal_control_paradiag_torch.paradiag.eigbasis import (
        build_eig_basis,
        build_eig_direct_fn,
        build_eig_gmres_solver,
        dense_pencil,
        load_eig_basis,
    )
    from optimal_control_paradiag_torch.paradiag.sdc import sdc_eigh

    f32 = torch.float32

    def built(sp, method, **kw):
        """(basis, its setup seconds by phase, the host wall seconds)."""
        timings = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        basis = build_eig_basis(sp, method=method, timings=timings, **kw)
        torch.cuda.synchronize()
        return basis, timings, time.perf_counter() - t0

    def pencil64(sp):
        M, K = dense_pencil(sp)
        return M.double(), K.double()

    # 32. the four bases at n = 961
    pts, tris = perturbed_mesh(UNSTRUCTURED_N, UNSTRUCTURED_AMP, 0)
    sp = make_general_space(pts, tris, dtype=f32, device=DEVICE)
    M, K = pencil64(sp)
    bases = {}
    for method, kw in (("host", {}), ("torch", {}), ("device", {}), ("sdc", {"base_size": 256})):
        bases[method], phases, secs = built(sp, method, **kw)
    lam_ref = bases["host"].lam
    for method, basis in bases.items():
        gates = basis_gates(torch, basis, M, K, lam_ref)
        extra = {"sdc_stats": {k: v for k, v in sdc_eigh.last_stats.items() if k != "ns_iters"}} if method == "sdc" else {}
        print(json.dumps({"phase": "eig_basis", "N": UNSTRUCTURED_N, "n": sp.n, "method": method,
                          "quality": basis.quality, **gates, "gates": [EIG_BASIS_MAX_RES, EIG_BASIS_MAX_ORTH,
                                                                       EIG_BASIS_MAX_LAM], **extra}), flush=True)
        if not gates["ok"]:
            return f"the {method!r} basis at n = {sp.n}: {gates}"
    # torch's float32 CUDA eigh at n <= 512 is cuSOLVER's Jacobi syevj: its
    # standard-form accuracy against syevd's (n = 961) and the port's route
    out = {}
    for N in (21, UNSTRUCTURED_N):
        jsp = make_general_space(*perturbed_mesh(N, UNSTRUCTURED_AMP, 0), dtype=f32, device=DEVICE)
        Mj, Kj = dense_pencil(jsp)
        L = torch.linalg.cholesky(Mj)
        S = torch.linalg.solve_triangular(L, torch.linalg.solve_triangular(L, Kj, upper=False).mT, upper=False).mT
        S = 0.5 * (S + S.mT)
        for label, (lam_s, Q_s) in (("torch_eigh", torch.linalg.eigh(S)), ("port_eigh", eigbasis_mod._eigh(S))):
            Sd, Qd, ld = S.double(), Q_s.double(), lam_s.double()
            G = Qd.mT @ Qd
            G.diagonal().sub_(1.0)
            out[f"n{jsp.n}_{label}"] = {"res": float(torch.linalg.norm(Sd @ Qd - Qd * ld) / torch.linalg.norm(Sd)),
                                        "orth": float(torch.linalg.norm(G))}
    print(json.dumps({"phase": "eigh_jacobi_range", "dtype": "float32", **out, "card": smi}), flush=True)
    for method in ("host", "torch", "device", "sdc"):  # setup seconds, rebuilt warm (first calls load libraries)
        _, phases, secs = built(sp, method, **({"base_size": 256} if method == "sdc" else {}))
        print(json.dumps({"phase": "eig_basis_setup", "n": sp.n, "method": method, "seconds": secs,
                          "phases_s": phases, "card": smi}), flush=True)
    del M, K

    # 33. the JAX bench's production tier: eig GMRES on the host basis
    up = WaveControlProblem(ProblemConfig(N_x=UNSTRUCTURED_N, N_t=UNSTRUCTURED_N_T, dim=2, dtype=f32), device=DEVICE,
                            space=sp)
    solve = build_eig_gmres_solver(up.operator, bases["host"], with_result=True, **EIG_GMRES)
    x, res = solve(up.rhs)
    its = int(res.iterations)
    rel = up.relative_residual_f64(WaveSolution(u=x[0], p=x[1], result=res))
    ms = timed(torch, smi, flush, "eig_gmres_solve", lambda: solve(up.rhs), 5, 2, n=sp.n, N_t=UNSTRUCTURED_N_T)
    wall, _, _ = wall_ms(torch, lambda: solve(up.rhs), 5, 2)
    print(json.dumps({"phase": "unstructured_eig_gmres", "N": UNSTRUCTURED_N, "n": sp.n, "N_t": UNSTRUCTURED_N_T,
                      "dtype": "float32", "eig_method": "host", **EIG_GMRES, "iterations": its,
                      "converged": bool(res.converged), "relative_residual_f64": rel, "jax_bench_iterations": 1,
                      "jax_bench_rel_f64": 1.99e-5, "gates": [EIG_GMRES_MAX_ITERS, EIG_MAX_REL], "ms": ms,
                      "host_wall_ms": wall, "card": smi}), flush=True)
    if not (its <= EIG_GMRES_MAX_ITERS and rel <= EIG_MAX_REL):
        return f"eig GMRES at n = {sp.n}: {its} iterations, residual {rel:.3e}"
    del up, solve, bases, sp

    # 34. the wall through the entry point: the 'auto' (cuSOLVER) basis
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pts, tris = perturbed_mesh(EIG_WALL_N, UNSTRUCTURED_AMP, 0)
    t0 = time.perf_counter()
    wsp = make_general_space(pts, tris, dtype=f32, device=DEVICE)
    wp = WaveControlProblem(ProblemConfig(N_x=EIG_WALL_N, N_t=EIG_WALL_N_T, dim=2, dtype=f32), device=DEVICE,
                            space=wsp)
    torch.cuda.synchronize()
    problem_s = time.perf_counter() - t0
    wcfg = SolverConfig(method="woodbury")
    t0 = time.perf_counter()
    sol = wp.solve(wcfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    steps, conv = int(sol.result.iterations), bool(sol.result.converged)
    rel = wp.relative_residual_f64(sol)
    run = wp.make_solver_fn(wcfg)
    ms = timed(torch, smi, flush, "eig_richardson_wall", lambda: run(wp.rhs), 5, 2, n=wsp.n, N_t=EIG_WALL_N_T)
    wall, _, _ = wall_ms(torch, lambda: run(wp.rhs), 5, 2)
    bound = eig_richardson_roofline(wsp.n, EIG_WALL_N_T, steps)
    print(json.dumps({"phase": "eig_wall_entry_point", "N": EIG_WALL_N, "n": wsp.n, "N_t": EIG_WALL_N_T,
                      "unknowns": 2 * EIG_WALL_N_T * wsp.n, "dtype": "float32", "eig_method": "auto",
                      "quality": wp._eig_basis.quality, "setup_s": wp.eig_setup_s, "problem_setup_s": problem_s,
                      "first_solve_s": first_s, "steps": steps, "converged": conv, "relative_residual_f64": rel,
                      "record_relative_residual": float(sol.result.residual_norm / torch.linalg.norm(wp.rhs).cpu()),
                      "gate": EIG_MAX_REL, "jax_bench_sdc_rel_f64_8_steps": 6.63e-5, "ms": ms, **bound,
                      "ms_over_bound": ms / bound["bound_ms"], "host_wall_ms": wall,
                      "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9, "card": smi}), flush=True)
    if not (conv and rel <= EIG_MAX_REL):
        return f"the wall (n = {wsp.n}): converged {conv} in {steps} steps, residual {rel:.3e}"
    del wp, wsp, sol, run
    torch.cuda.empty_cache()

    # 35. SDC on the card at n = 5041, against the 'device' basis
    pts, tris = perturbed_mesh(EIG_SDC_N, UNSTRUCTURED_AMP, 0)
    ssp = make_general_space(pts, tris, dtype=f32, device=DEVICE)
    dev_basis, dev_phases, dev_s = built(ssp, "device")
    sdc_basis, sdc_phases, sdc_s = built(ssp, "sdc")
    stats = {k: v for k, v in sdc_eigh.last_stats.items()}
    M, K = pencil64(ssp)
    gates = basis_gates(torch, sdc_basis, M, K, dev_basis.lam)
    dev_gates = basis_gates(torch, dev_basis, M, K, dev_basis.lam)
    del M, K
    sp_ = WaveControlProblem(ProblemConfig(N_x=EIG_SDC_N, N_t=EIG_WALL_N_T, dim=2, dtype=f32), device=DEVICE,
                             space=ssp)
    rels = {}
    for label, basis, steps in (("sdc", sdc_basis, 8), ("device", dev_basis, 2)):
        x, rec_rel = build_eig_direct_fn(sp_.operator, basis, steps=steps, with_residual=True)(sp_.rhs, basis.V)
        rels[label] = (steps, sp_.relative_residual_f64(WaveSolution(u=x[0], p=x[1], result=None)), float(rec_rel))
    print(json.dumps({"phase": "sdc_on_card", "N": EIG_SDC_N, "n": ssp.n, "base_size": 2048, "sdc_s": sdc_s,
                      "sdc_phases_s": sdc_phases, "device_s": dev_s, "device_phases_s": dev_phases,
                      "sdc_vs_device": gates, "device_self": dev_gates, "last_stats": stats,
                      "richardson": {k: {"steps": v[0], "relative_residual_f64": v[1], "record": v[2]}
                                     for k, v in rels.items()},
                      "gate": EIG_MAX_REL, "card": smi}), flush=True)
    if not (gates["ok"] and stats["splits"] >= 1 and rels["sdc"][1] <= EIG_MAX_REL):
        return f"SDC at n = {ssp.n}: {gates}, splits {stats['splits']}, 8-step residual {rels['sdc'][1]:.3e}"
    del sp_, ssp, dev_basis, sdc_basis

    # 36. the CLI's eigenbasis cache, and the Lagrangian oracle on the card
    with tempfile.TemporaryDirectory() as tmp, unittest.mock.patch.object(cli_run, "EIG_CACHE_DIR", tmp):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rec = cli_run.main(["--rebuild-eig-cache", "--nx", "48", "--eig-method", "device", "--out", tmp])
        secs = time.perf_counter() - t0
        pts, tris = perturbed_mesh(48, UNSTRUCTURED_AMP, 0)
        loaded = load_eig_basis(rec["path"], make_general_space(pts, tris, dtype=f32, device=DEVICE))
        print(json.dumps({"phase": "cli_rebuild_eig_cache", **{k: v for k, v in rec.items() if k != "path"},
                          "file_mb": os.path.getsize(rec["path"]) / 1e6, "loaded_quality": loaded.quality,
                          "seconds": secs, "card": smi}), flush=True)
        if not (rec["n"] == 47 * 47 and loaded.quality == "f32" == rec["quality"]):
            return f"--rebuild-eig-cache: {rec}, loaded quality {loaded.quality}"
    lag = {}
    for dev in (DEVICE, "cpu"):
        lp = LagrangianWaveProblem(ProblemConfig(N_x=8, N_t=8, scaled=False), device=dev)
        ls = lp.solve()
        lag[dev] = (ls.u.cpu(), lp.error_vs_analytic(ls), bool(ls.result.converged))
    du = rel_err(torch, lag[DEVICE][0], lag["cpu"][0])
    print(json.dumps({"phase": "lagrangian_card_vs_cpu", "N_x": 8, "N_t": 8, "dtype": "float64", "u_rel": du,
                      "error_vs_analytic": [lag[DEVICE][1], lag["cpu"][1]], "tol": LAGRANGIAN_TOL}), flush=True)
    if not (du <= LAGRANGIAN_TOL and lag[DEVICE][2] and abs(lag[DEVICE][1] - lag["cpu"][1]) <= LAGRANGIAN_TOL):
        return f"Lagrangian card vs CPU: u {du:.3e} apart, errors {lag[DEVICE][1]} / {lag['cpu'][1]}"
    return None


def sdc_wall(torch, smi) -> int:
    """``--sdc-wall``: the 'device' and 'sdc' bases of the wall mesh (n =
    20449), the gates of phase 32 between them, SDC's ``last_stats``, and
    the 8-step Richardson solve on the SDC basis (N_t = 64)."""
    from optimal_control_paradiag_torch import ProblemConfig, WaveControlProblem
    from optimal_control_paradiag_torch.fem.general import make_general_space
    from optimal_control_paradiag_torch.models.wave import WaveSolution
    from optimal_control_paradiag_torch.paradiag.eigbasis import build_eig_basis, build_eig_direct_fn, dense_pencil
    from optimal_control_paradiag_torch.paradiag.sdc import sdc_eigh

    pts, tris = perturbed_mesh(EIG_WALL_N, UNSTRUCTURED_AMP, 0)
    sp = make_general_space(pts, tris, dtype=torch.float32, device=DEVICE)
    out = {}
    for method in ("device", "sdc"):
        torch.cuda.reset_peak_memory_stats()
        timings = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        basis = build_eig_basis(sp, method=method, timings=timings)
        torch.cuda.synchronize()
        out[method] = (basis, time.perf_counter() - t0, timings, torch.cuda.max_memory_allocated() / 1e9)
    M, K = (A.double() for A in dense_pencil(sp))
    gates = basis_gates(torch, out["sdc"][0], M, K, out["device"][0].lam)
    del M, K
    torch.cuda.empty_cache()
    prob = WaveControlProblem(ProblemConfig(N_x=EIG_WALL_N, N_t=EIG_WALL_N_T, dim=2, dtype=torch.float32),
                              device=DEVICE, space=sp)
    basis = out["sdc"][0]
    x, rec = build_eig_direct_fn(prob.operator, basis, steps=8, with_residual=True)(prob.rhs, basis.V)
    rel = prob.relative_residual_f64(WaveSolution(u=x[0], p=x[1], result=None))
    stats = dict(sdc_eigh.last_stats)
    print(json.dumps({"phase": "sdc_wall", "N": EIG_WALL_N, "n": sp.n, "N_t": EIG_WALL_N_T,
                      **{f"{m}_s": v[1] for m, v in out.items()}, **{f"{m}_phases_s": v[2] for m, v in out.items()},
                      **{f"{m}_peak_device_gb": v[3] for m, v in out.items()}, "sdc_vs_device": gates,
                      "last_stats": stats, "richardson_8_steps_relative_residual_f64": rel,
                      "richardson_record": float(rec), "gate": EIG_MAX_REL, "card": smi}), flush=True)
    if not (gates["ok"] and rel <= EIG_MAX_REL):
        return fail(f"SDC at the wall: {gates}, 8-step residual {rel:.3e}")
    return 0


SHARDED = dict(N_x=2049, N_t=1024)  # bench_multichip.py:163-164, its on-chip shape: n = 2048, K = 513
SHARDED_VS_UNSHARDED_TOL = 1e-5  # float32, relative max-abs: the same 'dft' pipeline, moves and reductions
SHARDED_WAVE_MAX_REL = 2 * MAX_REL_RESIDUAL  # the 'dft' time transform: the transform candidates' gate
SHARDED_REF = dict(rtol=1e-8)  # the reference run's GMRES (tests/test_parallel.py:22-36: same count, 1e-8)
SHARDED_GMRES_X_TOL = 1e-10
SHARDED_MINRES = dict(method="minres", rtol=1e-10, maxiter=200)
SHARDED_MINRES_X_TOL = 1e-8  # tests/test_parallel.py:313-334
SHARDMAP_MATVEC_TOL = 1e-6
SHARDMAP_PC_TOL = 2e-4  # float32 split-real DFT + DST matmuls against the FFT fulldiag apply
DIRECT_COLLECTIVES = {"all_to_all": 6, "all_reduce": 3}


def sharded_phases(torch, smi, flush):
    """Phases 37-41: the sharded layer on a 1x1 grid of one NCCL rank
    (module docstring). Returns an error message or None."""
    import math

    import numpy as np

    from optimal_control_paradiag_torch import (
        HeatControlProblem,
        ProblemConfig,
        SolverConfig,
        WaveControlProblem,
        reference_1d_default,
    )
    from optimal_control_paradiag_torch.models.heat import HeatSolution
    from optimal_control_paradiag_torch.models.wave import WaveSolution
    from optimal_control_paradiag_torch.paradiag.pc import build_preconditioner
    from optimal_control_paradiag_torch.paradiag.spectral import build_woodbury_solver
    from optimal_control_paradiag_torch.parallel import multihost
    from optimal_control_paradiag_torch.parallel.sharding import make_layout
    from optimal_control_paradiag_torch.parallel.shardmap_ops import (
        build_shardmap_matvec,
        build_shardmap_preconditioner,
    )
    from optimal_control_paradiag_torch.parallel.solve import make_sharded_heat_solver, make_sharded_solver

    with multihost.group_of_one(device="cuda", timeout_s=300):
        layout = make_layout(1, 1)
        grid = {"grid": [1, 1], "backend": torch.distributed.get_backend(), "card": smi}

        def once(run, b):
            layout.counts.clear()
            x, res = run(b)
            torch.cuda.synchronize()
            return x, res, dict(layout.counts)

        # 37-38. the direct solves at the on-chip shape, wave and heat
        for family in ("wave", "heat"):
            if family == "wave":
                prob = WaveControlProblem(ProblemConfig(**SHARDED, dtype=torch.float32), device="cuda")
                run, sh = make_sharded_solver(prob, SolverConfig(method="woodbury"), layout)
                plain = build_woodbury_solver(prob.operator, refine=1, time_transform="dft")
                residual = lambda x: prob.relative_residual_f64(WaveSolution(*prob._unscale(x), result=None))
                gate = SHARDED_WAVE_MAX_REL
            else:
                prob = HeatControlProblem(ProblemConfig(**SHARDED, dtype=torch.float32), device="cuda")
                run, sh = make_sharded_heat_solver(prob, SolverConfig(method="woodbury"), layout)
                plain = prob.build_woodbury_solver(refine=1, time_transform="dft")
                s = math.sqrt(prob.config.gamma)
                residual = lambda x: prob.relative_residual_f64(HeatSolution(u=x[0] / s, p=x[1], result=None))
                gate = HEAT_MAX_REL_RESIDUAL
            if sh is None:
                return f"the sharded {family} solve calls the on-chip shape uneven on a 1x1 grid"
            b = sh.shard(prob.rhs)
            x, _, counts = once(run, b)
            x0 = plain(prob.rhs)
            diff = rel_err(torch, x, x0)
            rel, rel0 = residual(x), residual(x0)
            ms = timed(torch, smi, flush, f"sharded_{family}_woodbury", lambda: run(b), **grid, **SHARDED)
            ms0 = timed(torch, smi, flush, f"unsharded_{family}_woodbury_dft", lambda: plain(prob.rhs), **SHARDED)
            print(json.dumps({"phase": f"sharded_{family}_woodbury", **SHARDED, "dtype": "float32", **grid,
                              "collectives": counts, "rel_max_abs_vs_unsharded": diff,
                              "tol": SHARDED_VS_UNSHARDED_TOL, "relative_residual_f64": rel,
                              "unsharded_relative_residual_f64": rel0, "gate": gate,
                              "ms_per_solve": ms, "unsharded_ms_per_solve": ms0}), flush=True)
            if counts != DIRECT_COLLECTIVES:
                return f"the sharded {family} Woodbury solve issued {counts}, not {DIRECT_COLLECTIVES}"
            if not diff <= SHARDED_VS_UNSHARDED_TOL:
                return f"the sharded {family} Woodbury solve is {diff:.3e} from the unsharded one"
            if not (np.isfinite(rel) and rel <= gate):
                return f"the sharded {family} Woodbury residual {rel:.3e} > {gate}"
            del prob, run, plain, x, x0, b

        # 39-40. GMRES (fulldiag) and MINRES on the reference run, float64
        ref = WaveControlProblem(reference_1d_default(), device="cuda")
        N_t, n = ref.rhs.shape[-2:]
        for name, solver, x_tol in (("gmres_fulldiag", SolverConfig(**SHARDED_REF), SHARDED_GMRES_X_TOL),
                                    ("minres", SolverConfig(**SHARDED_MINRES), SHARDED_MINRES_X_TOL)):
            run, sh = make_sharded_solver(ref, solver, layout)
            b = sh.shard(ref.rhs) if sh is not None else ref.rhs
            x, res, counts = once(run, b)
            want = ref.solve(solver)
            x0 = torch.stack([want.u, want.p])
            diff = rel_err(torch, x, x0)
            its, its0 = int(res.iterations), int(want.result.iterations)
            resid = float(ref.residual_norm(WaveSolution(*ref._unscale(x), result=res)))
            ms = timed(torch, smi, None, f"sharded_{name}_reference", lambda: run(b), runs=5, warmup=1, **grid)
            ms0 = timed(torch, smi, None, f"unsharded_{name}_reference", lambda: ref.solve(solver), runs=5, warmup=1)
            print(json.dumps({"phase": f"sharded_{name}", "N_x": 80, "N_t": 81, "dtype": "float64", **grid,
                              "iterations": its, "unsharded_iterations": its0, "converged": bool(res.converged),
                              "rel_max_abs_vs_unsharded": diff, "tol": x_tol, "residual_norm": resid,
                              "collectives": counts, "ms_per_solve": ms, "unsharded_ms_per_solve": ms0}), flush=True)
            if counts.get("all_gather", 0):
                return f"sharded {name} all-gathered: {counts}"
            if not bool(res.converged) or (its != its0 if name.startswith("gmres") else abs(its - its0) > 1):
                return f"sharded {name} took {its} iterations, the unsharded solve {its0}"
            if not diff <= x_tol:
                return f"sharded {name} is {diff:.3e} from the unsharded solve"

        # 41. the explicit-collective matvec and preconditioner at the on-chip shape
        prob = WaveControlProblem(ProblemConfig(**SHARDED, dtype=torch.float32), device="cuda")
        op = prob.operator
        gen = torch.Generator(device="cuda").manual_seed(0)
        r = torch.randn(op.shape, generator=gen, device="cuda", dtype=torch.float32)
        mv, pc = build_shardmap_matvec(op, layout), build_shardmap_preconditioner(op, layout)
        pc0 = build_preconditioner(op)
        for name, fn, ref_fn, tol in (("matvec", mv, op.matvec, SHARDMAP_MATVEC_TOL),
                                      ("preconditioner", pc, pc0, SHARDMAP_PC_TOL)):
            layout.counts.clear()
            y = fn(r)
            torch.cuda.synchronize()
            counts = dict(layout.counts)
            err = rel_err(torch, y, ref_fn(r))
            ms = timed(torch, smi, flush, f"shardmap_{name}", lambda: fn(r), **grid, **SHARDED)
            ms0 = timed(torch, smi, flush, f"unsharded_{name}", lambda: ref_fn(r), **SHARDED)
            print(json.dumps({"phase": f"shardmap_{name}", **SHARDED, "dtype": "float32", **grid,
                              "collectives": counts, "rel_max_abs_vs_unsharded": err, "tol": tol,
                              "ms": ms, "unsharded_ms": ms0}), flush=True)
            if not err <= tol:
                return f"the explicit-collective {name} is {err:.3e} from the unsharded one"
        if torch.distributed.get_backend() != "nccl":
            return "the sharded phases ran on another backend than NCCL"
    return None


def cards_phases(torch, smi, cards: int):
    """``--cards N``: the sharded CLI on N cards (module docstring). Each
    case runs once per grid; the record's timings are single host-wall
    samples of the CLI's two solves, not a benchmark. Returns an error
    message or None."""
    import tempfile

    big = ["--nx", str(SHARDED["N_x"]), "--nt", str(SHARDED["N_t"]), "--dtype", "float32"]
    grids = [(1, 1)] + [(t, cards // t) for t in range(cards, 0, -1) if cards % t == 0]
    # (name, CLI arguments, float64-oracle gate, iterations or None); each on every grid
    cases = [
        ("wave_woodbury", big + ["--method", "woodbury"], SHARDED_WAVE_MAX_REL, None),
        ("wave_gmres_reference", ["--rtol", "1e-8"], 1e-10, 5),
        ("heat_woodbury", big + ["--method", "woodbury", "--model", "heat"], HEAT_MAX_REL_RESIDUAL, None),
        # N_t = 1022: uneven time blocks where the time axis has 4 ranks
        ("wave_woodbury_uneven", ["--nx", "2049", "--nt", "1022", "--dtype", "float32", "--method", "woodbury"],
         SHARDED_WAVE_MAX_REL, None),
        # MINRES's tail at rtol 1e-10 sits on a plateau near the threshold:
        # the reductions' order moves it by two iterations (20 or 22 on the
        # CPU), so its count is printed and its residual gated
        ("wave_minres_reference", ["--method", "minres", "--rtol", "1e-10"], 1e-8, None),
        ("wave_2d_consistent", ["--dim", "2", "--nx", "192", "--nt", "128", "--dtype", "float32", "--method",
                                "woodbury"], CONSISTENT_WAVE_MAX_REL, None),
        ("mesh_file_eig_woodbury", ["--mesh-file", "MESH", "--nx", "32", "--nt", "32", "--dtype", "float32",
                                    "--method", "woodbury"], EIG_MAX_REL, None),
    ]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cards_") as tmp:
        pts, tris = perturbed_mesh(32, 0.18, 0)
        np_mesh = os.path.join(tmp, "mesh.npz")
        import numpy as np

        np.savez(np_mesh, points=pts, triangles=tris)
        for name, argv, gate, iters in cases:
            argv = [np_mesh if a == "MESH" else a for a in argv]
            for nt, ns in grids:
                cmd = [sys.executable, "-m", "optimal_control_paradiag_torch.run", "--mesh", f"{nt},{ns}",
                       "--out", os.path.join(tmp, name), *argv]
                if nt * ns > 1:
                    cmd[1:1] = ["-m", "torch.distributed.run", "--standalone", f"--nproc-per-node={nt * ns}"]
                t0 = time.perf_counter()
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=HERE)
                if proc.returncode != 0:
                    return f"sharded CLI {name} on {nt}x{ns} exited {proc.returncode}: {proc.stderr[-2000:]}"
                out = proc.stdout
                rec = json.loads(out[out.index("{"):out.rindex("}") + 1])
                rel = rec["relative_residual_f64"]
                print(json.dumps({"phase": "sharded_cards", "case": name, "grid": [nt, ns], "cards": nt * ns,
                                  "backend": "nccl", "card": smi, "iterations": rec["iterations"],
                                  "relative_residual_f64": rel, "gate": gate, "collectives": rec["collectives"],
                                  "timings_ms": rec["timings_ms"], "run_s": time.perf_counter() - t0}), flush=True)
                if not rel <= gate:
                    return f"sharded CLI {name} on {nt}x{ns}: residual {rel:.3e} > {gate}"
                if iters is not None and rec["iterations"] != iters:
                    return f"sharded CLI {name} on {nt}x{ns}: {rec['iterations']} iterations, not {iters}"
                if rec["collectives"].get("all_gather", 0):
                    return f"sharded CLI {name} on {nt}x{ns} all-gathered"
    return None


# B3, the bf16x3 GEMM (phases 42-45): dst_precision='high' on the JAX bench's
# stage_woodbury_polished (bench.py:258-307: 'high' + refine = 1 + polish = 1
# at the headline, gate rel <= 5e-4), through the entry point with the fused
# kernel; the heat family takes the same option.


def time_pack_phases(torch, smi, flush):
    """Phase 46: the packed FFT's pack, split, merge and unpack kernels
    against their twins and timed; the direct solves through them, through
    the eager composition before the kernels and through two rffts. Prints
    one JSON line per result; returns (None, the T1-T4 entries of the
    ``kernels`` line), or (what failed, None)."""
    from optimal_control_paradiag_torch import HeatControlProblem, ProblemConfig, WaveControlProblem
    from optimal_control_paradiag_torch.ops import time_pack as tp
    from optimal_control_paradiag_torch.ops import transforms as tr
    from optimal_control_paradiag_torch.paradiag import cuda_heat as ch
    from optimal_control_paradiag_torch.paradiag import cuda_woodbury as cw
    from optimal_control_paradiag_torch.paradiag import spectral
    from optimal_control_paradiag_torch.utils.timing import counters

    def bits(t):
        r = torch.view_as_real(t.contiguous()) if t.is_complex() else t.contiguous()
        return r.view(torch.int32 if r.dtype == torch.float32 else torch.int64)

    def same_values(a, b):
        return a.shape == b.shape and a.dtype == b.dtype and torch.equal(bits(a), bits(b))

    def same(a, b):
        return a.stride() == b.stride() and same_values(a, b)

    def kernel_launches(fn):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.key.startswith(("Memcpy", "Memset")))

    def eager():  # the time transforms as the eager composition before the kernels
        return (unittest.mock.patch.object(spectral, "time_rfft_conj_packed", tr._time_rfft_conj_packed_reference),
                unittest.mock.patch.object(spectral, "time_irfft_conj_packed", tr._time_irfft_conj_packed_reference))

    ways = ("pack", "split", "merge", "unpack")
    launch_counters = tuple(f"time_pack.{w}.launches" for w in ways)
    gen = torch.Generator(device="cuda").manual_seed(46)
    ms, bounds = {}, {}
    K = N_T // 2 + 1
    n = N_X - 1
    for dtype in (torch.float32, torch.float64):
        for lanes in ((), (8,)):
            s = torch.randn(lanes + (2, N_T, n), dtype=dtype, device="cuda", generator=gen)
            Z = torch.fft.fft(tp.pack(s), dim=-2)  # cuFFT's output, as the split reads it
            cdt = Z.dtype
            xi = torch.randn(lanes + (2, K, n), dtype=cdt, device="cuda", generator=gen)
            z = torch.fft.ifft(tp.merge(xi, N_T), dim=-2, norm="forward")  # as the unpack reads it
            item = Z.element_size()
            B = lanes[0] if lanes else 1
            nbytes = {"split": B * item * (N_T * n + 2 * K * n),  # one read, one write
                      "pack": B * item * 2 * N_T * n}
            nbytes["merge"], nbytes["unpack"] = nbytes["split"], nbytes["pack"]
            before = {k: counters[k] for k in launch_counters}
            packed = tp.pack(s)
            checks = {"pack": same_values(tp.pack_reference(s), packed)
                      and packed.stride()[-2] == (1 if B > 1 else n),  # the layout cuFFT's plan reads
                      "pack_fft": same(torch.fft.fft(tp.pack_reference(s), dim=-2), torch.fft.fft(packed, dim=-2)),
                      "split": same(tp.split_reference(Z, N_T), tp.split(Z, N_T)),
                      "merge": same_values(tp.merge_reference(xi, N_T), tp.merge(xi, N_T)),
                      "unpack": same(tp.unpack_reference(z, N_T), tp.unpack(z, N_T)),
                      "forward": same(tr._time_rfft_conj_packed_reference(s, N_T), tr.time_rfft_conj_packed(s, N_T)),
                      "inverse": same(tr._time_irfft_conj_packed_reference(xi, N_T),
                                      tr.time_irfft_conj_packed(xi, N_T))}
            moved = {k: counters[k] - v for k, v in before.items()}
            label = f"{str(dtype)[6:]}_b{B}"
            print(json.dumps({"phase": "time_pack_bitwise", "case": label, "split_lanes": tp.check_split(Z, N_T),
                              "Z_strides": list(Z.stride()), "packed_strides": list(packed.stride()), **checks,
                              "counted": moved}), flush=True)
            if not all(checks.values()) or moved != {k: 2 for k in launch_counters}:
                return f"time_pack {label}: not bitwise the twin, or launches miscounted: {checks} {moved}", None
            bounds[label] = {w: roofline(nbytes[w], 0) for w in ways}
            if B > 1:  # torch's own copy to the plan's layout, which pack and merge now write
                pack_replaced = lambda: tp.pack_reference(s).transpose(-1, -2).contiguous()  # noqa: E731
            else:
                pack_replaced = lambda: tp.pack_reference(s)  # noqa: E731
            fns = {"pack": lambda: tp.pack(s), "pack_twin": lambda: tp.pack_reference(s),
                   "pack_replaced": pack_replaced,
                   "split": lambda: tp.split(Z, N_T), "split_twin": lambda: tp.split_reference(Z, N_T),
                   "merge": lambda: tp.merge(xi, N_T), "merge_twin": lambda: tp.merge_reference(xi, N_T),
                   "unpack": lambda: tp.unpack(z, N_T), "unpack_twin": lambda: tp.unpack_reference(z, N_T),
                   "forward": lambda: tr.time_rfft_conj_packed(s, N_T),
                   "forward_twin": lambda: tr._time_rfft_conj_packed_reference(s, N_T),
                   "inverse": lambda: tr.time_irfft_conj_packed(xi, N_T),
                   "inverse_twin": lambda: tr._time_irfft_conj_packed_reference(xi, N_T)}
            for name, fn in fns.items():
                way = name.split("_")[0]
                cold = timed(torch, smi, flush, f"time_pack_{name}_{label}", fn, bytes=nbytes.get(way))
                warm, _, _ = device_ms(torch, fn, None)
                ms[f"{name}_{label}"], ms[f"{name}_{label}_warm"] = cold, warm
                print(json.dumps({"timing": f"time_pack_{name}_{label}", "clock": "device", "l2": "warm",
                                  "median_ms": warm, "card": smi}), flush=True)
                if name in ways:
                    bound = bounds[label][name]
                    print(json.dumps({"phase": "time_pack_bound", "kernel": name, "case": label,
                                      "bytes": nbytes[name], "cold_ms": cold, "warm_ms": warm, **bound,
                                      "share_cold": bound["bound_ms"] / cold}), flush=True)
            del s, Z, xi, z, packed

    # the float32 headline direct solves and the 2D heat cell's: the kernels,
    # the eager composition before them, two rffts
    wave = WaveControlProblem(ProblemConfig(N_x=N_X, N_t=N_T, dtype=torch.float32), device="cuda")
    heat = HeatControlProblem(ProblemConfig(N_x=N_X, N_t=N_T, dtype=torch.float32), device="cuda")
    heat2d = HeatControlProblem(ProblemConfig(**HEAT_2D, dtype=torch.float32), device="cuda")
    def rffts(p):
        return rfft_solver(p.space, p.config.N_t, torch.float32, ch.fused_heat, ch.pack_heat_constants(p))

    cases = {"wave_single": (wave.rhs, cw.build_cuda_woodbury_solver(wave.operator),
                             rfft_solver(wave.space, N_T, torch.float32, cw.fused_woodbury,
                                         cw.pack_constants(wave.operator))),
             "heat_b8": (torch.stack([heat.rhs * (1.0 + 0.125 * i) for i in range(8)]),
                         ch.build_cuda_heat_solver(heat), rffts(heat)),
             "heat2d_b8": (torch.stack([heat2d.rhs * (1.0 + 0.125 * i) for i in range(8)]),
                           ch.build_cuda_heat_solver(heat2d), rffts(heat2d))}
    per_solve = {}
    for name, (b, packed, rffts) in cases.items():
        for k in launch_counters:
            counters[k] = 0
        x = packed(b)
        per_solve[name] = {k: counters[k] for k in launch_counters}
        patches = eager()
        with patches[0], patches[1]:
            x_eager = packed(b)
            eager_launches = kernel_launches(lambda: packed(b))
        if per_solve[name] != {k: 1 for k in launch_counters}:
            return f"the {name} solve did not launch one of each time_pack kernel: {per_solve[name]}", None
        if not same(x_eager, x):
            return f"the {name} solve through the kernels is not bitwise the eager composition's", None
        fns = {"kernels": lambda: packed(b), "rffts": lambda: rffts(b)}
        launches = {k: kernel_launches(f) for k, f in fns.items()}
        launches["eager"] = eager_launches
        device = {k: timed(torch, smi, flush, f"time_pack_solve_{name}_{k}", f) for k, f in fns.items()}
        patches = eager()
        with patches[0], patches[1]:
            device["eager"] = timed(torch, smi, flush, f"time_pack_solve_{name}_eager", lambda: packed(b))
        walls = {k: [] for k in ("kernels", "eager", "rffts")}
        for _ in range(3):  # in turns: kernels, eager composition, rffts
            for k in walls:
                if k == "eager":
                    patches = eager()
                    with patches[0], patches[1]:
                        walls[k].append(wall_ms(torch, lambda: packed(b))[0])
                else:
                    walls[k].append(wall_ms(torch, fns[k])[0])
        print(json.dumps({"phase": "time_pack_solves", "case": name, "lanes": b.shape[0] if b.dim() == 4 else 1,
                          "device_ms_l2_cold": device, "host_wall_ms": {k: statistics.median(v)
                                                                         for k, v in walls.items()},
                          "kernel_launches": launches, "counted": per_solve[name], "card": smi}), flush=True)
        del b, x, x_eager

    def entry(way, kernel, replaces):
        e = {
            "name": f"time_pack_{way}_cuda",
            "route": "cuda",
            "source": "optimal_control_paradiag_torch/csrc/time_pack.cu",
            "kernel": kernel,
            "replaces": replaces,
            "replaces_kind": "eager jnp glue around the FFT, which XLA fuses, not a pl.pallas_call",
            "launches": per_solve["wave_single"][f"time_pack.{way}.launches"],
            "launches_heat_b8": per_solve["heat_b8"][f"time_pack.{way}.launches"],
            "launches_heat2d_b8": per_solve["heat2d_b8"][f"time_pack.{way}.launches"],
            "max_abs_err": 0.0,  # bitwise the twin
            "ms": ms[f"{way}_float32_b1"],
            "warm_ms": ms[f"{way}_float32_b1_warm"],
            "plain_ms": ms[f"{way}_twin_float32_b1"],
            **bounds["float32_b1"][way],
            "library_ms": None,
            "ms_b8": ms[f"{way}_float32_b8"],
            "warm_ms_b8": ms[f"{way}_float32_b8_warm"],
            "bound_ms_b8": bounds["float32_b8"][way]["bound_ms"],
            "ms_f64": ms[f"{way}_float64_b1"],
            "bound_ms_f64": bounds["float64_b1"][way]["bound_ms"],
        }
        if way == "pack":  # torch.complex, and at B > 1 torch's copy to the plan's layout
            e["replaced_ms"], e["replaced_ms_b8"] = ms["pack_replaced_float32_b1"], ms["pack_replaced_float32_b8"]
        if way == "unpack":  # the normalisation's mul_ and the stack: the twin itself
            e["replaced_ms"], e["replaced_ms_b8"] = ms["unpack_twin_float32_b1"], ms["unpack_twin_float32_b8"]
        return e

    return None, [entry("split", "T1 time_pack_split_kernel", "optimal_control_paradiag_tpu/ops/transforms.py:282"),
                  entry("merge", "T2 time_pack_merge_rows_kernel / time_pack_merge_tiles_kernel",
                        "optimal_control_paradiag_tpu/ops/transforms.py:295"),
                  entry("pack", "T3 time_pack_pack_rows_kernel / time_pack_pack_tiles_kernel",
                        "optimal_control_paradiag_tpu/ops/transforms.py:282"),
                  entry("unpack", "T4 time_pack_unpack_kernel", "optimal_control_paradiag_tpu/ops/transforms.py:295")]


def cgs2_phases(torch, smi, flush):
    """Phase 47: CGS2's kernels (``csrc/cgs2.cu``) against their twin and
    timed at both GMRES cells' shapes and phase 25's float32 one. Prints
    one JSON line per result; returns (None, the C1 entry of the
    ``kernels`` line), or (what failed, None)."""
    from optimal_control_paradiag_torch.krylov.gmres import cgs2_reference
    from optimal_control_paradiag_torch.ops import cgs2 as cg
    from optimal_control_paradiag_torch.utils.timing import counters

    def rel(a, b):
        return max(float(torch.linalg.norm(a[i] - b[i]) / torch.linalg.norm(b[i])) for i in range(b.shape[0]))

    gen = torch.Generator(device="cuda").manual_seed(47)
    rows = max(CGS2_KS) + 2
    cases = {}
    for case, (B, m, dtype_name) in CGS2_CASES.items():
        dtype, tol = getattr(torch, dtype_name), CGS2_TOL[dtype_name]
        V = torch.empty((B, rows, m), dtype=dtype, device="cuda")
        v0 = torch.randn((B, m), dtype=dtype, device="cuda", generator=gen)
        V[:, 0] = v0 / torch.linalg.norm(v0, dim=1, keepdim=True)
        for k in range(rows - 1):  # an orthonormal basis, by the twin
            cgs2_reference(V, torch.randn((B, m), dtype=dtype, device="cuda", generator=gen), k)
        Vt = V.clone()
        for k in CGS2_KS:
            # a fresh w, not in the span of the rows an earlier k's timed calls rewrote
            w = torch.randn((B, m), dtype=dtype, device="cuda", generator=gen)
            Vt[:, : k + 1].copy_(V[:, : k + 1])
            before = counters["cgs2.launches"]
            H = cg.cgs2(V, w, k)
            torch.cuda.synchronize()
            launches = counters["cgs2.launches"] - before
            Ht = cgs2_reference(Vt, w, k)
            err_h, err_row = rel(H, Ht), rel(V[:, k + 1], Vt[:, k + 1])
            label = f"{case}_k{k}"
            if launches != cg.LAUNCHES_PER_STEP or not (err_h <= tol and err_row <= tol):
                return (f"cgs2 {label}: {launches} launches, Hessenberg {err_h:.3g} and row {err_row:.3g} "
                        "from the twin"), None
            nbytes = (3 * (k + 1) + 7) * B * m * V.element_size()
            bound = roofline(nbytes, 0)
            step = lambda: cg.cgs2(V, w, k)  # noqa: E731
            twin = lambda: cgs2_reference(Vt, w, k)  # noqa: E731
            cold = timed(torch, smi, flush, f"cgs2_{label}", step, bytes=nbytes)
            warm, _, _ = device_ms(torch, step, None)
            twin_ms = timed(torch, smi, flush, f"cgs2_twin_{label}", twin)
            out = {"lanes": B, "m": m, "dtype": dtype_name, "k": k, "bytes": nbytes, "ms": cold, "warm_ms": warm,
                   **bound, "share_cold": bound["bound_ms"] / cold, "launches": launches, "twin_ms": twin_ms,
                   "rel_err_h": err_h, "rel_err_row": err_row, "tol": tol}
            print(json.dumps({"phase": "cgs2", "case": label, **out, "card": smi}), flush=True)
            cases[label] = out
        del V, Vt, w, H, Ht
    # launches per Arnoldi step as this run counted them: phase 47's steps,
    # and the GMRES solves of phases 14, 25 and 31 (absent under --cgs2)
    per_step = {"cgs2_phase": sum(c["launches"] for c in cases.values()) / len(cases),
                **{label: c["cgs2_launches"] / c["krylov_steps"] for label, c in CGS2_ROUTE.items()}}
    return None, {"name": "cgs2_cuda", "route": "cuda", "source": "optimal_control_paradiag_torch/csrc/cgs2.cu",
                  "kernel": "C1 cgs2_pass_kernel (three passes) and cgs2_scale_kernel",
                  "replaces": "optimal_control_paradiag_tpu/krylov/gmres.py:159",
                  "replaces_kind": "two blocked jnp products a step, which XLA lowers, not a pl.pallas_call",
                  "launches_per_step": per_step, "route_counts": CGS2_ROUTE, "cases": cases}


def b3_library(torch, b3, a, b_hi, b_lo):
    """The same function from one library call per product: the split and
    three cuBLAS bf16 products with float32 output (``torch.mm(...,
    out_dtype=torch.float32)``), summed in the twin's order. A yardstick
    only: the port never calls it."""
    a_hi, a_lo = b3.split_bf16(a)
    mm = lambda x, y: torch.mm(x, y, out_dtype=torch.float32)
    return (mm(a_hi, b_lo) + mm(a_lo, b_hi)) + mm(a_hi, b_hi)


def b3_sass(path: str) -> dict:
    """Counts of HGMMA (wgmma), UTMALDG (a TMA load), SYNCS (mbarrier) and
    USETMAXREG (setmaxnreg) in the SASS of ``bf16x3_wgmma_kernel`` in the
    library at ``path`` (``cuobjdump -sass``); ``checked`` False, with the
    reason, where the tool or the kernel is missing."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {"checked": False, "reason": "cuobjdump not found"}
    proc = subprocess.run([tool, "-sass", path], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        return {"checked": False, "reason": f"cuobjdump failed: {proc.stderr.strip()[:300]}"}
    functions, name = {}, None
    for line in proc.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            functions[name] = []
        elif name is not None:
            functions[name].append(line)
    kernel = next((f for f in functions if "bf16x3_wgmma_kernel" in f), None)
    if kernel is None:
        return {"checked": False, "reason": f"no bf16x3_wgmma_kernel among {sorted(functions)}"}
    text = "\n".join(functions[kernel])
    return {"checked": True, "function": kernel,
            "counts": {op: len(re.findall(r"\b" + op + r"\b", text)) for op in ("HGMMA", "UTMALDG", "SYNCS", "USETMAXREG")}}


def bf16x3_phases(torch, smi, flush, wave_highest_polished: float, variants, sass: dict):
    """Phases 43-45 (module docstring). ``wave_highest_polished``: phase
    11's residual of the 'highest' polished wave headline; ``sass``: phase
    42's reading of the wgmma GEMM's SASS; ``variants``:
    the ``start_variant`` builds, ``b3_profile`` (``-DBF16X3_PROFILE``)
    among them. Returns (an error message or None, the kernels line's
    entries of B3's GEMM and of its split pass)."""
    import numpy as np

    from optimal_control_paradiag_torch import HeatControlProblem, ProblemConfig, SolverConfig, WaveControlProblem
    from optimal_control_paradiag_torch.cuda_build import declare
    from optimal_control_paradiag_torch.fem.space import make_space
    from optimal_control_paradiag_torch.ops import bf16x3 as b3
    from optimal_control_paradiag_torch.utils.timing import counters

    def high(cls, shape, prec="high"):
        return cls(ProblemConfig(**shape, dtype=torch.float32, dst_precision=prec), device="cuda")

    # 43. B3 against its twin on the card, both routes, at the main path's
    # shapes, ragged shapes and an all-positive sum (the drift case)
    wave, heat1, heat2 = high(WaveControlProblem, dict(N_x=N_X, N_t=N_T)), high(HeatControlProblem, HEAT_1D), \
        high(HeatControlProblem, HEAT_2D)
    rng = np.random.default_rng(12)
    rand = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
    positive = lambda *shape: torch.from_numpy(rng.uniform(0.0, 1.0, shape).astype(np.float32)).cuda()

    def sine64(N_x):
        i = np.arange(1, N_x)
        return torch.from_numpy(np.sin(np.pi * np.outer(i, i) / N_x)).cuda()

    ws, hs = wave.space.dst_matrix_split, heat2.space.dst_matrix_split
    ws_mma = b3.split_matrix(wave.space.dst_matrix, route="mma")  # PR 12's kernel at the headline
    hs_mma = b3.split_matrix(heat2.space.dst_matrix, route="mma")  # and on the heat 2D axis
    n1, n2 = wave.space.n1d, heat2.space.n1d
    Vw, Vh = sine64(N_X), sine64(HEAT_2D["N_x"])
    gx = heat2.rhs.reshape(-1, n2)
    gy = b3.bf16x3_matmul(gx, hs).reshape(-1, n2, n2).transpose(-1, -2).contiguous().reshape(-1, n2)
    b_odd = {shape: rand(*shape) for shape in ((1, 1), (33, 9), (65, 200), (600, 1))}
    b_pos, a_pos = positive(n1, 512), positive(512, n1)
    a_batched = rand(8 * 2 * N_T, n1)
    odd = lambda shape, route=None: (b3.split_matrix(b_odd[shape], route), b_odd[shape].double())
    cases = [  # label, A, split B, float64 B, float64 gate
        ("headline DST, main-path rhs", wave.rhs.reshape(-1, n1), ws, Vw, True),
        ("headline DST, random", rand(2 * N_T, n1), ws, Vw, True),
        ("batched DST (B = 8), random", a_batched, ws, Vw, True),
        ("headline DST, main-path rhs, 'mma' route", wave.rhs.reshape(-1, n1), ws_mma, Vw, True),
        ("batched DST (B = 8), random, 'mma' route", a_batched, ws_mma, Vw, True),
        ("heat 2D x axis, main-path rhs", gx, hs, Vh, True),
        ("heat 2D y axis, main-path rhs", gy, hs, Vh, True),
        ("heat 2D axis, random", rand(2 * HEAT_2D["N_t"] * n2, n2), hs, Vh, True),
        ("heat 2D x axis, main-path rhs, 'mma' route", gx, hs_mma, Vh, True),
        ("M = 1 DST, random", rand(1, n1), ws, Vw, True),
        ("M = 129 DST, random", rand(129, n1), ws, Vw, True),
        ("1 x 1 x 1", rand(1, 1), *odd((1, 1)), False),
        ("17 x 33 x 9", rand(17, 33), *odd((33, 9)), False),
        ("300 x 65 x 200, 'wgmma' route", rand(300, 65), *odd((65, 200), "wgmma"), True),
        ("200 x 600 x 1, 'wgmma' route", rand(200, 600), *odd((600, 1), "wgmma"), True),
        ("drift: positive 512 x 2047 x 512, 'wgmma' route", a_pos, b3.split_matrix(b_pos, "wgmma"), b_pos.double(), True),
        ("drift: positive 512 x 2047 x 512, 'mma' route", a_pos, b3.split_matrix(b_pos, "mma"), b_pos.double(), True),
    ]
    max_abs_err = None
    for label, a, split, b64, gate64 in cases:
        out = b3.bf16x3_matmul(a, split)
        torch.cuda.synchronize()
        twin = b3.bf16x3_matmul_reference(a, split.hi, split.lo)
        err = rel_err(torch, out, twin)
        err64 = rel_err(torch, out.double(), a.double() @ b64)
        print(json.dumps({"phase": "b3_vs_twin", "case": label, "route": split.route, "M": a.shape[0], "K": a.shape[1],
                          "N": split.n, "rel_max_abs_err": err, "tol": B3_TOL,
                          "twin_vs_float64": rel_err(torch, twin.double(), a.double() @ b64),
                          "kernel_vs_float64": err64, "float64_gate": B3_F64_TOL if gate64 else None}), flush=True)
        if not err <= B3_TOL:
            return f"B3 disagrees with its twin ({label}): {err:.3e} > {B3_TOL:.0e}", None
        if gate64 and not err64 <= B3_F64_TOL:
            return f"B3 misses the float64 product ({label}): {err64:.3e} > {B3_F64_TOL:.0e}", None
        if max_abs_err is None:
            max_abs_err = (out - twin).abs().max().item()
    del gy, cases, b_odd, a_pos, b_pos
    # the split pass, bitwise the twin's split
    a = wave.rhs.reshape(-1, n1)
    ld = b3.padded_width(n1)
    planes = b3.split_rows(a, ld)
    plain_planes = b3.split_rows_reference(a, ld)
    bitwise = bool(torch.equal(planes, plain_planes))
    split_err = (planes.float() - plain_planes.float()).abs().max().item()
    del planes, plain_planes
    print(json.dumps({"phase": "b3_split_bitwise", "M": a.shape[0], "K": n1, "ld": ld, "bitwise": bitwise,
                      "max_abs_err": split_err}), flush=True)
    if not bitwise:
        return "the split pass differs from split_bf16", None
    # the crossover table of the two routes (M = 2048, N = K), each timed in
    # turns ('mma', 'wgmma', 'wgmma', 'mma'), both held to the twin
    crossover = []
    for m, k in ((2048, 32), (2048, 64), (2048, 96), (2048, 128), (2048, 255), (2048, 512), (2048, 1023),
                 (2048, 2047), (2 * HEAT_2D["N_t"] * n2, n2)):
        ak, bk = rand(m, k), rand(k, k)
        splits = {route: b3.split_matrix(bk, route) for route in b3.ROUTES}
        turns = {route: [] for route in b3.ROUTES}
        for route in ("mma", "wgmma", "wgmma", "mma"):
            turns[route].append(device_ms(torch, lambda s=splits[route]: b3.bf16x3_matmul(ak, s), flush)[0])
        errs = {route: rel_err(torch, b3.bf16x3_matmul(ak, s), b3.bf16x3_matmul_reference(ak, s.hi, s.lo))
                for route, s in splits.items()}
        row = {"K": k, "M": m, "N": k, **{f"{r}_ms": statistics.mean(t) for r, t in turns.items()},
               **{f"{r}_turns_ms": t for r, t in turns.items()}, **{f"{r}_rel_err": e for r, e in errs.items()},
               "faster": min(b3.ROUTES, key=lambda r: statistics.mean(turns[r])), "rule": b3.bf16x3_route(k, k),
               "card": smi}
        print(json.dumps({"phase": "b3_crossover", **row}), flush=True)
        if max(errs.values()) > B3_TOL:
            return f"B3 disagrees with its twin in the crossover table at K = {k}: {errs}", None
        crossover.append([m, k, row["mma_ms"], row["wgmma_ms"]])

    # 44. the 'high' polished paths through the entry points, each with the
    # counts of B3's GEMM (all, and its 'wgmma' route), of the split pass and
    # of the family's kernel set to 0 just before and read just after: B3
    # once per DST (per axis in 2D), two DSTs per base solve, and two base
    # solves with polish = 1
    pol = SolverConfig(method="woodbury", use_pallas=True, polish=1)
    axis_wgmma = int(hs.route == "wgmma")
    runs = {}
    for name, prob, cfg, fused, want in (
        ("wave_headline_high_polished", wave, pol, "b1.launches", (4, 4, 4, 2)),
        ("wave_headline_high_unpolished", wave, SolverConfig(method="woodbury", use_pallas=True), "b1.launches",
         (2, 2, 2, 1)),
        ("heat_1d_high_polished", heat1, pol, "b2.launches", (4, 4, 4, 2)),
        ("heat_2d_high_polished", heat2, pol, "b2.launches", (8, 8 * axis_wgmma, 8 * axis_wgmma, 2)),
    ):
        counters["b3.launches"] = counters["b3.launches.wgmma"] = counters["b3.split.launches"] = counters[fused] = 0
        t0 = time.perf_counter()
        sol = prob.solve(cfg)
        torch.cuda.synchronize()
        first_solve_s = time.perf_counter() - t0
        launches = (counters["b3.launches"], counters["b3.launches.wgmma"], counters["b3.split.launches"], counters[fused])
        if launches != want:
            return f"{name} launched (B3, B3 'wgmma', split pass, fused) {launches}, not {want}", None
        if sol.u.shape != (prob.config.N_t, prob.space.n) or not (torch.isfinite(sol.u).all() and torch.isfinite(sol.p).all()):
            return f"{name}: the solution is not finite or has {tuple(sol.u.shape)}", None
        runs[name] = (prob.relative_residual_f64(sol), launches, first_solve_s)
    highest = {"wave_headline": wave_highest_polished}
    heat_highest = {}
    for label, shape in (("heat_1d", HEAT_1D), ("heat_2d", HEAT_2D)):
        heat_highest[label] = high(HeatControlProblem, shape, "highest")
        highest[label] = heat_highest[label].relative_residual_f64(heat_highest[label].solve(pol))
    gates = {"wave_headline_high_polished": min(WAVE_HIGH_MAX_REL_RESIDUAL, HIGH_RESIDUAL_FACTOR * highest["wave_headline"]),
             "wave_headline_high_unpolished": None,
             "heat_1d_high_polished": HEAT_MAX_REL_RESIDUAL,
             "heat_2d_high_polished": HIGH_RESIDUAL_FACTOR * highest["heat_2d"]}
    for name, (rel, launches, first_solve_s) in runs.items():
        ref = highest["_".join(name.split("_")[:2])]
        print(json.dumps({"phase": "b3_main_path", "case": name, "dtype": "float32", "dst_precision": "high",
                          "b3_launches": launches[0], "b3_wgmma_launches": launches[1], "split_launches": launches[2],
                          "fused_launches": launches[3],
                          "first_solve_s": first_solve_s, "relative_residual_f64": rel,
                          "highest_polished_residual": ref, "ratio_to_highest_polished": rel / ref,
                          "gate": gates[name]}), flush=True)
        if gates[name] is not None and not rel <= gates[name]:
            return f"{name}: residual {rel:.3e} > {gates[name]:.3e}", None

    # 45. times: B3 at the headline and batched, the new route beside PR 12's
    # kernel in turns, the split pass alone, the twin, the library
    # composition and the FP32 cuBLAS DST; the polished solves 'high'
    # against 'highest'
    b_hi, b_lo = ws.hi.contiguous(), ws.lo.contiguous()
    library_note = None
    try:
        lib_err = rel_err(torch, b3_library(torch, b3, a, b_hi, b_lo), b3.bf16x3_matmul_reference(a, ws.hi, ws.lo))
        print(json.dumps({"phase": "b3_library_vs_twin", "rel_max_abs_err": lib_err, "gate": None}), flush=True)
    except (TypeError, RuntimeError) as exc:
        library_note = f"torch.mm(..., out_dtype=torch.float32) unavailable in torch {torch.__version__}: {exc}"[:300]
    full = make_space(1, N_X, dtype=torch.float32, device="cuda")
    batched = torch.stack([wave.rhs] * 8)
    ab = batched.reshape(-1, n1)
    ms = {}
    for label, operand, new, previous in (("headline", a, ws, ws_mma), ("batched", ab, ws, ws_mma),
                                          ("heat_2d_axis", gx, hs, hs_mma)):
        for route, split in (("previous", previous), ("new", new), ("new", new), ("previous", previous)):
            ms.setdefault(f"b3_{label}_{route}", []).append(
                timed(torch, smi, flush, f"b3_{label}_{route}", lambda x=operand, s=split: b3.bf16x3_matmul(x, s),
                      kernel_route=split.route))
    ms = {name: statistics.mean(t) for name, t in ms.items()}
    wave_fns = {prec: high(WaveControlProblem, dict(N_x=N_X, N_t=N_T), prec).make_solver_fn(pol) for prec in ("high", "highest")}
    timings = {
        "b3_split_headline": lambda: b3.split_rows(a, ld),
        "b3_split_plain_headline": lambda: b3.split_rows_reference(a, ld),
        "b3_twin_headline": lambda: b3.bf16x3_matmul_reference(a, ws.hi, ws.lo),
        "dst_fp32_cublas_headline": lambda: full.dst(wave.rhs),
        "dst_bf16x3_headline": lambda: wave.space.dst(wave.rhs),
        "dst_bf16x3_heat_2d": lambda: heat2.space.dst(heat2.rhs),
        "wave_solve_polished_high": lambda: wave_fns["high"](wave.rhs),
        "wave_solve_polished_highest": lambda: wave_fns["highest"](wave.rhs),
    }
    if library_note is None:
        timings["b3_library_headline"] = lambda: b3_library(torch, b3, a, b_hi, b_lo)
    for label, hp in (("heat_1d", heat1), ("heat_2d", heat2)):
        timings[f"{label}_solve_polished_high"] = lambda f=hp.build_polished_solver(polish=1, use_pallas=True), b=hp.rhs: f(b)
        hh = heat_highest[label]
        timings[f"{label}_solve_polished_highest"] = lambda f=hh.build_polished_solver(polish=1, use_pallas=True), b=hh.rhs: f(b)
    ms.update({name: timed(torch, smi, flush, name, fn) for name, fn in timings.items()})
    # where a block's time goes (the profile build, clock64 sums of consumer
    # warpgroup 0's thread 0, medians over blocks)
    plib = finish_variant(variants["b3_profile"])
    plib.bf16x3_profile_read.argtypes = [ctypes.c_void_p]
    plib = declare(plib, b3.WGMMA_SIGNATURES, "bf16x3_wgmma_error_string")
    c = torch.empty(a.shape[0], ws.n, device="cuda")
    for _ in range(3):
        b3.wgmma_into(plib, a, ws, c)
    torch.cuda.synchronize()
    marks = np.zeros((1024, 8), dtype=np.int64)
    if plib.bf16x3_profile_read(marks.ctypes.data) != 0:
        return "reading the B3 profile failed", None
    blocks = -(-a.shape[0] // 128) * -(-ws.n // 128)
    marks = marks[:min(blocks, 1024)]
    med = lambda x: float(np.median(x))
    # blocks in the order each SM ran them: the gap between one block's last
    # mark and the next block's first on the same SM
    gaps = [b[4] - a_[6] for sm in np.unique(marks[:, 7])
            for a_, b in itertools.pairwise(sorted(marks[marks[:, 7] == sm].tolist(), key=lambda r: r[4]))]
    profile = {"blocks": int(marks.shape[0]), "stages": -(-n1 // 64), "sms_used": int(np.unique(marks[:, 7]).size),
               **{f"{k}_cycles_median": med(marks[:, j])
                  for j, k in enumerate(("mainloop", "consumer_waits_for_a_stage", "consumer_products_and_release"))},
               "mainloop_ns_median": med(marks[:, 5] - marks[:, 4]),
               "epilogue_ns_median": med(marks[:, 6] - marks[:, 5]),
               "sm_clock_ghz_median": med(marks[:, 0] / np.maximum(marks[:, 5] - marks[:, 4], 1)),
               "span_ns": int(marks[:, 6].max() - marks[:, 4].min()),
               "second_block_gap_ns_median": med(gaps) if gaps else None,
               "last_block_start_ns": int(marks[:, 4].max() - marks[:, 4].min())}
    print(json.dumps({"phase": "b3_profile", **profile, "card": smi}), flush=True)
    # the wrapper's host cost per call (enqueue, no synchronize), in turns:
    # each route and one FP32 torch.mm
    host = {"mma": [], "wgmma": [], "torch_mm_fp32": []}
    fns = {"mma": lambda: b3.bf16x3_matmul(a, ws_mma), "wgmma": lambda: b3.bf16x3_matmul(a, ws),
           "torch_mm_fp32": lambda: torch.mm(a, wave.space.dst_matrix)}
    for _ in range(7):
        for name, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            host[name].append((time.perf_counter() - t0) / 200 * 1e6)
            torch.cuda.synchronize()
    host_us = {name: min(v) for name, v in host.items()}
    print(json.dumps({"phase": "b3_host_cost", "us_per_call_min": host_us, "us_per_call": host, "card": smi}), flush=True)
    # the polished wave solves' host wall, 'high' and 'highest' interleaved
    walls = {"high": [], "highest": []}
    for prec in walls:
        for _ in range(WARMUP):
            wave_fns[prec](wave.rhs)
    for i in range(30):
        for prec in (("high", "highest") if i % 2 == 0 else ("highest", "high")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wave_fns[prec](wave.rhs)
            torch.cuda.synchronize()
            walls[prec].append((time.perf_counter() - t0) * 1e3)
    for prec, w in walls.items():
        print(json.dumps({"timing": f"wave_solve_polished_{prec}", "clock": "host_wall", "interleaved": True,
                          "median_ms": statistics.median(w), "min_ms": min(w), "max_ms": max(w), "runs": len(w),
                          "card": smi}), flush=True)

    def bound(M, K, N):
        # A read and C written once in float32, both B planes read once; three bf16 products
        return roofline(4 * M * K + 2 * 2 * K * N + 4 * M * N, 3 * 2 * M * N * K, BF16_FLOPS_PER_S)

    head = bound(*a.shape, ws.n)
    axis = bound(*gx.shape, hs.n)
    entry = {
        "name": "bf16x3_gemm_cuda",
        "route": "cuda",
        "source": "optimal_control_paradiag_torch/csrc/bf16x3_wgmma.cu",
        "source_small_k": "optimal_control_paradiag_torch/csrc/bf16x3_gemm.cu",
        "replaces": "optimal_control_paradiag_tpu/fem/space.py:317",
        "replaces_kind": "XLA's Precision.HIGH dot (P1Space.dst, the four-step plans), not a pl.pallas_call",
        "launches": runs["wave_headline_high_polished"][1][0],
        "wgmma_launches": runs["wave_headline_high_polished"][1][1],
        "split_launches": runs["wave_headline_high_polished"][1][2],
        "kernel_route": ws.route,
        "max_abs_err": max_abs_err,
        "ms": ms["b3_headline_new"],
        "previous_ms": ms["b3_headline_previous"],
        "split_ms": ms["b3_split_headline"],
        "plain_ms": ms["b3_twin_headline"],
        **head,
        "library_ms": ms.get("b3_library_headline"),
        "library_note": library_note,
        "fp32_cublas_dst_ms": ms["dst_fp32_cublas_headline"],
        "batched_ms": ms["b3_batched_new"],
        "batched_previous_ms": ms["b3_batched_previous"],
        "batched_bound_ms": bound(*ab.shape, ws.n)["bound_ms"],
        "launches_2d": runs["heat_2d_high_polished"][1][0],
        "kernel_route_2d_axis": hs.route,
        "ms_2d_axis": ms["b3_heat_2d_axis_new"],
        "previous_ms_2d_axis": ms["b3_heat_2d_axis_previous"],
        "bound_ms_2d_axis": axis["bound_ms"],
        "bound_by_2d_axis": axis["bound_by"],
        "crossover_m_k_mma_wgmma_ms": crossover,
        "host_us_per_call": host_us,
        "profile": profile,
        "sass": sass,
    }
    split = {
        "name": "bf16x3_split_cuda",
        "route": "cuda",
        "source": "optimal_control_paradiag_torch/csrc/bf16x3_wgmma.cu",
        "replaces": "optimal_control_paradiag_tpu/fem/space.py:317",
        "replaces_kind": "the operand split of XLA's Precision.HIGH dot, not a pl.pallas_call",
        "launches": runs["wave_headline_high_polished"][1][2],
        "max_abs_err": split_err,
        "ms": ms["b3_split_headline"],
        "plain_ms": ms["b3_split_plain_headline"],
        # A read once in float32, both planes written once; the split's few
        # float32 operations per element are far below either rate
        **roofline(4 * a.numel() + 2 * 2 * a.shape[0] * ld, 3 * a.numel()),
        "library_ms": None,
    }
    return None, [entry, split]


def bf16x3_alone(torch, smi, kind, variants, sass) -> int:
    """``--bf16x3``: phases 43-45 after the builds, with phase 11's
    'highest' polished wave headline solved here for their gate."""
    from optimal_control_paradiag_torch import ProblemConfig, SolverConfig, WaveControlProblem

    wave = WaveControlProblem(ProblemConfig(N_x=N_X, N_t=N_T, dtype=torch.float32), device="cuda")
    rel_pol = wave.relative_residual_f64(wave.solve(SolverConfig(method="woodbury", use_pallas=True, polish=1)))
    print(json.dumps({"phase": "wave_polish", "N_x": N_X, "N_t": N_T, "dtype": "float32", "polish": 1,
                      "relative_residual_f64": rel_pol}), flush=True)
    del wave
    err, b3_entries = bf16x3_phases(torch, smi, torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda"), rel_pol,
                                    variants, sass)
    if err:
        return fail(err)
    print(json.dumps({"kernels": b3_entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this smoke needs a CUDA card")
    import optimal_control_paradiag_torch as port

    if not os.path.abspath(port.__file__).startswith(HERE + os.sep):
        return fail(f"the port was imported from {port.__file__}, not from this checkout")
    from optimal_control_paradiag_torch import (
        HeatControlProblem,
        ProblemConfig,
        SolverConfig,
        WaveControlProblem,
        reference_1d_default,
    )
    from optimal_control_paradiag_torch.cuda_build import load_library
    from optimal_control_paradiag_torch.ops import bf16x3 as b3
    from optimal_control_paradiag_torch.ops.transforms import (
        time_irfft_conj_packed,
        time_rfft_conj_packed,
    )
    from optimal_control_paradiag_torch.paradiag import cuda_heat as ch
    from optimal_control_paradiag_torch.paradiag import cuda_woodbury as cw
    from optimal_control_paradiag_torch.paradiag import fused
    from optimal_control_paradiag_torch.paradiag.spectral import (
        _capacity_matrices,
        build_polished_solver,
        spectral_relative_residual,
    )
    from optimal_control_paradiag_torch.utils.timing import counters

    import numpy as np

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if "--cards" in sys.argv[1:]:
        cards = int(sys.argv[sys.argv.index("--cards") + 1])
        if torch.cuda.device_count() < cards:
            return fail(f"--cards {cards}: {torch.cuda.device_count()} card(s) visible")
        err = cards_phases(torch, smi, cards)
        if err:
            return fail(err)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--sharded" in sys.argv[1:]:
        err = sharded_phases(torch, smi, torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda"))
        if err:
            return fail(err)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--time-pack" in sys.argv[1:]:
        from optimal_control_paradiag_torch.ops import time_pack as tp

        built = load_library(tp.KERNEL_SOURCE)
        print(json.dumps({"phase": "build", "source": tp.KERNEL_SOURCE, "nvcc_s": built.seconds}), flush=True)
        print_ptxas(built.log)
        err, tp_entries = time_pack_phases(torch, smi, torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda"))
        if err:
            return fail(err)
        print(json.dumps({"kernels": tp_entries}), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--cgs2" in sys.argv[1:]:
        from optimal_control_paradiag_torch.ops import cgs2 as cg

        built = load_library(cg.KERNEL_SOURCE)
        print(json.dumps({"phase": "build", "source": cg.KERNEL_SOURCE, "nvcc_s": built.seconds}), flush=True)
        print_ptxas(built.log)
        err, c1 = cgs2_phases(torch, smi, torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda"))
        if err:
            return fail(err)
        print(json.dumps({"kernels": [c1]}), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--sdc-wall" in sys.argv[1:]:
        code = sdc_wall(torch, smi)
        if code == 0:
            print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                     "count": torch.cuda.device_count()}}), flush=True)
        return code

    # 2. build the six sources and the measurement variants, all at once
    b3_only = "--bf16x3" in sys.argv[1:]
    t0 = time.perf_counter()
    variants = {"b3_profile": start_variant(b3.WGMMA_SOURCE, "BF16X3_PROFILE")}
    if not b3_only:
        variants.update({
            "woodbury_profile": start_variant(cw.KERNEL.source, "WOODBURY_PROFILE"),
            "heat_profile": start_variant(ch.KERNEL.source, "HEAT_WOODBURY_PROFILE"),
            "heat_profile_skip_b": start_variant(ch.KERNEL.source, "HEAT_WOODBURY_PROFILE", "HEAT_WOODBURY_SKIP_B"),
            "heat_planes": start_variant(ch.KERNEL.source, "HEAT_WOODBURY_PLANES")})
    from optimal_control_paradiag_torch.ops import cgs2 as cg
    from optimal_control_paradiag_torch.ops import time_pack as tp

    sources = (cw.KERNEL.source, ch.KERNEL.source, b3.KERNEL_SOURCE, b3.WGMMA_SOURCE, tp.KERNEL_SOURCE,
               cg.KERNEL_SOURCE)
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        builds = list(zip(sources, pool.map(load_library, sources)))
    for source, built in builds:
        print(json.dumps({"phase": "build", "source": source, "nvcc_s": built.seconds,
                          "load_s": time.perf_counter() - t0}), flush=True)
        print_ptxas(built.log)
    # 42. the wgmma GEMM's SASS: tensor-core wgmma (HGMMA) and TMA loads (UTMALDG)
    sass = b3_sass(dict(builds)[b3.WGMMA_SOURCE].lib._name)
    print(json.dumps({"phase": "b3_sass", **sass}), flush=True)
    if not sass["checked"]:
        return fail(f"bf16x3_wgmma_kernel's SASS could not be checked: {sass['reason']}")
    if not (sass["counts"]["HGMMA"] and sass["counts"]["UTMALDG"]):
        return fail(f"bf16x3_wgmma_kernel's SASS lacks HGMMA or UTMALDG: {sass['counts']}")
    if b3_only:
        return bf16x3_alone(torch, smi, kind, variants, sass)

    # 3. both kernels vs the twin at the main path's shapes
    prob = WaveControlProblem(ProblemConfig(N_x=N_X, N_t=N_T, dtype=torch.float32), device="cuda")
    op = prob.operator
    consts = cw.pack_constants(op)
    K, n = consts.a11r.shape
    b_hat = time_rfft_conj_packed(prob.space.dst(prob.rhs), N_T)  # the main path's kernel input
    kernels = {"slab": cw.fused_woodbury, "streaming": streaming(cw.KERNEL)}
    for itemsize in (4, 8):
        sched = fused.schedule(cw.KERNEL, K, n, itemsize)
        print(json.dumps({"phase": "woodbury_schedule", "K": K, "n": n, "itemsize": itemsize,
                          **dataclasses.asdict(sched), "blocks": -(-n // sched.cols)}), flush=True)
        if sched.kind != "slab":
            return fail(f"the main path's shape takes the {sched.kind} schedule, not the slab")
    x_kernel = cw.fused_woodbury(b_hat, consts, 1)
    x_stream = streaming(cw.KERNEL)(b_hat, consts, 1)
    torch.cuda.synchronize()
    x_twin = cw.fused_woodbury_reference(b_hat, consts, 1)
    max_abs_err = (x_kernel - x_twin).abs().max().item()
    checks = [("slab", "float32 main-path input", K, n, rel_err(torch, x_kernel, x_twin), TOL_F32),
              ("streaming", "float32 main-path input", K, n, rel_err(torch, x_stream, x_twin), TOL_F32)]
    prob64 = WaveControlProblem(ProblemConfig(N_x=N_X, N_t=N_T, dtype=torch.float64), device="cuda")
    consts64 = cw.pack_constants(prob64.operator)
    b_hat64 = time_rfft_conj_packed(prob64.space.dst(prob64.rhs), N_T)
    rng = np.random.default_rng(0)
    noise = torch.from_numpy(rng.standard_normal((2, K, n)) + 1j * rng.standard_normal((2, K, n)))
    for label, bh, c, tol in (
        ("float32 random", noise.to(torch.complex64).cuda(), consts, TOL_F32),
        ("float64 main-path input", b_hat64, consts64, TOL_F64),
        ("float64 random", noise.cuda(), consts64, TOL_F64),
    ):
        x_ref = cw.fused_woodbury_reference(bh, c, 1)
        for which, fn in kernels.items():
            xk = fn(bh, c, 1)
            torch.cuda.synchronize()
            checks.append((which, label, K, n, rel_err(torch, xk, x_ref), tol))
    # The schedule's own choice at a long K: 5001 bins, 440 KB per column in
    # float64, over what a block may hold, at the headline's time step
    # (T = 20). The imaginary part of its capacity matrices is 8.6e-11 of
    # the real one, close to the plan's 1e-10 limit, so the real part is
    # taken unchecked: the kernel and the twin compute the same function of
    # any constants.
    plong = WaveControlProblem(ProblemConfig(N_x=8, N_t=10000, T=20.0, dtype=torch.float64), device="cuda")
    with unittest.mock.patch.object(cw, "_real_capacity_matrices", lambda pl: _capacity_matrices(pl).real):
        clong = cw.pack_constants(plong.operator)
    sched = fused.schedule(cw.KERNEL, *clong.a11r.shape, 8)
    print(json.dumps({"phase": "woodbury_schedule", "K": clong.a11r.shape[0], "n": clong.a11r.shape[1],
                      "itemsize": 8, **dataclasses.asdict(sched)}), flush=True)
    if sched.kind != "streaming":
        return fail(f"the long-K shape takes the {sched.kind} schedule, not the streaming one")
    bl = time_rfft_conj_packed(plong.space.dst(plong.rhs), 10000)
    xk = cw.fused_woodbury(bl, clong, 1)
    torch.cuda.synchronize()
    checks.append(("streaming (own choice)", "float64 main-path input, N_t = 10000, T = 20", *clong.a11r.shape,
                   rel_err(torch, xk, cw.fused_woodbury_reference(bl, clong, 1)), TOL_F64))
    del plong, clong, bl
    # How far each float32 solve lies from the float64 one on the same input.
    x_exact = cw.fused_woodbury_reference(b_hat.to(torch.complex128), consts64, 1)
    print(json.dumps({"phase": "float32_vs_float64", "K": K, "n": n,
                      "kernel_rel_err": rel_err(torch, x_kernel.to(torch.complex128), x_exact),
                      "streaming_rel_err": rel_err(torch, x_stream.to(torch.complex128), x_exact),
                      "twin_rel_err": rel_err(torch, x_twin.to(torch.complex128), x_exact)}), flush=True)
    # Outside the main path (refine != 1), printed and not gated: how far the
    # kernel's summation order moves x on a random input.
    for label, bh, c in (("float32 random", noise.to(torch.complex64).cuda(), consts),
                         ("float64 random", noise.cuda(), consts64)):
        for refine in (0, 2):
            xk = cw.fused_woodbury(bh, c, refine)
            torch.cuda.synchronize()
            print(json.dumps({"phase": "reorder_sensitivity", "case": label, "refine": refine,
                              "rel_max_abs_err": rel_err(torch, xk, cw.fused_woodbury_reference(bh, c, refine)),
                              "gate": None}), flush=True)
    del prob64, consts64, b_hat64, x_exact, x_stream
    for which, label, ck, cn, err, tol in checks:
        print(json.dumps({"phase": "kernel_vs_twin", "kernel": which, "case": label, "K": ck, "n": cn,
                          "rel_max_abs_err": err, "tol": tol}), flush=True)
        if not err <= tol:
            return fail(f"the {which} kernel disagrees with its twin ({label}): {err:.3e} > {tol:.0e}")

    # 4. the main path, through the user entry point
    cfg = SolverConfig(method="woodbury", use_pallas=True)
    counters["b1.launches"] = 0
    t0 = time.perf_counter()
    sol = prob.solve(cfg)
    torch.cuda.synchronize()
    first_solve_s = time.perf_counter() - t0
    launches = counters["b1.launches"]
    if launches < 1:
        return fail("the main path did not launch the fused Woodbury kernel")
    if sol.u.shape != (N_T, n) or sol.u.dtype != torch.float32 or not sol.u.is_cuda:
        return fail(f"solution u has {tuple(sol.u.shape)} {sol.u.dtype} on {sol.u.device}")
    if not (torch.isfinite(sol.u).all() and torch.isfinite(sol.p).all()):
        return fail("the headline solution is not finite")
    rel = prob.relative_residual_f64(sol)
    print(json.dumps({"phase": "main_path", "N_x": N_X, "N_t": N_T, "dtype": "float32",
                      "launches": launches, "first_solve_s": first_solve_s,
                      "relative_residual_f64": rel, "gate": MAX_REL_RESIDUAL}), flush=True)
    if not rel <= MAX_REL_RESIDUAL:
        return fail(f"headline residual {rel:.3e} > {MAX_REL_RESIDUAL}")

    ref_gpu = WaveControlProblem(reference_1d_default(), device="cuda")
    ref_cpu = WaveControlProblem(reference_1d_default(), device="cpu")
    e_gpu = ref_gpu.error_aligned(ref_gpu.solve(cfg))
    e_cpu = ref_cpu.error_aligned(ref_cpu.solve(cfg))
    print(json.dumps({"phase": "reference_1d_default", "dtype": "float64",
                      "error_aligned_cuda": e_gpu, "error_aligned_cpu": e_cpu}), flush=True)
    if not abs(e_gpu - e_cpu) <= ERROR_ALIGNED_TOL:
        return fail(f"error_aligned differs between card and CPU: {e_gpu!r} vs {e_cpu!r}")

    # 5. timings at the headline shape
    solve_fn = prob.make_solver_fn(cfg)
    plain_fn = prob.make_solver_fn(SolverConfig(method="woodbury", use_pallas=False))
    rhs = prob.rhs
    s = prob.space.dst(rhs)
    # the slab narrowed to two columns per block, so that two blocks fit on an SM
    two = fused.slab_schedule(cw.KERNEL, K, 2, 4)
    if not 2 * (two.smem_bytes + 1024) <= 228 * 1024:
        return fail(f"the C = 2 slab takes {two.smem_bytes} B: two blocks no longer fit on an SM")
    print(json.dumps({"phase": "woodbury_schedule", "K": K, "n": n, "itemsize": 4,
                      **dataclasses.asdict(two), "blocks": -(-n // two.cols)}), flush=True)
    timings = {
        "solve_cuda_kernel": lambda: solve_fn(rhs),
        "solve_plain_torch": lambda: plain_fn(rhs),
        "woodbury_kernel": lambda: cw.fused_woodbury(b_hat, consts, 1),
        "woodbury_kernel_streaming": lambda: streaming(cw.KERNEL)(b_hat, consts, 1),
        "woodbury_kernel_two_per_sm": lambda: fused.launch(cw.KERNEL, b_hat, consts, 1, two),
        "woodbury_twin": lambda: cw.fused_woodbury_reference(b_hat, consts, 1),
        "dst_matmul": lambda: prob.space.dst(rhs),
        "packed_fft_roundtrip": lambda: time_irfft_conj_packed(time_rfft_conj_packed(s, N_T), N_T),
    }
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    ms = {}
    for name, fn in timings.items():
        med, lo, hi = device_ms(torch, fn, flush)
        ms[name] = med
        print(json.dumps({"timing": name, "clock": "device", "l2": "cold", "median_ms": med, "min_ms": lo,
                          "max_ms": hi, "runs": RUNS, "card": smi}), flush=True)
    print(json.dumps({"phase": "slab_profile", "K": K, "n": n, "dtype": "float32", **dataclasses.asdict(fused.schedule(cw.KERNEL, K, n, 4)),
                      "sms": torch.cuda.get_device_properties(0).multi_processor_count,
                      **slab_profile(torch, cw, finish_variant(variants["woodbury_profile"]), b_hat, consts,
                                     fused.schedule(cw.KERNEL, K, n, 4))}), flush=True)
    for name in ("woodbury_kernel", "woodbury_kernel_streaming"):
        med, lo, hi = device_ms(torch, timings[name], None)
        ms[name + "_warm"] = med
        print(json.dumps({"timing": name, "clock": "device", "l2": "warm", "median_ms": med, "min_ms": lo,
                          "max_ms": hi, "runs": RUNS, "card": smi}), flush=True)
    for name in ("solve_cuda_kernel", "solve_plain_torch"):
        med, lo, hi = wall_ms(torch, timings[name])
        print(json.dumps({"timing": name, "clock": "host_wall", "median_ms": med, "min_ms": lo,
                          "max_ms": hi, "runs": RUNS, "card": smi}), flush=True)

    b1 = {
        "name": "woodbury_fused_cuda",
        "route": "cuda",
        "source": "optimal_control_paradiag_torch/csrc/woodbury.cu",
        "replaces": "optimal_control_paradiag_tpu/paradiag/pallas_woodbury.py:48",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms["woodbury_kernel"],
        "plain_ms": ms["woodbury_twin"],
        # each input read once, x written once; refine = 1: W (80 flops per
        # element) + A_hat and W again (140)
        **roofline(4 * (11 * K * n + 20 * n + 16 * K), K * n * (80 + 140 * 1)),
        "library_ms": None,
        "streaming_ms": ms["woodbury_kernel_streaming"],
    }
    if not ms["woodbury_kernel"] < ms["woodbury_kernel_streaming"]:
        print(json.dumps({"phase": "warning", "what": "the slab kernel is not faster than the streaming one, L2 cold",
                          "ms": ms["woodbury_kernel"], "streaming_ms": ms["woodbury_kernel_streaming"]}), flush=True)
    wave_rel, wave_prob = rel, prob
    del prob, consts, b_hat, x_kernel, x_twin, s

    # 6-7. both heat kernels vs the twin at both heat shapes, refine = 1 (the
    # main path), with the schedule each dtype takes
    heat = {}
    heat_kernels = {"slab": ch.fused_heat, "streaming": streaming(ch.KERNEL)}
    for label, shape in (("1d", HEAT_1D), ("2d", HEAT_2D)):
        p32 = HeatControlProblem(ProblemConfig(**shape, dtype=torch.float32), device="cuda")
        p64 = HeatControlProblem(ProblemConfig(**shape, dtype=torch.float64), device="cuda")
        c32, c64 = ch.pack_heat_constants(p32), ch.pack_heat_constants(p64)
        hK, hn = c32.a11r.shape
        for c in (c32, c64):
            print(json.dumps({"phase": "heat_schedule", "shape": label, "K": hK, "n": hn,
                              "itemsize": c.a11r.element_size(), **dataclasses.asdict(c.schedule),
                              "blocks": -(-hn // c.schedule.cols)}), flush=True)
            if c.schedule.kind != "slab":
                return fail(f"the heat {label} shape takes the {c.schedule.kind} schedule, not the slab")
        bh32 = time_rfft_conj_packed(p32.space.dst(p32.rhs), shape["N_t"])
        bh64 = time_rfft_conj_packed(p64.space.dst(p64.rhs), shape["N_t"])
        rng = np.random.default_rng(1)
        noise = torch.from_numpy(rng.standard_normal((2, hK, hn)) + 1j * rng.standard_normal((2, hK, hn)))
        for case, bh, c, tol in (
            ("float32 main-path input", bh32, c32, HEAT_TOL_F32),
            ("float32 random", noise.to(torch.complex64).cuda(), c32, HEAT_TOL_F32),
            ("float64 main-path input", bh64, c64, TOL_F64),
            ("float64 random", noise.cuda(), c64, TOL_F64),
        ):
            xt = ch.fused_heat_reference(bh, c, 1)
            x_exact = ch.fused_heat_reference(bh.to(torch.complex128), c64, 1) if bh.dtype == torch.complex64 else None
            for which, fn in heat_kernels.items():
                xk = fn(bh, c, 1)
                torch.cuda.synchronize()
                err = rel_err(torch, xk, xt)
                out = {"phase": "heat_kernel_vs_twin", "kernel": which, "shape": label, "case": case, "K": hK,
                       "n": hn, "rel_max_abs_err": err, "tol": tol}
                if x_exact is not None:
                    # how far each float32 solve lies from the float64 one on the same input
                    out["kernel_vs_float64"] = rel_err(torch, xk.to(torch.complex128), x_exact)
                    out["twin_vs_float64"] = rel_err(torch, xt.to(torch.complex128), x_exact)
                print(json.dumps(out), flush=True)
                if not err <= tol:
                    return fail(f"heat {which} kernel disagrees with its twin ({label}, {case}): {err:.3e} > {tol:.0e}")
                if case == "float32 main-path input" and which == "slab":
                    heat[label] = (p32, c32, bh32, (xk - xt).abs().max().item())
        del p64, c64, bh64, noise

    # 8-9. the heat main paths, through the user entry point
    def b2_kinds():  # B2 launches by schedule kind, as counted
        return {k: counters["b2.launches." + k] for k in ("slab", "streaming") if counters["b2.launches." + k]}

    cfg = SolverConfig(method="woodbury", use_pallas=True)
    heat_launches = {}
    for label, shape in (("1d", HEAT_1D), ("2d", HEAT_2D)):
        hp = heat[label][0]
        counters["b2.launches"] = counters["b2.launches.slab"] = counters["b2.launches.streaming"] = 0
        t0 = time.perf_counter()
        sol = hp.solve(cfg)
        torch.cuda.synchronize()
        first_solve_s = time.perf_counter() - t0
        hlaunches, hkinds = counters["b2.launches"], b2_kinds()
        if hlaunches < 1:
            return fail(f"the heat {label} main path did not launch the fused heat kernel")
        if hkinds != {"slab": hlaunches}:
            return fail(f"the heat {label} main path launched {hkinds}, not the slab kernel alone")
        heat_launches[label] = (hlaunches, hkinds)
        if sol.u.shape != (shape["N_t"], hp.space.n) or sol.u.dtype != torch.float32 or not sol.u.is_cuda:
            return fail(f"heat {label} solution u has {tuple(sol.u.shape)} {sol.u.dtype} on {sol.u.device}")
        if not (torch.isfinite(sol.u).all() and torch.isfinite(sol.p).all()):
            return fail(f"the heat {label} solution is not finite")
        hrel = hp.relative_residual_f64(sol)
        # the polished two-float solve on the same kernel
        counters["b2.launches"] = counters["b2.launches.slab"] = counters["b2.launches.streaming"] = 0
        x, e = build_polished_solver(hp, polish=1, dword=True, base_solver=ch.build_cuda_heat_solver(hp))(hp.rhs)
        torch.cuda.synchronize()
        dword_launches = counters["b2.launches"]
        if b2_kinds() != {"slab": dword_launches}:
            return fail(f"the heat {label} dword solve launched {b2_kinds()}, not the slab kernel alone")
        bb = hp.rhs.double().cpu().numpy()
        r = hp.matvec_host_f64(x.double().cpu().numpy() + e.double().cpu().numpy()) - bb
        rel_dword = float(np.linalg.norm(r.ravel()) / np.linalg.norm(bb.ravel()))
        print(json.dumps({"phase": f"heat_{label}_main_path", **shape, "dtype": "float32",
                          "launches": hlaunches, "launches_by_kind": hkinds, "first_solve_s": first_solve_s,
                          "relative_residual_f64": hrel, "gate": HEAT_MAX_REL_RESIDUAL if label == "1d" else None,
                          "error_vs_analytic": hp.error_vs_analytic(sol), "dword_launches": dword_launches,
                          "relative_residual_f64_dword": rel_dword, "dword_gate": DWORD_MAX_REL_RESIDUAL}), flush=True)
        if label == "1d" and not hrel <= HEAT_MAX_REL_RESIDUAL:
            return fail(f"heat 1D headline residual {hrel:.3e} > {HEAT_MAX_REL_RESIDUAL}")
        if not rel_dword <= DWORD_MAX_REL_RESIDUAL:
            return fail(f"heat {label} dword residual {rel_dword:.3e} > {DWORD_MAX_REL_RESIDUAL}")

    # 10. small heat problems in float64, card vs CPU
    for shape in (dict(N_x=64, N_t=16, dim=2, mass="lumped"), dict(N_x=128, N_t=32)):
        errs = []
        for dev in ("cuda", "cpu"):
            hp = HeatControlProblem(ProblemConfig(**shape), device=dev)
            errs.append(hp.error_vs_analytic(hp.solve(cfg)))
        e_gpu, e_cpu = errs
        print(json.dumps({"phase": "heat_card_vs_cpu", **shape, "dtype": "float64",
                          "error_vs_analytic_cuda": e_gpu, "error_vs_analytic_cpu": e_cpu}), flush=True)
        if not abs(e_gpu - e_cpu) <= ERROR_ALIGNED_TOL:
            return fail(f"heat error_vs_analytic differs between card and CPU: {e_gpu!r} vs {e_cpu!r}")

    # 11. the wave headline with physical-space polish
    pol_cfg = SolverConfig(method="woodbury", use_pallas=True, polish=1)
    counters["b1.launches"] = 0
    wsol = wave_prob.solve(pol_cfg)
    torch.cuda.synchronize()
    wave_pol_launches = counters["b1.launches"]
    rel_pol = wave_prob.relative_residual_f64(wsol)
    wop = wave_prob.operator
    x, e = build_polished_solver(wop, polish=1, dword=True, base_solver=cw.build_cuda_woodbury_solver(wop))(wave_prob.rhs)
    rel_pol_dword = spectral_relative_residual(
        wop, x.double().cpu().numpy() + e.double().cpu().numpy(), wave_prob.rhs.double().cpu().numpy())
    print(json.dumps({"phase": "wave_polish", "N_x": N_X, "N_t": N_T, "dtype": "float32", "polish": 1,
                      "launches": wave_pol_launches, "relative_residual_f64": rel_pol,
                      "relative_residual_f64_polish0": wave_rel, "gate": MAX_REL_RESIDUAL,
                      "relative_residual_f64_dword": rel_pol_dword}), flush=True)
    if wave_pol_launches < 1:
        return fail("the wave polish path did not launch the fused Woodbury kernel")
    if not (rel_pol <= MAX_REL_RESIDUAL and rel_pol <= wave_rel):
        return fail(f"wave polish=1 residual {rel_pol:.3e} above {MAX_REL_RESIDUAL} or the polish=0 {wave_rel:.3e}")

    # 12. timings of the heat and polished paths, and of the heat kernels
    planes = fused.declare_library(ch.KERNEL, finish_variant(variants["heat_planes"]))  # constants loaded from the (K, n) planes
    wave_pol_fn = wave_prob.make_solver_fn(pol_cfg)
    wrhs = wave_prob.rhs
    timings = {
        "wave_solve_polished": lambda: wave_pol_fn(wrhs),
        "wave_matvec": lambda: wop.matvec(wrhs),
        "wave_matvec_accurate": lambda: wop.matvec_accurate(wrhs),
    }
    for label in ("1d", "2d"):
        hp, hc, hb, _ = heat[label]
        fns = (ch.build_cuda_heat_solver(hp), hp.build_woodbury_solver(),
               hp.build_polished_solver(polish=1, use_pallas=True))
        timings.update({
            f"heat_{label}_solve_cuda_kernel": lambda f=fns[0], b=hp.rhs: f(b),
            f"heat_{label}_solve_plain_torch": lambda f=fns[1], b=hp.rhs: f(b),
            f"heat_{label}_solve_polished": lambda f=fns[2], b=hp.rhs: f(b),
            f"heat_{label}_kernel": lambda b=hb, c=hc: ch.fused_heat(b, c, 1),
            f"heat_{label}_kernel_streaming": lambda b=hb, c=hc: streaming(ch.KERNEL)(b, c, 1),
            f"heat_{label}_kernel_planes": lambda b=hb, c=hc: fused.launch(ch.KERNEL, b, c, 1, c.schedule, planes),
            f"heat_{label}_twin": lambda b=hb, c=hc: ch.fused_heat_reference(b, c, 1),
            f"heat_{label}_dst_matmul": lambda sp=hp.space, b=hp.rhs: sp.dst(b),
            f"heat_{label}_packed_fft_roundtrip": lambda t=hp.space.dst(hp.rhs), N=hp.config.N_t: (
                time_irfft_conj_packed(time_rfft_conj_packed(t, N), N)),
            f"heat_{label}_matvec": lambda p=hp: p.matvec(p.rhs),
            f"heat_{label}_matvec_accurate": lambda p=hp: p.matvec_accurate(p.rhs),
        })
    for name, fn in timings.items():
        med, lo, hi = device_ms(torch, fn, flush)
        ms[name] = med
        print(json.dumps({"timing": name, "clock": "device", "l2": "cold", "median_ms": med, "min_ms": lo,
                          "max_ms": hi, "runs": RUNS, "card": smi}), flush=True)
    for label in ("1d", "2d"):
        for name in (f"heat_{label}_kernel", f"heat_{label}_kernel_streaming", f"heat_{label}_kernel_planes"):
            med, lo, hi = device_ms(torch, timings[name], None)
            ms[name + "_warm"] = med
            print(json.dumps({"timing": name, "clock": "device", "l2": "warm", "median_ms": med, "min_ms": lo,
                              "max_ms": hi, "runs": RUNS, "card": smi}), flush=True)
    # the heat slab's profile, and that of a build whose load sweep leaves b
    # out (its x is wrong: it times the sweep without b's copies)
    hprofs = {}
    for build in ("heat_profile", "heat_profile_skip_b"):
        hprofs[build] = fused.declare_library(ch.KERNEL, finish_variant(variants[build]))
        hprofs[build].heat_woodbury_profile_read.argtypes = [ctypes.c_void_p]
    for label, build in itertools.product(("1d", "2d"), hprofs):
        _, hc, hb, _ = heat[label]
        hK, hn = hc.a11r.shape
        lib = hprofs[build]
        prof = block_profile(torch, lambda b=hb, c=hc, lib=lib: fused.launch(ch.KERNEL, b, c, 1, c.schedule, lib),
                             lib.heat_woodbury_profile_read, -(-hn // hc.schedule.cols))
        print(json.dumps({"phase": "heat_slab_profile" + build[len("heat_profile"):], "shape": label, "K": hK,
                          "n": hn, "dtype": "float32", **dataclasses.asdict(hc.schedule),
                          "sms": torch.cuda.get_device_properties(0).multi_processor_count, **prof}), flush=True)
    for label in ("1d", "2d"):
        if not ms[f"heat_{label}_kernel"] < ms[f"heat_{label}_kernel_streaming"]:
            print(json.dumps({"phase": "warning", "what": f"the heat slab kernel is not faster than the streaming one "
                              f"at the {label} shape, L2 cold", "ms": ms[f"heat_{label}_kernel"],
                              "streaming_ms": ms[f"heat_{label}_kernel_streaming"]}), flush=True)
    for name in ("heat_1d_solve_cuda_kernel", "heat_2d_solve_cuda_kernel", "heat_1d_solve_polished",
                 "wave_solve_polished"):
        med, lo, hi = wall_ms(torch, timings[name])
        print(json.dumps({"timing": name, "clock": "host_wall", "median_ms": med, "min_ms": lo,
                          "max_ms": hi, "runs": RUNS, "card": smi}), flush=True)
    heat_bounds = {}
    for label in ("1d", "2d"):
        hK, hn = heat[label][1].a11r.shape
        # each input read once, x written once; refine = 1: W (64 flops per
        # element) + A_hat and W again (108)
        heat_bounds[label] = roofline(4 * (11 * hK * hn + 6 * hn + 8 * hK), hK * hn * (64 + 108 * 1))
        print(json.dumps({"phase": "heat_kernel_bound", "shape": label, "K": hK, "n": hn,
                          "ms": ms[f"heat_{label}_kernel"], **heat_bounds[label]}), flush=True)

    b2 = {
        "name": "heat_woodbury_fused_cuda",
        "route": "cuda",
        "source": "optimal_control_paradiag_torch/csrc/heat_woodbury.cu",
        "replaces": "optimal_control_paradiag_tpu/paradiag/pallas_heat.py:35",
        "launches": heat_launches["1d"][0],
        "max_abs_err": heat["1d"][3],
        "ms": ms["heat_1d_kernel"],
        "plain_ms": ms["heat_1d_twin"],
        **heat_bounds["1d"],
        "library_ms": None,
        "launches_by_kind": heat_launches["1d"][1],
        "streaming_ms": ms["heat_1d_kernel_streaming"],
        # the 2D lumped shape (K = 33, n = 65025)
        "launches_2d": heat_launches["2d"][0],
        "max_abs_err_2d": heat["2d"][3],
        "ms_2d": ms["heat_2d_kernel"],
        "plain_ms_2d": ms["heat_2d_twin"],
        "bound_ms_2d": heat_bounds["2d"]["bound_ms"],
        "bound_by_2d": heat_bounds["2d"]["bound_by"],
        "streaming_ms_2d": ms["heat_2d_kernel_streaming"],
    }
    err = gmres_phases(torch, smi, flush)
    if err:
        return fail(err)
    err = transform_phases(torch, smi, flush, {"ms": ms["solve_cuda_kernel"], "rel": wave_rel})
    if err:
        return fail(err)
    err = cli_phases(torch, smi)
    if err:
        return fail(err)
    err, batched = batched_phases(torch, smi, flush)
    if err:
        return fail(err)
    b1.update(batched["wave"])
    b2.update(batched["heat"])
    err = krylov_direct_phases(torch, smi, flush)
    if err:
        return fail(err)
    err = nondiagonal_phases(torch, smi, flush)
    if err:
        return fail(err)
    err = eigbasis_phases(torch, smi, flush)
    if err:
        return fail(err)
    err = sharded_phases(torch, smi, flush)
    if err:
        return fail(err)
    err, b3_entries = bf16x3_phases(torch, smi, flush, rel_pol, variants, sass)
    if err:
        return fail(err)
    err, tp_entries = time_pack_phases(torch, smi, flush)
    if err:
        return fail(err)
    err, c1 = cgs2_phases(torch, smi, flush)
    if err:
        return fail(err)

    print(json.dumps({"kernels": [b1, b2, *b3_entries, *tp_entries, c1]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        for proc in _VARIANT_BUILDS:  # stop any variant build a failed run left behind
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    sys.exit(code)
