#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Runs from the root of a checkout; needs one CUDA card, ``nvcc`` and
``nvidia-smi``, and no network. Phases, each of which fails the run:

1. require CUDA; print the card's name and power limit (``nvidia-smi``);
2. build the fused Woodbury kernel from ``csrc/woodbury.cu`` (nvcc);
3. hold the kernel against its plain PyTorch twin on the card, at the main
   path's shapes (K = 513, n = 2047): float32 and float64;
4. drive the main path once through the user entry point at the headline
   shape (N_x = 2048, N_t = 1024, float32, ``method='woodbury',
   use_pallas=True``), with the kernel's launch count set to 0 just before
   and read just after, and gate it on the float64 oracle residual
   (<= 8e-4); solve the reference's default problem in float64 on the card
   and on the CPU and require the same error;
5. time the solve, the kernel, its twin, the DST matmul and the packed FFT
   round trip with CUDA events (median of 20 runs after warm-up, each run
   started with a cold L2 cache).

It prints one JSON line per timing, then the kernel line, and last the
device line ``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

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
RUNS, WARMUP = 20, 5
SPIN_CYCLES = 10_000_000  # ~5 ms at the H100's 1.98 GHz: longer than any enqueue timed here
L2_FLUSH_BYTES = 128 * 2**20  # written before each timed run: over twice the H100's 50 MB L2
# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


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
    in L2 from the previous run."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
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


def rel_err(torch, a, b) -> float:
    return (a - b).abs().max().item() / b.abs().max().item()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this smoke needs a CUDA card")
    import optimal_control_paradiag_torch as port

    if not os.path.abspath(port.__file__).startswith(HERE + os.sep):
        return fail(f"the port was imported from {port.__file__}, not from this checkout")
    from optimal_control_paradiag_torch import (
        ProblemConfig,
        SolverConfig,
        WaveControlProblem,
        reference_1d_default,
    )
    from optimal_control_paradiag_torch.cuda_build import load_library
    from optimal_control_paradiag_torch.ops.transforms import (
        time_irfft_conj_packed,
        time_rfft_conj_packed,
    )
    from optimal_control_paradiag_torch.paradiag import cuda_woodbury as cw

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

    # 2. build
    t0 = time.perf_counter()
    built = load_library(cw.KERNEL_SOURCE)
    print(json.dumps({"phase": "build", "source": cw.KERNEL_SOURCE,
                      "nvcc_s": built.seconds, "load_s": time.perf_counter() - t0}), flush=True)
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip(), flush=True)

    # 3. kernel vs twin at the main path's shapes
    prob = WaveControlProblem(ProblemConfig(N_x=N_X, N_t=N_T, dtype=torch.float32), device="cuda")
    op = prob.operator
    consts = cw.pack_constants(op)
    K, n = consts.a11r.shape
    b_hat = time_rfft_conj_packed(prob.space.dst(prob.rhs), N_T)  # the main path's kernel input
    x_kernel = cw.fused_woodbury(b_hat, consts, 1)
    torch.cuda.synchronize()
    x_twin = cw.fused_woodbury_reference(b_hat, consts, 1)
    err_main = rel_err(torch, x_kernel, x_twin)
    max_abs_err = (x_kernel - x_twin).abs().max().item()
    checks = [("float32 main-path input", err_main, TOL_F32)]
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
        xk = cw.fused_woodbury(bh, c, 1)
        torch.cuda.synchronize()
        checks.append((label, rel_err(torch, xk, cw.fused_woodbury_reference(bh, c, 1)), tol))
    # How far each float32 solve lies from the float64 one on the same input.
    x_exact = cw.fused_woodbury_reference(b_hat.to(torch.complex128), consts64, 1)
    print(json.dumps({"phase": "float32_vs_float64", "K": K, "n": n,
                      "kernel_rel_err": rel_err(torch, x_kernel.to(torch.complex128), x_exact),
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
    del prob64, consts64, b_hat64, x_exact
    for label, err, tol in checks:
        print(json.dumps({"phase": "kernel_vs_twin", "case": label, "K": K, "n": n,
                          "rel_max_abs_err": err, "tol": tol}), flush=True)
        if not err <= tol:
            return fail(f"kernel disagrees with its twin ({label}): {err:.3e} > {tol:.0e}")

    # 4. the main path, through the user entry point
    cfg = SolverConfig(method="woodbury", use_pallas=True)
    cw.fused_woodbury.launches = 0
    t0 = time.perf_counter()
    sol = prob.solve(cfg)
    torch.cuda.synchronize()
    first_solve_s = time.perf_counter() - t0
    launches = cw.fused_woodbury.launches
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
    timings = {
        "solve_cuda_kernel": lambda: solve_fn(rhs),
        "solve_plain_torch": lambda: plain_fn(rhs),
        "woodbury_kernel": lambda: cw.fused_woodbury(b_hat, consts, 1),
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
    for name in ("solve_cuda_kernel", "solve_plain_torch"):
        med, lo, hi = wall_ms(torch, timings[name])
        print(json.dumps({"timing": name, "clock": "host_wall", "median_ms": med, "min_ms": lo,
                          "max_ms": hi, "runs": RUNS, "card": smi}), flush=True)

    itemsize = 4
    kbytes = (11 * K * n + 20 * n + 16 * K) * itemsize  # each input read once, x written once
    kflops = K * n * (80 + 140 * 1)  # refine = 1: W (80 flops/elt) + A_hat and W again (140)
    t_bytes, t_ops = kbytes / HBM_BYTES_PER_S * 1e3, kflops / FP32_FLOPS_PER_S * 1e3
    print(json.dumps({"kernels": [{
        "name": "woodbury_fused_cuda",
        "route": "cuda",
        "source": "optimal_control_paradiag_torch/csrc/woodbury.cu",
        "replaces": "optimal_control_paradiag_tpu/paradiag/pallas_woodbury.py:48",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms["woodbury_kernel"],
        "plain_ms": ms["woodbury_twin"],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
