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
   started with a cold L2 cache);
6. build the heat family's fused kernel from ``csrc/heat_woodbury.cu``;
7. hold it against its plain twin at both heat shapes (1D, K = 513,
   n = 2047; 2D lumped, K = 33, n = 65025), on the main-path input and on a
   seeded random one, in float32 and float64;
8. drive the heat 1D headline solve (N_x = 2048, N_t = 1024, float32)
   through ``HeatControlProblem(...).solve(SolverConfig(method='woodbury',
   use_pallas=True))`` with the heat kernel's launch count set to 0 just
   before and read just after; gate its float64 residual (<= 2.24e-2) and
   that of the polished two-float (dword) solve (<= 1e-6);
9. the same for the heat 2D lumped solve (N_x = 256, N_t = 64): dword gate;
10. solve two small heat problems in float64 on the card and on the CPU and
    require the same ``error_vs_analytic``;
11. drive the wave headline solve with ``polish=1``: residual <= 8e-4 and
    no higher than without polish;
12. time the heat and polished paths at both heat shapes.

It prints one JSON line per timing, then the kernels line, and last the
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
RUNS, WARMUP = 20, 5
# ~20 ms at the H100's 1.98 GHz: longer than any enqueue timed here, the
# polished solves included
SPIN_CYCLES = 40_000_000
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


def roofline(nbytes: int, flops: int) -> dict:
    """The least time the card could take: bytes over the HBM rate or float32
    operations over the non-tensor float32 peak, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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
        HeatControlProblem,
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
    from optimal_control_paradiag_torch.paradiag import cuda_heat as ch
    from optimal_control_paradiag_torch.paradiag import cuda_woodbury as cw
    from optimal_control_paradiag_torch.paradiag.spectral import (
        build_polished_solver,
        spectral_relative_residual,
    )

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
    }
    wave_rel, wave_prob = rel, prob
    del prob, consts, b_hat, x_kernel, x_twin, s

    # 6. build the heat kernel
    t0 = time.perf_counter()
    built = load_library(ch.KERNEL_SOURCE)
    print(json.dumps({"phase": "build", "source": ch.KERNEL_SOURCE,
                      "nvcc_s": built.seconds, "load_s": time.perf_counter() - t0}), flush=True)
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip(), flush=True)

    # 7. heat kernel vs twin at both heat shapes, refine = 1 (the main path)
    heat = {}
    for label, shape in (("1d", HEAT_1D), ("2d", HEAT_2D)):
        p32 = HeatControlProblem(ProblemConfig(**shape, dtype=torch.float32), device="cuda")
        p64 = HeatControlProblem(ProblemConfig(**shape, dtype=torch.float64), device="cuda")
        c32, c64 = ch.pack_heat_constants(p32), ch.pack_heat_constants(p64)
        hK, hn = c32.a11r.shape
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
            xk = ch.fused_heat(bh, c, 1)
            torch.cuda.synchronize()
            xt = ch.fused_heat_reference(bh, c, 1)
            err = rel_err(torch, xk, xt)
            out = {"phase": "heat_kernel_vs_twin", "shape": label, "case": case, "K": hK, "n": hn,
                   "rel_max_abs_err": err, "tol": tol}
            if bh.dtype == torch.complex64:
                # how far each float32 solve lies from the float64 one on the same input
                x_exact = ch.fused_heat_reference(bh.to(torch.complex128), c64, 1)
                out["kernel_vs_float64"] = rel_err(torch, xk.to(torch.complex128), x_exact)
                out["twin_vs_float64"] = rel_err(torch, xt.to(torch.complex128), x_exact)
            print(json.dumps(out), flush=True)
            if not err <= tol:
                return fail(f"heat kernel disagrees with its twin ({label}, {case}): {err:.3e} > {tol:.0e}")
            if case == "float32 main-path input":
                heat[label] = (p32, c32, bh32, (xk - xt).abs().max().item())
        del p64, c64, bh64, noise

    # 8-9. the heat main paths, through the user entry point
    cfg = SolverConfig(method="woodbury", use_pallas=True)
    for label, shape in (("1d", HEAT_1D), ("2d", HEAT_2D)):
        hp = heat[label][0]
        ch.fused_heat.launches = 0
        t0 = time.perf_counter()
        sol = hp.solve(cfg)
        torch.cuda.synchronize()
        first_solve_s = time.perf_counter() - t0
        hlaunches = ch.fused_heat.launches
        if hlaunches < 1:
            return fail(f"the heat {label} main path did not launch the fused heat kernel")
        if label == "1d":
            heat_launches = hlaunches
        if sol.u.shape != (shape["N_t"], hp.space.n) or sol.u.dtype != torch.float32 or not sol.u.is_cuda:
            return fail(f"heat {label} solution u has {tuple(sol.u.shape)} {sol.u.dtype} on {sol.u.device}")
        if not (torch.isfinite(sol.u).all() and torch.isfinite(sol.p).all()):
            return fail(f"the heat {label} solution is not finite")
        hrel = hp.relative_residual_f64(sol)
        # the polished two-float solve on the same kernel
        ch.fused_heat.launches = 0
        x, e = build_polished_solver(hp, polish=1, dword=True, base_solver=ch.build_cuda_heat_solver(hp))(hp.rhs)
        torch.cuda.synchronize()
        dword_launches = ch.fused_heat.launches
        bb = hp.rhs.double().cpu().numpy()
        r = hp.matvec_host_f64(x.double().cpu().numpy() + e.double().cpu().numpy()) - bb
        rel_dword = float(np.linalg.norm(r.ravel()) / np.linalg.norm(bb.ravel()))
        print(json.dumps({"phase": f"heat_{label}_main_path", **shape, "dtype": "float32",
                          "launches": hlaunches, "first_solve_s": first_solve_s,
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
    cw.fused_woodbury.launches = 0
    wsol = wave_prob.solve(pol_cfg)
    torch.cuda.synchronize()
    wave_pol_launches = cw.fused_woodbury.launches
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

    # 12. timings of the heat and polished paths
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
        name = f"heat_{label}_kernel"
        med, lo, hi = device_ms(torch, timings[name], None)
        print(json.dumps({"timing": name, "clock": "device", "l2": "warm", "median_ms": med, "min_ms": lo,
                          "max_ms": hi, "runs": RUNS, "card": smi}), flush=True)
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
        "launches": heat_launches,
        "max_abs_err": heat["1d"][3],
        "ms": ms["heat_1d_kernel"],
        "plain_ms": ms["heat_1d_twin"],
        **heat_bounds["1d"],
        "library_ms": None,
    }
    print(json.dumps({"kernels": [b1, b2]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
