"""The transforms of the PyTorch port (``ops/transforms.py``: the DFT-matmul
time transforms, the four-step time transforms and the four-step DST-I; the
'fft' and 'mxu4' sine transforms of ``P1Space``; the 'dft' and 'mxu'
half-spectrum time transforms; the preconditioner's 'dft' transform) vs the
JAX package, on the same seeded numpy inputs, on the CPU.

Tolerances (relative max-abs, ``|a - b|.max() <= tol * |a|.max()``, a the
JAX result): the transforms 1e-12 in float64 and, in float32, those of
tests/test_transforms.py against numpy's fft and the sine matrix (1e-5 time,
2e-5 DST); the Woodbury solves 1e-11; the GMRES solves the same iteration
counts and solutions to 1e-10 (tests/test_torch_gmres.py's rule)."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optimal_control_paradiag_tpu as J
from optimal_control_paradiag_torch import ProblemConfig, SolverConfig
from optimal_control_paradiag_torch.fem.space import make_space as t_make_space
from optimal_control_paradiag_torch.interop import heat_problem_from_jax, problem_from_jax
from optimal_control_paradiag_torch.ops import transforms as t_tr
from optimal_control_paradiag_torch.paradiag import spectral as t_sp
from optimal_control_paradiag_torch.paradiag.pc import build_preconditioner as t_build_pc
from optimal_control_paradiag_tpu.fem.space import make_space as j_make_space
from optimal_control_paradiag_tpu.models.heat import HeatControlProblem as JHeat
from optimal_control_paradiag_tpu.ops import transforms as j_tr
from optimal_control_paradiag_tpu.paradiag import spectral as j_sp
from optimal_control_paradiag_tpu.paradiag.pc import build_preconditioner as j_build_pc

torch.set_num_threads(1)

tg = importlib.import_module("optimal_control_paradiag_torch.krylov.gmres")
jg = importlib.import_module("optimal_control_paradiag_tpu.krylov.gmres")


def _close(ref, got, tol):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape
    assert np.abs(ref - got).max() <= tol * np.abs(ref).max()


# ------------------------------------------------------------ DFT matmuls


@pytest.mark.parametrize("N", [7, 8, 16, 81])
def test_dft_matmul_time_transforms_match_jax(N):
    rng = np.random.default_rng(N)
    x = rng.standard_normal((2, N, 5))
    z = x + 1j * rng.standard_normal(x.shape)
    Cj, Sj = j_tr.dft_matrices(N, jnp.float64)
    Ct, St = t_tr.dft_matrices(N, torch.float64, "cpu")
    _close(Cj, Ct, 1e-12)
    _close(Sj, St, 1e-12)
    zt, xt = torch.from_numpy(z), torch.from_numpy(x)
    _close(j_tr.time_ifft_mm(jnp.asarray(z), Cj, Sj), t_tr.time_ifft_mm(zt, Ct, St), 1e-12)
    _close(j_tr.time_fft_mm(jnp.asarray(z), Cj, Sj), t_tr.time_fft_mm(zt, Ct, St), 1e-12)
    _close(j_tr.time_ifft_real_mm(jnp.asarray(x), Cj, Sj), t_tr.time_ifft_real_mm(xt, Ct, St), 1e-12)
    _close(j_tr.time_fft_real_part_mm(jnp.asarray(z), Cj, Sj), t_tr.time_fft_real_part_mm(zt, Ct, St), 1e-12)
    # and numpy's conventions
    _close(np.fft.ifft(z, axis=1), t_tr.time_ifft_mm(zt, Ct, St), 1e-12)
    _close(np.fft.fft(z, axis=1), t_tr.time_fft_mm(zt, Ct, St), 1e-12)


# ------------------------------------------------------ four-step transforms


@pytest.mark.parametrize("N", [16, 81, 64, 12, 1024])
def test_fourstep_time_roundtrip_matches_jax(N):
    rng = np.random.default_rng(N)
    x = rng.standard_normal((2, N, 7))
    K = N // 2 + 1
    xi = rng.standard_normal((2, K, 7)) + 1j * rng.standard_normal((2, K, 7))
    xi[:, 0].imag = 0.0  # a Hermitian half spectrum: real self-conjugate bins
    if N % 2 == 0:
        xi[:, -1].imag = 0.0
    jp, tp = j_tr.FourStepPlan(N, jnp.float64), t_tr.FourStepPlan(N, torch.float64, device="cpu")
    assert (tp.a, tp.b, tp.K) == (jp.a, jp.b, jp.K)
    for name in ("Cb", "Sb", "Wre", "Wim", "Ca", "Sa", "Cb1", "Sb1"):
        _close(getattr(jp, name), getattr(tp, name), 1e-12)
    fwd = t_tr.time_rfft_conj_mm4(torch.from_numpy(x), tp)
    _close(j_tr.time_rfft_conj_mm4(jnp.asarray(x), jp), fwd, 1e-12)
    _close(np.conj(np.fft.rfft(x, axis=1)) / N, fwd, 1e-12)
    back = t_tr.time_irfft_conj_mm4(torch.from_numpy(xi), tp)
    _close(j_tr.time_irfft_conj_mm4(jnp.asarray(xi), jp), back, 1e-12)
    _close(np.fft.irfft(np.conj(xi), n=N, axis=1) * N, back, 1e-12)
    # float32: tests/test_transforms.py's tolerance against numpy
    x32 = x.astype(np.float32)
    p32 = t_tr.FourStepPlan(N, torch.float32, device="cpu")
    ref = np.conj(np.fft.rfft(x32, axis=1)) / N
    out = t_tr.time_rfft_conj_mm4(torch.from_numpy(x32), p32)
    assert out.dtype == torch.complex64
    _close(ref, out, 1e-5)
    back_ref = np.fft.irfft(np.conj(ref), n=N, axis=1) * N
    back32 = t_tr.time_irfft_conj_mm4(torch.from_numpy(ref.astype(np.complex64)), p32)
    assert back32.dtype == torch.float32
    _close(back_ref, back32, 1e-5)


def test_fourstep_rejects_prime():
    with pytest.raises(ValueError):
        t_tr.FourStepPlan(13, torch.float32, device="cpu")
    assert t_tr.factor_pair(13) == j_tr.factor_pair(13) == (1, 13)
    for N in (12, 16, 81, 1024, 2048, 4096):
        assert t_tr.factor_pair(N) == j_tr.factor_pair(N)


@pytest.mark.parametrize("N_x", [8, 9, 80, 10])
def test_fourstep_dst_matches_jax(N_x):
    n = N_x - 1
    rng = np.random.default_rng(N_x)
    x = rng.standard_normal((3, 5, n))
    jp, tp = j_tr.DstFourStepPlan(N_x, jnp.float64), t_tr.DstFourStepPlan(N_x, torch.float64, device="cpu")
    _close(j_tr.dst1_mm4(jnp.asarray(x), jp), t_tr.dst1_mm4(torch.from_numpy(x), tp), 1e-12)
    i = np.arange(1, N_x)
    V = np.sin(np.pi * np.outer(i, i) / N_x)
    _close(x @ V, t_tr.dst1_mm4(torch.from_numpy(x), tp), 1e-12)
    x32 = x.astype(np.float32)
    out = t_tr.dst1_mm4(torch.from_numpy(x32), t_tr.DstFourStepPlan(N_x, torch.float32, device="cpu"))
    assert out.dtype == torch.float32
    _close(x32 @ V, out, 2e-5)


def test_reduced_precision_plans_are_refused():
    """``precision='high'`` (bf16x3, tests/test_torch_bf16x3.py) builds; an
    unknown precision raises, and so does TF32."""
    for plan in (t_tr.FourStepPlan, t_tr.DstFourStepPlan):
        assert plan(16, torch.float32, precision="high", device="cpu").precision == "high"
        with pytest.raises(ValueError, match="precision"):
            plan(16, torch.float32, precision="tf32", device="cpu")
    old = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="full"):
            t_tr.FourStepPlan(16, torch.float32, device="cpu")
    finally:
        torch.set_float32_matmul_precision(old)


# -------------------------------------- half-spectrum 'dft' and 'mxu' paths

CASES = [
    dict(N_x=12, N_t=10),
    dict(N_x=11, N_t=9, mass="lumped", gamma=0.5),
    dict(N_x=6, N_t=8, dim=2, mass="lumped"),
]
CASE_IDS = ["1d-consistent", "1d-lumped", "2d-lumped"]
# the matmul DST with 'dft' and 'mxu' is in tests/test_torch_spectral.py
WAVE_COMBOS = [("fft", "fft2"), ("mxu4", "fft2"), ("fft", "dft"), ("mxu4", "mxu")]
COMBOS = [("matmul", "dft"), ("matmul", "mxu")] + WAVE_COMBOS
ids = lambda combos: [f"{d}-{t}" for d, t in combos]


def _wave_pair(kw):
    jcfg = J.ProblemConfig(**kw)
    jp = J.WaveControlProblem(jcfg)
    return jp, problem_from_jax(dataclasses.asdict(jcfg), {k: np.asarray(v) for k, v in jp._data.items()},
                                device="cpu")


@pytest.mark.parametrize("N_t", [16, 81, 9, 13])
@pytest.mark.parametrize("time_transform", ["dft", "mxu"])
def test_halfspectrum_transforms_match_jax(N_t, time_transform):
    """Both directions against the JAX package, at N_t with a radix split
    and at a prime (13: 'mxu' falls back to the rfft)."""
    js = j_make_space(1, 9)
    ts = t_make_space(1, 9, device="cpu")
    rng = np.random.default_rng(N_t)
    x = rng.standard_normal((2, N_t, ts.n))
    K = N_t // 2 + 1
    xi = rng.standard_normal((2, K, ts.n)) + 1j * rng.standard_normal((2, K, ts.n))
    xi[:, 0].imag = 0.0
    if N_t % 2 == 0:
        xi[:, -1].imag = 0.0
    jf, jb = j_sp.make_halfspectrum_transforms(js, N_t, jnp.float64, time_transform=time_transform)
    tf, tb = t_sp.make_halfspectrum_transforms(ts, N_t, torch.float64, time_transform=time_transform)
    fwd = tf(torch.from_numpy(x))
    _close(jf(jnp.asarray(x)), fwd, 1e-12)
    _close(jb(jnp.asarray(xi)), tb(torch.from_numpy(xi)), 1e-12)
    _close(x, tb(fwd), 1e-12)


@pytest.mark.parametrize("kw", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("dst_method,time_transform", WAVE_COMBOS, ids=ids(WAVE_COMBOS))
def test_wave_woodbury_matches_jax(kw, dst_method, time_transform):
    jp, tp = _wave_pair(dict(kw, dst_method=dst_method))
    assert tp.space.dst_method == dst_method
    x_j = jax.jit(j_sp.build_woodbury_solver(jp.operator, refine=1, time_transform=time_transform))(jp.rhs)
    x_t = t_sp.build_woodbury_solver(tp.operator, refine=1, time_transform=time_transform)(
        torch.from_numpy(np.array(jp.rhs)))
    _close(x_j, x_t, 1e-11)


@pytest.mark.parametrize("dst_method,time_transform", COMBOS, ids=ids(COMBOS))
def test_heat_woodbury_matches_jax(dst_method, time_transform):
    """The JAX heat problem always takes the matmul DST (it drops
    ``dst_method``, ROADMAP Queue C); the port's honours it, and the
    solves agree all the same."""
    kw = dict(N_x=13, N_t=9, gamma=0.5)
    jcfg = J.ProblemConfig(**kw)
    jp = JHeat(jcfg)
    tp = heat_problem_from_jax(dict(dataclasses.asdict(jcfg), dst_method=dst_method),
                               {k: np.asarray(v) for k, v in jp._data.items()}, device="cpu")
    assert tp.space.dst_method == dst_method
    x_j = jax.jit(jp.build_woodbury_solver(refine=1, time_transform=time_transform))(jp.rhs)
    x_t = tp.build_woodbury_solver(refine=1, time_transform=time_transform)(torch.from_numpy(np.array(jp.rhs)))
    _close(x_j, x_t, 1e-11)


@pytest.mark.parametrize("dst_method", ["fft", "mxu4"])
def test_wave_solve_with_dst_method_matches_jax(dst_method):
    """The user entry point, direct (fused twin) and GMRES (fulldiag, and
    eig with the dst inner solver)."""
    jp, tp = _wave_pair(dict(N_x=24, N_t=20, dst_method=dst_method))
    ts = tp.solve(SolverConfig(method="woodbury", use_pallas=True))
    js = jp.solve(J.SolverConfig(method="woodbury", use_pallas=True))
    _close(js.u, ts.u, 1e-11)
    for inner in ("auto", "dst"):
        js = jp.solve(J.SolverConfig(rtol=1e-10, inner=inner))
        ts = tp.solve(SolverConfig(rtol=1e-10, inner=inner))
        assert int(ts.result.iterations) == int(js.result.iterations)
        _close(js.u, ts.u, 1e-10)
        _close(js.p, ts.p, 1e-10)


@pytest.mark.parametrize("dst_method", ["fft", "mxu4"])
def test_heat_gmres_with_dst_method_matches_jax(dst_method):
    kw = dict(N_x=9, N_t=10, dim=2, mass="lumped", gamma=0.7)
    jcfg = J.ProblemConfig(**kw)
    jp = JHeat(jcfg)
    tp = heat_problem_from_jax(dict(dataclasses.asdict(jcfg), dst_method=dst_method),
                               {k: np.asarray(v) for k, v in jp._data.items()}, device="cpu")
    js = jp.solve(J.SolverConfig(method="gmres", rtol=1e-10))
    ts = tp.solve(SolverConfig(method="gmres", rtol=1e-10))
    assert int(ts.result.iterations) == int(js.result.iterations)
    _close(js.u, ts.u, 1e-10)


@pytest.mark.parametrize("variant", ["fulldiag", "eig"])
@pytest.mark.parametrize("dst_method", ["matmul", "fft"])
def test_dft_preconditioner_matches_jax(variant, dst_method):
    """``build_preconditioner(time_transform='dft')``: the apply against
    JAX's 'dft' apply and against the port's 'fft' apply, and GMRES
    preconditioned by it, against JAX's."""
    jp, tp = _wave_pair(dict(N_x=16, N_t=12, dst_method=dst_method))
    pj = j_build_pc(jp.operator, variant=variant, time_transform="dft")
    pt = t_build_pc(tp.operator, variant=variant, time_transform="dft")
    r = np.random.default_rng(7).standard_normal(tp.operator.shape)
    y = pt(torch.from_numpy(r))
    assert y.dtype == torch.float64 and not y.is_complex()
    _close(pj(jnp.asarray(r)), y, 1e-12)
    _close(t_build_pc(tp.operator, variant=variant)(torch.from_numpy(r)), y, 1e-12)
    b = np.array(jp.rhs)
    rj = jg.gmres(jp.operator.matvec, jnp.asarray(b), M=pj, rtol=1e-10, restart=30)
    rt = tg.gmres(tp.operator.matvec, torch.from_numpy(b), M=pt, rtol=1e-10, restart=30)
    assert int(rt.iterations) == int(rj.iterations) and bool(rt.converged)
    _close(np.asarray(rj.x), rt.x, 1e-10)


def test_float32_residual_by_dst_method_mirrors_jax():
    """In float32 the 'fft' and 'mxu4' sine transforms leave the Woodbury
    solve a larger residual than the matmul (the inverse transform's
    rounding, which spectral refinement cannot see): in the JAX package as
    in the port. The matmul and four-step residuals agree within 10 %; the
    FFT's within 30 %, since each package's CPU FFT library rounds its own
    way in float32 (the port's is 1.21x the JAX figure here)."""
    from optimal_control_paradiag_torch.models.wave import WaveSolution
    from optimal_control_paradiag_tpu.models.wave import WaveSolution as JSolution

    res = {}
    for dst_method in ("matmul", "fft", "mxu4"):
        jp = J.WaveControlProblem(J.ProblemConfig(N_x=512, N_t=256, dtype=jnp.float32, dst_method=dst_method))
        tp = problem_from_jax(dataclasses.asdict(jp.config), {k: np.asarray(v) for k, v in jp._data.items()},
                              device="cpu")
        xj = jax.jit(j_sp.build_woodbury_solver(jp.operator))(jp.rhs)
        xt = t_sp.build_woodbury_solver(tp.operator)(tp.rhs)
        rj = jp.relative_residual_f64(JSolution(*jp._unscale(xj), None))
        rt = tp.relative_residual_f64(WaveSolution(*tp._unscale(xt), None))
        assert abs(rt - rj) <= (0.3 if dst_method == "fft" else 0.1) * rj, (dst_method, rt, rj)
        res[dst_method] = rt
    assert res["fft"] > 1.3 * res["matmul"] and res["mxu4"] > 1.1 * res["matmul"], res


def test_float32_paths_stay_float32():
    from optimal_control_paradiag_torch import WaveControlProblem

    for dst_method, tt in (("fft", "mxu"), ("mxu4", "dft")):
        p = WaveControlProblem(ProblemConfig(N_x=16, N_t=12, dtype=torch.float32, dst_method=dst_method),
                               device="cpu")
        x = t_sp.build_woodbury_solver(p.operator, time_transform=tt)(p.rhs)
        assert x.dtype == torch.float32
        assert t_build_pc(p.operator, time_transform="dft")(p.rhs).dtype == torch.float32
