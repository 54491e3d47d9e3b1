"""The heat family of the PyTorch port (models/heat.py, paradiag/cuda_heat.py)
vs the JAX package, on identical inputs carried over by
``optimal_control_paradiag_torch.interop``, in float64 on the CPU: the port's
fused solve runs the kernel's plain twin, the JAX package's its Pallas
kernel in interpret mode.

Tolerances (relative max-abs, ``|a - b|.max() <= tol * |a|.max()``, a the
JAX result): data and rhs, the operators, the plan, the capacity matrices
and the packed constants 1e-12; the twin against the Pallas kernel and the
solves 1e-11; ``error_vs_analytic`` 1e-10 absolute."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import optimal_control_paradiag_tpu as J
from optimal_control_paradiag_torch import HeatControlProblem, ProblemConfig, SolverConfig
from optimal_control_paradiag_torch.cuda_build import launch_fused_solve
from optimal_control_paradiag_torch.interop import heat_problem_from_jax
from optimal_control_paradiag_torch.ops.transforms import time_rfft_conj_packed
from optimal_control_paradiag_torch.paradiag import cuda_heat as ch
from optimal_control_paradiag_tpu.models.heat import HeatControlProblem as JHeat
from optimal_control_paradiag_tpu.paradiag import pallas_heat

torch.set_num_threads(1)

CASES = [
    dict(N_x=17, N_t=8),
    dict(N_x=13, N_t=9, gamma=0.5),
    dict(N_x=12, N_t=8, mass="lumped", T=1.0),
    dict(N_x=9, N_t=10, dim=2, mass="lumped", gamma=0.7),
]
IDS = ["1d-consistent", "1d-odd-gamma", "1d-lumped", "2d-lumped"]


def _close(ref, got, tol):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape
    assert np.abs(ref - got).max() <= tol * np.abs(ref).max()


def _pair(kw, device="cpu", **extra):
    """(JAX heat problem, port heat problem) on the JAX problem's data."""
    jcfg = J.ProblemConfig(**kw, **extra)
    jp = JHeat(jcfg)
    data = {k: np.asarray(v) for k, v in jp._data.items()}
    return jp, heat_problem_from_jax(dataclasses.asdict(jcfg), data, device=device)


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_data_and_rhs_match_jax(kw):
    """Without interop the port builds the same manufactured data."""
    jp = JHeat(J.ProblemConfig(**kw))
    tp = HeatControlProblem(ProblemConfig(**kw), device="cpu")
    assert set(tp._data) == set(jp._data) == {"f", "g", "u0"}
    for k in ("f", "g", "u0"):
        _close(jp._data[k], tp._data[k], 1e-12)
    _close(jp.rhs, tp.rhs, 1e-12)
    assert tp.tau == jp.tau


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_operators_match_jax(kw):
    jp, tp = _pair(kw)
    x = np.random.default_rng(0).standard_normal((2, kw["N_t"], tp.space.n))
    xt = torch.from_numpy(x)
    _close(jp.matvec(jax.numpy.asarray(x)), tp.matvec(xt), 1e-12)
    _close(jp.matvec_accurate(jax.numpy.asarray(x)), tp.matvec_accurate(xt), 1e-12)
    _close(jp.matvec_host_f64(x), tp.matvec_host_f64(x), 1e-12)
    _close(tp.matvec(xt), tp.matvec_host_f64(x), 1e-12)


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_plan_and_capacity_match_jax(kw):
    jp, tp = _pair(kw)
    for j_arr, t_arr in zip(jp._plan(), tp._plan()):
        _close(j_arr, t_arr, 1e-12)
    _close(jp._capacity_2x2(), tp._capacity_2x2(), 1e-12)


@pytest.mark.parametrize("kw", [CASES[0], CASES[1], CASES[3]], ids=[IDS[0], IDS[1], IDS[3]])
def test_packed_constants_match_pallas_packing(kw, monkeypatch):
    """pack_heat_constants against the arrays the Pallas kernel is called
    with (``pallas_heat.py:149-182``), padding and spare rows removed."""
    jp, tp = _pair(kw)
    seen = []
    real_pallas_call = pallas_heat.pl.pallas_call

    def spy(*args, **kwargs):
        call = real_pallas_call(*args, **kwargs)
        return lambda *ins: (seen.append(ins), call(*ins))[1]

    monkeypatch.setattr(pallas_heat.pl, "pallas_call", spy)
    pallas_heat.build_pallas_heat_solver(jp, refine=0, interpret=True)(jp.rhs)
    a11r, a11i, invdet, colc, phases = (np.asarray(a) for a in seen[0][4:])
    c = ch.pack_heat_constants(tp)
    K, n = kw["N_t"] // 2 + 1, tp.space.n
    assert c.a11r.shape == (K, n) and c.colc.shape == (6, n) and c.phases.shape == (K, 8)
    _close(a11r[:, :n], c.a11r, 1e-12)
    _close(a11i[:, :n], c.a11i, 1e-12)
    _close(invdet[:, :n], c.invdet, 1e-12)
    _close(colc[:6, :n], c.colc, 1e-12)
    _close(phases, c.phases, 1e-12)


@pytest.mark.parametrize(
    "kw,refine",
    [
        (dict(N_x=17, N_t=8), 0),
        (dict(N_x=17, N_t=8), 1),
        (dict(N_x=17, N_t=9), 0),
        (dict(N_x=17, N_t=9), 1),
        (dict(N_x=9, N_t=8, dim=2, mass="lumped"), 1),
        (dict(N_x=9, N_t=9, dim=2, mass="lumped"), 0),
    ],
    ids=["1d-8-r0", "1d-8-r1", "1d-9-r0", "1d-9-r1", "2d-lumped-8-r1", "2d-lumped-9-r0"],
)
def test_fused_twin_matches_pallas_interpret(kw, refine):
    jp, tp = _pair(kw)
    x_j = np.asarray(jax.jit(pallas_heat.build_pallas_heat_solver(
        jp, refine=refine, interpret=True))(jp.rhs))
    x_t = ch.build_cuda_heat_solver(tp, refine=refine)(torch.from_numpy(np.array(jp.rhs)))
    _close(x_j, x_t, 1e-11)


@pytest.mark.parametrize("kw", CASES, ids=IDS)
@pytest.mark.parametrize("use_pallas", [True, False], ids=["fused", "plain"])
def test_solve_matches_jax(kw, use_pallas):
    jp, tp = _pair(kw)
    js = jp.solve(J.SolverConfig(method="woodbury", use_pallas=use_pallas))
    ts = tp.solve(SolverConfig(method="woodbury", use_pallas=use_pallas))
    assert ts.result is None and ts.u.dtype == torch.float64
    _close(js.u, ts.u, 1e-11)
    _close(js.p, ts.p, 1e-11)
    assert abs(jp.error_vs_analytic(js) - tp.error_vs_analytic(ts)) <= 1e-10
    assert tp.relative_residual(ts) < 1e-12
    assert tp.relative_residual_f64(ts) < 1e-12
    # the two float64 oracles on the JAX solution
    js_port = type(ts)(u=torch.from_numpy(np.array(js.u)), p=torch.from_numpy(np.array(js.p)), result=None)
    assert abs(jp.relative_residual_f64(js) - tp.relative_residual_f64(js_port)) <= 1e-12


@pytest.mark.parametrize("time_transform", ["fft", "fft2"])
def test_time_transforms_match_jax(time_transform):
    jp, tp = _pair(CASES[1])
    x_j = jax.jit(jp.build_woodbury_solver(refine=1, time_transform=time_transform))(jp.rhs)
    x_t = tp.build_woodbury_solver(refine=1, time_transform=time_transform)(torch.from_numpy(np.array(jp.rhs)))
    _close(x_j, x_t, 1e-11)


def test_unpacked_fft_kernel_path_matches_packed():
    tp = HeatControlProblem(ProblemConfig(N_x=20, N_t=15), device="cpu")
    x1 = ch.build_cuda_heat_solver(tp, pack_fft=True)(tp.rhs)
    x2 = ch.build_cuda_heat_solver(tp, pack_fft=False)(tp.rhs)
    assert (x1 - x2).abs().max() <= 1e-12 * x1.abs().max()


def test_error_vs_analytic_converges_like_jax():
    """Backward Euler: the manufactured error halves with tau, and matches
    the JAX package's to 1e-10."""
    errs = []
    for N_t in (16, 32):
        jp, tp = _pair(dict(N_x=64, N_t=N_t))
        solver = SolverConfig(method="woodbury", use_pallas=True)
        e_t = tp.error_vs_analytic(tp.solve(solver))
        assert abs(jp.error_vs_analytic(jp.solve(J.SolverConfig(method="woodbury"))) - e_t) <= 1e-10
        errs.append(e_t)
    assert 1.5 < errs[0] / errs[1] < 2.6, errs


def test_wrapper_on_cpu_runs_the_twin_and_counts_nothing():
    tp = HeatControlProblem(ProblemConfig(N_x=12, N_t=10), device="cpu")
    c = ch.pack_heat_constants(tp)
    b_hat = time_rfft_conj_packed(tp.space.dst(tp.rhs), 10)
    before = ch.fused_heat.launches
    x = ch.fused_heat(b_hat, c, 1)
    assert ch.fused_heat.launches == before
    assert torch.equal(x, ch.fused_heat_reference(b_hat, c, 1))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ch.fused_heat(torch.zeros(2, 6, 11, dtype=torch.complex128, device="meta"), c, 1)


def test_float32_dtype_discipline():
    """float32 end to end, and the plain and fused residuals within 2x the
    JAX package's."""
    import jax.numpy as jnp

    jp, tp = _pair(dict(N_x=128, N_t=64), dtype=jnp.float32)
    for use_pallas in (True, False):
        solver = SolverConfig(method="woodbury", use_pallas=use_pallas)
        ts = tp.solve(solver)
        for t in (tp.rhs, ts.u, ts.p, tp.matvec_accurate(tp.rhs)):
            assert t.dtype == torch.float32
        js = jp.solve(J.SolverConfig(method="woodbury", use_pallas=use_pallas))
        assert tp.relative_residual_f64(ts) <= 2.0 * jp.relative_residual_f64(js)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert HeatControlProblem(ProblemConfig(N_x=8, N_t=6)).rhs.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HeatControlProblem(ProblemConfig(N_x=8, N_t=6))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        heat_problem_from_jax(dataclasses.asdict(J.ProblemConfig(N_x=8, N_t=6)), {})


def test_dst_method_is_passed_through():
    """The JAX heat problem drops ``dst_method`` (ROADMAP Queue C); the port
    passes it to the space: 'matmul' gives the 'auto' result, and 'fft'
    the same to 1e-11."""
    kw = dict(N_x=12, N_t=8)
    tp = HeatControlProblem(ProblemConfig(**kw, dst_method="matmul"), device="cpu")
    assert tp.space.dst_method == "matmul"
    ref = HeatControlProblem(ProblemConfig(**kw), device="cpu")
    solver = SolverConfig(method="woodbury", use_pallas=True)
    assert torch.equal(tp.solve(solver).u, ref.solve(solver).u)
    fft = HeatControlProblem(ProblemConfig(**kw, dst_method="fft"), device="cpu")
    assert fft.space.dst_method == "fft"
    x = fft.solve(solver).u
    assert (x - ref.solve(solver).u).abs().max() <= 1e-11 * x.abs().max()


@pytest.mark.parametrize(
    "cfg,solver",
    [(ProblemConfig(N_x=6, N_t=6, dim=2), SolverConfig(method="woodbury"))],
    ids=["2d-consistent"],
)
def test_unported_paths_raise(cfg, solver):
    """The 2D consistent mass's ``method='woodbury'`` (tensor GMRES) solves
    in the port as in the JAX package; of its builders only the sharded one
    (ROADMAP Queue A item 14) still raises."""
    prob = HeatControlProblem(cfg, device="cpu")
    sol = prob.solve(solver)
    assert bool(sol.result.converged) and prob.relative_residual_f64(sol) < 1e-8
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 14"):
        prob.build_woodbury_solver(layout=object())


@pytest.mark.parametrize(
    "call",
    ["build_tensor_gmres_solver", "sharded"],
)
def test_unported_builders_raise(call):
    """The sharded builder raises naming its ROADMAP item; the tensor GMRES
    builder is ported, and on a diagonalizable space its preconditioner is
    the exact solve: one iteration, as in the JAX package."""
    tp = HeatControlProblem(ProblemConfig(N_x=8, N_t=6), device="cpu")
    if call == "sharded":
        with pytest.raises(NotImplementedError, match="ROADMAP Queue A"):
            tp.build_woodbury_solver(layout=object())
    else:
        _, res = getattr(tp, call)(with_result=True)(tp.rhs)
        assert bool(res.converged) and int(res.iterations) == 1


def test_gmres_on_2d_consistent_mass_raises_like_jax():
    """JAX's ``_plan`` refuses the 2D consistent mass with a ``ValueError``
    when the GMRES preconditioner is built (``models/heat.py:214``); so does
    the port's."""
    with pytest.raises(ValueError, match="diagonalizable"):
        JHeat(J.ProblemConfig(N_x=6, N_t=6, dim=2)).solve(J.SolverConfig(method="gmres"))
    with pytest.raises(ValueError, match="diagonalizable"):
        HeatControlProblem(ProblemConfig(N_x=6, N_t=6, dim=2), device="cpu").solve(SolverConfig(method="gmres"))


def test_invalid_problems_raise_like_jax():
    with pytest.raises(ValueError, match="scaled"):
        JHeat(J.ProblemConfig(N_x=8, N_t=6, scaled=False))
    with pytest.raises(ValueError, match="scaled"):
        HeatControlProblem(ProblemConfig(N_x=8, N_t=6, scaled=False), device="cpu")
    tp = HeatControlProblem(ProblemConfig(N_x=6, N_t=6, dim=2), device="cpu")
    with pytest.raises(ValueError, match="diagonalizable"):
        tp.build_woodbury_solver()
    with pytest.raises(ValueError, match="diagonalizable"):
        ch.build_cuda_heat_solver(tp)
    with pytest.raises(NotImplementedError, match="method 'spectral'"):
        HeatControlProblem(ProblemConfig(N_x=8, N_t=6), device="cpu").solve(SolverConfig(method="spectral"))


def test_launch_checks_refuse_bad_input_before_any_launch():
    """The argument checks shared by both kernel wrappers run before the
    launcher is called (here a recording stand-in, on CPU tensors)."""
    tp = HeatControlProblem(ProblemConfig(N_x=12, N_t=10), device="cpu")
    c = ch.pack_heat_constants(tp)
    shapes = {"a11r": ("K", "n"), "a11i": ("K", "n"), "invdet": ("K", "n"), "colc": (6, "n"),
              "phases": ("K", 8)}
    calls = []
    fns = {torch.float64: lambda *a: calls.append(a) or 0}
    launch = lambda b, consts=c, sh=shapes, refine=1: launch_fused_solve(
        "heat", fns, None, b, consts, sh, refine)
    good = torch.zeros(2, 6, 11, dtype=torch.complex128)
    for bad, match in (
        (torch.zeros(2, 6, 10, dtype=torch.complex128), "contiguous"),
        (torch.zeros(2, 11, 6, dtype=torch.complex128).transpose(1, 2), "contiguous"),
        (good.conj(), "resolved"),
        (torch.zeros(2, 6, 11, dtype=torch.float64), "complex"),
        (torch.zeros(2, 6, 11, dtype=torch.complex64), "constant a11r"),
    ):
        with pytest.raises(ValueError, match=match):
            launch(bad)
    with pytest.raises(ValueError, match="inconsistent"):
        launch(good, sh=dict(shapes, colc=(4, "n")))
    with pytest.raises(ValueError, match="refine"):
        launch(good, refine=-1)
    assert not calls
