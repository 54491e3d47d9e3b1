"""The physical-space polish ladder of the PyTorch port vs the JAX package:
the nested stiffness, the cancellation-aware all-at-once matvec, the exact
two-sum and ``build_polished_solver`` on both families, on identical inputs
on the CPU (the fused solves run the kernels' plain twins in the port and
the Pallas kernels in interpret mode in the JAX package).

Tolerances: stencils and matvecs 1e-12 relative max-abs in float64; the
float64 polished wave solve 1e-11; float32 residuals (float64 host oracles)
within 2x of the JAX package's, and the dword residuals below the
``bench.py`` gate of 1e-6; the two-sum exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optimal_control_paradiag_tpu as J
from optimal_control_paradiag_torch import SolverConfig
from optimal_control_paradiag_torch.fem.space import make_space as t_make_space
from optimal_control_paradiag_torch.interop import heat_problem_from_jax, problem_from_jax
from optimal_control_paradiag_torch.ops.allatonce import build_operator as t_build_operator
from optimal_control_paradiag_torch.paradiag import cuda_woodbury as cw
from optimal_control_paradiag_torch.paradiag import spectral as t_sp
from optimal_control_paradiag_tpu.fem.space import make_space as j_make_space
from optimal_control_paradiag_tpu.models.heat import HeatControlProblem as JHeat
from optimal_control_paradiag_tpu.ops.allatonce import build_operator as j_build_operator
from optimal_control_paradiag_tpu.paradiag import spectral as j_sp

torch.set_num_threads(1)

SPACES = [
    dict(dim=1, N_x=17, mass="consistent"),
    dict(dim=1, N_x=16, mass="lumped"),
    dict(dim=2, N_x=7, mass="lumped"),
    dict(dim=2, N_x=6, mass="consistent"),
]
IDS = ["1d-consistent", "1d-lumped", "2d-lumped", "2d-consistent"]


def _close(ref, got, tol):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape
    assert np.abs(ref - got).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("kw", SPACES, ids=IDS)
def test_nested_stiffness_matches_jax(kw):
    js = j_make_space(**kw)
    ts = t_make_space(**kw, dtype=torch.float64, device="cpu")
    x = np.random.default_rng(0).standard_normal((3, js.n))
    _close(js.apply_stiffness_nested(jnp.asarray(x)), ts.apply_stiffness_nested(torch.from_numpy(x)), 1e-12)
    _close(ts.apply_stiffness(torch.from_numpy(x)), ts.apply_stiffness_nested(torch.from_numpy(x)), 1e-12)


@pytest.mark.parametrize("kw", SPACES, ids=IDS)
@pytest.mark.parametrize("scaled,gamma", [(True, 0.5), (False, 2.0)])
def test_matvec_accurate_matches_jax(kw, scaled, gamma):
    N_t, dt = 7, 0.3
    jop = j_build_operator(j_make_space(**kw), N_t, dt, gamma, scaled=scaled)
    top = t_build_operator(t_make_space(**kw, dtype=torch.float64, device="cpu"), N_t, dt, gamma, scaled=scaled)
    x = np.random.default_rng(1).standard_normal((2, N_t, jop.space.n))
    _close(jop.matvec_accurate(jnp.asarray(x)), top.matvec_accurate(torch.from_numpy(x)), 1e-12)
    _close(top.matvec(torch.from_numpy(x)), top.matvec_accurate(torch.from_numpy(x)), 1e-12)


def test_nested_forms_are_more_accurate_in_float32():
    """On a smooth state the nested forms sit closer to the float64 product
    than the plain ones (the point of the rewrite)."""
    ts = t_make_space(dim=1, N_x=512, dtype=torch.float32, device="cpu")
    top = t_build_operator(ts, 64, 1.0 / 64, 1.0)
    xs = np.sin(np.pi * np.asarray(ts.coords[0]))[None, None, :] * np.exp(-np.linspace(0, 1, 64))[None, :, None]
    x64 = np.concatenate([xs, 0.5 * xs]).astype(np.float32).astype(np.float64)
    exact = top.matvec_host_f64(x64)
    x32 = torch.from_numpy(x64.astype(np.float32))
    err = lambda y: np.abs(y.double().numpy() - exact).max() / np.abs(exact).max()
    assert err(top.matvec_accurate(x32)) < err(top.matvec(x32)) / 10


def test_two_sum_is_exact():
    rng = np.random.default_rng(2)
    a = (rng.standard_normal(4096) * 10.0 ** rng.integers(-8, 8, 4096)).astype(np.float32)
    b = (rng.standard_normal(4096) * 10.0 ** rng.integers(-8, 8, 4096)).astype(np.float32)
    s, e = t_sp._two_sum(torch.from_numpy(a), torch.from_numpy(b))
    assert s.dtype == e.dtype == torch.float32
    np.testing.assert_array_equal(s.numpy(), a + b)
    exact = a.astype(np.float64) + b.astype(np.float64)
    np.testing.assert_array_equal(s.double().numpy() + e.double().numpy(), exact)


@pytest.mark.parametrize(
    "kw", [dict(refine=2), dict(time_transform="fft"), dict(half_spectrum=True)],
    ids=["refine", "time_transform", "half_spectrum"],
)
def test_base_solver_excludes_inner_knobs(kw):
    tp = problem_from_jax(dataclasses.asdict(J.ProblemConfig(N_x=8, N_t=6)),
                          {k: np.asarray(v) for k, v in J.WaveControlProblem(J.ProblemConfig(N_x=8, N_t=6))._data.items()},
                          device="cpu")
    with pytest.raises(ValueError, match="base_solver"):
        t_sp.build_polished_solver(tp.operator, base_solver=lambda b: b, **kw)


def _wave_pair(jcfg):
    jp = J.WaveControlProblem(jcfg)
    data = {k: np.asarray(v) for k, v in jp._data.items()}
    return jp, problem_from_jax(dataclasses.asdict(jcfg), data, device="cpu")


@pytest.mark.parametrize("use_pallas", [True, False], ids=["fused", "plain"])
@pytest.mark.parametrize("polish", [1, 2])
def test_wave_polish_matches_jax_f64(use_pallas, polish):
    jp, tp = _wave_pair(J.ProblemConfig(N_x=40, N_t=24))
    js = jp.solve(J.SolverConfig(method="woodbury", use_pallas=use_pallas, polish=polish))
    ts = tp.solve(SolverConfig(method="woodbury", use_pallas=use_pallas, polish=polish))
    _close(js.u, ts.u, 1e-11)
    _close(js.p, ts.p, 1e-11)
    assert tp.relative_residual_f64(ts) < 1e-12


def test_wave_polish_float32_ladder():
    """float32: polish=1 lands no higher than the plain solve and within 2x
    of the JAX package's; the dword pair goes below the float32 floor."""
    jp, tp = _wave_pair(J.ProblemConfig(N_x=256, N_t=128, dtype=jnp.float32))
    res = {}
    for polish in (0, 1):
        js = jp.solve(J.SolverConfig(method="woodbury", use_pallas=True, polish=polish))
        ts = tp.solve(SolverConfig(method="woodbury", use_pallas=True, polish=polish))
        assert ts.u.dtype == torch.float32
        res[polish] = tp.relative_residual_f64(ts)
        assert res[polish] <= 2.0 * jp.relative_residual_f64(js), (polish, res)
    assert res[1] <= res[0]
    op = tp.operator
    pol = t_sp.build_polished_solver(op, polish=1, dword=True, base_solver=cw.build_cuda_woodbury_solver(op))
    x, e = pol(tp.rhs)
    assert x.dtype == e.dtype == torch.float32
    b = tp.rhs.double().numpy()
    r_dword = t_sp.spectral_relative_residual(op, x.double().numpy() + e.double().numpy(), b)
    jx, je = jax.jit(j_sp.build_polished_solver(jp.operator, polish=1, dword=True))(jp.rhs)
    r_jax = j_sp.spectral_relative_residual(jp.operator, np.asarray(jx, np.float64) + np.asarray(je, np.float64), b)
    assert r_dword < 1e-6 and r_dword <= 2.0 * r_jax, (r_dword, r_jax)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["fused", "plain"])
def test_heat_polish_ladder_f32(use_pallas):
    """The heat ladder of tests/test_heat.py (N_x=256, N_t=128, float32):
    the port's dword residual below 1e-6 and within 2x of the JAX
    package's; solve(polish=1) no higher than 1.5x the plain solve."""
    jcfg = J.ProblemConfig(N_x=256, N_t=128, dtype=jnp.float32)
    jp = JHeat(jcfg)
    tp = heat_problem_from_jax(dataclasses.asdict(jcfg), {k: np.asarray(v) for k, v in jp._data.items()}, device="cpu")
    bb = np.asarray(jp.rhs, np.float64)

    def rel(xs):
        r = jp.matvec_host_f64(xs) - bb
        return float(np.linalg.norm(r.ravel()) / np.linalg.norm(bb.ravel()))

    x, e = tp.build_polished_solver(polish=1, dword=True, use_pallas=use_pallas)(tp.rhs)
    assert x.dtype == e.dtype == torch.float32
    r_port = rel(x.double().numpy() + e.double().numpy())
    jx, je = jax.jit(jp.build_polished_solver(polish=1, dword=True, use_pallas=use_pallas))(jp.rhs)
    r_jax = rel(np.asarray(jx, np.float64) + np.asarray(je, np.float64))
    assert r_port < 1e-6 and r_port <= 2.0 * r_jax, (r_port, r_jax)

    solver = SolverConfig(method="woodbury", use_pallas=use_pallas)
    r_plain = tp.relative_residual_f64(tp.solve(solver))
    r_pol = tp.relative_residual_f64(tp.solve(dataclasses.replace(solver, polish=1)))
    assert r_port < r_plain / 50 and r_pol <= 1.5 * r_plain, (r_port, r_plain, r_pol)


@pytest.mark.parametrize("kw", [dict(N_x=17, N_t=9), dict(N_x=9, N_t=8, dim=2, mass="lumped")],
                         ids=["1d", "2d-lumped"])
def test_heat_polish_matches_jax_f64(kw):
    jcfg = J.ProblemConfig(**kw)
    jp = JHeat(jcfg)
    tp = heat_problem_from_jax(dataclasses.asdict(jcfg), {k: np.asarray(v) for k, v in jp._data.items()}, device="cpu")
    js = jp.solve(J.SolverConfig(method="woodbury", use_pallas=True, polish=1))
    ts = tp.solve(SolverConfig(method="woodbury", use_pallas=True, polish=1))
    _close(js.u, ts.u, 1e-11)
    _close(js.p, ts.p, 1e-11)
