"""GMRES with the ParaDiag preconditioner on the card against the same solve
on the CPU. These tests need a CUDA card; they skip without one. The file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda_gmres.py -q

Tolerances: the same iteration count on both devices; ``error_aligned`` and
heat ``error_vs_analytic`` 1e-10 apart (float64); u 1e-6 apart across the
``eig`` inner solvers (tests/test_inner.py:94-103)."""

import pytest
import torch

from optimal_control_paradiag_torch import (
    HeatControlProblem,
    ProblemConfig,
    SolverConfig,
    WaveControlProblem,
    reference_1d_default,
)

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_reference_default_run_on_card_matches_cpu(cuda):
    """The verification run, ``reference_1d_default()`` at rtol 1e-8."""
    out = {}
    for dev in (cuda, "cpu"):
        prob = WaveControlProblem(reference_1d_default(), device=dev)
        sol = prob.solve(SolverConfig(rtol=1e-8))
        assert sol.u.device.type == torch.device(dev).type
        assert bool(sol.result.converged) and int(sol.result.iterations) <= 10
        assert float(prob.residual_norm(sol)) < 1e-8
        out[str(dev)] = (int(sol.result.iterations), prob.error_aligned(sol))
    (it_g, e_g), (it_c, e_c) = out.values()
    assert it_g == it_c
    assert abs(e_g - e_c) <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("inner", ["dst", "tridiag_thomas", "tridiag_pcr", "cocg"])
def test_eig_inner_solvers_on_card(cuda, inner):
    prob = WaveControlProblem(ProblemConfig(N_x=12, N_t=13), device=cuda)
    ref = prob.solve(SolverConfig(rtol=1e-8))
    sol = prob.solve(SolverConfig(rtol=1e-8, inner=inner))
    assert bool(sol.result.converged)
    assert abs(int(sol.result.iterations) - int(ref.result.iterations)) <= 1
    assert (sol.u - ref.u).abs().max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(N_x=32, N_t=32), dict(N_x=16, N_t=8, dim=2, mass="lumped")],
                         ids=["1d", "2d-lumped"])
def test_heat_gmres_on_card_matches_cpu(cuda, kw):
    out = []
    for dev in (cuda, "cpu"):
        prob = HeatControlProblem(ProblemConfig(**kw), device=dev)
        sol = prob.solve(SolverConfig(method="gmres", rtol=1e-10))
        assert bool(sol.result.converged) and int(sol.result.iterations) <= 5
        assert prob.relative_residual_f64(sol) < 1e-8
        out.append((int(sol.result.iterations), prob.error_vs_analytic(sol)))
    assert out[0][0] == out[1][0]
    assert abs(out[0][1] - out[1][1]) <= 1e-10
