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


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(N_x=64, N_t=32), dict(N_x=12, N_t=9, dim=2, mass="lumped")],
                         ids=["1d", "2d-lumped"])
def test_half_spectrum_fulldiag_gmres_on_card_matches_cpu(cuda, kw):
    """Float64 wave GMRES with the unsharded 'fulldiag' PC, which runs on the
    real half spectrum: the same iterations on the card as on the CPU, the
    apply 1e-12 apart (relative), and one counted half-spectrum apply a
    step plus one for the starting residual."""
    from optimal_control_paradiag_torch.paradiag.pc import build_preconditioner
    from optimal_control_paradiag_torch.utils.timing import counters

    cfg = ProblemConfig(dtype=torch.float64, **kw)
    out = []
    for dev in (cuda, "cpu"):
        prob = WaveControlProblem(cfg, device=dev)
        r = torch.randn(prob.operator.shape, dtype=torch.float64, generator=torch.Generator().manual_seed(4))
        y = build_preconditioner(prob.operator, variant="fulldiag")(r.to(dev))
        before = counters["pc.fulldiag.half_spectrum"]
        sol = prob.solve(SolverConfig(rtol=1e-8, pc_variant="fulldiag"))
        its = int(sol.result.iterations)
        assert bool(sol.result.converged) and prob.relative_residual_f64(sol) < 1e-7
        assert counters["pc.fulldiag.half_spectrum"] - before == its + 1
        out.append((its, y))
    assert out[0][1].is_cuda
    assert out[0][0] == out[1][0]
    assert _rel(out[0][1], out[1][1]) <= 1e-12


# --- the spaces the sine transform does not diagonalize: 2D consistent mass
# and triangle meshes (float64, card against CPU; applies 1e-12 relative,
# solves 1e-10 relative with the same iteration counts)


def _rel(a, b):
    return (a.cpu() - b.cpu()).abs().max().item() / b.abs().max().item()


def _mesh_space(device, N=8, seed=0):
    import numpy as np

    from optimal_control_paradiag_torch import native
    from optimal_control_paradiag_torch.fem.general import boundary_nodes, make_general_space

    pts, tris = native.unit_square_mesh(N)
    bnd = boundary_nodes(pts.shape[0], tris)
    pts[~bnd] += np.random.default_rng(seed).uniform(-0.18 / N, 0.18 / N, size=pts[~bnd].shape)
    return make_general_space(pts, tris, device=device)


@pytest.mark.cuda
def test_tensor_gmres_on_card_matches_cpu(cuda):
    from optimal_control_paradiag_torch.paradiag.woodbury2d import build_tensor_gmres_solver

    out = []
    for dev in (cuda, "cpu"):
        prob = WaveControlProblem(ProblemConfig(N_x=16, N_t=16, dim=2), device=dev)
        x, res = build_tensor_gmres_solver(prob.operator, rtol=1e-10, with_result=True)(prob.rhs)
        assert x.device.type == torch.device(dev).type and bool(res.converged)
        out.append((int(res.iterations), x))
    assert out[0][0] == out[1][0]
    assert _rel(out[0][1], out[1][1]) <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["blockline", "blockdense", "block", "blockband"])
def test_direct_variant_applies_on_card_match_cpu(cuda, variant):
    from optimal_control_paradiag_torch.paradiag.pc import build_preconditioner

    r = torch.randn(2, 8, 49, dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    ys = []
    for dev in (cuda, "cpu"):
        cfg = ProblemConfig(N_x=8, N_t=8, dim=2)
        space = _mesh_space(dev) if variant == "blockband" else None
        prob = WaveControlProblem(cfg, device=dev, space=space)
        ys.append(build_preconditioner(prob.operator, variant=variant, inner_tol=1e-13, inner_maxiter=300)(r.to(dev)))
    assert ys[0].is_cuda
    assert _rel(ys[0], ys[1]) <= (1e-10 if variant == "block" else 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["2d-consistent-auto", "mesh-auto", "mesh-smw", "heat-2d-consistent"])
def test_nondiagonal_solves_on_card_match_cpu(cuda, kind):
    out = []
    for dev in (cuda, "cpu"):
        if kind == "heat-2d-consistent":
            prob = HeatControlProblem(ProblemConfig(N_x=12, N_t=8, dim=2), device=dev)
            sol = prob.solve(SolverConfig(method="woodbury"))
        else:
            space = None if kind == "2d-consistent-auto" else _mesh_space(dev)
            prob = WaveControlProblem(ProblemConfig(N_x=8, N_t=8, dim=2), device=dev, space=space)
            solver = SolverConfig(method="woodbury", pc_variant="blockband") if kind == "mesh-smw" else SolverConfig(rtol=1e-10)
            sol = prob.solve(solver)
        assert prob.relative_residual_f64(sol) < 1e-8
        out.append((None if sol.result is None else int(sol.result.iterations), sol.u))
    assert out[0][0] == out[1][0]
    assert _rel(out[0][1], out[1][1]) <= 1e-10


@pytest.mark.cuda
def test_batched_tensor_gmres_on_card(cuda):
    """B = 3 lanes: per-lane counts equal to the single solves', each lane
    within 1e-10 of its own solve; a float32 solve converges too."""
    from optimal_control_paradiag_torch.paradiag.woodbury2d import build_tensor_gmres_solver

    prob = WaveControlProblem(ProblemConfig(N_x=12, N_t=12, dim=2), device=cuda)
    g = torch.Generator(device="cpu").manual_seed(5)
    bs = torch.stack([prob.rhs] + [prob.rhs * (1 + 0.5 * torch.randn(prob.rhs.shape, generator=g).to(cuda))
                                   for _ in range(2)])
    solve = build_tensor_gmres_solver(prob.operator, rtol=1e-10, with_result=True)
    xs, res = solve(bs)
    for i in range(3):
        x, r = solve(bs[i])
        assert int(r.iterations) == int(res.iterations[i])
        assert _rel(xs[i], x) <= 1e-10
    p32 = WaveControlProblem(ProblemConfig(N_x=12, N_t=12, dim=2, dtype=torch.float32), device=cuda)
    sol = p32.solve(SolverConfig(method="woodbury"))
    assert sol.u.dtype == torch.float32 and p32.relative_residual_f64(sol) < 1e-4
