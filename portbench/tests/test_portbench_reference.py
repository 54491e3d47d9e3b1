"""The plain reference: against a dense float64 solve, the port's own oracle, and its controls."""

import math

import numpy as np
import pytest
import torch

from portbench import traffic as gen
from portbench.reference import model as ref, solve as rs

torch.set_num_threads(1)

SPACES = [(1, "consistent", 24), (1, "lumped", 24), (2, "lumped", 6), (2, "consistent", 6)]


def _case(problem, dim, mass, N_x, N_t=8, seed=5, index=2):
    pc = {"N_x": N_x, "N_t": N_t, "T": 2.0, "gamma": 1.0, "dim": dim, "scaled": True, "mass": mass}
    data = {k: torch.from_numpy(v) for k, v in gen.member(problem, pc, "float64", seed, index).items()}
    return pc, data


def _dense(problem, pc, shape):
    n = int(np.prod(shape))
    cols = [ref.matvec(problem, pc, e.reshape(shape)).reshape(-1) for e in torch.eye(n, dtype=torch.float64)]
    return torch.stack(cols, 1)


@pytest.mark.parametrize("problem", ["wave", "heat"])
@pytest.mark.parametrize("dim,mass,N_x", SPACES)
@pytest.mark.parametrize("N_t", [8, 9])
def test_against_a_dense_float64_solve(problem, dim, mass, N_x, N_t):
    """Every space, GMRES on the 2D consistent mass; an odd N_t leaves the
    block solve a trailing slice coupled to nothing."""
    pc, data = _case(problem, dim, mass, N_x, N_t)
    b = ref.rhs(problem, pc, data)
    A = _dense(problem, pc, b.shape)
    x = torch.linalg.solve(A, b.reshape(-1)).reshape(b.shape)
    assert ref.rel_residual(problem, pc, data, x) < 1e-12
    xs = rs.solve(problem, pc, b, "float64")
    assert float((xs - x).abs().max() / x.abs().max()) < 1e-12
    assert ref.rel_residual(problem, pc, data, torch.full_like(x, math.nan)) == math.inf


@pytest.mark.parametrize("dim,mass,N_x", SPACES[:3])
def test_eigenvalues_of_the_stencils(dim, mass, N_x):
    pc = {"N_x": N_x, "dim": dim, "mass": mass}
    m, k = rs.eigenvalues(pc)
    i = torch.arange(1, N_x, dtype=torch.float64)
    S = torch.sin(math.pi * torch.outer(i, i) / N_x)
    V = S if dim == 1 else torch.einsum("ay,bx->abyx", S, S).reshape((N_x - 1) ** 2, -1)
    np.testing.assert_allclose(ref.mass(pc, V).numpy(), (m[:, None] * V).numpy(), atol=1e-12)
    np.testing.assert_allclose(ref.stiffness(pc, V).numpy(), (k[:, None] * V).numpy(), atol=1e-10)


@pytest.mark.parametrize("problem", ["wave", "heat"])
def test_matches_the_ports_operator_and_oracle(problem):
    """Written apart from the port, the reference gives its operator, its
    right-hand side and its float64 oracle's residual."""
    from optimal_control_paradiag_torch import HeatControlProblem, ProblemConfig, SolverConfig, WaveControlProblem

    pc, data = _case(problem, 1, "consistent", 48, N_t=16)
    cls = WaveControlProblem if problem == "wave" else HeatControlProblem
    prob = cls(ProblemConfig(**pc, dtype=torch.float32), device="cpu", data={k: v.numpy() for k, v in data.items()})
    sol = prob.solve(SolverConfig(method="woodbury"))
    b = ref.rhs(problem, pc, data)
    np.testing.assert_allclose(prob.rhs.double().numpy(), b.numpy(), rtol=1e-6, atol=1e-6 * float(b.abs().max()))
    x = torch.stack([sol.u, sol.p]).double()
    mv = prob.operator.matvec if problem == "wave" else prob.matvec
    np.testing.assert_allclose(ref.matvec(problem, pc, x).numpy(), mv(x).numpy(), atol=1e-12)
    # the port's oracle judges against its own float32 rhs; the reference against the data's
    assert ref.rel_residual(problem, pc, data, x) == pytest.approx(prob.relative_residual_f64(sol), rel=0.05)


@pytest.mark.parametrize("problem", ["wave", "heat"])
@pytest.mark.parametrize("dim,N_x,N_t", [(1, 128, 64), (2, 64, 32)], ids=["1d", "2d_consistent"])
def test_control_precisions_in_order(problem, dim, N_x, N_t):
    """Each precision reads below the next; on the 2D consistent mass (GMRES)
    float64 takes at most 15 steps a lane."""
    pc, data = _case(problem, dim, "consistent", N_x, N_t=N_t)
    b = ref.rhs(problem, pc, data)
    steps = {p: [] for p in ("float64", "float32", "tf32", "bf16")}
    rel = {p: ref.rel_residual(problem, pc, data, rs.solve(problem, pc, b, p, steps[p])) for p in steps}
    assert rel["float64"] < 1e-11 < rel["float32"] < rel["tf32"] / 10 < rel["bf16"]
    if dim == 2:
        assert 1 <= steps["float64"][0] <= 15 and all(1 <= s[0] <= rs.LOW_STEPS for s in steps.values())
    else:
        assert not any(steps.values())
    assert rs.control_precision({"dtype": "float64", "dst_precision": "highest"}) == "float32"
    assert rs.control_precision({"dtype": "float32", "dst_precision": "highest"}) == "tf32"
    assert rs.control_precision({"dtype": "float32", "dst_precision": "high"}) == "bf16"


def test_round_mantissa():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-8 - 2**-9, 3.0], dtype=torch.float32)
    assert rs.round_mantissa(x, 10).tolist() == [1.0, 1.0 + 4 * 2**-11, -1.0 - 2**-8 - 2**-9, 3.0]
    assert rs.round_mantissa(x, 7).tolist() == [1.0, 1.0, -1.0 - 2**-7, 3.0]


def test_gmres_is_never_entered_on_a_sine_diagonalizable_space(monkeypatch):
    """On the 1D and 2D lumped spaces ``solve`` is the sine solve alone, and
    ``surrogate_solve`` is that solve in float64, bit for bit."""
    def refused(*args):
        raise AssertionError("GMRES entered")

    monkeypatch.setattr(rs, "_gmres", refused)
    for dim, mass, N_x in SPACES[:3]:
        for problem in ("wave", "heat"):
            pc, data = _case(problem, dim, mass, N_x, N_t=7)
            b = torch.stack([ref.rhs(problem, pc, data)] * 2)
            steps = []
            for p in ("float64", "float32", "tf32", "bf16"):
                rs.solve(problem, pc, b, p, steps)
            assert steps == [] and rs.diagonalizable(pc)
            assert torch.equal(rs.surrogate_solve(problem, pc, b), rs.solve(problem, pc, b, "float64"))
    pc, data = _case("wave", 2, "consistent", 6)
    with pytest.raises(AssertionError, match="GMRES entered"):
        rs.solve("wave", pc, ref.rhs("wave", pc, data))


def test_surrogate_symbols_are_the_sine_diagonal_of_the_consistent_mass():
    """The surrogate's mass eigenvalues are the diagonal of V M V^T / (N_x/2)^2
    for the 2D consistent mass; its stiffness eigenvalues the 5-point ones."""
    N_x = 8
    pc = {"N_x": N_x, "dim": 2, "mass": "consistent"}
    m, k = rs.symbols(pc)
    i = torch.arange(1, N_x, dtype=torch.float64)
    S = torch.sin(math.pi * torch.outer(i, i) / N_x)
    V = torch.einsum("ay,bx->abyx", S, S).reshape((N_x - 1) ** 2, -1)
    MV = ref.mass(pc, V) @ V.T / (N_x / 2) ** 2
    np.testing.assert_allclose(torch.diagonal(MV).numpy(), m.numpy(), atol=1e-15)
    assert float((MV - torch.diag(torch.diagonal(MV))).abs().max()) > 1e-4  # the part the surrogate leaves out
    np.testing.assert_allclose(k.numpy(), rs.eigenvalues(dict(pc, mass="lumped"))[1].numpy())
    with pytest.raises(ValueError, match="does not diagonalize"):
        rs.eigenvalues(pc)


def test_the_control_of_a_2d_consistent_cell_reads_above_the_program():
    """A tiny 2D consistent wave cell under the batch8 traffic: the port's
    float32 route passes where the TF32 GMRES control in its place reads
    more than 3 times as high; the surrogate alone reads higher than the
    program too."""
    from portbench import cell as cellmod
    from portbench_helpers import consistent_cell

    cell = consistent_cell("batch8", N_x=32, N_t=16)
    seed = 2**31 + 77
    precision = rs.control_precision(cell.traffic)
    assert precision == "tf32"
    pc = cell.config["problem_config"]

    def wrap(solve):
        return lambda fn: (lambda b: (solve(b), None))

    program = cellmod.run_cell(cell, seed, 0.1, False, device="cpu")
    control = cellmod.run_cell(cell, seed, 0.1, False, device="cpu",
                               wrap=wrap(lambda b: rs.solve("wave", pc, b.to(torch.float64), precision)))
    surrogate = cellmod.run_cell(cell, seed, 0.1, False, device="cpu",
                                 wrap=wrap(lambda b: rs.surrogate_solve("wave", pc, b)))
    read = {k: v["check"]["rel_residual"]["value"] for k, v in
            (("program", program), ("control", control), ("surrogate", surrogate))}
    assert program["check"]["answered"]["value"] == 32
    assert read["control"] > 3 * read["program"] and read["surrogate"] > 3 * read["program"]
