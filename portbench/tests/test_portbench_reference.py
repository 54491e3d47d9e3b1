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
def test_against_a_dense_float64_solve(problem, dim, mass, N_x):
    pc, data = _case(problem, dim, mass, N_x)
    b = ref.rhs(problem, pc, data)
    A = _dense(problem, pc, b.shape)
    x = torch.linalg.solve(A, b.reshape(-1)).reshape(b.shape)
    assert ref.rel_residual(problem, pc, data, x) < 1e-12
    if (dim, mass) != (2, "consistent"):
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
def test_control_precisions_in_order(problem):
    pc, data = _case(problem, 1, "consistent", 128, N_t=64)
    b = ref.rhs(problem, pc, data)
    rel = {p: ref.rel_residual(problem, pc, data, rs.solve(problem, pc, b, p)) for p in ("float64", "float32", "tf32", "bf16")}
    assert rel["float64"] < 1e-11 < rel["float32"] < rel["tf32"] / 10 < rel["bf16"]
    assert rs.control_precision({"dtype": "float64", "dst_precision": "highest"}) == "float32"
    assert rs.control_precision({"dtype": "float32", "dst_precision": "highest"}) == "tf32"
    assert rs.control_precision({"dtype": "float32", "dst_precision": "high"}) == "bf16"


def test_round_mantissa():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-8 - 2**-9, 3.0], dtype=torch.float32)
    assert rs.round_mantissa(x, 10).tolist() == [1.0, 1.0 + 4 * 2**-11, -1.0 - 2**-8 - 2**-9, 3.0]
    assert rs.round_mantissa(x, 7).tolist() == [1.0, 1.0, -1.0 - 2**-7, 3.0]
