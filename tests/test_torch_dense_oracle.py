"""The naive dense assembly of the all-at-once system in the PyTorch port
(``ops/dense_oracle.py``) vs the JAX package's, in float64 on the CPU, and
the port's matrix-free operator, its densified matrix and its right-hand
side against it: the cases of tests/test_operator.py:23.

Tolerances: the oracle's (A, b) equal to JAX's (1e-12 absolute; both are
the same float64 numpy loops over the same M and K);
``AllAtOnceOperator.dense``, the matvec and ``build_rhs`` against the
oracle, 1e-12 absolute."""

import numpy as np
import pytest
import torch

from optimal_control_paradiag_torch.fem.space import make_space
from optimal_control_paradiag_torch.models.analytic import manufactured
from optimal_control_paradiag_torch.ops.allatonce import build_operator, build_rhs
from optimal_control_paradiag_torch.ops.dense_oracle import assemble_dense
from optimal_control_paradiag_tpu.fem.space import make_space as j_make_space
from optimal_control_paradiag_tpu.ops.dense_oracle import assemble_dense as j_assemble_dense

torch.set_num_threads(1)


def _data(sp, N_t, dt, T, gamma, dim):
    an = manufactured(dim, T, gamma)
    f = np.stack([np.asarray(sp.interpolate(lambda *x: an.f(*x, i * dt))) for i in range(N_t)])
    g = np.stack([np.asarray(sp.interpolate(lambda *x: an.g(*x, (i + 1) * dt))) for i in range(N_t)])
    return f, g, np.asarray(sp.interpolate(an.u0)), np.asarray(sp.interpolate(an.u1))


@pytest.mark.parametrize(
    "dim,N_x,N_t,gamma,scaled,mass",
    [
        (1, 6, 7, 1.0, True, "consistent"),
        (1, 6, 7, 1.0, False, "consistent"),
        (1, 5, 8, 0.25, True, "consistent"),
        (1, 5, 8, 0.25, False, "consistent"),
        (2, 4, 5, 1.0, True, "consistent"),
        (2, 4, 5, 2.0, True, "lumped"),
    ],
)
def test_oracle_matches_jax_and_the_operator(dim, N_x, N_t, gamma, scaled, mass):
    T = 2.0
    dt = T / N_t
    sp = make_space(dim, N_x, mass=mass, device="cpu")
    op = build_operator(sp, N_t, dt, gamma, scaled=scaled)
    s = np.sqrt(gamma) if scaled else 1.0
    f, g, u0, u1 = _data(sp, N_t, dt, T, gamma, dim)

    A, b = assemble_dense(sp, N_t, dt, gamma, scaled, s * f, g, s * u0, s * u1)
    jA, jb = j_assemble_dense(j_make_space(dim, N_x, mass=mass), N_t, dt, gamma, scaled, s * f, g, s * u0, s * u1)
    np.testing.assert_allclose(A, jA, rtol=0, atol=1e-12)
    np.testing.assert_allclose(b, jb, rtol=0, atol=1e-12)

    np.testing.assert_allclose(op.dense().numpy(), A, rtol=0, atol=1e-12)
    x = np.random.default_rng(42).standard_normal((2, N_t, sp.n))
    np.testing.assert_allclose(op.matvec(torch.from_numpy(x)).numpy().reshape(-1), A @ x.reshape(-1), atol=1e-12)
    t = lambda v: torch.from_numpy(np.asarray(v))
    b_got = build_rhs(op, t(s * f), t(g), t(s * u0), t(s * u1)).numpy().reshape(-1)
    np.testing.assert_allclose(b_got, b, atol=1e-12)
