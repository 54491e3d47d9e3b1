"""The autodiff-Lagrangian derivation oracle of the PyTorch port
(``models/wave_lagrangian.py``) vs the JAX package's, in float64 on the
CPU: the KKT residual (``torch.func.grad`` against ``jax.grad``), the
Hessian-vector product (forward over reverse), the 'direct' and 'gmres'
solves and ``error_vs_analytic``; the fast cases of tests/test_lagrangian.py
run in both packages.

Tolerances (relative max-abs): the KKT residual and the HVP 1e-12; the
'direct' solve 1e-10; ``error_vs_analytic`` 1e-10 absolute; 'gmres' JAX's
iteration count, x 1e-8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_control_paradiag_torch import LagrangianWaveProblem, ProblemConfig
from optimal_control_paradiag_tpu.config import ProblemConfig as JProblemConfig
from optimal_control_paradiag_tpu.models.wave_lagrangian import LagrangianWaveProblem as JLagrangian

torch.set_num_threads(1)

CASES = [dict(N_x=6, N_t=7), dict(N_x=4, N_t=5, dim=2, gamma=0.5)]
IDS = ["1d", "2d"]


def _close(ref, got, tol):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert ref.shape == got.shape
    assert np.abs(ref - got).max() <= tol * np.abs(ref).max()


def _pair(**kw):
    return (JLagrangian(JProblemConfig(scaled=False, **kw)),
            LagrangianWaveProblem(ProblemConfig(scaled=False, **kw), device="cpu"))


def test_requires_unscaled():
    """tests/test_lagrangian.py:12."""
    with pytest.raises(ValueError, match="unscaled"):
        LagrangianWaveProblem(ProblemConfig(N_x=6, N_t=7, scaled=True), device="cpu")


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_kkt_residual_and_hvp_match_jax(kw):
    """grad S at a random point and an HVP against JAX's, 1e-12; the
    Lagrangian itself too."""
    jp, tp = _pair(**kw)
    rng = np.random.default_rng(0)
    u, p, v = (rng.standard_normal((tp.N, tp.space.n)) for _ in range(3))
    _close(jax.jit(jp.lagrangian)(jnp.asarray(u), jnp.asarray(p)),
           tp.lagrangian(torch.from_numpy(u), torch.from_numpy(p)).reshape(()), 1e-12)
    _close(jax.jit(jp.kkt_residual)(jnp.asarray(u), jnp.asarray(p)),
           tp.kkt_residual(torch.from_numpy(u), torch.from_numpy(p)), 1e-12)
    vv = np.stack([v, u])
    jgrad = lambda z: jp.kkt_residual(z[0], z[1])
    jhv = jax.jit(lambda w: jax.jvp(jgrad, (jnp.zeros(vv.shape),), (w,))[1])(jnp.asarray(vv))
    _close(jhv, tp.hvp(torch.from_numpy(vv)), 1e-12)


def test_hvp_is_symmetric():
    """tests/test_lagrangian.py:17: H is a Hessian, so v2.H v1 = v1.H v2."""
    tp = LagrangianWaveProblem(ProblemConfig(N_x=5, N_t=6, scaled=False), device="cpu")
    rng = np.random.default_rng(0)
    v1, v2 = (torch.from_numpy(rng.standard_normal((2, tp.N, tp.space.n))) for _ in range(2))
    a, b = float(torch.sum(v2 * tp.hvp(v1))), float(torch.sum(v1 * tp.hvp(v2)))
    np.testing.assert_allclose(a, b, rtol=1e-10)


@pytest.mark.parametrize("kw", [dict(N_x=12, N_t=12), CASES[1]], ids=IDS)
def test_direct_solve_matches_jax(kw):
    """The 'direct' solve (the Hessian column by column through vmapped
    HVPs, then LU) against JAX's, 1e-10; ``error_vs_analytic`` equal; the
    1D case is tests/test_lagrangian.py:36 (error < 8.0)."""
    jp, tp = _pair(**kw)
    jsol, sol = jp.solve(), tp.solve()
    assert bool(sol.result.converged) and bool(jsol.result.converged)
    _close(jsol.u, sol.u, 1e-10)
    _close(jsol.p, sol.p, 1e-10)
    e, je = tp.error_vs_analytic(sol), jp.error_vs_analytic(jsol)
    assert abs(e - je) <= 1e-10
    if kw.get("dim", 1) == 1:
        assert e < 8.0


def test_gmres_solve_matches_jax():
    """The matrix-free 'gmres' route: JAX's iteration count, x 1e-8."""
    jp, tp = _pair(N_x=6, N_t=7)
    jsol, sol = jp.solve("gmres", rtol=1e-10), tp.solve("gmres", rtol=1e-10)
    assert int(sol.result.iterations) == int(jsol.result.iterations)
    assert bool(sol.result.converged)
    _close(jsol.u, sol.u, 1e-8)
