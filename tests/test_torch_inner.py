"""The inner solvers of the ParaDiag ``eig`` preconditioner in the PyTorch
port (``ops/tridiag.py``, ``krylov/cocg.py``, ``paradiag/inner.py``) vs the
JAX package, in float64 on the CPU, on seeded numpy inputs.

Tolerances: Thomas and PCR against JAX's and against a dense solve 1e-12
(relative max-abs); the tridiagonal inner solve against the DST one 1e-10
absolute, as tests/test_inner.py; COCG on the 2D consistent shifted system
the dense residual bound of tests/test_inner.py:56 (1e-8 absolute) and the
same iteration count as JAX's ``cocg``; end to end, each inner solver
converges, the same iterations as JAX, u within 1e-6 of the default solve
(tests/test_inner.py:94-103)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optimal_control_paradiag_tpu as J
from optimal_control_paradiag_torch import ProblemConfig, SolverConfig, WaveControlProblem
from optimal_control_paradiag_torch.fem.space import make_space
from optimal_control_paradiag_torch.interop import problem_from_jax
from optimal_control_paradiag_torch.krylov.cocg import cocg
from optimal_control_paradiag_torch.ops import tridiag
from optimal_control_paradiag_torch.paradiag import inner
from optimal_control_paradiag_tpu.fem.space import make_space as j_make_space
from optimal_control_paradiag_tpu.krylov.cocg import cocg as j_cocg
from optimal_control_paradiag_tpu.ops import tridiag as j_tridiag
from optimal_control_paradiag_tpu.paradiag import inner as j_inner

torch.set_num_threads(1)


def _close(ref, got, tol):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape
    assert np.abs(ref - got).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("solver", ["thomas", "pcr"])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128], ids=["real", "complex"])
@pytest.mark.parametrize("n", [1, 2, 7, 16, 33])
def test_tridiag_matches_jax_and_dense(solver, dtype, n):
    rng = np.random.default_rng(0)
    batch = 5

    def rand(shape):
        x = rng.standard_normal(shape)
        if np.issubdtype(dtype, np.complexfloating):
            x = x + 1j * rng.standard_normal(shape)
        return x

    d = rand((batch, n)) + 4.0  # diagonally dominant
    dl, du, b = rand((batch, n)), rand((batch, n)), rand((batch, n))
    x = getattr(tridiag, solver)(*(torch.from_numpy(a) for a in (dl, d, du, b))).numpy()
    xj = np.asarray(getattr(j_tridiag, solver)(*(jnp.asarray(a) for a in (dl, d, du, b))))
    _close(xj, x, 1e-12)
    dense = np.stack([
        np.linalg.solve(np.diag(d[i]) + np.diag(dl[i][1:], -1) + np.diag(du[i][:-1], 1), b[i])
        for i in range(batch)
    ])
    _close(dense, x, 1e-12)


def _shifted_case(N_t, n, seed, shift):
    rng = np.random.default_rng(seed)
    sigma = rng.standard_normal((N_t, 1)) + 1j * rng.standard_normal((N_t, 1)) + shift
    rhs = rng.standard_normal((N_t, n)) + 1j * rng.standard_normal((N_t, n))
    return sigma, rhs


@pytest.mark.parametrize("method", ["thomas", "pcr"])
@pytest.mark.parametrize("mass", ["consistent", "lumped"])
def test_tridiag_inner_matches_dst_and_jax(method, mass):
    dt = 0.1
    sp = make_space(1, 17, mass=mass, device="cpu")
    tri = inner.make_tridiag_inner_solver(sp, dt, method=method)
    dst = inner.make_dst_inner_solver(sp, dt)
    sigma, rhs = _shifted_case(6, sp.n, 1, 3.0)
    w = tri(torch.from_numpy(sigma), torch.from_numpy(rhs))
    np.testing.assert_allclose(w.numpy(), dst(torch.from_numpy(sigma), torch.from_numpy(rhs)).numpy(), atol=1e-10)
    jsp = j_make_space(1, 17, mass=mass)
    _close(j_inner.make_tridiag_inner_solver(jsp, dt, method=method)(jnp.asarray(sigma), jnp.asarray(rhs)), w, 1e-12)
    _close(j_inner.make_dst_inner_solver(jsp, dt)(jnp.asarray(sigma), jnp.asarray(rhs)),
           dst(torch.from_numpy(sigma), torch.from_numpy(rhs)), 1e-12)


def test_spectrum_tensor_matches_jax():
    for kw in (dict(dim=2, N_x=8), dict(dim=2, N_x=8, mass="lumped"), dict(dim=1, N_x=9)):
        _close(j_make_space(**kw).spectrum_tensor, make_space(**kw, device="cpu").spectrum_tensor, 1e-15)


def test_cocg_solves_2d_consistent_shifted_system_like_jax():
    """tests/test_inner.py:56: the COCG inner solve on the 2D consistent
    mass; the port's ``cocg`` takes JAX's iteration count on it."""
    dt = 0.15
    c = 0.5 * dt * dt
    sp, jsp = make_space(2, 8, device="cpu"), j_make_space(2, 8)
    sigma, rhs = _shifted_case(4, sp.n, 2, 2.0)
    w = inner.make_cocg_inner_solver(sp, dt, tol=1e-12, maxiter=100)(torch.from_numpy(sigma), torch.from_numpy(rhs))
    M, K = jsp.mass_dense(), jsp.stiffness_dense()
    for k in range(4):
        np.testing.assert_allclose((sigma[k, 0] * M + c * K) @ w[k].numpy(), rhs[k], atol=1e-8)
    wj = j_inner.make_cocg_inner_solver(jsp, dt, tol=1e-12, maxiter=100)(jnp.asarray(sigma), jnp.asarray(rhs))
    _close(wj, w, 1e-10)

    # the iteration counts, through each package's cocg on the same system
    muK = np.asarray(jsp.spectrum[1])[None, :]
    muMt = np.asarray(jsp.spectrum_tensor)[None, :]

    def port_pinv(r, s=torch.from_numpy(sigma)):
        return sp.idst(sp.dst(r) / (s * torch.from_numpy(muMt) + c * torch.from_numpy(muK)))

    def jax_pinv(r, s=jnp.asarray(sigma)):
        return jsp.idst(jsp.dst(r) / (s * muMt + c * muK))

    st = torch.from_numpy(sigma)
    _, it_t = cocg(lambda v: st * sp.apply_mass(v) + c * sp.apply_stiffness(v), torch.from_numpy(rhs),
                   M=port_pinv, dot_axes=(-1,), tol=1e-12, maxiter=100)
    sj = jnp.asarray(sigma)
    _, it_j = j_cocg(lambda v: sj * jsp.apply_mass(v) + c * jsp.apply_stiffness(v), jnp.asarray(rhs),
                     M=jax_pinv, dot_axes=(-1,), tol=1e-12, maxiter=100)
    assert 1 < it_t == int(it_j) < 100


def test_jacobi_cocg_needs_a_general_space():
    """The JAX package reaches ``space.mass_diag`` and fails with an
    AttributeError on a structured space; the port raises a ValueError that
    names the (unstructured) spaces it serves."""
    with pytest.raises(ValueError, match="general"):
        inner.make_jacobi_cocg_inner_solver(make_space(1, 8, device="cpu"), 0.1)


@pytest.mark.parametrize("which", ["dst", "tridiag_thomas", "tridiag_pcr", "cocg"])
def test_eig_inner_solvers_end_to_end(which):
    """tests/test_inner.py:94: every inner solver converges to the default
    solve's u, in JAX's iteration count."""
    jcfg = J.ProblemConfig(N_x=12, N_t=13)
    jp = J.WaveControlProblem(jcfg)
    tp = problem_from_jax(dataclasses.asdict(jcfg), {k: np.asarray(v) for k, v in jp._data.items()}, device="cpu")
    ref = tp.solve(SolverConfig(rtol=1e-8))
    sol = tp.solve(SolverConfig(rtol=1e-8, inner=which))
    assert bool(sol.result.converged)
    np.testing.assert_allclose(sol.u.numpy(), ref.u.numpy(), atol=1e-6)
    js = jp.solve(J.SolverConfig(rtol=1e-8, inner=which))
    assert int(sol.result.iterations) == int(js.result.iterations)


def test_wave_cocg_inner_on_2d_consistent_mass_matches_jax():
    """An explicit ``inner='cocg'`` on the 2D consistent mass (the 'eig'
    variant with COCG inner solves; ``inner='auto'`` picks blockline)."""
    jcfg = J.ProblemConfig(N_x=6, N_t=8, dim=2)
    jp = J.WaveControlProblem(jcfg)
    tp = problem_from_jax(dataclasses.asdict(jcfg), {k: np.asarray(v) for k, v in jp._data.items()}, device="cpu")
    js = jp.solve(J.SolverConfig(rtol=1e-8, inner="cocg"))
    ts = tp.solve(SolverConfig(rtol=1e-8, inner="cocg"))
    assert bool(ts.result.converged) == bool(js.result.converged)
    assert int(ts.result.iterations) == int(js.result.iterations)
    np.testing.assert_allclose(ts.u.numpy(), np.asarray(js.u), rtol=0, atol=1e-8)


@pytest.mark.parametrize(
    "cfg,solver,match",
    [
        (ProblemConfig(N_x=6, N_t=6, dim=2), SolverConfig(rtol=1e-8), None),
        (ProblemConfig(N_x=8, N_t=6), SolverConfig(inner="cocg_jacobi"), "general"),
        (ProblemConfig(N_x=8, N_t=6), SolverConfig(rtol=1e-8, pc_variant="blockdense"), None),
    ],
    ids=["2d-consistent-auto", "cocg-jacobi", "blockdense"],
)
def test_unported_gmres_routes_raise(cfg, solver, match):
    """The GMRES routes of ROADMAP Queue A items 9 and 10: the 2D consistent
    mass's auto route (blockline) and 'blockdense' converge; Jacobi-COCG on
    a structured space raises ``ValueError`` (the JAX package an
    AttributeError: a structured space has no ``mass_diag``)."""
    prob = WaveControlProblem(cfg, device="cpu")
    if match is None:
        sol = prob.solve(solver)
        assert bool(sol.result.converged) and prob.relative_residual_f64(sol) < 1e-6
    else:
        with pytest.raises(ValueError, match=match):
            prob.solve(solver)
