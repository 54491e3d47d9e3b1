"""The block-line direct inner solve of the PyTorch port
(``paradiag/blockline.py``), the ``block``, ``blockdense`` and ``blockline``
variants of ``paradiag/pc.py`` and the GMRES auto route of the 2D
consistent mass vs the JAX package, in float64 on the CPU, on seeded numpy
inputs; the fast tests of tests/test_blockline.py, each run in both
packages.

Tolerances (relative max-abs, ``|a - b|.max() <= tol * |a|.max()``):
factors and applies 1e-12 against JAX; blockline against blockdense 1e-9,
the circulant inverse 1e-10 absolute and the iterative ``block`` variant
against blockline 1e-6, as the JAX tests hold them; GMRES solves 1e-10 with
the same iteration counts (batched: the same per-lane counts as JAX's
``vmap``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optimal_control_paradiag_tpu as J
from optimal_control_paradiag_torch import SolverConfig
from optimal_control_paradiag_torch.fem.space import make_space
from optimal_control_paradiag_torch.interop import problem_from_jax
from optimal_control_paradiag_torch.paradiag.blockline import blockline_entries, build_blockline_solver
from optimal_control_paradiag_torch.paradiag.eigs import circulant_eigs
from optimal_control_paradiag_torch.paradiag.pc import build_preconditioner
from optimal_control_paradiag_tpu.paradiag.blockline import build_blockline_solver as j_build_blockline_solver
from optimal_control_paradiag_tpu.paradiag.pc import build_preconditioner as j_build_preconditioner

torch.set_num_threads(1)


def _close(ref, got, tol):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape
    assert np.abs(ref - got).max() <= tol * np.abs(ref).max()


def _pair(**kw):
    """(JAX problem, port problem on the CPU) on the same data."""
    jcfg = J.ProblemConfig(**kw)
    jp = J.WaveControlProblem(jcfg)
    tp = problem_from_jax(dataclasses.asdict(jcfg), {k: np.asarray(v) for k, v in jp._data.items()}, device="cpu")
    return jp, tp


def test_tensor_mass_splitting_identity():
    """tests/test_blockline.py:26: M = V diag(spectrum_tensor) V^{-1} +
    (h^2/24) S (x) S, whose remainder has zero sine-basis diagonal."""
    N_x = 9
    sp = make_space(2, N_x, device="cpu")
    m = sp.n1d
    i = np.arange(1, N_x)
    V1 = np.sin(np.pi * np.outer(i, i) / N_x)
    V = np.kron(V1, V1)
    Mt = V @ np.diag(np.asarray(sp.spectrum_tensor, np.float64)) @ np.linalg.inv(V)
    S1 = np.eye(m, k=1) - np.eye(m, k=-1)
    R = sp.mass_dense().numpy() - Mt
    np.testing.assert_allclose(R, (sp.h**2 / 24.0) * np.kron(S1, S1), atol=1e-12)
    assert np.abs(np.diag(np.linalg.inv(V) @ R @ V)).max() < 1e-14


@pytest.mark.parametrize("dim,mass", [(1, "consistent"), (1, "lumped"), (2, "lumped")])
def test_spectrum_tensor_equals_spectrum_when_diagonalizable(dim, mass):
    sp = make_space(dim, 7, mass=mass, device="cpu")
    np.testing.assert_array_equal(np.asarray(sp.spectrum_tensor), np.asarray(sp.spectrum[0]))


@pytest.mark.parametrize("N_t", [6, 8, 9, 12])
def test_blockline_matches_blockdense(N_t):
    """tests/test_blockline.py:53: the structured factorization reproduces
    the dense per-mode inverses, for odd N_t (the Hermitian mirror) and N_t
    % 4 == 0 (Lambda_2 ~ 0 modes); each variant equals JAX's to 1e-12."""
    jp, tp = _pair(N_x=7, N_t=N_t, dim=2)
    r = np.random.default_rng(0).standard_normal((2, N_t, tp.space.n))
    y_bd = build_preconditioner(tp.operator, variant="blockdense")(torch.from_numpy(r)).numpy()
    y_bl = build_preconditioner(tp.operator, variant="blockline")(torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(y_bl, y_bd, rtol=1e-9, atol=1e-9 * np.abs(y_bd).max())
    for variant, y in (("blockdense", y_bd), ("blockline", y_bl)):
        _close(jax.jit(j_build_preconditioner(jp.operator, variant=variant))(jnp.asarray(r)), y, 1e-12)


def test_blockline_solver_matches_jax_per_mode():
    """The half-spectrum solver itself on a Hermitian mode array (the
    factors through their applies), against JAX's."""
    jp, tp = _pair(N_x=8, N_t=7, dim=2)
    rhat = np.fft.ifft(np.random.default_rng(4).standard_normal((2, 7, tp.space.n)), axis=1)
    w = build_blockline_solver(tp.operator)(torch.from_numpy(rhat))
    _close(jax.jit(j_build_blockline_solver(jp.operator))(jnp.asarray(rhat)), w, 1e-12)


def test_blockline_is_exact_circulant_inverse():
    """tests/test_blockline.py:69: the blockline PC applied to the
    block-circulant matvec of x returns x."""
    _, tp = _pair(N_x=6, N_t=8, dim=2)
    op, sp = tp.operator, tp.space
    e = circulant_eigs(op.N_t, op.dt, op.gamma)
    c = 0.5 * op.dt * op.dt
    theta = op.dt * op.dt / np.sqrt(op.gamma)
    L1 = torch.from_numpy(np.asarray(e.Lambda1))[:, None]
    L2 = torch.from_numpy(np.asarray(e.Lambda2))[:, None]

    def circulant_matvec(x):
        xh = torch.fft.ifft(x.to(torch.complex128), dim=1)
        mu, mp = sp.apply_mass(xh[0]), sp.apply_mass(xh[1])
        ku, kp = sp.apply_stiffness(xh[0]), sp.apply_stiffness(xh[1])
        yu = L1 * mu + c * L2 * ku - theta * mp
        yp = theta * mu + L1.conj() * mp + c * L2.conj() * kp
        return torch.fft.fft(torch.stack([yu, yp]), dim=1).real

    x = np.random.default_rng(1).standard_normal((2, op.N_t, sp.n))
    x_rec = build_preconditioner(op, variant="blockline")(circulant_matvec(torch.from_numpy(x)))
    np.testing.assert_allclose(x_rec.numpy(), x, rtol=0, atol=1e-10)


def test_blockline_requires_2d():
    _, tp = _pair(N_x=8, N_t=6, dim=1)
    with pytest.raises(ValueError, match="2D"):
        build_blockline_solver(tp.operator)


def test_blockline_entries_formula():
    assert blockline_entries(64, 63) == 33 * 63 * 126**2
    assert blockline_entries(64, 63) < 64 * (2 * 63 * 63) ** 2


def test_block_variant_tensor_pc_matches_blockline():
    """tests/test_blockline.py:113 at N = 16: the iterative 'block' variant
    (COCG + tensor-mass Cramer preconditioner) agrees with the direct
    blockline solve to 1e-6, and with JAX's 'block' apply."""
    jp, tp = _pair(N_x=16, N_t=16, dim=2)
    r = np.random.default_rng(2).standard_normal((2, 16, tp.space.n))
    y_it = build_preconditioner(tp.operator, variant="block", inner_tol=1e-12, inner_maxiter=300)(torch.from_numpy(r))
    y_dr = build_preconditioner(tp.operator, variant="blockline")(torch.from_numpy(r))
    np.testing.assert_allclose(y_it.numpy(), y_dr.numpy(), atol=1e-6 * np.abs(y_dr.numpy()).max())
    j_it = jax.jit(j_build_preconditioner(jp.operator, variant="block", inner_tol=1e-12, inner_maxiter=300))
    _close(j_it(jnp.asarray(r)), y_it, 1e-10)


@pytest.mark.parametrize("variant", ["block", "blockdense"])
def test_variants_on_1d_match_jax(variant):
    """'block' and 'blockdense' also serve sine-diagonalizable spaces (1D):
    the same applies as JAX's, and the exact circulant inverse of fulldiag."""
    jp, tp = _pair(N_x=8, N_t=7)
    r = np.random.default_rng(5).standard_normal((2, 7, tp.space.n))
    y = build_preconditioner(tp.operator, variant=variant, inner_tol=1e-13, inner_maxiter=200)(torch.from_numpy(r))
    _close(jax.jit(j_build_preconditioner(jp.operator, variant=variant, inner_tol=1e-13, inner_maxiter=200))(
        jnp.asarray(r)), y, 1e-11)
    _close(build_preconditioner(tp.operator)(torch.from_numpy(r)), y, 1e-9)


def test_2d_consistent_auto_dispatch_is_blockline():
    """tests/test_blockline.py:130: ``inner='auto'`` on the 2D consistent
    mass picks blockline; JAX's iteration count, and the dense direct
    solve's answer."""
    jp, tp = _pair(N_x=6, N_t=8, dim=2)
    sol = tp.solve(SolverConfig(rtol=1e-10))
    assert bool(sol.result.converged)
    js = jp.solve(J.SolverConfig(rtol=1e-10))
    assert int(sol.result.iterations) == int(js.result.iterations)
    _close(js.u, sol.u, 1e-10)
    lu = tp.solve(SolverConfig(method="direct"))
    np.testing.assert_allclose(sol.u.numpy(), lu.u.numpy(), atol=1e-7)
    np.testing.assert_allclose(sol.p.numpy(), lu.p.numpy(), atol=1e-7)


# tests/test_blockline.py:164, at N <= 16 (JAX's pins: lumped 7/7, consistent 76/63)
@pytest.mark.parametrize("mass,pins", [("lumped", {8: 7, 16: 7}), ("consistent", {8: 76, 16: 63})])
def test_2d_iteration_count_pins(mass, pins):
    for N, cap in pins.items():
        jp, tp = _pair(N_x=N, N_t=N, dim=2, mass=mass)
        sol = tp.solve(SolverConfig(rtol=1e-8))
        assert bool(sol.result.converged), (mass, N)
        assert int(sol.result.iterations) <= cap, (mass, N, int(sol.result.iterations))
        assert int(sol.result.iterations) == int(jp.solve(J.SolverConfig(rtol=1e-8)).result.iterations), (mass, N)


def test_batched_blockline_gmres_matches_jax_vmap():
    """GMRES through the blockline auto route on a batch of three (the
    problem's rhs and two seeded lanes): JAX's vmapped per-lane counts and
    solutions."""
    jp, tp = _pair(N_x=6, N_t=8, dim=2)
    rng = np.random.default_rng(9)
    rhs = tp.rhs.numpy()
    bs = np.stack([rhs] + [rhs * (1.0 + 0.5 * rng.standard_normal(rhs.shape)) for _ in range(2)])
    xs, res = tp.make_batched_solver_fn(SolverConfig(rtol=1e-10))(torch.from_numpy(bs))
    jxs, jres = jp.make_batched_solver_fn(J.SolverConfig(rtol=1e-10))(jnp.asarray(bs))
    assert res.iterations.tolist() == np.asarray(jres.iterations).tolist()
    _close(jxs, xs, 1e-10)
