"""The 2D consistent-mass direct solves of the PyTorch port
(``paradiag/woodbury2d.py``, the wave and heat ``method='woodbury'`` routes
on non-diagonalizable spaces) vs the JAX package, in float64 on the CPU, on
seeded numpy inputs; the fast tests of tests/test_woodbury2d.py, each run
in both packages.

Tolerances (relative max-abs, ``|a - b|.max() <= tol * |a|.max()``): the
splitting maps and capacity inverses 1e-12, the SMW direct solves 1e-11,
the GMRES solves 1e-10 with the same iteration counts (batched: the same
per-lane counts as JAX's ``vmap``); the port against its own dense direct
solve 1e-8 absolute and the splitting identity 1e-10 absolute, as the JAX
tests hold them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optimal_control_paradiag_tpu as J
from optimal_control_paradiag_torch import SolverConfig
from optimal_control_paradiag_torch.interop import heat_problem_from_jax, problem_from_jax
from optimal_control_paradiag_torch.models.wave import WaveSolution
from optimal_control_paradiag_torch.paradiag.pc import build_preconditioner
from optimal_control_paradiag_torch.paradiag.spectral import _capacity_CW, _spectral_plan
from optimal_control_paradiag_torch.paradiag.woodbury2d import (
    build_tensor_gmres_solver,
    build_woodbury2d_solver,
    time_corner_maps,
)
from optimal_control_paradiag_tpu.models.heat import HeatControlProblem as JHeat
from optimal_control_paradiag_tpu.paradiag import woodbury2d as jw

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


def _pair_heat(**kw):
    jcfg = J.ProblemConfig(**kw)
    jh = JHeat(jcfg)
    th = heat_problem_from_jax(dataclasses.asdict(jcfg), {k: np.asarray(v) for k, v in jh._data.items()}, device="cpu")
    return jh, th


# tests/test_woodbury2d.py:20
@pytest.mark.parametrize("dim,mass", [(2, "consistent"), (1, "consistent"), (2, "lumped")],
                         ids=["2d-consistent", "1d-consistent", "2d-lumped"])
def test_time_corner_splitting_identity(dim, mass):
    """P^{-1}(A x - Psi R Phi* x) == x for every space, and each of the
    three maps equals the JAX package's."""
    jp, tp = _pair(N_x=8, N_t=6, dim=dim, mass=mass)
    op = tp.operator
    variant = "blockline" if (dim == 2 and mass == "consistent") else "fulldiag"
    Pinv = build_preconditioner(op, variant=variant)
    phi_star, R, psi = time_corner_maps(op)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(op.shape)
    xt = torch.from_numpy(x)
    x_rec = Pinv(op.matvec(xt) - psi(R(phi_star(xt))))
    np.testing.assert_allclose(x_rec.numpy(), x, rtol=0, atol=1e-10)
    jphi, jR, jpsi = jw.time_corner_maps(jp.operator)
    _close(jphi(jnp.asarray(x)), phi_star(xt), 1e-12)
    z = rng.standard_normal((4, op.space.n))
    _close(jR(jnp.asarray(z)), R(torch.from_numpy(z)), 1e-12)
    _close(jpsi(jnp.asarray(z)), psi(torch.from_numpy(z)), 1e-12)


def test_tensor_capacity_inverse_matches_jax():
    """The tensor-mass surrogate's capacity ingredients (C_j, W_j) of the
    mass-surrogate plan, from which the SMW capacity preconditioner is made."""
    from optimal_control_paradiag_tpu.paradiag.spectral import _capacity_CW as j_cw
    from optimal_control_paradiag_tpu.paradiag.spectral import _spectral_plan as j_plan

    jp, tp = _pair(N_x=9, N_t=8, dim=2)
    for ref, got in zip(j_cw(j_plan(jp.operator, mass_surrogate=True)),
                        _capacity_CW(_spectral_plan(tp.operator, mass_surrogate=True))):
        _close(ref, got, 1e-12)


def test_woodbury2d_matches_dense_direct():
    """tests/test_woodbury2d.py:36: ``method='woodbury'`` on the 2D
    consistent mass (tensor GMRES) against the dense direct solve, and
    against JAX's."""
    jp, tp = _pair(N_x=7, N_t=8, dim=2)
    sol = tp.solve(SolverConfig(method="woodbury"))
    assert sol.result is None  # the direct-solve API, as in the JAX package
    lu = tp.solve(SolverConfig(method="direct"))
    np.testing.assert_allclose(sol.u.numpy(), lu.u.numpy(), atol=1e-8)
    np.testing.assert_allclose(sol.p.numpy(), lu.p.numpy(), atol=1e-8)
    js = jp.solve(J.SolverConfig(method="woodbury"))
    _close(js.u, sol.u, 1e-10)
    _close(js.p, sol.p, 1e-10)


def test_woodbury2d_residual_and_capacity_pins():
    """tests/test_woodbury2d.py:45 at N = 16: the SMW solve over blockline
    reaches a true residual below 1e-8 and equals JAX's to 1e-11; its
    capacity GMRES takes JAX's iteration count (<= 22)."""
    jp, tp = _pair(N_x=16, N_t=16, dim=2)
    op = tp.operator
    x = build_woodbury2d_solver(op, cap_rtol=1e-10)(tp.rhs)
    rel = float(torch.linalg.norm((op.matvec(x) - tp.rhs).reshape(-1)) / torch.linalg.norm(tp.rhs.reshape(-1)))
    assert rel < 1e-8
    _close(jax.jit(jw.build_woodbury2d_solver(jp.operator, cap_rtol=1e-10))(jp.rhs), x, 1e-11)

    # the capacity iteration count, from the pieces (as the JAX test does)
    from optimal_control_paradiag_torch.krylov.gmres import gmres

    Pinv = build_preconditioner(op, variant="blockline")
    phi_star, R, psi = time_corner_maps(op)
    C, W = _capacity_CW(_spectral_plan(op, mass_surrogate=True))
    Minv = torch.from_numpy(np.linalg.inv(np.eye(4)[None] + C @ W).real)
    sp = tp.space
    res = gmres(lambda q: q + R(phi_star(Pinv(psi(q)))), R(phi_star(Pinv(tp.rhs))),
                M=lambda q: sp.idst(torch.einsum("nab,bn->an", Minv, sp.dst(q))),
                restart=100, rtol=1e-10, maxiter=100)
    assert bool(res.converged)
    assert int(res.iterations) <= 22, int(res.iterations)
    assert int(res.iterations) == _jax_capacity_iterations(jp)


def _jax_capacity_iterations(jp) -> int:
    """The JAX package's capacity GMRES count (tests/test_woodbury2d.py:59-82)."""
    from optimal_control_paradiag_tpu.krylov.gmres import gmres as j_gmres
    from optimal_control_paradiag_tpu.paradiag.pc import build_preconditioner as j_bp
    from optimal_control_paradiag_tpu.paradiag.spectral import _capacity_CW as j_cw
    from optimal_control_paradiag_tpu.paradiag.spectral import _spectral_plan as j_plan

    op = jp.operator
    Pinv = j_bp(op, variant="blockline")
    phi_star, R, psi = jw.time_corner_maps(op)
    C, W = j_cw(j_plan(op, mass_surrogate=True))
    Minv = jnp.asarray(np.linalg.inv(np.eye(4)[None] + C @ W).real)
    sp = jp.space
    res = jax.jit(lambda r: j_gmres(lambda q: q + R(phi_star(Pinv(psi(q)))), r,
                                    M=lambda q: sp.idst(jnp.einsum("nab,bn->an", Minv, sp.dst(q))),
                                    restart=100, rtol=1e-10, maxiter=100))(R(phi_star(Pinv(jp.rhs))))
    return int(res.iterations)


def test_woodbury2d_rejects_diagonalizable():
    _, tp = _pair(N_x=8, N_t=6, dim=2, mass="lumped")
    with pytest.raises(ValueError, match="diagonalizable"):
        build_woodbury2d_solver(tp.operator)
    with pytest.raises(ValueError, match="diagonalizable"):
        build_tensor_gmres_solver(tp.operator)


# tests/test_woodbury2d.py:100, at N <= 16
@pytest.mark.parametrize("N", [8, 12, 16])
def test_tensor_gmres_matches_jax(N):
    """The mesh-independent tensor GMRES: JAX's iteration count at rtol
    1e-10 (<= 12, as JAX pins it), its solution to 1e-10, and a float64
    oracle residual below 1e-8."""
    jp, tp = _pair(N_x=N, N_t=N, dim=2)
    x, res = build_tensor_gmres_solver(tp.operator, rtol=1e-10, maxiter=40, with_result=True)(tp.rhs)
    jx, jres = jax.jit(jw.build_tensor_gmres_solver(jp.operator, rtol=1e-10, maxiter=40, with_result=True))(jp.rhs)
    assert bool(res.converged)
    assert int(res.iterations) == int(jres.iterations) <= 12
    _close(jx, x, 1e-10)
    assert tp.relative_residual_f64(WaveSolution(u=x[0], p=x[1], result=None)) < 1e-8


def test_tensor_gmres_is_the_woodbury_default_and_matches_blockline_smw():
    """tests/test_woodbury2d.py:119: ``method='woodbury'`` is the tensor
    GMRES; ``pc_variant='blockline'`` selects the SMW solve; both agree to
    direct accuracy, and each equals JAX's."""
    jp, tp = _pair(N_x=12, N_t=8, dim=2)
    sol_t = tp.solve(SolverConfig(method="woodbury"))
    sol_s = tp.solve(SolverConfig(method="woodbury", pc_variant="blockline"))
    np.testing.assert_allclose(sol_t.u.numpy(), sol_s.u.numpy(), atol=1e-8)
    np.testing.assert_allclose(sol_t.p.numpy(), sol_s.p.numpy(), atol=1e-8)
    _close(jp.solve(J.SolverConfig(method="woodbury")).u, sol_t.u, 1e-10)
    _close(jp.solve(J.SolverConfig(method="woodbury", pc_variant="blockline")).u, sol_s.u, 1e-11)


def test_polished_woodbury_on_2d_consistent_matches_jax():
    """``polish`` on top of the tensor GMRES, as in the JAX package."""
    jp, tp = _pair(N_x=8, N_t=8, dim=2)
    _close(jp.solve(J.SolverConfig(method="woodbury", polish=1)).u,
           tp.solve(SolverConfig(method="woodbury", polish=1)).u, 1e-10)


def _lanes(tp, B=3):
    """The problem's rhs and B-1 seeded lanes, as numpy."""
    rng = np.random.default_rng(7)
    rhs = tp.rhs.numpy()
    return np.stack([rhs] + [rhs * (1.0 + 0.5 * rng.standard_normal(rhs.shape)) for _ in range(B - 1)])


def test_batched_tensor_gmres_matches_jax_vmap():
    """A batch of three through the tensor GMRES: JAX's vmapped per-lane
    counts and solutions, and each lane equal to its own solve."""
    jp, tp = _pair(N_x=8, N_t=8, dim=2)
    bs = _lanes(tp)
    xs, res = build_tensor_gmres_solver(tp.operator, rtol=1e-10, with_result=True)(torch.from_numpy(bs))
    jxs, jres = jax.jit(jax.vmap(jw.build_tensor_gmres_solver(jp.operator, rtol=1e-10, with_result=True)))(
        jnp.asarray(bs))
    assert res.iterations.tolist() == np.asarray(jres.iterations).tolist()
    _close(jxs, xs, 1e-10)
    one = build_tensor_gmres_solver(tp.operator, rtol=1e-10, with_result=True)
    for i in range(3):
        x, r = one(torch.from_numpy(bs[i]))
        assert int(r.iterations) == int(res.iterations[i])
        _close(x, xs[i], 1e-10)


@pytest.mark.parametrize("pc_variant", ["fulldiag", "blockline"], ids=["tensor-gmres", "smw"])
def test_batched_woodbury_route_matches_jax_vmap(pc_variant):
    """``make_batched_solver_fn`` on the 2D consistent mass, both direct
    routes, against JAX's ``jax.vmap`` of the same solve."""
    jp, tp = _pair(N_x=8, N_t=8, dim=2)
    bs = _lanes(tp)
    xs, res = tp.make_batched_solver_fn(SolverConfig(method="woodbury", pc_variant=pc_variant))(torch.from_numpy(bs))
    assert res is None
    jxs, _ = jp.make_batched_solver_fn(J.SolverConfig(method="woodbury", pc_variant=pc_variant))(jnp.asarray(bs))
    _close(jxs, xs, 1e-10)


def test_heat_tensor_gmres_matches_jax():
    """The heat family's 2D consistent-mass solve
    (``HeatControlProblem.build_tensor_gmres_solver`` and its
    ``method='woodbury'`` route): JAX's iteration count and solution."""
    jh, th = _pair_heat(N_x=8, N_t=8, dim=2)
    js = jh.solve(J.SolverConfig(method="woodbury"))
    ts = th.solve(SolverConfig(method="woodbury"))
    assert bool(ts.result.converged)
    assert int(ts.result.iterations) == int(js.result.iterations)
    _close(js.u, ts.u, 1e-10)
    assert th.relative_residual_f64(ts) < 1e-8
    x, res = th.build_tensor_gmres_solver(rtol=1e-10, with_result=True)(th.rhs)
    jx, jres = jax.jit(jh.build_tensor_gmres_solver(rtol=1e-10, with_result=True))(jh.rhs)
    assert int(res.iterations) == int(jres.iterations)
    _close(jx, x, 1e-10)
    W = th.build_woodbury_solver(refine=0, mass_surrogate=True)
    r = np.random.default_rng(3).standard_normal((2, 8, th.space.n))
    _close(jax.jit(jh.build_woodbury_solver(refine=0, mass_surrogate=True))(jnp.asarray(r)),
           W(torch.from_numpy(r)), 1e-12)
