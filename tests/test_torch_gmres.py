"""Restarted GMRES of the PyTorch port (``krylov/gmres.py``) and both
families' ``method='gmres'`` solves vs the JAX package, in float64 on the
CPU, on identical inputs (seeded numpy systems; problems carried over by
``optimal_control_paradiag_torch.interop``).

Tolerances. Against JAX's ``gmres`` on the same matvec and preconditioner:
the same ``iterations`` and ``converged``, ``residual_history`` to rtol 1e-8
over the steps taken, with an absolute floor of 1e-13 times the initial
residual (a restart starts from the true residual ``b - A x``, whose
cancellation turns last-bit differences of the two packages' ``A @ x`` into
relative differences of ~eps/(|r|/|b|): 8e-8 at |r|/|b| = 3e-11), and ``x``
to 1e-10 relative max-abs. Dense systems: x to
1e-9 (no restart) and 1e-7 (restart) absolute against ``numpy.linalg.solve``,
as tests/test_gmres.py. Wave end to end (tests/test_endtoend.py): the same
iterations as JAX, u and p to 1e-10 absolute, the error pins to rtol 1e-6,
``error_aligned`` to 1e-10. Heat (tests/test_heat.py:23): the same
iterations as JAX, at most 5, ``relative_residual_f64`` below 1e-8."""

import dataclasses
import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optimal_control_paradiag_tpu as J
from optimal_control_paradiag_torch import SolverConfig
from optimal_control_paradiag_torch.interop import heat_problem_from_jax, problem_from_jax, solver_from_jax
from optimal_control_paradiag_tpu.models.heat import HeatControlProblem as JHeat

torch.set_num_threads(1)

# the modules (each package's krylov/__init__ exports a function of that name)
tg = importlib.import_module("optimal_control_paradiag_torch.krylov.gmres")
jg = importlib.import_module("optimal_control_paradiag_tpu.krylov.gmres")

# tests/test_endtoend.py:23-34
REFMETRIC_PINNED = {5: 3.892978733745, 10: 2.521856821760, 15: 1.831793732973, 20: 1.471805694944}
ALIGNED_PINNED = {5: 2.800438672622, 10: 1.403822833010, 15: 0.819026042513, 20: 0.544594305396}


def _system(n, complex_, seed):
    """tests/test_gmres.py's seeded system, as numpy arrays."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    if complex_:
        A = A + 1j * rng.standard_normal((n, n))
    A = A / np.linalg.norm(A, 2) + 2.0 * np.eye(n)
    b = rng.standard_normal(n)
    if complex_:
        b = b + 1j * rng.standard_normal(n)
    return A, b


def _both(A, b, Minv=None, **kw):
    """(JAX result, port result) of ``gmres`` on ``A x = b``, with the
    preconditioner ``v -> Minv @ v`` when given."""
    Aj, Bt = jnp.asarray(A), torch.from_numpy(A)
    Mj = None if Minv is None else (lambda v, P=jnp.asarray(Minv): P @ v)
    Mt = None if Minv is None else (lambda v, P=torch.from_numpy(Minv): P @ v)
    x0 = kw.pop("x0", None)
    rj = jg.gmres(lambda v: Aj @ v, jnp.asarray(b), M=Mj,
                  x0=None if x0 is None else jnp.asarray(x0), **kw)
    rt = tg.gmres(lambda v: Bt @ v, torch.from_numpy(b), M=Mt,
                  x0=None if x0 is None else torch.from_numpy(x0), **kw)
    return rj, rt


def _assert_same_run(rj, rt):
    it = int(rj.iterations)
    assert int(rt.iterations) == it
    assert bool(rt.converged) == bool(rj.converged)
    hj, ht = np.asarray(rj.residual_history), rt.residual_history.numpy()
    np.testing.assert_allclose(ht[: it + 1], hj[: it + 1], rtol=1e-8, atol=1e-13 * hj[0])
    assert np.all(np.isnan(ht[it + 1:])) and np.all(np.isnan(hj[it + 1:]))
    xj, xt = np.asarray(rj.x), rt.x.numpy()
    assert np.abs(xt - xj).max() <= 1e-10 * np.abs(xj).max()


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("restart", [40, 7], ids=["no-restart", "restart-7"])
@pytest.mark.parametrize("side", ["left", "right"])
def test_gmres_matches_jax(complex_, restart, side):
    A, b = _system(40, complex_, seed=1)
    Minv = np.diag(1.0 / np.diag(A))  # Jacobi
    rj, rt = _both(A, b, Minv, restart=restart, rtol=1e-11, maxiter=300, side=side)
    _assert_same_run(rj, rt)
    assert bool(rt.converged)
    if restart == 7:
        assert int(rt.iterations) > 7  # exercised the restart path


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
def test_gmres_solves_dense_system(complex_):
    A, b = _system(40, complex_, seed=0)
    rj, rt = _both(A, b, restart=40, rtol=1e-12, maxiter=200)
    np.testing.assert_allclose(rt.x.numpy(), np.linalg.solve(A, b), atol=1e-9)
    assert bool(rt.converged)
    _assert_same_run(rj, rt)


def test_gmres_with_restart():
    A, b = _system(50, False, seed=1)
    rj, rt = _both(A, b, restart=7, rtol=1e-10, maxiter=500)
    np.testing.assert_allclose(rt.x.numpy(), np.linalg.solve(A, b), atol=1e-7)
    assert int(rt.iterations) > 7
    _assert_same_run(rj, rt)


def test_exact_preconditioner_converges_in_one_step():
    A, b = _system(30, False, seed=2)
    rj, rt = _both(A, b, np.linalg.inv(A), restart=30, rtol=1e-10)
    assert int(rt.iterations) == int(rj.iterations) == 1
    np.testing.assert_allclose(rt.x.numpy(), np.linalg.solve(A, b), atol=1e-8)


def test_warm_start_matches_jax():
    A, b = _system(25, True, seed=6)
    x0 = np.linalg.solve(A, b) + 1e-3 * np.random.default_rng(7).standard_normal(25)
    rj, rt = _both(A, b, restart=25, rtol=1e-8, maxiter=100, x0=x0)
    _assert_same_run(rj, rt)


def test_residual_history_and_monitor():
    A, b = _system(25, False, seed=3)
    rj, rt = _both(A, b, restart=25, rtol=1e-10, maxiter=100)
    it = int(rt.iterations)
    hist = rt.residual_history.numpy()
    assert hist.shape == (101,)
    assert np.all(np.isfinite(hist[: it + 1])) and np.all(np.isnan(hist[it + 1:]))
    assert hist[it] <= 1e-10 * hist[0] + 1e-30
    _assert_same_run(rj, rt)


def test_zero_rhs():
    A, _ = _system(10, False, seed=5)
    rt = tg.gmres(lambda v: torch.from_numpy(A) @ v, torch.zeros(10, dtype=torch.float64), restart=10)
    assert int(rt.iterations) == 0 and bool(rt.converged)
    assert torch.equal(rt.x, torch.zeros(10, dtype=torch.float64))


def test_restart_memory_clamp_matches_jax():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tg.clamp_restart(300, (2, 16, 15), torch.float32, 1000) == 300
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            r = tg.clamp_restart(300, (2, 1024, 2047), dtype, 1000)
        assert rec and "clamping" in str(rec[0].message)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert r == jg.clamp_restart(300, (2, 1024, 2047), jdtype, 1000) < 300
        assert (r + 1) * 2 * 1024 * 2047 * (4 if dtype == torch.float32 else 8) <= 4e9
    # the solve still runs with a requested-but-clamped restart
    res = tg.gmres(lambda v: 2.0 * v, torch.ones(8, dtype=torch.float64), restart=300, rtol=1e-12, maxiter=50)
    assert bool(res.converged)
    with pytest.raises(ValueError, match="side"):
        tg.gmres(lambda v: v, torch.ones(3, dtype=torch.float64), side="middle")


# ----------------------------------------------------------------- wave


def _wave_pair(jcfg):
    jp = J.WaveControlProblem(jcfg)
    data = {k: np.asarray(v) for k, v in jp._data.items()}
    return jp, problem_from_jax(dataclasses.asdict(jcfg), data, device="cpu")


@pytest.mark.parametrize("N", [5, 10, 15, 20])
def test_wave_gmres_matches_jax_and_pins(N):
    jp, tp = _wave_pair(J.ProblemConfig(N_x=N, N_t=N))
    js = jp.solve(J.SolverConfig(rtol=1e-10))
    ts = tp.solve(solver_from_jax(dataclasses.asdict(J.SolverConfig(rtol=1e-10))))
    assert bool(ts.result.converged)
    assert int(ts.result.iterations) == int(js.result.iterations)
    np.testing.assert_allclose(ts.u.numpy(), np.asarray(js.u), rtol=0, atol=1e-10)
    np.testing.assert_allclose(ts.p.numpy(), np.asarray(js.p), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tp.error_vs_analytic(ts), REFMETRIC_PINNED[N], rtol=1e-6)
    np.testing.assert_allclose(tp.error_aligned(ts), ALIGNED_PINNED[N], rtol=1e-6)


def test_reference_default_run_matches_jax():
    """The verification run: ``reference_1d_default()``, rtol 1e-8
    (~5 iterations, aligned error ~0.0686)."""
    jp, tp = _wave_pair(J.reference_1d_default())
    js = jp.solve(J.SolverConfig(rtol=1e-8))
    ts = tp.solve(SolverConfig(rtol=1e-8))
    assert bool(ts.result.converged) and int(ts.result.iterations) <= 10
    assert int(ts.result.iterations) == int(js.result.iterations)
    assert abs(tp.error_aligned(ts) - jp.error_aligned(js)) <= 1e-10
    assert float(tp.residual_norm(ts)) < 1e-8
    assert tp.relative_residual_f64(ts) < 1e-8


def test_wave_right_side_and_warm_start_match_jax():
    # rtol 1e-11: the step-5 residual lies at the 1e-10 threshold's edge and
    # falls below it or not by the PC's rounding order: at 1e-10 the
    # full-spectrum order stops at step 5 with the 'dft' time transform and
    # at step 7 with 'fft', as JAX does; the half spectrum stops at 5 with
    # either. At 1e-11 every order takes 7 steps and u agrees to ~3e-13.
    jp, tp = _wave_pair(J.ProblemConfig(N_x=12, N_t=13))
    js = jp.solve(J.SolverConfig(rtol=1e-11, pc_side="right"))
    ts = tp.solve(SolverConfig(rtol=1e-11, pc_side="right"))
    assert int(ts.result.iterations) == int(js.result.iterations)
    np.testing.assert_allclose(ts.u.numpy(), np.asarray(js.u), rtol=0, atol=1e-12)
    # a warm start from a perturbed solution, scaled unknowns
    x0 = np.stack([np.asarray(js.u), np.asarray(js.p)])
    x0 = x0 + 1e-4 * np.random.default_rng(8).standard_normal(x0.shape)
    js = jp.solve(J.SolverConfig(rtol=1e-6), x0=jnp.asarray(x0))
    ts = tp.solve(SolverConfig(rtol=1e-6), x0=torch.from_numpy(x0))
    assert int(ts.result.iterations) == int(js.result.iterations)
    np.testing.assert_allclose(ts.u.numpy(), np.asarray(js.u), rtol=0, atol=1e-10)


def test_eig_variant_same_iterations():
    jp, tp = _wave_pair(J.ProblemConfig(N_x=12, N_t=13))
    it_f = int(tp.solve(SolverConfig(rtol=1e-8, pc_variant="fulldiag")).result.iterations)
    te = tp.solve(SolverConfig(rtol=1e-8, pc_variant="eig"))
    assert abs(it_f - int(te.result.iterations)) <= 1
    je = jp.solve(J.SolverConfig(rtol=1e-8, pc_variant="eig"))
    assert int(te.result.iterations) == int(je.result.iterations)


def test_2d_lumped_same_iterations_as_jax():
    jp, tp = _wave_pair(J.ProblemConfig(N_x=8, N_t=10, dim=2, mass="lumped"))
    js = jp.solve(J.SolverConfig(rtol=1e-8))
    ts = tp.solve(SolverConfig(rtol=1e-8))
    assert bool(ts.result.converged)
    assert int(ts.result.iterations) == int(js.result.iterations)
    np.testing.assert_allclose(ts.u.numpy(), np.asarray(js.u), rtol=0, atol=1e-10)


def test_unpreconditioned_gmres_matches_jax():
    """``pc=None``: plain GMRES, the same iteration count as JAX. Without the
    preconditioner the iterates amplify rounding (the two packages' u
    differ by ~1e-8 at rtol 1e-6), so u is held to the preconditioned
    solution at the solve's own accuracy instead."""
    jp, tp = _wave_pair(J.ProblemConfig(N_x=6, N_t=5))
    js = jp.solve(J.SolverConfig(pc=None, rtol=1e-6, restart=20))
    ts = tp.solve(SolverConfig(pc=None, rtol=1e-6, restart=20))
    assert bool(ts.result.converged)
    assert int(ts.result.iterations) == int(js.result.iterations)
    ref = tp.solve(SolverConfig(rtol=1e-12))
    assert (ts.u - ref.u).abs().max() <= 1e-5 * ref.u.abs().max()


# ----------------------------------------------------------------- heat


@pytest.mark.parametrize("N", [16, 32, 64])
def test_heat_gmres_matches_jax(N):
    jcfg = J.ProblemConfig(N_x=N, N_t=N)
    jp = JHeat(jcfg)
    tp = heat_problem_from_jax(dataclasses.asdict(jcfg), {k: np.asarray(v) for k, v in jp._data.items()},
                               device="cpu")
    js = jp.solve(J.SolverConfig(method="gmres", rtol=1e-10))
    ts = tp.solve(SolverConfig(method="gmres", rtol=1e-10))
    assert bool(ts.result.converged)
    assert int(ts.result.iterations) == int(js.result.iterations) <= 5
    assert tp.relative_residual_f64(ts) < 1e-8
    np.testing.assert_allclose(ts.u.numpy(), np.asarray(js.u), rtol=0, atol=1e-10)

