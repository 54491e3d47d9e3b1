"""MINRES on the symmetrized all-at-once system (``krylov/minres.py``,
``paradiag/symmetric.py``, ``HeatControlProblem.build_symmetric_system``) of
the PyTorch port vs the JAX package, in float64 on the CPU (MINRES iterates
in physical coordinates and meets the float32 time-stencil cancellation, so
it is held in float64 only).

Tolerances: the swapped operator exactly symmetric (0.0); the SPD
preconditioner's apply 1e-12 relative max-abs against JAX, its matrix
symmetric to 1e-12 and positive definite; MINRES the same iteration counts
and x to 1e-10 relative max-abs, wave and heat, 1D, 2D lumped and 2D
consistent (tensor-mass surrogate)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optimal_control_paradiag_tpu as J
from optimal_control_paradiag_torch import SolverConfig
from optimal_control_paradiag_torch.interop import heat_problem_from_jax, problem_from_jax
from optimal_control_paradiag_torch.krylov.minres import minres
from optimal_control_paradiag_torch.paradiag.symmetric import build_symmetric_system
from optimal_control_paradiag_tpu.krylov.minres import minres as j_minres
from optimal_control_paradiag_tpu.models.heat import HeatControlProblem as JHeat
from optimal_control_paradiag_tpu.paradiag.symmetric import build_symmetric_system as j_build_symmetric_system

torch.set_num_threads(1)


def _close(ref, got, tol):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape
    assert np.abs(ref - got).max() <= tol * np.abs(ref).max()


def _wave(**kw):
    jp = J.WaveControlProblem(J.ProblemConfig(**kw))
    data = {k: np.asarray(v) for k, v in jp._data.items()}
    return jp, problem_from_jax(dataclasses.asdict(jp.config), data, device="cpu")


def _heat(**kw):
    jp = JHeat(J.ProblemConfig(**kw))
    data = {k: np.asarray(v) for k, v in jp._data.items()}
    return jp, heat_problem_from_jax(dataclasses.asdict(jp.config), data, device="cpu")


def _columns(f, shape):
    """The matrix of a linear map on states of ``shape``, by columns."""
    m = int(np.prod(shape))
    eye = torch.eye(m, dtype=torch.float64).reshape((m,) + tuple(shape))
    return f(eye).reshape(m, m).T.numpy()


SYM_CASES = [dict(N_x=6, N_t=7), dict(N_x=5, N_t=6, gamma=0.5), dict(N_x=4, N_t=5, dim=2, mass="lumped"),
             dict(N_x=4, N_t=5, dim=2)]
SYM_IDS = ["1d", "1d-gamma", "2d-lumped", "2d-consistent"]


@pytest.mark.parametrize("kw", SYM_CASES, ids=SYM_IDS)
@pytest.mark.parametrize("family", ["wave", "heat"])
def test_swapped_operator_exactly_symmetric(kw, family):
    """tests/test_symmetric.py:11-20 and tests/test_heat.py:153-160 on the
    port: the swap makes the matrix symmetric to the last bit (the batched
    matvec builds every column at once)."""
    jp, tp = (_wave if family == "wave" else _heat)(**kw)
    mv, _, _ = (build_symmetric_system(tp.operator) if family == "wave" else tp.build_symmetric_system())
    A = _columns(mv, (2, kw["N_t"], tp.space.n))
    assert np.abs(A - A.T).max() == 0.0


@pytest.mark.parametrize("kw", SYM_CASES, ids=SYM_IDS)
@pytest.mark.parametrize("family", ["wave", "heat"])
def test_spd_preconditioner_matches_jax(kw, family):
    jp, tp = (_wave if family == "wave" else _heat)(**kw)
    if family == "wave":
        (jmv, jpc, jsw), (tmv, tpc, tsw) = j_build_symmetric_system(jp.operator), build_symmetric_system(tp.operator)
    else:
        (jmv, jpc, jsw), (tmv, tpc, tsw) = jp.build_symmetric_system(), tp.build_symmetric_system()
    x = np.random.default_rng(0).standard_normal((2, kw["N_t"], tp.space.n))
    xt = torch.from_numpy(x)
    _close(jpc(jnp.asarray(x)), tpc(xt), 1e-12)
    _close(jmv(jnp.asarray(x)), tmv(xt), 1e-12)
    np.testing.assert_array_equal(np.asarray(jsw(jnp.asarray(x))), tsw(xt).numpy())
    P = _columns(tpc, x.shape)
    np.testing.assert_allclose(P, P.T, atol=1e-12 * np.abs(P).max())
    assert np.linalg.eigvalsh(0.5 * (P + P.T)).min() > 0


WAVE_CASES = [
    (dict(N_x=20, N_t=20), dict(rtol=1e-10, maxiter=100)),
    (dict(N_x=10, N_t=12, dim=2, mass="lumped"), dict(rtol=1e-10, maxiter=100)),
    (dict(N_x=6, N_t=6, dim=2), dict(rtol=1e-12, maxiter=200)),
]
WAVE_IDS = ["1d-20x20", "2d-lumped", "2d-consistent-surrogate"]


@pytest.mark.parametrize("kw,skw", WAVE_CASES, ids=WAVE_IDS)
def test_wave_minres_matches_jax(kw, skw):
    """tests/test_symmetric.py:36-74's solves on the port."""
    jp, tp = _wave(**kw)
    js = jp.solve(J.SolverConfig(method="minres", **skw))
    ts = tp.solve(SolverConfig(method="minres", **skw))
    assert bool(ts.result.converged) and bool(js.result.converged)
    assert int(ts.result.iterations) == int(js.result.iterations)
    _close(js.u, ts.u, 1e-10)
    _close(js.p, ts.p, 1e-10)
    assert ts.result.residual_history.shape == (skw["maxiter"] + 1,)


HEAT_CASES = [
    (dict(N_x=16, N_t=16), dict(rtol=1e-10, maxiter=200)),
    (dict(N_x=9, N_t=10, dim=2, mass="lumped", gamma=0.7), dict(rtol=1e-10, maxiter=200)),
    (dict(N_x=12, N_t=8, dim=2), dict(rtol=1e-8, maxiter=300)),
]


@pytest.mark.parametrize("kw,skw", HEAT_CASES, ids=["1d", "2d-lumped", "2d-consistent-surrogate"])
def test_heat_minres_matches_jax(kw, skw):
    """tests/test_heat.py:147-178's solves on the port."""
    jp, tp = _heat(**kw)
    js = jp.solve(J.SolverConfig(method="minres", **skw))
    ts = tp.solve(SolverConfig(method="minres", **skw))
    assert bool(ts.result.converged) and bool(js.result.converged)
    assert int(ts.result.iterations) == int(js.result.iterations)
    _close(js.u, ts.u, 1e-10)
    _close(js.p, ts.p, 1e-10)
    if tp.space.diagonalizable:
        sw = tp.solve(SolverConfig(method="woodbury"))
        np.testing.assert_allclose(ts.u.numpy(), sw.u.numpy(), atol=1e-10)


@pytest.mark.parametrize("with_pc", [True, False], ids=["spd-pc", "no-pc"])
def test_minres_recurrences_match_jax(with_pc):
    """The bare solver on the swapped wave system: every field of the
    record. Preconditioned from a warm start to convergence;
    unpreconditioned for 8 steps (its Lanczos vectors lose orthogonality
    soon after, and both packages' iterates then drift apart by up to 1e-2
    at step 20, as rounding decides)."""
    jp, tp = _wave(N_x=10, N_t=8)
    (jmv, jpc, jsw), (tmv, tpc, tsw) = j_build_symmetric_system(jp.operator), build_symmetric_system(tp.operator)
    b = np.array(jp.rhs)
    x0 = 1e-3 * b if with_pc else np.zeros_like(b)
    kw = dict(rtol=1e-9, maxiter=60 if with_pc else 8)
    rj = j_minres(jmv, jsw(jnp.asarray(b)), M=jpc if with_pc else None, x0=jnp.asarray(x0), **kw)
    rt = minres(tmv, tsw(torch.from_numpy(b)), M=tpc if with_pc else None, x0=torch.from_numpy(x0), **kw)
    assert bool(rt.converged) == with_pc
    assert int(rt.iterations) == int(rj.iterations)
    assert bool(rt.converged) == bool(rj.converged)
    _close(rj.x, rt.x, 1e-10)
    hj, ht = np.asarray(rj.residual_history), rt.residual_history.numpy()
    np.testing.assert_allclose(ht, hj, rtol=1e-8, atol=1e-8 * hj[0])
    assert np.isnan(ht[int(rt.iterations) + 1 :]).all()


def test_minres_pc_none_runs_unpreconditioned():
    """``SolverConfig(pc=None)`` drops the SPD preconditioner (the wave
    family's rule; the JAX package's heat MINRES always keeps it): 5 steps
    of each, the same iterate (see above for why so few)."""
    jp, tp = _wave(N_x=8, N_t=6)
    js = jp.solve(J.SolverConfig(method="minres", pc=None, rtol=1e-12, maxiter=5))
    ts = tp.solve(SolverConfig(method="minres", pc=None, rtol=1e-12, maxiter=5))
    assert int(ts.result.iterations) == int(js.result.iterations) == 5 and not bool(ts.result.converged)
    _close(js.u, ts.u, 1e-10)
    pc = tp.solve(SolverConfig(method="minres", rtol=1e-12, maxiter=5))
    assert (pc.u - ts.u).abs().max() > 1e-6 * ts.u.abs().max()


def _perturbed_counts(nx, nt, n_rhs=4, rtol=1e-8):
    """MINRES iteration counts of both packages (float64, the wave family)
    on the problem's rhs and on ``n_rhs - 1`` copies of it perturbed by
    seeded noise of 1e-13 relative, with the gap between the two packages'
    u on the problem's own rhs. After its first sharp drop the recurrence
    loses orthogonality, and the count at rtol 1e-8 then moves with rounding
    by more than the packages differ."""
    jp, tp = _wave(N_x=nx, N_t=nt)
    cfg = dict(method="minres", rtol=rtol, maxiter=1000)
    fj, ft = jp.make_solver_fn(J.SolverConfig(**cfg)), tp.make_solver_fn(SolverConfig(**cfg))
    b = np.array(jp.rhs)
    rng = np.random.default_rng(0)
    cj, ct, gap = [], [], None
    for i in range(n_rhs):
        bi = b if i == 0 else b * (1 + 1e-13 * rng.standard_normal(b.shape))
        (xj, rj), (xt, rt) = fj(jnp.asarray(bi)), ft(torch.from_numpy(bi))
        assert bool(rj.converged) and bool(rt.converged)
        cj.append(int(rj.iterations))
        ct.append(int(rt.iterations))
        if i == 0:
            xj = np.asarray(xj)
            gap = float(np.abs(xj - xt.numpy()).max() / np.abs(xj).max())
    return cj, ct, gap


@pytest.mark.parametrize("nx,nt", [(128, 64), (256, 128)], ids=["128x64", "256x128"])
def test_minres_mid_size_counts_within_jax_rounding_spread(nx, nt):
    """Past the small shapes the count at rtol 1e-8 is not a fixed number:
    the port's counts lie within the spread of the JAX package's own counts
    under 1e-13 perturbations of the rhs, and both solutions agree to the
    solve's accuracy."""
    cj, ct, gap = _perturbed_counts(nx, nt)
    assert min(cj) <= min(ct) and max(ct) <= max(cj), (cj, ct)
    assert gap <= 1e-6


if __name__ == "__main__":
    # python tests/test_torch_minres.py: the counts' growth with the mesh
    # (wave, float64, rtol 1e-8, CPU), both packages, four right-hand sides
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    for nx, nt in ((80, 81), (256, 128), (512, 256), (1024, 512)):
        cj, ct, gap = _perturbed_counts(nx, nt)
        print(f"N_x={nx} N_t={nt}: JAX {cj}, port {ct}, u rel max-abs {gap:.2e}", flush=True)
