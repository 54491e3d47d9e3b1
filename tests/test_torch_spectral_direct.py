"""GMRES in spectral coordinates, the full-spectrum Woodbury solve and the
dense direct solve of the PyTorch port vs the JAX package, in float64 on the
CPU: ``paradiag/spectral.py`` (``build_spectral_system``, ``solve_spectral``,
``build_woodbury_solver(half_spectrum=False)``), ``AllAtOnceOperator.dense``
and ``operator_nnz``, ``P1Space.mass_dense`` / ``stiffness_dense``,
``HeatControlProblem.dense``, and the wave and heat ``method='direct'``.

Tolerances (relative max-abs, ``|a - b|.max() <= tol * |a|.max()``, a the
JAX result): the spectral operators and transforms 1e-12; the spectral
method 1e-10 with the same iteration counts; the full-spectrum Woodbury
solve and the direct solves 1e-11; the dense matrices 1e-12; the nonzero
counts and the dense mass and stiffness matrices equal. Direct solves stay
at <= 400 unknowns."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optimal_control_paradiag_tpu as J
from optimal_control_paradiag_torch import SolverConfig
from optimal_control_paradiag_torch.interop import heat_problem_from_jax, problem_from_jax
from optimal_control_paradiag_torch.ops.allatonce import operator_nnz
from optimal_control_paradiag_torch.paradiag import spectral as t_sp
from optimal_control_paradiag_tpu.models.heat import HeatControlProblem as JHeat
from optimal_control_paradiag_tpu.ops.allatonce import operator_nnz as j_operator_nnz
from optimal_control_paradiag_tpu.paradiag import spectral as j_sp

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


SPEC_CASES = [dict(N_x=12, N_t=8), dict(N_x=9, N_t=7, gamma=0.5), dict(N_x=6, N_t=8, dim=2, mass="lumped")]
SPEC_IDS = ["1d", "1d-odd", "2d-lumped"]


@pytest.mark.parametrize("kw", SPEC_CASES, ids=SPEC_IDS)
@pytest.mark.parametrize("tt", ["fft", "dft"])
def test_spectral_system_ops_match_jax(kw, tt):
    """A_hat, D_inv and both transforms of the full-spectrum system, on a
    single state and (port) on a batch of three."""
    jp, tp = _wave(**kw)
    jops = j_sp._make_ops(jp.operator, j_sp._spectral_plan(jp.operator), time_transform=tt)
    tops = t_sp._make_ops(tp.operator, t_sp._spectral_plan(tp.operator), time_transform=tt)
    rng = np.random.default_rng(0)
    shape = jp.operator.shape
    x = rng.standard_normal((3,) + shape)
    xi = x + 1j * rng.standard_normal((3,) + shape)
    for f_j, f_t, arg in zip(jops, tops, (xi, xi, x, xi)):
        ref = np.asarray(f_j(jnp.asarray(arg[0])))
        _close(ref, f_t(torch.from_numpy(arg[0])), 1e-12)
        _close(ref, f_t(torch.from_numpy(arg))[0], 1e-12)
    if tt == "fft":
        for f_j, f_t in zip(j_sp.build_spectral_system(jp.operator), t_sp.build_spectral_system(tp.operator)):
            _close(f_j(jnp.asarray(xi[1])), f_t(torch.from_numpy(xi[1])), 1e-12)


@pytest.mark.parametrize("kw", SPEC_CASES, ids=SPEC_IDS)
def test_spectral_method_matches_jax(kw):
    """tests/test_endtoend.py:124-135's method='spectral' on the port: the
    same iterations, the solution to 1e-10, the complex GMRES record."""
    jp, tp = _wave(**kw)
    js = jp.solve(J.SolverConfig(method="spectral", rtol=1e-10))
    ts = tp.solve(SolverConfig(method="spectral", rtol=1e-10))
    assert bool(ts.result.converged)
    assert int(ts.result.iterations) == int(js.result.iterations)
    _close(js.u, ts.u, 1e-10)
    _close(js.p, ts.p, 1e-10)
    gm = tp.solve(SolverConfig(method="gmres", rtol=1e-10))
    np.testing.assert_allclose(ts.u.numpy(), gm.u.numpy(), atol=1e-8)


def test_solve_spectral_and_spectral_refusals_match_jax():
    jp, tp = _wave(N_x=12, N_t=8)
    xj, rj = j_sp.solve_spectral(jp.operator, jp.rhs, rtol=1e-10)
    xt, rt = t_sp.solve_spectral(tp.operator, tp.rhs, rtol=1e-10)
    assert int(rt.iterations) == int(rj.iterations)
    _close(xj, xt, 1e-10)
    with pytest.raises(ValueError, match="fused spectral-step"):
        tp.solve(SolverConfig(method="spectral", use_pallas=True))
    with pytest.raises(ValueError, match="diagonalizable"):
        t_sp.build_spectral_system(_wave(N_x=5, N_t=6, dim=2)[1].operator)


@pytest.mark.parametrize("kw", SPEC_CASES, ids=SPEC_IDS)
@pytest.mark.parametrize("tt,refine", [(None, 0), (None, 1), ("fft", 2), ("dft", 1)])
def test_full_spectrum_woodbury_matches_jax(kw, tt, refine):
    jp, tp = _wave(**kw)
    x_j = j_sp.build_woodbury_solver(jp.operator, refine=refine, time_transform=tt, half_spectrum=False)(jp.rhs)
    f = t_sp.build_woodbury_solver(tp.operator, refine=refine, time_transform=tt, half_spectrum=False)
    _close(x_j, f(tp.rhs), 1e-11)
    bs = torch.stack([tp.rhs, -2.0 * tp.rhs, torch.roll(tp.rhs, 1, dims=-2)])
    xs = f(bs)
    for i in range(3):
        _close(f(bs[i]), xs[i], 1e-12)
    half = t_sp.build_woodbury_solver(tp.operator, refine=refine)(tp.rhs)
    _close(half, f(tp.rhs), 1e-11)


def test_full_spectrum_mxu_refused_like_jax():
    jp, tp = _wave(N_x=12, N_t=8)
    with pytest.raises(ValueError, match="half-spectrum"):
        j_sp.build_woodbury_solver(jp.operator, time_transform="mxu", half_spectrum=False)
    with pytest.raises(ValueError, match="half-spectrum"):
        t_sp.build_woodbury_solver(tp.operator, time_transform="mxu", half_spectrum=False)


DENSE_CASES = [dict(N_x=6, N_t=7), dict(N_x=5, N_t=6, mass="lumped", gamma=0.5), dict(N_x=4, N_t=5, dim=2),
               dict(N_x=4, N_t=5, dim=2, mass="lumped")]
DENSE_IDS = ["1d", "1d-lumped", "2d-consistent", "2d-lumped"]


@pytest.mark.parametrize("kw", DENSE_CASES, ids=DENSE_IDS)
def test_dense_and_nnz_match_jax(kw):
    """``dense`` against JAX's (1e-12), ``operator_nnz`` equal to JAX's and to
    the dense matrix's count, and the dense mass and stiffness equal."""
    jp, tp = _wave(**kw)
    A_j, A_t = np.asarray(jp.operator.dense()), tp.operator.dense()
    assert A_t.shape == (tp.operator.size,) * 2 and A_t.dtype == torch.float64
    _close(A_j, A_t, 1e-12)
    assert operator_nnz(tp.operator) == j_operator_nnz(jp.operator) == int((A_t != 0).sum())
    np.testing.assert_array_equal(tp.space.mass_dense().numpy(), np.asarray(jp.space.mass_dense()))
    np.testing.assert_array_equal(tp.space.stiffness_dense().numpy(), np.asarray(jp.space.stiffness_dense()))
    small = tp.operator.dense(chunk=7)
    np.testing.assert_array_equal(small.numpy(), A_t.numpy())


@pytest.mark.parametrize("kw", [dict(N_x=17, N_t=8), dict(N_x=5, N_t=6, dim=2, mass="lumped", gamma=0.7),
                                dict(N_x=4, N_t=5, dim=2)], ids=["1d", "2d-lumped", "2d-consistent"])
def test_heat_dense_matches_jax(kw):
    jp, tp = _heat(**kw)
    _close(jp.dense(), tp.dense(chunk=64), 1e-12)


@pytest.mark.parametrize(
    "kw,skw",
    [
        (dict(N_x=10, N_t=12), {}),
        (dict(N_x=8, N_t=10, gamma=0.5, scaled=False), dict(pc=None)),
        (dict(N_x=5, N_t=6, dim=2, mass="lumped"), {}),
        (dict(N_x=4, N_t=6, dim=2), {}),
    ],
    ids=["1d", "1d-unscaled", "2d-lumped", "2d-consistent"],
)
def test_wave_direct_matches_jax(kw, skw):
    """tests/test_endtoend.py:60-77's direct solves on the port; the batched
    direct solve is lane by lane the single one."""
    jp, tp = _wave(**kw)
    js = jp.solve(J.SolverConfig(method="direct", **skw))
    ts = tp.solve(SolverConfig(method="direct", **skw))
    assert ts.result is None
    _close(js.u, ts.u, 1e-11)
    _close(js.p, ts.p, 1e-11)
    bs = torch.stack([tp.rhs, 0.5 * tp.rhs, torch.roll(tp.rhs, 1, dims=-1)])
    xs, res = tp.make_batched_solver_fn(SolverConfig(method="direct", **skw))(bs)
    assert res is None
    for i in range(3):
        _close(tp.make_solver_fn(SolverConfig(method="direct", **skw))(bs[i])[0], xs[i], 1e-12)
    if tp.space.diagonalizable and tp.config.scaled:
        _close(tp.solve(SolverConfig(method="woodbury")).u, ts.u, 1e-10)


@pytest.mark.parametrize("kw", [dict(N_x=17, N_t=8), dict(N_x=5, N_t=6, dim=2, mass="lumped"), dict(N_x=4, N_t=6, dim=2)],
                         ids=["1d", "2d-lumped", "2d-consistent"])
def test_heat_direct_matches_jax(kw):
    """tests/test_heat.py:14-20, :51-60's dense LU on the port."""
    jp, tp = _heat(**kw)
    js = jp.solve(J.SolverConfig(method="direct"))
    ts = tp.solve(SolverConfig(method="direct"))
    assert ts.result is None
    _close(js.u, ts.u, 1e-11)
    _close(js.p, ts.p, 1e-11)
    assert tp.relative_residual_f64(ts) < 1e-12
