"""The ParaDiag preconditioner of the PyTorch port (``paradiag/pc.py``, and
``HeatControlProblem.build_preconditioner``) vs the JAX package, in float64
on the CPU, on seeded numpy inputs.

Tolerances (relative max-abs, ``|a - b|.max() <= tol * |a|.max()``): the
port's applies against JAX's 1e-12; the PC against the exact inverse of the
block-circulant operator 1e-9 absolute (tests/test_paradiag.py); ``fulldiag``
against ``eig`` 1e-10, or 1e-6 where N_t % 4 == 0 (Lambda_2 ~ 0 there)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optimal_control_paradiag_tpu as J
from optimal_control_paradiag_torch import HeatControlProblem, ProblemConfig
from optimal_control_paradiag_torch.fem.space import make_space
from optimal_control_paradiag_torch.interop import heat_problem_from_jax
from optimal_control_paradiag_torch.ops.allatonce import build_operator
from optimal_control_paradiag_torch.paradiag.pc import build_preconditioner
from optimal_control_paradiag_tpu.fem.space import make_space as j_make_space
from optimal_control_paradiag_tpu.models.heat import HeatControlProblem as JHeat
from optimal_control_paradiag_tpu.ops.allatonce import build_operator as j_build_operator
from optimal_control_paradiag_tpu.paradiag.pc import build_preconditioner as j_build_preconditioner

torch.set_num_threads(1)


def _close(ref, got, tol):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape
    assert np.abs(ref - got).max() <= tol * np.abs(ref).max()


def _ops(dim, N_x, N_t, gamma=1.0, mass="consistent", scaled=True):
    """(JAX operator, port operator) of one problem."""
    dt = 2.0 / N_t
    jop = j_build_operator(j_make_space(dim, N_x, mass=mass), N_t, dt, gamma, scaled=scaled)
    top = build_operator(make_space(dim, N_x, mass=mass, device="cpu"), N_t, dt, gamma, scaled=scaled)
    return jop, top


def circulant_matvec(op, x):
    """The block-circulant analogue P of the all-at-once operator (periodic
    time stencils, full-weight coupling), tests/test_paradiag.py's oracle in
    torch."""
    sp = op.space
    u, p = x[0], x[1]
    d2h = 0.5 * op.dt * op.dt
    mu, mp = sp.apply_mass(u), sp.apply_mass(p)
    ku, kp = sp.apply_stiffness(u), sp.apply_stiffness(p)
    roll = lambda a, s: torch.roll(a, s, 0)
    au = (mu - 2 * roll(mu, 1) + roll(mu, 2)) + d2h * (ku + roll(ku, 2)) - op.c_up * mp
    ap = op.c_pu * mu + (mp - 2 * roll(mp, -1) + roll(mp, -2)) + d2h * (kp + roll(kp, -2))
    return torch.stack([au, ap])


# tests/test_paradiag.py:35-44, each geometry with both variants
@pytest.mark.parametrize(
    "dim,N_x,N_t,gamma,mass",
    [(1, 8, 7, 1.0, "consistent"), (1, 6, 9, 0.5, "lumped"), (2, 5, 6, 1.0, "lumped")],
    ids=["1d-consistent", "1d-lumped", "2d-lumped"],
)
@pytest.mark.parametrize("variant", ["fulldiag", "eig"])
def test_pc_matches_jax_and_inverts_circulant(dim, N_x, N_t, gamma, mass, variant):
    jop, top = _ops(dim, N_x, N_t, gamma, mass)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, N_t, top.space.n))
    r = circulant_matvec(top, torch.from_numpy(x))
    pc = build_preconditioner(top, variant=variant)
    y = pc(r)
    assert y.dtype == torch.float64 and y.shape == r.shape
    np.testing.assert_allclose(y.numpy(), x, rtol=0, atol=1e-9)
    r_rand = rng.standard_normal(r.shape)
    _close(j_build_preconditioner(jop, variant=variant)(jnp.asarray(r_rand)), pc(torch.from_numpy(r_rand)), 1e-12)


@pytest.mark.parametrize("N_t", [7, 8, 81])
def test_fulldiag_equals_eig_variant(N_t):
    _, top = _ops(1, 10, N_t)
    r = torch.from_numpy(np.random.default_rng(4).standard_normal((2, N_t, top.space.n)))
    yf = build_preconditioner(top, variant="fulldiag")(r)
    ye = build_preconditioner(top, variant="eig")(r)
    tol = 1e-10 if N_t % 4 else 1e-6  # the eig route loses digits at Lambda_2 ~ 0
    _close(yf, ye, tol)


def test_fulldiag_robust_at_singular_lambda2():
    """N_t = 8: mode k = 2 has Lambda_2 = 1 + e^{i pi} ~ 1e-16."""
    _, top = _ops(1, 8, 8)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 8, top.space.n)))
    y = build_preconditioner(top, variant="fulldiag")(circulant_matvec(top, x))
    np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=0, atol=1e-9)


def test_float32_pc_stays_float32():
    top = build_operator(make_space(1, 8, dtype=torch.float32, device="cpu"), 7, 2.0 / 7, 1.0)
    r = torch.ones(2, 7, top.space.n, dtype=torch.float32)
    for variant in ("fulldiag", "eig"):
        assert build_preconditioner(top, variant=variant)(r).dtype == torch.float32


def test_pc_requires_scaled_system():
    jop, top = _ops(1, 8, 7, scaled=False)
    with pytest.raises(ValueError):
        j_build_preconditioner(jop)
    with pytest.raises(ValueError, match="scaled"):
        build_preconditioner(top)


def test_pc_refusals():
    """What the port refuses, and how: the JAX package's ValueErrors (the
    2D direct variants refuse a 1D space, as JAX's do)."""
    _, top = _ops(1, 8, 7)
    _, top2 = _ops(2, 5, 6)  # 2D consistent mass
    r = torch.from_numpy(np.random.default_rng(8).standard_normal(top.shape))
    _close(build_preconditioner(top)(r), build_preconditioner(top, time_transform="dft")(r), 1e-12)
    with pytest.raises(ValueError, match="time_transform"):
        build_preconditioner(top, time_transform="x")
    with pytest.raises(ValueError, match="2D"):
        build_preconditioner(top, variant="blockline")
    with pytest.raises(ValueError, match="diagonalizable"):
        build_preconditioner(top, variant="blockband")
    with pytest.raises(ValueError, match="unknown variant"):
        build_preconditioner(top, variant="x")
    with pytest.raises(ValueError, match="sine-diagonalizable"):
        build_preconditioner(top2)
    with pytest.raises(ValueError, match="inner_solver"):
        build_preconditioner(top2, variant="eig")


def test_sharded_pc_raises():
    _, top = _ops(1, 8, 7)
    with pytest.raises(NotImplementedError, match="item 14"):
        build_preconditioner(top, layout=object())


HEAT_CASES = [
    dict(N_x=17, N_t=8),
    dict(N_x=13, N_t=9, gamma=0.5),
    dict(N_x=12, N_t=8, mass="lumped", T=1.0),
    dict(N_x=9, N_t=10, dim=2, mass="lumped", gamma=0.7),
]


@pytest.mark.parametrize("kw", HEAT_CASES, ids=["1d-consistent", "1d-odd-gamma", "1d-lumped", "2d-lumped"])
def test_heat_preconditioner_matches_jax(kw):
    jcfg = J.ProblemConfig(**kw)
    jp = JHeat(jcfg)
    tp = heat_problem_from_jax(dataclasses.asdict(jcfg), {k: np.asarray(v) for k, v in jp._data.items()},
                               device="cpu")
    r = np.random.default_rng(6).standard_normal((2, kw["N_t"], tp.space.n))
    y = tp.build_preconditioner()(torch.from_numpy(r))
    assert y.dtype == torch.float64
    _close(jp.build_preconditioner()(jnp.asarray(r)), y, 1e-12)


def test_heat_preconditioner_refuses_2d_consistent_mass():
    with pytest.raises(ValueError, match="diagonalizable"):
        HeatControlProblem(ProblemConfig(N_x=6, N_t=6, dim=2), device="cpu").build_preconditioner()
