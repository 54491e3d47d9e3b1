"""The batched multi-RHS solve of the PyTorch port vs the JAX package's
``jax.vmap`` of its single solve, in float64 on the CPU, on the same B = 3
seeded right-hand sides: ``WaveControlProblem.make_batched_solver_fn`` (the
port's lock-step batch against JAX's ``jax.jit(jax.vmap(...))``), batched
GMRES with each ``eig`` inner solver, the heat builders on ``(B, 2, N_t, n)``
against ``jax.vmap`` of the JAX heat builders, and both kernels' plain twins
on a batch against the vmapped Pallas kernels in interpret mode.

Tolerances (relative max-abs, ``|a - b|.max() <= tol * |a|.max()``, a the
JAX result): the direct solves 1e-11, the iterative ones 1e-10 with equal
per-lane iteration counts and per-lane residual histories to rtol 1e-8 with
an absolute floor of 1e-13 of the initial residual (tests/test_torch_gmres.py;
MINRES 1e-8, see ``MINRES_HISTORY_FLOOR``);
operators and preconditioner applies 1e-12. Three lanes, not two: with
B = 2 a state's ``x[0]`` / ``x[1]`` would silently pick lanes instead of u
and p."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optimal_control_paradiag_tpu as J
from optimal_control_paradiag_torch import HeatControlProblem, ProblemConfig, SolverConfig
from optimal_control_paradiag_torch.interop import heat_problem_from_jax, problem_from_jax, solver_from_jax
from optimal_control_paradiag_torch.paradiag import cuda_heat as ch
from optimal_control_paradiag_torch.paradiag import cuda_woodbury as cw
from optimal_control_paradiag_torch.paradiag.pc import build_preconditioner
from optimal_control_paradiag_torch.paradiag.spectral import spectral_relative_residual
from optimal_control_paradiag_tpu.models.heat import HeatControlProblem as JHeat
from optimal_control_paradiag_tpu.paradiag import pallas_heat
from optimal_control_paradiag_tpu.paradiag.pallas_woodbury import build_pallas_woodbury_solver
from optimal_control_paradiag_tpu.paradiag.pc import build_preconditioner as j_build_preconditioner

torch.set_num_threads(1)

B = 3
# MINRES's residual estimate falls by ~6 orders in one step near the end
# (8e-3 -> 1.4e-8 of the initial at 12 x 8): that step's cancellation puts
# the rounding of either package at ~2e-9 of the initial residual, the same
# between the port's single and JAX's single solve (the port's batched lane
# is bitwise its single solve). Its histories are compared with this floor.
MINRES_HISTORY_FLOOR = 1e-8


def _close(ref, got, tol):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape
    assert np.abs(ref - got).max() <= tol * np.abs(ref).max()


def _pair(**kw):
    jp = J.WaveControlProblem(J.ProblemConfig(**kw))
    data = {k: np.asarray(v) for k, v in jp._data.items()}
    return jp, problem_from_jax(dataclasses.asdict(jp.config), data, device="cpu")


def _batch(shape, seed=0):
    """B distinct right-hand sides: seeded normal states."""
    return np.random.default_rng(seed).standard_normal((B,) + tuple(shape))


def _smooth_batch(jp, seed):
    """B distinct smooth right-hand sides: seeded combinations of the
    manufactured right-hand sides at gamma and gamma / 2. MINRES takes ~130
    steps on a rough (normal) right-hand side, and after that many the
    counts of two correct implementations may differ by one."""
    other = J.WaveControlProblem(dataclasses.replace(jp.config, gamma=0.5 * jp.config.gamma)).rhs
    c = np.random.default_rng(seed).standard_normal((B, 2, 1, 1, 1))
    return c[:, 0] * np.asarray(jp.rhs) + c[:, 1] * np.asarray(other)


def _same_records(rj, rt, floor=1e-13):
    """Per-lane iteration counts equal; histories to rtol 1e-8 with an
    absolute floor of ``floor`` times each lane's initial residual."""
    it_j, it_t = np.asarray(rj.iterations), np.asarray(rt.iterations)
    assert it_t.shape == (B,)
    np.testing.assert_array_equal(it_t, it_j)
    np.testing.assert_array_equal(np.asarray(rt.converged), np.asarray(rj.converged))
    hj, ht = np.asarray(rj.residual_history), np.asarray(rt.residual_history)
    assert ht.shape == hj.shape
    for i in range(B):
        np.testing.assert_allclose(ht[i], hj[i], rtol=1e-8, atol=floor * hj[i, 0])


SOLVERS = [
    (dict(method="woodbury", refine=1), 1e-11),
    (dict(method="woodbury", refine=1, use_pallas=True), 1e-11),
    (dict(method="spectral", rtol=1e-10), 1e-10),
    (dict(method="gmres", rtol=1e-10), 1e-10),
    (dict(method="minres", rtol=1e-10), 1e-10),
]


@pytest.mark.parametrize("skw,tol", SOLVERS, ids=["woodbury", "woodbury-fused", "spectral", "gmres", "minres"])
def test_batched_solver_matches_jax(skw, tol):
    """tests/test_batched.py:20-38's solvers at its shape, plus the fused
    Woodbury solve (the JAX package's Pallas kernel in interpret mode)."""
    jp, tp = _pair(N_x=12, N_t=8)
    bs = _smooth_batch(jp, 0) if skw["method"] == "minres" else _batch(tp.operator.shape)
    jsolver = J.SolverConfig(**skw)
    xs_j, rj = jp.make_batched_solver_fn(jsolver)(jnp.asarray(bs))
    fn = tp.make_batched_solver_fn(solver_from_jax(dataclasses.asdict(jsolver)))
    assert tp.make_batched_solver_fn(solver_from_jax(dataclasses.asdict(jsolver))) is fn
    xs_t, rt = fn(torch.from_numpy(bs))
    assert xs_t.shape == (B,) + tp.operator.shape
    _close(xs_j, xs_t, tol)
    if skw["method"] == "woodbury":
        assert rt is None and rj is None
    else:
        _same_records(rj, rt, MINRES_HISTORY_FLOOR if skw["method"] == "minres" else 1e-13)


def test_batched_lanes_match_sequential_solves():
    """Each lane of a batched GMRES and MINRES solve is the single solve of
    its right-hand side: the same iterations, x to 1e-10."""
    jp, tp = _pair(N_x=12, N_t=8)
    rough, smooth = torch.from_numpy(_batch(tp.operator.shape, seed=1)), torch.from_numpy(_smooth_batch(jp, 1))
    for solver, bs in ((SolverConfig(method="gmres", rtol=1e-10), rough),
                       (SolverConfig(method="minres", rtol=1e-10), smooth),
                       (SolverConfig(method="gmres", rtol=1e-10, restart=4, pc_side="right"), rough)):
        xs, res = tp.make_batched_solver_fn(solver)(bs)
        run = tp.make_solver_fn(solver)
        for i in range(B):
            xi, ri = run(bs[i])
            assert int(res.iterations[i]) == int(ri.iterations)
            _close(xi, xs[i], 1e-10)


def test_batched_warm_start_x0():
    jp, tp = _pair(N_x=12, N_t=8)
    bs, x0 = _batch(tp.operator.shape, seed=2), 0.1 * _batch(tp.operator.shape, seed=3)
    solver = SolverConfig(method="gmres", rtol=1e-10)
    xs_j, rj = jp.make_batched_solver_fn(J.SolverConfig(method="gmres", rtol=1e-10))(jnp.asarray(bs), jnp.asarray(x0))
    xs_t, rt = tp.make_batched_solver_fn(solver)(torch.from_numpy(bs), torch.from_numpy(x0))
    _close(xs_j, xs_t, 1e-10)
    _same_records(rj, rt)


def test_batched_linearity_oracle():
    """tests/test_batched.py:41-47: solve(c b) == c solve(b) across the batch."""
    _, tp = _pair(N_x=10, N_t=12)
    bs = torch.tensor([1.0, -0.5, 2.25], dtype=torch.float64)[:, None, None, None] * tp.rhs[None]
    xs, _ = tp.make_batched_solver_fn(SolverConfig(method="woodbury", refine=2))(bs)
    np.testing.assert_allclose(xs[1].numpy(), -0.5 * xs[0].numpy(), rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(xs[2].numpy(), 2.25 * xs[0].numpy(), rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "fused"])
def test_batched_2d_lumped_matches_jax(use_pallas):
    """tests/test_batched.py:50-55's 2D lumped case, against JAX's batch."""
    jp, tp = _pair(N_x=6, N_t=8, dim=2, mass="lumped")
    bs = _batch(tp.operator.shape, seed=4)
    xs_j, _ = jp.make_batched_solver_fn(J.SolverConfig(method="woodbury", use_pallas=use_pallas))(jnp.asarray(bs))
    xs_t, _ = tp.make_batched_solver_fn(SolverConfig(method="woodbury", use_pallas=use_pallas))(torch.from_numpy(bs))
    _close(xs_j, xs_t, 1e-11)


@pytest.mark.parametrize("inner", ["dst", "tridiag_thomas", "tridiag_pcr", "cocg"])
def test_batched_gmres_eig_inner_matches_jax(inner):
    jp, tp = _pair(N_x=12, N_t=8)
    bs = _batch(tp.operator.shape, seed=5)
    xs_j, rj = jp.make_batched_solver_fn(J.SolverConfig(rtol=1e-10, inner=inner))(jnp.asarray(bs))
    xs_t, rt = tp.make_batched_solver_fn(SolverConfig(rtol=1e-10, inner=inner))(torch.from_numpy(bs))
    _close(xs_j, xs_t, 1e-10)
    _same_records(rj, rt)


@pytest.mark.parametrize("variant,tt", [("fulldiag", "fft"), ("fulldiag", "dft"), ("eig", "fft")])
def test_batched_preconditioner_apply_matches_jax(variant, tt):
    jp, tp = _pair(N_x=12, N_t=8)
    r = _batch(tp.operator.shape, seed=6)
    jpc = j_build_preconditioner(jp.operator, variant=variant, time_transform=tt)
    tpc = build_preconditioner(tp.operator, variant=variant, time_transform=tt)
    _close(jax.vmap(jpc)(jnp.asarray(r)), tpc(torch.from_numpy(r)), 1e-12)


@pytest.mark.parametrize("refine", [0, 1, 2])
def test_batched_fused_twin_matches_vmapped_pallas(refine):
    """B1's twin on a (B, 2, K, n) batch against the Pallas kernel, vmapped
    (one pallas_call with a further grid axis), in interpret mode."""
    jp, tp = _pair(N_x=20, N_t=12)
    bs = _batch(tp.operator.shape, seed=7)
    xs_j = jax.jit(jax.vmap(build_pallas_woodbury_solver(jp.operator, refine=refine, interpret=True)))(jnp.asarray(bs))
    xs_t = cw.build_cuda_woodbury_solver(tp.operator, refine=refine)(torch.from_numpy(bs))
    _close(xs_j, xs_t, 1e-12)


def _heat_pair(kw):
    jcfg = J.ProblemConfig(**kw)
    jp = JHeat(jcfg)
    data = {k: np.asarray(v) for k, v in jp._data.items()}
    return jp, heat_problem_from_jax(dataclasses.asdict(jcfg), data, device="cpu")


HEAT_CASES = [dict(N_x=17, N_t=8), dict(N_x=9, N_t=10, dim=2, mass="lumped", gamma=0.7)]


@pytest.mark.parametrize("kw", HEAT_CASES, ids=["1d", "2d-lumped"])
@pytest.mark.parametrize("which", ["woodbury-r0", "woodbury-r1", "fused-twin", "polished", "pc", "matvec"])
def test_heat_builders_take_a_batch_like_jax_vmap(kw, which):
    """tests/test_heat.py:135-145: the heat builders on (B, 2, N_t, n)
    against ``jax.vmap`` of the JAX builders."""
    jp, tp = _heat_pair(kw)
    bs = _batch((2, kw["N_t"], tp.space.n), seed=8)
    if which.startswith("woodbury"):
        r = int(which[-1])
        jf, tf, tol = jp.build_woodbury_solver(refine=r), tp.build_woodbury_solver(refine=r), 1e-11
    elif which == "fused-twin":
        jf = pallas_heat.build_pallas_heat_solver(jp, refine=1, interpret=True)
        tf, tol = ch.build_cuda_heat_solver(tp, refine=1), 1e-11
    elif which == "polished":
        jf, tf, tol = jp.build_polished_solver(polish=1), tp.build_polished_solver(polish=1), 1e-11
    elif which == "pc":
        jf, tf, tol = jp.build_preconditioner(), tp.build_preconditioner(), 1e-12
    else:
        jf, tf, tol = jp.matvec, tp.matvec, 1e-12
    xs_j = jax.jit(jax.vmap(jf))(jnp.asarray(bs))
    xs_t = tf(torch.from_numpy(bs))
    _close(xs_j, xs_t, tol)
    _close(jp.matvec_host_f64(bs[1]), tp.matvec_host_f64(bs)[1], 1e-12)


def test_heat_batched_lanes_match_single_solves():
    """Each lane of the heat builders' batch is the single solve (JAX's
    tests/test_heat.py:135 check, on the port alone)."""
    tp = HeatControlProblem(ProblemConfig(N_x=17, N_t=8), device="cpu")
    bs = torch.from_numpy(_batch((2, 8, tp.space.n), seed=9))
    for f in (tp.build_woodbury_solver(refine=0), ch.build_cuda_heat_solver(tp)):
        xs = f(bs)
        for i in range(B):
            _close(f(bs[i]), xs[i], 1e-12)


def test_launch_checks_pass_the_batch_and_refuse_bad_sizes(monkeypatch):
    """``launch_fused_solve`` (here with a recording stand-in for the
    launcher, on CPU tensors, and stand-ins for the CUDA device and stream)
    passes B after n, 1 for a single state, and refuses B = 0 and
    B > 65535 before any launch."""
    from types import SimpleNamespace

    from optimal_control_paradiag_torch.cuda_build import MAX_BATCH, launch_fused_solve

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(cuda_stream=0))

    tp = HeatControlProblem(ProblemConfig(N_x=12, N_t=10), device="cpu")
    c = ch.pack_heat_constants(tp)
    shapes = {"a11r": ("K", "n"), "a11i": ("K", "n"), "invdet": ("K", "n"), "colc": (6, "n"), "phases": ("K", 8)}
    calls = []
    fns = {torch.float64: lambda *a: calls.append(a) or 0}
    launch = lambda b: launch_fused_solve("heat", fns, None, b, c, shapes, 1)
    for shape, B in (((2, 6, 11), 1), ((3, 2, 6, 11), 3), ((1, 2, 6, 11), 1)):
        x = launch(torch.zeros(shape, dtype=torch.complex128))
        assert x.shape == shape and calls[-1][7:10] == (6, 11, B) and calls[-1][10] == 1
    assert MAX_BATCH == 65535
    for bad in ((0, 2, 6, 11), (MAX_BATCH + 1, 2, 1, 1)):
        with pytest.raises(ValueError, match="lanes|contiguous"):
            launch(torch.zeros(bad, dtype=torch.complex128))
    with pytest.raises(ValueError, match="1 to 65535 lanes"):
        launch(torch.zeros((0, 2, 6, 11), dtype=torch.complex128))
    with pytest.raises(ValueError, match="contiguous"):
        launch(torch.zeros((2, 2, 2, 6, 11), dtype=torch.complex128))
    assert len(calls) == 3


def _float32_noise_residuals(nx, nt, n_noise=4, seed=9):
    """Float64 oracle residuals of the float32 batched Woodbury solve, both
    packages, plain and through the kernel (JAX's Pallas kernel in
    interpret mode, the port's twin), on the problem's rhs and ``n_noise``
    seeded normal right-hand sides scaled to its largest magnitude."""
    jp = J.WaveControlProblem(J.ProblemConfig(N_x=nx, N_t=nt, dtype=jnp.float32))
    data = {k: np.asarray(v) for k, v in jp._data.items()}
    tp = problem_from_jax(dataclasses.asdict(jp.config), data, device="cpu")
    rhs = np.asarray(jp.rhs)
    noise = np.abs(rhs).max() * np.random.default_rng(seed).standard_normal((n_noise,) + rhs.shape)
    bs = np.concatenate([rhs[None], noise.astype(np.float32)])
    out = {}
    for use_pallas in (False, True):
        xj = jp.make_batched_solver_fn(J.SolverConfig(method="woodbury", use_pallas=use_pallas))(jnp.asarray(bs))[0]
        xt = tp.make_batched_solver_fn(SolverConfig(method="woodbury", use_pallas=use_pallas))(torch.from_numpy(bs))[0]
        for name, x in (("jax", np.asarray(xj)), ("port", xt.numpy())):
            out[name, use_pallas] = [spectral_relative_residual(tp.operator, x[i].astype(np.float64),
                                                                bs[i].astype(np.float64)) for i in range(len(bs))]
    return out


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel-twin"])
def test_float32_noise_lanes_read_jax_residual(use_pallas):
    """Seeded noise right-hand sides meet another float32 floor than the
    problem's own; the port's batched solve reads the residual of JAX's on
    each lane within 5 %, so that floor is the method's, not the port's."""
    out = _float32_noise_residuals(256, 128)
    rj, rt = np.array(out["jax", use_pallas]), np.array(out["port", use_pallas])
    assert (rj[1:] < rj[0]).all() or (rj[1:] > rj[0]).all()  # noise: another level than the rhs
    np.testing.assert_allclose(rt, rj, rtol=0.05)


if __name__ == "__main__":
    # python tests/test_torch_batched.py: the float32 noise residuals at the
    # wave headline on the CPU, both packages, plain and through the kernel
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    for (pkg, use_pallas), r in _float32_noise_residuals(2048, 1024).items():
        print(f"{pkg} use_pallas={use_pallas}: rhs {r[0]:.3e}, noise " + " ".join(f"{v:.3e}" for v in r[1:]))
