"""The whole slice: ``WaveControlProblem(...).solve(SolverConfig(
method='woodbury', use_pallas=True))`` of the PyTorch port (device='cpu',
where the fused solve runs the kernel's plain twin) vs the JAX package (its
Pallas kernel in interpret mode), on identical inputs carried over by
``optimal_control_paradiag_torch.interop``. Also: the float32 dtype
discipline, the port's independence from JAX, the CUDA default device, and
the methods not ported yet.

Tolerances: u and p relative max-abs 1e-11; error_aligned 1e-10 absolute;
the port's residual_norm / ||b|| below 1e-10; the two float64 residual
oracles on one solution 1e-12 absolute. The polish path is held against
the JAX package in tests/test_torch_polish.py."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import optimal_control_paradiag_tpu as J
from optimal_control_paradiag_torch import (
    HeatControlProblem,
    ProblemConfig,
    SolverConfig,
    WaveControlProblem,
    reference_1d_default,
)
from optimal_control_paradiag_torch.interop import problem_from_jax, solver_from_jax

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(jcfg, device="cpu"):
    """(JAX problem, port problem) on the JAX problem's own data."""
    jp = J.WaveControlProblem(jcfg)
    data = {k: np.asarray(v) for k, v in jp._data.items()}
    return jp, problem_from_jax(dataclasses.asdict(jcfg), data, device=device)


def _rel(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    return np.abs(ref - got).max() / np.abs(ref).max()


@pytest.mark.parametrize(
    "jcfg",
    [J.reference_1d_default(), J.ProblemConfig(N_x=48, N_t=32)],
    ids=["reference-80x81", "48x32"],
)
@pytest.mark.parametrize("use_pallas", [True, False], ids=["fused", "plain"])
def test_solve_matches_jax(jcfg, use_pallas):
    jp, tp = _pair(jcfg)
    jsolver = J.SolverConfig(method="woodbury", use_pallas=use_pallas)
    tsolver = solver_from_jax(dataclasses.asdict(jsolver))
    assert tsolver == SolverConfig(method="woodbury", use_pallas=use_pallas)
    np.testing.assert_allclose(tp.rhs.numpy(), np.asarray(jp.rhs), rtol=0, atol=1e-12 * np.abs(np.asarray(jp.rhs)).max())

    js, ts = jp.solve(jsolver), tp.solve(tsolver)
    assert ts.result is None and ts.u.dtype == torch.float64
    assert _rel(js.u, ts.u) <= 1e-11
    assert _rel(js.p, ts.p) <= 1e-11
    assert abs(jp.error_aligned(js) - tp.error_aligned(ts)) <= 1e-10
    assert abs(jp.error_vs_analytic(js) - tp.error_vs_analytic(ts)) <= 1e-10
    for a, b in zip(jp.output_trajectories(js), tp.output_trajectories(ts)):
        assert _rel(a, b) <= 1e-11
    assert (tp.residual_norm(ts) / torch.linalg.norm(tp.rhs)).item() < 1e-10
    # the two float64 oracles, on the JAX solution (relative agreement on
    # O(1) residuals: tests/test_torch_spectral.py)
    js_as_port = type(ts)(u=torch.from_numpy(np.array(js.u)), p=torch.from_numpy(np.array(js.p)), result=None)
    assert abs(jp.relative_residual_f64(js) - tp.relative_residual_f64(js_as_port)) <= 1e-12


def test_manufactured_data_matches_jax():
    """Without interop the port builds the same data as the JAX package."""
    jp = J.WaveControlProblem(J.ProblemConfig(N_x=10, N_t=8, gamma=0.5))
    tp = WaveControlProblem(ProblemConfig(N_x=10, N_t=8, gamma=0.5), device="cpu")
    for k in ("f", "g", "u0", "u1"):
        np.testing.assert_allclose(tp._data[k].numpy(), np.asarray(jp._data[k]), rtol=1e-15, atol=1e-15)
    assert _rel(jp.rhs, tp.rhs) <= 1e-12


def test_float32_dtype_discipline():
    """float32 end to end: every tensor the solve returns stays float32, and
    its float64-oracle residual is within 2x the JAX package's."""
    import jax.numpy as jnp

    jp, tp = _pair(J.ProblemConfig(N_x=256, N_t=128, dtype=jnp.float32))
    solver = SolverConfig(method="woodbury", use_pallas=True)
    ts = tp.solve(solver)
    js = jp.solve(J.SolverConfig(method="woodbury", use_pallas=True))
    for t in (tp.rhs, ts.u, ts.p, tp.residual_norm(ts), tp.make_solver_fn(solver)(tp.rhs)[0]):
        assert t.dtype == torch.float32
    r_t, r_j = tp.relative_residual_f64(ts), jp.relative_residual_f64(js)
    assert r_t <= 2.0 * r_j, (r_t, r_j)


def test_port_imports_no_jax():
    code = (
        "import sys, torch\n"
        "from optimal_control_paradiag_torch import HeatControlProblem, ProblemConfig, SolverConfig, WaveControlProblem\n"
        "import optimal_control_paradiag_torch.interop\n"
        "p = WaveControlProblem(ProblemConfig(N_x=8, N_t=6), device='cpu')\n"
        "s = p.solve(SolverConfig(method='woodbury', use_pallas=True))\n"
        "assert p.relative_residual_f64(s) < 1e-10\n"
        "h = HeatControlProblem(ProblemConfig(N_x=8, N_t=6), device='cpu')\n"
        "s = h.solve(SolverConfig(method='woodbury', use_pallas=True, polish=1))\n"
        "assert h.relative_residual_f64(s) < 1e-10\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'optimal_control_paradiag_tpu')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert WaveControlProblem(ProblemConfig(N_x=8, N_t=6)).rhs.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WaveControlProblem(ProblemConfig(N_x=8, N_t=6))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        problem_from_jax(dataclasses.asdict(J.ProblemConfig(N_x=8, N_t=6)), {})


@pytest.mark.parametrize(
    "cls,cfg,solver",
    [
        (WaveControlProblem, reference_1d_default(), SolverConfig()),
        (WaveControlProblem, reference_1d_default(), SolverConfig(method="minres")),
        (WaveControlProblem, reference_1d_default(), SolverConfig(method="spectral")),
        (WaveControlProblem, reference_1d_default(), SolverConfig(method="direct")),
        (HeatControlProblem, reference_1d_default(), SolverConfig(method="gmres")),
        (WaveControlProblem, ProblemConfig(N_x=6, N_t=6, dim=2), SolverConfig(method="woodbury")),
    ],
    ids=["gmres", "minres", "spectral", "direct", "heat-gmres", "2d-consistent"],
)
def test_unported_paths_raise(cls, cfg, solver):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A"):
        cls(cfg, device="cpu").solve(solver)


def test_config_validation_matches_jax():
    for kw in (dict(dim=3), dict(mass="diag"), dict(N_t=2), dict(dst_precision="low"),
               dict(dst_method="x")):
        with pytest.raises(ValueError):
            J.ProblemConfig(**dict(dict(N_x=8, N_t=6), **kw))
        with pytest.raises(ValueError):
            ProblemConfig(**dict(dict(N_x=8, N_t=6), **kw))
    with pytest.raises(ValueError):
        ProblemConfig(N_x=8, N_t=6, dtype=torch.float16)
    for kw in (dict(method="x"), dict(refine=-1), dict(polish=1)):
        with pytest.raises(ValueError):
            J.SolverConfig(**kw)
        with pytest.raises(ValueError):
            SolverConfig(**kw)
    assert [f.name for f in dataclasses.fields(ProblemConfig)] == [
        f.name for f in dataclasses.fields(J.ProblemConfig)]
    assert dataclasses.asdict(SolverConfig()) == dataclasses.asdict(J.SolverConfig())
