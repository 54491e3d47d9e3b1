"""PyTorch port vs JAX package: the diagonalized system's host plan and
capacity matrices, the packed half-spectrum FFT pair, the plain
half-spectrum Woodbury direct solve, and the float64 residual oracle, on the
same seeded inputs in float64 on the CPU. Tolerances (relative max-abs,
``|a - b|.max() <= tol * |a|.max()``, a the JAX result): plan constants and
FFTs 1e-12, the Woodbury solve 1e-11, the oracle 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_control_paradiag_torch import ProblemConfig as TProblemConfig
from optimal_control_paradiag_torch import WaveControlProblem as TWave
from optimal_control_paradiag_torch.ops import transforms as t_tr
from optimal_control_paradiag_torch.paradiag import spectral as t_sp
from optimal_control_paradiag_tpu import ProblemConfig as JProblemConfig
from optimal_control_paradiag_tpu import WaveControlProblem as JWave
from optimal_control_paradiag_tpu.ops import transforms as j_tr
from optimal_control_paradiag_tpu.paradiag import spectral as j_sp

torch.set_num_threads(1)

CASES = [
    dict(N_x=12, N_t=10),
    dict(N_x=11, N_t=9, mass="lumped", gamma=0.5),
    dict(N_x=6, N_t=8, dim=2, mass="lumped"),
]
IDS = ["1d-consistent", "1d-lumped", "2d-lumped"]


def _assert_close(ref, got, tol):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape
    assert np.abs(ref - got).max() <= tol * np.abs(ref).max()


def _ops(kw):
    jp = JWave(JProblemConfig(**kw))
    tp = TWave(TProblemConfig(**kw), device="cpu")
    return jp.operator, tp.operator


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_spectral_plan_matches_jax(kw):
    jop, top = _ops(kw)
    jpl, tpl = j_sp._spectral_plan(jop), t_sp._spectral_plan(top)
    assert (jpl.N_t, jpl.n) == (tpl.N_t, tpl.n)
    assert jpl.c == tpl.c and jpl.theta == tpl.theta
    for name in ("a11_h", "det_h", "muM64", "muK64", "L1c", "L2c", "m1", "kap1", "tm1", "mk1"):
        _assert_close(getattr(jpl, name), getattr(tpl, name), 1e-12)
    K = jpl.N_t // 2 + 1
    for j_arr, t_arr in zip(jpl.mode_diag(K), tpl.mode_diag(K)):
        _assert_close(np.broadcast_to(np.asarray(j_arr), (K, jpl.n)),
                      np.broadcast_to(t_arr.resolve_conj().numpy(), (K, jpl.n)), 1e-12)
    jC, jW = j_sp._capacity_CW(jpl)
    tC, tW = t_sp._capacity_CW(tpl)
    _assert_close(jC, tC, 1e-12)
    _assert_close(jW, tW, 1e-12)
    _assert_close(j_sp._capacity_matrices(jpl), t_sp._capacity_matrices(tpl), 1e-12)


@pytest.mark.parametrize("N_t", [9, 10, 16, 33])
def test_packed_fft_pair_matches_jax(N_t):
    rng = np.random.default_rng(N_t)
    s = rng.standard_normal((2, N_t, 7))
    K = N_t // 2 + 1
    xi = rng.standard_normal((2, K, 7)) + 1j * rng.standard_normal((2, K, 7))
    fwd = t_tr.time_rfft_conj_packed(torch.from_numpy(s), N_t)
    assert fwd.is_contiguous() and not fwd.is_conj() and fwd.shape == (2, K, 7)
    _assert_close(j_tr.time_rfft_conj_packed(jnp.asarray(s), N_t), fwd, 1e-12)
    _assert_close(
        j_tr.time_irfft_conj_packed(jnp.asarray(xi), N_t),
        t_tr.time_irfft_conj_packed(torch.from_numpy(xi), N_t),
        1e-12,
    )
    # the packed pair is the two-rfft transform and its inverse
    _assert_close(np.conj(np.fft.rfft(s, axis=1)) / N_t, fwd, 1e-12)
    _assert_close(s, t_tr.time_irfft_conj_packed(fwd, N_t), 1e-12)


@pytest.mark.parametrize("kw", CASES, ids=IDS)
@pytest.mark.parametrize("refine", [0, 1])
@pytest.mark.parametrize("time_transform", ["fft2", "fft", "dft", "mxu"])
def test_plain_woodbury_matches_jax(kw, refine, time_transform):
    jp = JWave(JProblemConfig(**kw))
    tp = TWave(TProblemConfig(**kw), device="cpu")
    b = np.array(jp.rhs)
    x_j = jax.jit(j_sp.build_woodbury_solver(
        jp.operator, refine=refine, half_spectrum=True, time_transform=time_transform))(jp.rhs)
    x_t = t_sp.build_woodbury_solver(
        tp.operator, refine=refine, time_transform=time_transform)(torch.from_numpy(b))
    _assert_close(x_j, x_t, 1e-11)


@pytest.mark.parametrize("kw", [CASES[0], CASES[2]], ids=[IDS[0], IDS[2]])
def test_residual_oracle_matches_jax(kw):
    jop, top = _ops(kw)
    rng = np.random.default_rng(3)
    x, b = rng.standard_normal((2,) + jop.shape)
    r_j = j_sp.spectral_relative_residual(jop, x, b)
    r_t = t_sp.spectral_relative_residual(top, x, b)
    assert abs(r_j - r_t) <= 1e-12 * r_j
    g = rng.standard_normal((3, 2 * top.space.n1d + 2))
    for ax in (0, 1):
        _assert_close(j_sp._np_dst_axis(g, ax), t_sp._np_dst_axis(g, ax), 1e-12)


@pytest.mark.parametrize("kw", [dict(layout=True)], ids=["layout"])
def test_unported_solver_options_raise(kw, tmp_path):
    """The sharded option is ported: on a 1x1 grid (a gloo group of this
    process) the solve equals the unsharded one with the 'dft' time
    transform (its default there), and 'mxu' is refused, as in the JAX
    package."""
    from optimal_control_paradiag_torch.parallel import multihost
    from optimal_control_paradiag_torch.parallel.sharding import make_layout

    _, top = _ops(CASES[0])
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(top.shape))
    with multihost.group_of_one(device="cpu", init_method=f"file://{tmp_path}/store", timeout_s=60):
        layout = make_layout(1, 1)
        got = t_sp.build_woodbury_solver(top, layout=layout)(b)
        with pytest.raises(ValueError, match="mxu"):
            t_sp.build_woodbury_solver(top, layout=layout, time_transform="mxu")
        with pytest.raises(ValueError, match="dft"):
            t_sp.make_halfspectrum_transforms(top.space, top.N_t, top.space.dtype, layout=layout, time_transform="fft")
    want = t_sp.build_woodbury_solver(top, time_transform="dft")(b)
    assert float((got - want).abs().max()) <= 1e-13 * float(want.abs().max())


def test_unknown_time_transform_raises():
    _, top = _ops(CASES[0])
    with pytest.raises(ValueError, match="unknown time_transform"):
        t_sp.build_woodbury_solver(top, time_transform="fftx")


@pytest.mark.parametrize("which", ["allow_tf32", "precision"])
def test_reduced_precision_matmul_is_refused(which):
    _, top = _ops(CASES[0])
    old_flag = torch.backends.cuda.matmul.allow_tf32
    old_prec = torch.get_float32_matmul_precision()
    try:
        if which == "allow_tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
        else:
            torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="full"):
            t_sp.build_woodbury_solver(top)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old_flag
        torch.set_float32_matmul_precision(old_prec)
