"""The fused Woodbury solve of the PyTorch port (paradiag/cuda_woodbury.py)
on the CPU, where its wrapper runs the kernel's plain twin, vs the JAX
package's Pallas kernel in interpret mode, on the cases of
tests/test_pallas_woodbury.py. Float64; tolerance relative max-abs 1e-12
(``|a - b|.max() <= tol * |a|.max()``, a the JAX result)."""

import jax
import numpy as np
import pytest
import torch

from optimal_control_paradiag_torch import ProblemConfig as TProblemConfig
from optimal_control_paradiag_torch import WaveControlProblem as TWave
from optimal_control_paradiag_torch.ops.transforms import time_rfft_conj_packed
from optimal_control_paradiag_torch.paradiag import cuda_woodbury as cw
from optimal_control_paradiag_torch.paradiag.spectral import _capacity_matrices, _spectral_plan
from optimal_control_paradiag_tpu import ProblemConfig as JProblemConfig
from optimal_control_paradiag_tpu import WaveControlProblem as JWave
from optimal_control_paradiag_tpu.paradiag.pallas_woodbury import build_pallas_woodbury_solver

torch.set_num_threads(1)

TOL = 1e-12


@pytest.mark.parametrize(
    "kw,refine",
    [
        (dict(N_x=40, N_t=24), 0),
        (dict(N_x=40, N_t=24), 1),
        (dict(N_x=64, N_t=33), 2),
        (dict(N_x=33, N_t=16), 1),
        (dict(N_x=9, N_t=12, dim=2, mass="lumped"), 1),
    ],
    ids=["40x24-r0", "40x24-r1", "64x33-r2", "33x16-r1", "2d-lumped-9x12-r1"],
)
def test_fused_twin_matches_pallas_interpret(kw, refine):
    jp = JWave(JProblemConfig(**kw))
    tp = TWave(TProblemConfig(**kw), device="cpu")
    x_j = np.asarray(jax.jit(build_pallas_woodbury_solver(
        jp.operator, refine=refine, interpret=True))(jp.rhs))
    x_t = cw.build_cuda_woodbury_solver(tp.operator, refine=refine)(
        torch.from_numpy(np.array(jp.rhs))).numpy()
    assert np.abs(x_j - x_t).max() <= TOL * np.abs(x_j).max()


def test_fused_solve_solves_system():
    """Direct-solver correctness: residual of the fused solve below 1e-10."""
    tp = TWave(TProblemConfig(N_x=48, N_t=32), device="cpu")
    b = tp.rhs
    x = cw.build_cuda_woodbury_solver(tp.operator, refine=1)(b)
    rel = torch.linalg.norm(tp.operator.matvec(x) - b) / torch.linalg.norm(b)
    assert rel.item() < 1e-10


def test_unpacked_fft_matches_packed():
    tp = TWave(TProblemConfig(N_x=20, N_t=15), device="cpu")
    x1 = cw.build_cuda_woodbury_solver(tp.operator, pack_fft=True)(tp.rhs)
    x2 = cw.build_cuda_woodbury_solver(tp.operator, pack_fft=False)(tp.rhs)
    assert (x1 - x2).abs().max() <= TOL * x1.abs().max()


def test_packed_constants_layout():
    """Each packed constant against its definition from the float64 plan."""
    tp = TWave(TProblemConfig(N_x=10, N_t=8), device="cpu")
    c = cw.pack_constants(tp.operator)
    plan = _spectral_plan(tp.operator)
    K, n = 5, 9
    assert c.a11r.shape == c.a11i.shape == c.invdet.shape == (K, n)
    assert c.colc.shape == (4, n) and c.gc.shape == (16, n) and c.phases.shape == (K, 16)
    np.testing.assert_array_equal(c.a11r.numpy() + 1j * c.a11i.numpy(), plan.a11_h[:K])
    np.testing.assert_array_equal(c.invdet.numpy(), 1.0 / plan.det_h[:K])
    G = _capacity_matrices(plan).real
    for a in range(4):
        for b in range(4):
            np.testing.assert_array_equal(c.gc[4 * a + b].numpy(), G[:, a, b])
    np.testing.assert_array_equal(c.colc[3].numpy(), plan.muM64 + plan.c * plan.muK64)
    # phi_uNm1 carries the pairing weights 1, 2, 2, 2, 1 (N_t even)
    phi = c.phases[:, 0].numpy() + 1j * c.phases[:, 1].numpy()
    np.testing.assert_allclose(np.abs(phi), [1, 2, 2, 2, 1], rtol=1e-15)


def test_wrapper_on_cpu_runs_the_twin_and_counts_nothing():
    tp = TWave(TProblemConfig(N_x=12, N_t=10), device="cpu")
    c = cw.pack_constants(tp.operator)
    b_hat = time_rfft_conj_packed(tp.space.dst(tp.rhs), 10)
    before = cw.fused_woodbury.launches
    x = cw.fused_woodbury(b_hat, c, 1)
    assert cw.fused_woodbury.launches == before
    assert torch.equal(x, cw.fused_woodbury_reference(b_hat, c, 1))


def test_wrapper_refuses_other_devices():
    tp = TWave(TProblemConfig(N_x=12, N_t=10), device="cpu")
    c = cw.pack_constants(tp.operator)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cw.fused_woodbury(torch.zeros(2, 6, 11, dtype=torch.complex128, device="meta"), c, 1)
