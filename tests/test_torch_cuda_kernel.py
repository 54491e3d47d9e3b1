"""The fused Woodbury CUDA kernel (csrc/woodbury.cu) vs its plain PyTorch
twin, on the card. These tests need a CUDA card and nvcc; they skip
without one. The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda_kernel.py -q

Tolerances (relative max-abs vs the twin): float64 1e-12. float32 at the
headline shape 2e-4: the kernel's strided K sums reorder the twin's, and the
rank-4 capacity correction amplifies the reordering to the size of the
float32 solve's own error (chip_smoke.py prints both).
"""

import numpy as np
import pytest
import torch

from optimal_control_paradiag_torch import ProblemConfig, SolverConfig, WaveControlProblem
from optimal_control_paradiag_torch.ops.transforms import time_rfft_conj_packed
from optimal_control_paradiag_torch.paradiag import cuda_woodbury as cw

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kw,dtype,refine,tol",
    [
        (dict(N_x=40, N_t=24), torch.float64, 0, 1e-12),
        (dict(N_x=40, N_t=24), torch.float64, 1, 1e-12),
        (dict(N_x=64, N_t=33), torch.float64, 2, 1e-12),
        (dict(N_x=9, N_t=12, dim=2, mass="lumped"), torch.float64, 1, 1e-12),
        (dict(N_x=2048, N_t=1024), torch.float32, 1, 2e-4),
    ],
    ids=["40x24-r0", "40x24-r1", "64x33-r2", "2d-lumped-r1", "headline-f32-r1"],
)
def test_kernel_matches_twin(cuda, kw, dtype, refine, tol):
    prob = WaveControlProblem(ProblemConfig(**kw, dtype=dtype), device=cuda)
    c = cw.pack_constants(prob.operator)
    b_hat = time_rfft_conj_packed(prob.space.dst(prob.rhs), kw["N_t"])
    before = cw.fused_woodbury.launches
    x = cw.fused_woodbury(b_hat, c, refine)
    torch.cuda.synchronize()
    assert cw.fused_woodbury.launches == before + 1
    assert x.dtype == b_hat.dtype and x.shape == b_hat.shape
    assert _rel(x, cw.fused_woodbury_reference(b_hat, c, refine)) <= tol


@pytest.mark.cuda
def test_solve_on_card_matches_cpu(cuda):
    cfg = ProblemConfig(N_x=48, N_t=32)
    solver = SolverConfig(method="woodbury", use_pallas=True)
    before = cw.fused_woodbury.launches
    s_gpu = WaveControlProblem(cfg, device=cuda).solve(solver)
    assert cw.fused_woodbury.launches == before + 1
    s_cpu = WaveControlProblem(cfg, device="cpu").solve(solver)
    assert _rel(s_gpu.u.cpu(), s_cpu.u) <= 1e-11
    assert _rel(s_gpu.p.cpu(), s_cpu.p) <= 1e-11


@pytest.mark.cuda
def test_kernel_rejects_bad_input(cuda):
    prob = WaveControlProblem(ProblemConfig(N_x=12, N_t=10), device=cuda)
    c = cw.pack_constants(prob.operator)
    wrong = torch.zeros(2, 6, 10, dtype=torch.complex128, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        cw.fused_woodbury(wrong, c, 1)
    f32 = torch.zeros(2, 6, 11, dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError, match="constant"):
        cw.fused_woodbury(f32, c, 1)
    assert np.isfinite(cw.fused_woodbury(torch.zeros(2, 6, 11, dtype=torch.complex128, device=cuda), c, 0).abs().max().item())
