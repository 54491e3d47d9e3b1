"""The bf16x3 GEMM kernel (csrc/bf16x3_gemm.cu, B3) vs its plain PyTorch
twin on the card, and the paths that reach it: ``P1Space.dst`` with
``dst_precision='high'``, the four-step plans with ``precision='high'`` and
the polished direct solves. These tests need a
CUDA card and nvcc; they skip without one. The file imports no JAX, so it
runs on a machine without it:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda_bf16x3.py -q

Tolerances: the kernel against the twin 1e-5 relative max-abs. The two
take the same exact bf16 products and differ only in the order of float32
sums (the twin: three cuBLAS FP32 products, then two adds; the kernel: each
32-deep K step summed from zero on the tensor cores, then added to a
running float32 sum). The polished 'high' solves: 1.25 x the 'highest'
polished residual, as chip_smoke.py holds them.
"""

import unittest.mock

import numpy as np
import pytest
import torch

from optimal_control_paradiag_torch import HeatControlProblem, ProblemConfig, SolverConfig, WaveControlProblem
from optimal_control_paradiag_torch.fem.space import make_space
from optimal_control_paradiag_torch.ops import bf16x3 as b3
from optimal_control_paradiag_torch.ops import transforms as tr
from optimal_control_paradiag_torch.paradiag import cuda_heat as ch
from optimal_control_paradiag_torch.paradiag import cuda_woodbury as cw

torch.set_num_threads(1)

TOL = 1e-5
RESIDUAL_FACTOR = 1.25


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "M,K,N",
    [(1, 1, 1), (17, 33, 9), (1, 2047, 2047), (2048, 2047, 2047), (130, 255, 255), (300, 32, 129), (129, 31, 128)],
)
def test_kernel_matches_twin(cuda, M, K, N):
    rng = np.random.default_rng(M + K + N)
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(cuda)
    split = b3.split_matrix(torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)).to(cuda))
    launches = b3.bf16x3_matmul.launches
    out = b3.bf16x3_matmul(a, split)
    torch.cuda.synchronize()
    assert b3.bf16x3_matmul.launches == launches + 1
    assert out.shape == (M, N) and out.dtype == torch.float32 and out.is_cuda
    assert _rel(out, b3.bf16x3_matmul_reference(a, split.hi, split.lo)) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("kw,lead,launches", [
    (dict(dim=1, N_x=2048), (2, 1024), 1),
    (dict(dim=1, N_x=2048), (8, 2, 1024), 1),
    (dict(dim=2, N_x=256, mass="lumped"), (2, 64), 2),
], ids=["headline", "batched", "2d"])
def test_high_dst_launches_the_kernel(cuda, kw, lead, launches):
    """A CUDA DST with 'high' launches B3 (once per axis) and never runs
    the twin; it agrees with the twin's DST on the CPU."""
    sp = make_space(**kw, dtype=torch.float32, device=cuda, dst_precision="high")
    cpu = make_space(**kw, dtype=torch.float32, device="cpu", dst_precision="high")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(lead + (sp.n,)).astype(np.float32))
    before = b3.bf16x3_matmul.launches
    with unittest.mock.patch.object(b3, "bf16x3_matmul_reference", side_effect=AssertionError("twin on CUDA")):
        y = sp.dst(x.to(cuda))
        torch.cuda.synchronize()
    assert b3.bf16x3_matmul.launches - before == launches
    assert _rel(y.cpu(), cpu.dst(x)) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1024, 64])
def test_high_plans_launch_the_kernel(cuda, N):
    """The four-step plans with ``precision='high'``: every radix product
    is a B3 launch on the card, within the tolerance of the same plan's
    twin on the CPU."""
    rng = np.random.default_rng(N)
    x = torch.from_numpy(rng.standard_normal((2, N, 33)).astype(np.float32))
    e = torch.from_numpy(rng.standard_normal((3, 4, N - 1)).astype(np.float32))
    plans = [(tr.FourStepPlan(N, torch.float32, precision="high", device=d), tr.time_rfft_conj_mm4, x, 6)
             for d in (cuda, "cpu")]
    plans += [(tr.DstFourStepPlan(N, torch.float32, precision="high", device=d), tr.dst1_mm4, e, 4)
              for d in (cuda, "cpu")]
    for (pc, fn, inp, launches), (pcpu, _, _, _) in zip(plans[::2], plans[1::2]):
        before = b3.bf16x3_matmul.launches
        got = fn(inp.to(cuda), pc)
        torch.cuda.synchronize()
        assert b3.bf16x3_matmul.launches - before == launches
        assert _rel(got.cpu(), fn(inp, pcpu)) <= TOL


@pytest.mark.cuda
def test_refused_launch_raises(cuda):
    """Planes off 16 bytes are refused by the launcher, and the wrapper
    raises; the next launch is unaffected."""
    K, N, ld = 8, 8, 8
    base = torch.zeros(2 * K * ld + 1, dtype=torch.bfloat16, device=cuda)
    bad = b3.SplitMatrix(planes=base[1:].view(2, K, ld), n=N)
    a = torch.ones(4, K, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        b3.bf16x3_matmul(a, bad)
    good = b3.split_matrix(torch.eye(K, device=cuda))
    torch.testing.assert_close(b3.bf16x3_matmul(a, good), a)


@pytest.mark.cuda
@pytest.mark.parametrize("family,kw,b3_launches", [
    ("wave", dict(N_x=512, N_t=256), 4),
    ("heat", dict(N_x=512, N_t=256), 4),
    ("heat", dict(N_x=64, N_t=32, dim=2, mass="lumped"), 8),
], ids=["wave-1d", "heat-1d", "heat-2d"])
def test_high_polished_solve(cuda, family, kw, b3_launches):
    """``dst_precision='high'`` with ``polish=1`` on the card: B3 twice per
    base solve (per axis in 2D), the family's kernel once per base solve,
    and the residual within 1.25x of the 'highest' polished solve."""
    Prob = WaveControlProblem if family == "wave" else HeatControlProblem
    fused = cw.fused_woodbury if family == "wave" else ch.fused_heat
    cfg = SolverConfig(method="woodbury", use_pallas=True, polish=1)
    res = {}
    for prec in ("highest", "high"):
        p = Prob(ProblemConfig(**kw, dtype=torch.float32, dst_precision=prec), device=cuda)
        b3.bf16x3_matmul.launches = fused.launches = 0
        sol = p.solve(cfg)
        torch.cuda.synchronize()
        assert (b3.bf16x3_matmul.launches, fused.launches) == ((b3_launches if prec == "high" else 0), 2)
        assert torch.isfinite(sol.u).all() and torch.isfinite(sol.p).all()
        res[prec] = p.relative_residual_f64(sol)
    assert res["high"] <= RESIDUAL_FACTOR * res["highest"]
