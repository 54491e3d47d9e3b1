"""The bf16x3 GEMM B3 vs its plain PyTorch twin on the card, both routes
(``'mma'``, csrc/bf16x3_gemm.cu; ``'wgmma'``, the split pass and the TMA /
wgmma GEMM of csrc/bf16x3_wgmma.cu), and the paths that reach it:
``P1Space.dst`` with ``dst_precision='high'``, the four-step plans with
``precision='high'`` and the polished direct solves. These tests need a
CUDA card and nvcc; they skip without one. The file imports no JAX, so it
runs on a machine without it:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda_bf16x3.py -q

Tolerances: the kernel against the twin 1e-5 relative max-abs. The two
take the same exact bf16 products and differ only in the order of float32
sums (the twin: three cuBLAS FP32 products, then two adds; the kernels:
each 32-deep ('mma') or 64-deep ('wgmma') K step summed from zero on the
tensor cores, then added to a running float32 sum). Against the float64
product 2e-5 (bf16x3 drops lo x lo, about 2^-16 of each product; the
twin reads 3.6e-6 at the headline). The polished 'high' solves: 1.25 x the
'highest' polished residual, as chip_smoke.py holds them.
"""

import unittest.mock

import numpy as np
import pytest
import torch

from optimal_control_paradiag_torch import HeatControlProblem, ProblemConfig, SolverConfig, WaveControlProblem
from optimal_control_paradiag_torch.fem.space import make_space
from optimal_control_paradiag_torch.ops import bf16x3 as b3
from optimal_control_paradiag_torch.ops import transforms as tr
from optimal_control_paradiag_torch.utils.timing import counters

torch.set_num_threads(1)

TOL = 1e-5
F64_TOL = 2e-5
RESIDUAL_FACTOR = 1.25
T = b3.WGMMA_MIN_WIDTH


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
    launches = counters["b3.launches"]
    out = b3.bf16x3_matmul(a, split)
    torch.cuda.synchronize()
    assert counters["b3.launches"] == launches + 1
    assert out.shape == (M, N) and out.dtype == torch.float32 and out.is_cuda
    assert _rel(out, b3.bf16x3_matmul_reference(a, split.hi, split.lo)) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("kw,lead,launches,wgmma", [
    (dict(dim=1, N_x=2048), (2, 1024), 1, 1),
    (dict(dim=1, N_x=2048), (8, 2, 1024), 1, 1),
    (dict(dim=2, N_x=256, mass="lumped"), (2, 64), 2, 2 * (b3.bf16x3_route(255, 255) == "wgmma")),
], ids=["headline", "batched", "2d"])
def test_high_dst_launches_the_kernel(cuda, kw, lead, launches, wgmma):
    """A CUDA DST with 'high' launches B3 (once per axis) on the route of
    its shape (the headline on 'wgmma') and never runs the twin; it agrees
    with the twin's DST on the CPU."""
    sp = make_space(**kw, dtype=torch.float32, device=cuda, dst_precision="high")
    cpu = make_space(**kw, dtype=torch.float32, device="cpu", dst_precision="high")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(lead + (sp.n,)).astype(np.float32))
    before, before_wgmma = counters["b3.launches"], counters["b3.launches.wgmma"]
    before_split = counters["b3.split.launches"]
    with unittest.mock.patch.object(b3, "bf16x3_matmul_reference", side_effect=AssertionError("twin on CUDA")):
        y = sp.dst(x.to(cuda))
        torch.cuda.synchronize()
    assert counters["b3.launches"] - before == launches
    assert counters["b3.launches.wgmma"] - before_wgmma == wgmma
    assert counters["b3.split.launches"] - before_split == wgmma  # one split pass per 'wgmma' GEMM
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
        before = counters["b3.launches"]
        got = fn(inp.to(cuda), pc)
        torch.cuda.synchronize()
        assert counters["b3.launches"] - before == launches
        assert _rel(got.cpu(), fn(inp, pcpu)) <= TOL


@pytest.mark.cuda
def test_refused_launch_raises(cuda):
    """Planes off 16 bytes are refused by the launcher, and the wrapper
    raises; the next launch is unaffected."""
    K, N, ld = 8, 8, 8
    base = torch.zeros(2 * K * ld + 1, dtype=torch.bfloat16, device=cuda)
    bad = b3.SplitMatrix(planes=base[1:].view(2, K, ld), k=K, n=N, route="mma")
    a = torch.ones(4, K, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        b3.bf16x3_matmul(a, bad)
    good = b3.split_matrix(torch.eye(K, device=cuda))
    torch.testing.assert_close(b3.bf16x3_matmul(a, good), a)



def _operands(cuda, M, K, N, seed, positive=False):
    rng = np.random.default_rng(seed)
    draw = (lambda *shape: rng.uniform(0.0, 1.0, shape)) if positive else (lambda *shape: rng.standard_normal(shape))
    a = torch.from_numpy(draw(M, K).astype(np.float32)).to(cuda)
    b = torch.from_numpy(draw(K, N).astype(np.float32)).to(cuda)
    return a, b


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [
    (2048, 2047, 2047), (16384, 2047, 2047), (129, 2047, 2047), (300, 65, 200), (200, 600, 1),
    (64, T - 1, T - 1), (64, T + 1, T + 1), (1, 1, 1), (130, 64, 128),
], ids=["headline", "batched", "M129", "K65", "N1", "threshold-1", "threshold+1", "1x1x1", "one-tile"])
def test_wgmma_route_matches_twin_and_float64(cuda, M, K, N):
    """The split pass and the wgmma GEMM against the twin and the float64
    product, at the headline, its batch of 8 and ragged shapes (any M, N,
    K: TMA zero-fills past M and N, the planes are zero past K)."""
    a, b = _operands(cuda, M, K, N, M + K + N)
    split = b3.split_matrix(b, route="wgmma")
    counts = lambda: (counters["b3.launches"], counters["b3.launches.wgmma"], counters["b3.split.launches"])
    launches, wgmma, splits = counts()
    out = b3.bf16x3_matmul(a, split)
    torch.cuda.synchronize()
    assert counts() == (launches + 1, wgmma + 1, splits + 1)
    assert out.shape == (M, N) and out.dtype == torch.float32 and out.is_cuda
    assert _rel(out, b3.bf16x3_matmul_reference(a, split.hi, split.lo)) <= TOL
    assert _rel(out.double(), a.double() @ b.double()) <= F64_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("k", [T - 1, T + 1])
def test_default_route_at_the_threshold(cuda, k):
    """Either side of the threshold, the shape's own route, right."""
    a, b = _operands(cuda, 300, k, k, k)
    split = b3.split_matrix(b)
    assert split.route == ("wgmma" if k >= T else "mma")
    wgmma = counters["b3.launches.wgmma"]
    out = b3.bf16x3_matmul(a, split)
    torch.cuda.synchronize()
    assert counters["b3.launches.wgmma"] - wgmma == (split.route == "wgmma")
    assert _rel(out, b3.bf16x3_matmul_reference(a, split.hi, split.lo)) <= TOL
    assert _rel(out.double(), a.double() @ b.double()) <= F64_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["wgmma", "mma"])
def test_drift_of_a_positive_sum(cuda, route):
    """All-positive A and B at K = 2047: every product adds to the sum, so
    a truncating tensor-core chain would drift towards zero; each K chunk
    summed from zero and promoted to a float32 add keeps the float64 gate."""
    a, b = _operands(cuda, 512, 2047, 512, 7, positive=True)
    out = b3.bf16x3_matmul(a, b3.split_matrix(b, route=route))
    torch.cuda.synchronize()
    assert _rel(out.double(), a.double() @ b.double()) <= F64_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("M,K", [(2048, 2047), (3, 65), (1, 1)])
def test_split_pass_is_split_bf16_bitwise(cuda, M, K):
    rng = np.random.default_rng(M + K)
    x = (rng.standard_normal((M, K)) * 10.0 ** rng.uniform(-30, 30, (M, K))).astype(np.float32)
    a = torch.from_numpy(x).to(cuda)
    ld = b3.padded_width(K)
    launches = counters["b3.split.launches"]
    planes = b3.split_rows(a, ld)
    torch.cuda.synchronize()
    assert counters["b3.split.launches"] == launches + 1 and planes.shape == (2, M, ld)
    hi, lo = b3.split_bf16(a)
    assert torch.equal(planes[0, :, :K], hi) and torch.equal(planes[1, :, :K], lo)
    assert (planes[:, :, K:] == 0).all()
    assert torch.equal(planes.cpu(), b3.split_rows(a.cpu(), ld))
    assert torch.equal(planes, b3.split_rows_reference(a, ld))


@pytest.mark.cuda
def test_refused_wgmma_launch_raises(cuda):
    """B's planes off 16 bytes: the 'wgmma' launcher refuses them and the
    wrapper raises; neither the 'mma' kernel nor the twin takes over, and
    the next launch is unaffected."""
    K, N = 64, 8
    ld = b3.padded_width(K)
    base = torch.zeros(2 * N * ld + 1, dtype=torch.bfloat16, device=cuda)
    bad = b3.SplitMatrix(planes=base[1:].view(2, N, ld), k=K, n=N, route="wgmma")
    a = torch.ones(4, K, device=cuda)
    launches = counters["b3.launches"]
    with unittest.mock.patch.object(b3, "bf16x3_matmul_reference", side_effect=AssertionError("twin on CUDA")), \
            unittest.mock.patch.object(b3, "_kernel_library", side_effect=AssertionError("fell back to 'mma'")):
        with pytest.raises(RuntimeError, match="launch failed"):
            b3.bf16x3_matmul(a, bad)
    assert counters["b3.launches"] == launches
    eye = torch.eye(K, N, device=cuda)
    torch.testing.assert_close(b3.bf16x3_matmul(a, b3.split_matrix(eye, route="wgmma")), a @ eye)


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
    fused = "b1.launches" if family == "wave" else "b2.launches"
    cfg = SolverConfig(method="woodbury", use_pallas=True, polish=1)
    res = {}
    for prec in ("highest", "high"):
        p = Prob(ProblemConfig(**kw, dtype=torch.float32, dst_precision=prec), device=cuda)
        counters["b3.launches"] = counters[fused] = 0
        sol = p.solve(cfg)
        torch.cuda.synchronize()
        assert (counters["b3.launches"], counters[fused]) == ((b3_launches if prec == "high" else 0), 2)
        assert torch.isfinite(sol.u).all() and torch.isfinite(sol.p).all()
        res[prec] = p.relative_residual_f64(sol)
    assert res["high"] <= RESIDUAL_FACTOR * res["highest"]
