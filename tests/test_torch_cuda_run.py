"""The transforms and the CLI of the PyTorch port on the card against the
CPU. These tests need a CUDA card; they skip without one. The file imports
no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda_run.py -q

Tolerances (relative max-abs, ``|a - b|.max() <= tol * |a|.max()``, b the
CPU result): float64 transforms 1e-12; float32 transforms 2e-5 (the DST) and
1e-5 (the time transforms), tests/test_transforms.py's against numpy; the
CLI's ``error_aligned_metric`` 1e-10 apart, with the same iterations."""

import numpy as np
import pytest
import torch

from optimal_control_paradiag_torch.fem.space import make_space
from optimal_control_paradiag_torch.ops import transforms as tr
from optimal_control_paradiag_torch.paradiag.spectral import make_halfspectrum_transforms
from optimal_control_paradiag_torch.run import main

torch.set_num_threads(1)

TOL = {torch.float64: (1e-12, 1e-12), torch.float32: (2e-5, 1e-5)}  # (DST, time)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(ref, got, tol):
    ref, got = ref.cpu(), got.cpu()
    assert ref.shape == got.shape and ref.dtype == got.dtype
    assert (ref - got).abs().max().item() <= tol * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("method", ["fft", "mxu4"])
@pytest.mark.parametrize("kw", [dict(dim=1, N_x=2048), dict(dim=2, N_x=64, mass="lumped")], ids=["1d", "2d"])
def test_dst_methods_on_card_match_cpu(cuda, dtype, method, kw):
    rng = np.random.default_rng(0)
    cpu = make_space(**kw, dtype=dtype, device="cpu", dst_method=method)
    card = make_space(**kw, dtype=dtype, device=cuda, dst_method=method)
    x = torch.from_numpy(rng.standard_normal((2, 16, cpu.n))).to(dtype)
    z = torch.complex(x, torch.from_numpy(rng.standard_normal(x.shape)).to(dtype))
    for v in (x, z):
        out = card.dst(v.to(cuda))
        assert out.is_cuda
        _close(cpu.dst(v), out, TOL[dtype][0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("time_transform", ["dft", "mxu"])
@pytest.mark.parametrize("N_t", [16, 81, 1024, 13])
def test_time_transforms_on_card_match_cpu(cuda, dtype, time_transform, N_t):
    """Both directions of the half-spectrum pipeline; 13 is prime, where
    'mxu' falls back to the rfft."""
    rng = np.random.default_rng(N_t)
    cpu = make_space(1, 65, dtype=dtype, device="cpu", dst_method="matmul")
    card = make_space(1, 65, dtype=dtype, device=cuda, dst_method="matmul")
    x = torch.from_numpy(rng.standard_normal((2, N_t, cpu.n))).to(dtype)
    fc, bc = make_halfspectrum_transforms(cpu, N_t, dtype, time_transform=time_transform)
    fg, bg = make_halfspectrum_transforms(card, N_t, dtype, time_transform=time_transform)
    xi = fc(x)
    _close(xi, fg(x.to(cuda)), TOL[dtype][1])
    _close(bc(xi), bg(xi.to(cuda)), TOL[dtype][1])


@pytest.mark.cuda
@pytest.mark.parametrize("N", [16, 81, 1024])
def test_dft_matmul_transforms_on_card_match_cpu(cuda, N):
    rng = np.random.default_rng(N)
    z = torch.from_numpy(rng.standard_normal((2, N, 9)) + 1j * rng.standard_normal((2, N, 9)))
    Cc, Sc = tr.dft_matrices(N, torch.float64, "cpu")
    Cg, Sg = tr.dft_matrices(N, torch.float64, cuda)
    zg = z.to(cuda)
    _close(tr.time_ifft_mm(z, Cc, Sc), tr.time_ifft_mm(zg, Cg, Sg), 1e-12)
    _close(tr.time_fft_real_part_mm(z, Cc, Sc), tr.time_fft_real_part_mm(zg, Cg, Sg), 1e-12)
    _close(torch.fft.ifft(z, dim=1), tr.time_ifft_mm(zg, Cg, Sg), 1e-12)


@pytest.mark.cuda
def test_cli_default_run_on_card_matches_cpu(cuda, tmp_path):
    """The reference's default run through the CLI (``--nx 80 --nt 81
    --rtol 1e-8``), on the card (``--platform auto``) and on the CPU."""
    argv = ["--nx", "80", "--nt", "81", "--rtol", "1e-8"]
    card = main(argv + ["--out", str(tmp_path / "card")])
    cpu = main(argv + ["--platform", "cpu", "--out", str(tmp_path / "cpu")])
    assert card["iterations"] == cpu["iterations"] == 5 and card["converged"] and cpu["converged"]
    assert abs(card["error_aligned_metric"] - cpu["error_aligned_metric"]) <= 1e-10
    assert card["residual_norm_true"] < 1e-8 and cpu["residual_norm_true"] < 1e-8
    for d in ("card", "cpu"):
        assert (tmp_path / d / "solution.npz").exists() and (tmp_path / d / "residuals.out").exists()
    assert card["config"]["platform"] == "auto"


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["wave", "heat"])
def test_kernels_between_two_rffts_on_card(cuda, family):
    """``pack_fft=False``: each fused kernel between two real rffts gives
    the packed FFT's solve (the rfft's strided output is made contiguous
    for the kernel)."""
    from optimal_control_paradiag_torch import HeatControlProblem, ProblemConfig, WaveControlProblem
    from optimal_control_paradiag_torch.paradiag import cuda_heat as ch
    from optimal_control_paradiag_torch.paradiag import cuda_woodbury as cw

    cfg = ProblemConfig(N_x=64, N_t=32)
    if family == "wave":
        op = WaveControlProblem(cfg, device=cuda).operator
        build = lambda pack: cw.build_cuda_woodbury_solver(op, pack_fft=pack)
    else:
        prob = HeatControlProblem(cfg, device=cuda)
        build = lambda pack: ch.build_cuda_heat_solver(prob, pack_fft=pack)
    b = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 32, 63))).to(cuda)
    _close(build(True)(b), build(False)(b), 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_batched_solves_on_card_match_cpu(cuda, dtype):
    """The batched wave solve (``make_batched_solver_fn``, one B1 launch)
    and the heat builders on a (3, 2, N_t, n) batch (one B2 launch), on the
    card against the same solves on the CPU: float64 1e-11, float32 1e-5."""
    from optimal_control_paradiag_torch import HeatControlProblem, ProblemConfig, SolverConfig, WaveControlProblem
    from optimal_control_paradiag_torch.paradiag import cuda_heat as ch
    from optimal_control_paradiag_torch.paradiag import cuda_woodbury as cw

    tol = 1e-11 if dtype == torch.float64 else 1e-5
    cfg = ProblemConfig(N_x=64, N_t=32, dtype=dtype)
    bs = torch.from_numpy(np.random.default_rng(6).standard_normal((3, 2, 32, 63))).to(dtype)
    solver = SolverConfig(method="woodbury", use_pallas=True)
    before = cw.fused_woodbury.launches
    card, _ = WaveControlProblem(cfg, device=cuda).make_batched_solver_fn(solver)(bs.to(cuda))
    assert cw.fused_woodbury.launches == before + 1
    _close(WaveControlProblem(cfg, device="cpu").make_batched_solver_fn(solver)(bs)[0], card, tol)
    before = ch.fused_heat.launches
    card = ch.build_cuda_heat_solver(HeatControlProblem(cfg, device=cuda))(bs.to(cuda))
    assert ch.fused_heat.launches == before + 1
    _close(ch.build_cuda_heat_solver(HeatControlProblem(cfg, device="cpu"))(bs), card, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["gmres", "spectral", "minres", "direct"])
def test_batched_iterative_and_direct_on_card_match_cpu(cuda, method):
    """The other batched methods (float64) on the card against the CPU: the
    same per-lane iterations, x to 1e-10."""
    from optimal_control_paradiag_torch import ProblemConfig, SolverConfig, WaveControlProblem

    cfg = ProblemConfig(N_x=24, N_t=16)
    solver = SolverConfig(method=method, rtol=1e-10)
    cpu = WaveControlProblem(cfg, device="cpu")
    bs = torch.stack([cpu.rhs, -0.5 * cpu.rhs, torch.roll(cpu.rhs, 1, dims=-2)])
    xc, rc = cpu.make_batched_solver_fn(solver)(bs)
    xg, rg = WaveControlProblem(cfg, device=cuda).make_batched_solver_fn(solver)(bs.to(cuda))
    _close(xc, xg, 1e-10)
    if rc is not None:
        assert torch.equal(torch.as_tensor(rc.iterations).cpu(), torch.as_tensor(rg.iterations).cpu())
