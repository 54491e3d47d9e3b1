"""The 2D consistent-mass wave solve on the card with B1 as the tensor
GMRES's preconditioner solve (``method='woodbury'``, ``use_pallas=True``):
the surrogate solve alone against its eager composition, at a small size
and at the cell's shape; the route against the CPU at a small size, with
the same lock-step steps; one B1 launch per preconditioner apply; and the
benchmark's cell (``wave2d_consistent.batch8_f64``: N_x = 192,
N_t = 128, float64, B = 8 a call) through its own entry and pool. These
tests need a CUDA card and nvcc; they skip without one. The file imports
no JAX:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda_wave2d_consistent.py -q
"""

import math

import numpy as np
import pytest
import torch

from optimal_control_paradiag_torch import ProblemConfig, SolverConfig, WaveControlProblem
from optimal_control_paradiag_torch.paradiag.cuda_woodbury import build_cuda_woodbury_solver
from optimal_control_paradiag_torch.paradiag.spectral import _build_woodbury_half, _spectral_plan
from optimal_control_paradiag_torch.utils.timing import counters
from portbench import cell as cellmod, manifest
from portbench.reference import model as ref

torch.set_num_threads(1)

CELL = "wave2d_consistent.batch8_f64"
SEED = 2**31 + 2407
ROUTE = SolverConfig(method="woodbury", use_pallas=True)
KEYS = ("b1.launches", "pc.tensor_mass.applies", "solve.tensor_gmres", "krylov/step")
# Card against CPU, float64: the same lock-step GMRES steps on B1 against
# its twin and cuBLAS / cuFFT against the CPU's sums; the answers differ
# by the rounding the GMRES stop (rtol 1e-10) leaves (CPU tests: two
# routes 1e-11 apart), so 1e-9.
CPU_AGREE = 1e-9
# The residual the CPU tests hold the route to at small sizes.
RESIDUAL = 1e-9
# B1's surrogate solve against the eager composition over the same plan:
# two exact float64 solves of one sine-diagonal system in another order of
# sums (the CPU tests read 9e-16 with the twin); 1e-12, as there.
SURROGATE_AGREE = 1e-12


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (B1 has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def _sync(x):
    if x.is_cuda:
        torch.cuda.synchronize()


def _counted(fn, b):
    """``fn(b)`` after a warm-up call, and the counters that call moved."""
    fn(b)
    _sync(b)
    before = {k: counters[k] for k in KEYS}
    x, rec = fn(b)
    _sync(b)
    return x, {k: counters[k] - before[k] for k in KEYS}


def _consistent(N_x, N_t):
    return dict(N_x=N_x, N_t=N_t, T=2.0, gamma=1.0, dim=2, scaled=True, mass="consistent")


@pytest.mark.cuda
@pytest.mark.parametrize("N_x,N_t,lanes", [(16, 16, 1), (16, 16, 3), (192, 128, 8)],
                         ids=["16x16-1", "16x16-3", "192x128-8"])
def test_b1_surrogate_solve_is_the_eager_composition(cuda, N_x, N_t, lanes):
    """The preconditioner's solve on the route (B1 between the 'fft2'
    transforms, float64, refine 0, surrogate constants) against
    ``_build_woodbury_half`` over the surrogate plan on the card, at a
    small size and at the cell's (K = 65, n = 36481, 8 lanes): one B1
    launch a call."""
    op = WaveControlProblem(ProblemConfig(**_consistent(N_x, N_t), dtype=torch.float64), device=cuda).operator
    eager = _build_woodbury_half(op, _spectral_plan(op, mass_surrogate=True), refine=0)
    b1 = build_cuda_woodbury_solver(op, refine=0, mass_surrogate=True)
    rng = np.random.default_rng([SEED, N_x, lanes])
    r = torch.from_numpy(rng.standard_normal((lanes, 2, N_t, (N_x - 1) ** 2))).to(cuda)
    r = r[0] if lanes == 1 else r
    b1(r)
    torch.cuda.synchronize()
    before = counters["b1.launches"]
    x = b1(r)
    torch.cuda.synchronize()
    assert counters["b1.launches"] - before == 1
    want = eager(r)
    err = float(torch.linalg.norm((x - want).reshape(-1)) / torch.linalg.norm(want.reshape(-1)))
    assert err <= SURROGATE_AGREE, err


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 3])
def test_the_route_on_the_card_matches_the_cpu(cuda, lanes):
    cfg = ProblemConfig(**_consistent(16, 16), dtype=torch.float64)
    rng = np.random.default_rng([SEED, lanes])
    b = torch.from_numpy(rng.standard_normal((lanes, 2, 16, 225)))
    xs, steps = {}, {}
    for dev in ("cpu", "cuda"):
        prob = WaveControlProblem(cfg, device=dev)
        bb = b.to(dev) if lanes > 1 else b[0].to(dev)
        fn = prob.make_batched_solver_fn(ROUTE) if lanes > 1 else prob.make_solver_fn(ROUTE)
        x, moved = _counted(fn, bb)
        assert moved["solve.tensor_gmres"] == 1
        assert moved["pc.tensor_mass.applies"] == moved["krylov/step"] + 1
        if dev == "cuda":
            assert moved["b1.launches"] == moved["pc.tensor_mass.applies"]
        xs[dev], steps[dev] = x.cpu(), moved["krylov/step"]
    assert steps["cuda"] == steps["cpu"] >= 1  # the same lock-step GMRES steps
    err = float(torch.linalg.norm(xs["cuda"] - xs["cpu"]) / torch.linalg.norm(xs["cpu"]))
    assert err <= CPU_AGREE, err
    pc = _consistent(16, 16)
    for lane in range(lanes):
        bl = b[lane]
        r = ref.matvec("wave", pc, xs["cuda"].reshape(b.shape)[lane]) - bl
        assert float(torch.linalg.norm(r) / torch.linalg.norm(bl)) <= RESIDUAL


@pytest.fixture(scope="module")
def cell_call(cuda):
    """The cell, the first batch of its pool, the answer and the counters
    one call moved (after a warm-up call)."""
    cell = manifest.load_cell(CELL, trace=False)
    fn = cellmod.entry(cell, cuda)
    b = cellmod.inputs(cell, SEED, cuda)[0]
    x, moved = _counted(fn, b)
    return cell, b, x, moved


@pytest.mark.cuda
def test_the_cell_call_is_one_b1_launch_an_apply(cell_call):
    cell, b, x, moved = cell_call
    pc = cell.config["problem_config"]
    assert b.shape == x.shape == (8, 2, pc["N_t"], (pc["N_x"] - 1) ** 2) == (8, 2, 128, 36481)
    assert x.dtype == torch.float64 and x.is_cuda
    assert moved["solve.tensor_gmres"] == 1 and moved["pc.tensor_mass.applies"] >= 2
    assert moved["b1.launches"] == moved["pc.tensor_mass.applies"]
    assert moved["pc.tensor_mass.applies"] == moved["krylov/step"] + 1


@pytest.mark.cuda
def test_every_lane_of_the_cell_call_within_its_limit(cell_call, cuda):
    cell, _, x, _ = cell_call
    rel = [ref.rel_residual("wave", cell.config["problem_config"],
                            {k: torch.from_numpy(v).to(cuda) for k, v in cellmod.member(cell, SEED, i).items()}, x[i])
           for i in range(x.shape[0])]
    assert all(math.isfinite(r) for r in rel)
    assert max(rel) <= float(cell.limits["rel_residual"]), rel
