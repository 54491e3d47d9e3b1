"""The 2D heat cell's solve on the card (``heat2d_lumped.batch8`` of the
port's benchmark: N_x = 256, N_t = 64, lumped mass, float32, B = 8 a
call), through the benchmark's own entry and pool. These tests need a CUDA
card and nvcc; they skip without one. The file imports no JAX:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda_heat2d.py -q

They hold the call to one B2 launch of the slab schedule and to two passes
over each grid axis (the forward and the inverse sine transform), every
lane's float64 residual by the benchmark's reference to the cell's limit,
and each lane of the batch to the single-rhs solve of the same data.
"""

import math

import pytest
import torch

from optimal_control_paradiag_torch.utils.timing import counters
from portbench import cell as cellmod, manifest
from portbench.reference import model as ref

torch.set_num_threads(1)

CELL = "heat2d_lumped.batch8"
SEED = 2**31 + 1801
# batched against single solves: the batch's DST GEMMs are other cuBLAS
# kernels than one rhs's, so the lanes differ by float32 rounding (B2's
# lanes are bitwise its single launches); 1e-5 is ~100 float32 ulps
LANE_AGREE = 1e-5


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (B2 has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def solved(cuda):
    """The cell, its entry, the first batch of its pool, the batch's answer
    and the counters that one call moved."""
    cell = manifest.load_cell(CELL, trace=False)
    fn = cellmod.entry(cell, cuda)
    b = cellmod.inputs(cell, SEED, cuda)[0]
    fn(b)  # built and warmed outside the counts
    torch.cuda.synchronize()
    keys = ("b2.launches", "b2.launches.slab", "b2.launches.streaming", "transforms/dst.x", "transforms/dst.y")
    before = {k: counters[k] for k in keys}
    x, _ = fn(b)
    torch.cuda.synchronize()
    moved = {k: counters[k] - before[k] for k in keys}
    return cell, fn, b, x, moved


@pytest.mark.cuda
def test_the_cell_shape(solved):
    cell, _, b, x, _ = solved
    pc = cell.config["problem_config"]
    shape = (int(cell.traffic["batch"]), 2, pc["N_t"], (pc["N_x"] - 1) ** 2)
    assert shape == (8, 2, 64, 65025) and b.shape == x.shape == shape
    assert b.dtype == x.dtype == torch.float32 and x.is_cuda


@pytest.mark.cuda
def test_one_slab_launch_and_two_passes_per_axis_a_call(solved):
    moved = solved[4]
    assert moved["b2.launches"] == moved["b2.launches.slab"] == 1 and moved["b2.launches.streaming"] == 0
    assert moved["transforms/dst.x"] == moved["transforms/dst.y"] == 2


@pytest.mark.cuda
def test_every_lane_within_the_cells_limit(solved, cuda):
    cell, _, _, x, _ = solved
    batch = int(cell.traffic["batch"])
    rel = [ref.rel_residual("heat", cell.config["problem_config"],
                            {k: torch.from_numpy(v).to(cuda) for k, v in cellmod.member(cell, SEED, i).items()}, x[i])
           for i in range(batch)]
    assert all(math.isfinite(r) for r in rel)
    assert max(rel) <= float(cell.limits["rel_residual"]), rel


@pytest.mark.cuda
def test_each_lane_matches_its_single_solve(solved):
    _, fn, b, x, _ = solved
    for lane in range(b.shape[0]):
        one, _ = fn(b[lane])
        err = float(torch.linalg.norm(x[lane] - one) / torch.linalg.norm(one))
        assert err <= LANE_AGREE, (lane, err)
