"""CGS2, the Arnoldi step's orthogonalisation, on the CPU: the plain twin
(``krylov/gmres.py`` ``cgs2_reference``, the batched products) against a
numpy float64 CGS2; ``arnoldi_step`` bitwise today's body on every CPU
basis, real and complex; no kernel launch counted on the CPU; the
kernels' argument checks (``ops/cgs2.py``), each refusal a ValueError
naming its condition, a basis off the card too; the launch schedule's
arithmetic and its row limit, and the restart cap at that limit; the
zero-norm branch. The kernels themselves run on the card
(``tests/test_torch_cuda_cgs2.py``).
"""

import warnings

import numpy as np
import pytest
import torch

from optimal_control_paradiag_torch import ProblemConfig, SolverConfig, WaveControlProblem
from optimal_control_paradiag_torch.krylov.gmres import arnoldi_step, cgs2_reference, clamp_restart, gmres
from optimal_control_paradiag_torch.ops import cgs2 as cg
from optimal_control_paradiag_torch.parallel.sharding import resolve_layout
from optimal_control_paradiag_torch.utils.timing import counters

torch.set_num_threads(1)

# Twin against numpy float64: the same CGS2 in another order of sums, so a
# few ulps of the working dtype times the entries' size.
AGREE = {torch.float64: 1e-12, torch.float32: 2e-5}
H100_SMS = 132


def _orthonormal(B, rows, m, seed):
    """``(B, rows, m)`` float64 numpy rows, orthonormal in each lane."""
    rng = np.random.default_rng(seed)
    return np.stack([np.linalg.qr(rng.standard_normal((m, rows)))[0].T for _ in range(B)])


def _numpy_cgs2(V, w, k):
    """CGS2 of each lane's w against its rows 0..k in numpy float64: the
    Hessenberg columns and the new rows."""
    H, rows = [], []
    for Q, x in zip(V[:, : k + 1], w):
        h1 = Q @ x
        x = x - h1 @ Q
        h2 = Q @ x
        x = x - h2 @ Q
        nrm = np.linalg.norm(x)
        H.append(np.append(h1 + h2, nrm))
        rows.append(x / nrm if nrm > 0 else x)
    return np.array(H), np.array(rows)


def _frozen_arnoldi_step(op, V, k, shape):
    """``arnoldi_step`` as it was before the kernels (unsharded), frozen."""
    B = V.shape[0]
    Vk = V[:, : k + 1]
    Vh = Vk.conj() if V.is_complex() else Vk
    lay = resolve_layout(None)
    w = op(V[:, k].reshape((B,) + tuple(shape))).reshape(B, -1)
    h1 = lay.all_reduce(torch.bmm(Vh, w[:, :, None])[:, :, 0])
    w = w - torch.bmm(h1[:, None, :], Vk)[:, 0]
    h2 = lay.all_reduce(torch.bmm(Vh, w[:, :, None])[:, :, 0])
    w = w - torch.bmm(h2[:, None, :], Vk)[:, 0]
    hk1 = torch.linalg.norm(w, dim=1)
    V[:, k + 1] = w / torch.where(hk1 > 0, hk1, torch.ones_like(hk1))[:, None]
    return torch.cat([h1 + h2, hk1.to(V.dtype)[:, None]], dim=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("k", [0, 1, 4])
@pytest.mark.parametrize("B", [1, 3])
def test_the_twin_is_numpy_cgs2(B, k, dtype):
    m = 257
    V = _orthonormal(B, 6, m, seed=[B, k])
    rng = np.random.default_rng([B, k, 1])
    w = rng.standard_normal((B, m)) + 5.0 * np.einsum("bj,bjm->bm", rng.standard_normal((B, k + 1)), V[:, : k + 1])
    Vt = torch.from_numpy(V).to(dtype)
    H = cgs2_reference(Vt, torch.from_numpy(w).to(dtype), k)
    H_np, rows_np = _numpy_cgs2(Vt.double().numpy(), torch.from_numpy(w).to(dtype).double().numpy(), k)
    assert H.shape == (B, k + 2) and H.dtype == dtype
    for lane in range(B):
        assert np.linalg.norm(H[lane].double().numpy() - H_np[lane]) <= AGREE[dtype] * np.linalg.norm(H_np[lane])
        assert np.linalg.norm(Vt[lane, k + 1].double().numpy() - rows_np[lane]) <= AGREE[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.complex64, torch.complex128],
                         ids=["f32", "f64", "c64", "c128"])
@pytest.mark.parametrize("B,k", [(1, 0), (1, 3), (3, 0), (3, 3)])
def test_arnoldi_step_on_the_cpu_is_bitwise_todays_body(B, k, dtype):
    shape = (2, 5, 7)
    m = int(np.prod(shape))
    gen = torch.Generator().manual_seed(B * 10 + k)
    V = torch.randn((B, 6, m), dtype=dtype, generator=gen)
    weights = torch.randn(shape, dtype=dtype, generator=gen)
    op = lambda v: weights * v + torch.roll(v, 1, dims=-1)  # noqa: E731
    V_old = V.clone()
    before = counters["cgs2.launches"]
    H = arnoldi_step(op, V, k, shape)
    H_old = _frozen_arnoldi_step(op, V_old, k, shape)
    assert counters["cgs2.launches"] == before
    assert torch.equal(H, H_old)
    assert torch.equal(V, V_old)


def test_no_launch_is_counted_on_the_cpu():
    prob = WaveControlProblem(ProblemConfig(N_x=16, N_t=16), device="cpu")
    before = counters["cgs2.launches"], counters["krylov/step"]
    sol = prob.solve(SolverConfig(rtol=1e-8))
    b = torch.stack([prob.rhs, -2.0 * prob.rhs])
    _, res = prob.make_batched_solver_fn(SolverConfig(rtol=1e-8))(b)
    assert bool(sol.result.converged) and bool(res.converged.all())
    assert counters["krylov/step"] - before[1] >= int(sol.result.iterations) >= 1
    assert counters["cgs2.launches"] == before[0]


def test_the_kernels_refuse_a_basis_off_the_card():
    gen = torch.Generator().manual_seed(7)
    V = torch.randn((2, 4, 33), dtype=torch.float64, generator=gen)
    w = torch.randn((2, 33), dtype=torch.float64, generator=gen)
    V2 = V.clone()
    before = counters["cgs2.launches"]
    with pytest.raises(ValueError, match="the basis is on cpu, not on a CUDA device"):
        cg.cgs2(V, w, 2)
    assert torch.equal(V, V2) and counters["cgs2.launches"] == before


def _valid(B=2, rows=4, m=64, dtype=torch.float64):
    return torch.zeros((B, rows, m), dtype=dtype), torch.zeros((B, m), dtype=dtype)


def test_a_step_the_kernels_take_passes_the_checks():
    V, w = _valid()
    assert cg.check_cgs2(V, w, 0) == (2, 1, 64)
    assert cg.check_cgs2(V, w, 2) == (2, 3, 64)
    assert cg.check_cgs2(V[:1], w[:1], 1) == (1, 2, 64)
    wide = torch.zeros((2, 80), dtype=torch.float64)[:, :64]  # lanes further apart than m
    assert cg.check_cgs2(V, wide, 1) == (2, 2, 64)


@pytest.mark.parametrize("case,match", [
    ("complex", "dtype torch.complex128 is not float32 or float64"),
    ("half", "dtype torch.float16 is not float32 or float64"),
    ("flat", "is not a \\(B, R \\+ 1, m\\) tensor"),
    ("empty", "is not a \\(B, R \\+ 1, m\\) tensor"),
    ("noncontiguous", "strides .* are not contiguous"),
    ("k_past_rows", "k \\+ 1 = 5 is not in 1..R = 1..3"),
    ("k_last_row", "k \\+ 1 = 4 is not in 1..R = 1..3"),
    ("k_negative", "k \\+ 1 = 0 is not in 1..R"),
    ("w_shape", "w's shape \\(2, 63\\) is not \\(B, m\\)"),
    ("w_lanes", "w's shape \\(3, 64\\) is not \\(B, m\\)"),
    ("w_dtype", "w \\(torch.float32 on cpu\\) does not match the basis"),
    ("w_stride", "w's strides .* have no unit element stride"),
    ("w_overlap", "w's lanes overlap"),
], ids=lambda v: v if isinstance(v, str) and " " not in v else "")
def test_each_refusal_names_its_condition(case, match):
    V, w = _valid()
    k = 1
    if case == "complex":
        V, w = V.to(torch.complex128), w.to(torch.complex128)
    elif case == "half":
        V, w = V.half(), w.half()
    elif case == "flat":
        V = V.reshape(2, -1)
    elif case == "empty":
        V = V[:, :, :0]
    elif case == "noncontiguous":
        V = V.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "k_past_rows":
        k = 4
    elif case == "k_last_row":
        k = 3
    elif case == "k_negative":
        k = -1
    elif case == "w_shape":
        w = w[:, :63]
    elif case == "w_lanes":
        w = torch.zeros((3, 64), dtype=torch.float64)
    elif case == "w_dtype":
        w = w.float()
    elif case == "w_stride":
        w = torch.zeros((2, 128), dtype=torch.float64)[:, ::2]
    elif case == "w_overlap":
        w = torch.zeros(64, dtype=torch.float64).expand(2, 64)
    with pytest.raises(ValueError, match=match):
        cg.check_cgs2(V, w, k)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("lanes,m", [(8, 9_339_136), (1, 4_192_256)], ids=["consistent", "gmres_f64"])
def test_the_schedule_fills_the_card_at_the_cells_shapes(lanes, m, itemsize):
    for rows in range(1, 13):
        s = cg.schedule(rows, m, lanes, itemsize, H100_SMS)
        assert s.chunk % cg.CHUNK_ALIGN == 0 and cg.CHUNK_ALIGN <= s.chunk <= cg.CHUNK_MAX
        assert s.smem_bytes == cg.smem_bytes(rows, s.chunk, itemsize) <= cg.SMEM_TARGET
        # four blocks an SM, on every SM: at least 4 x 132 blocks in all
        assert cg.SMEM_PER_SM // (s.smem_bytes + cg.SMEM_RESERVED) >= 4
        assert s.blocks * lanes >= 4 * H100_SMS
        assert s.blocks <= -(-m // s.chunk)
        # the chunk is the largest that keeps the target
        assert cg.smem_bytes(rows, s.chunk + cg.CHUNK_ALIGN, itemsize) > cg.SMEM_TARGET or s.chunk == cg.CHUNK_MAX


def test_the_schedule_at_small_states_and_many_rows():
    s = cg.schedule(3, 20, 2, 8, H100_SMS)
    assert s.chunk == 32 and s.blocks == 1  # one chunk covers the state
    s = cg.schedule(118, 4_192_256, 1, 8, H100_SMS)
    assert s.chunk == cg.CHUNK_ALIGN and s.smem_bytes <= cg.SMEM_PER_BLOCK_MAX
    assert cg.segments(1) == 8 and cg.segments(3) == 2 and cg.segments(8) == 1 and cg.segments(50) == 1
    # partials and projections, then three 32-bit tickets a lane in whole elements
    assert cg.scratch_elements(3, 2, 5, 8) == 3 * 2 * 7 + 5 and cg.scratch_elements(3, 2, 5, 4) == 3 * 2 * 7 + 9
    with pytest.raises(ValueError, match="rows of a 16-element chunk need"):
        cg.schedule(2000, 10**6, 1, 8, H100_SMS)


@pytest.mark.parametrize("itemsize,rows", [(8, 853), (4, 1707)], ids=["f64", "f32"])
def test_max_rows_is_the_most_a_block_stages(itemsize, rows):
    assert cg.max_rows(itemsize) == rows
    s = cg.schedule(rows, 4096, 1, itemsize, H100_SMS)
    assert s.chunk == cg.CHUNK_ALIGN and s.smem_bytes + cg.SMEM_STATIC <= cg.SMEM_PER_BLOCK_MAX
    with pytest.raises(ValueError, match=f"max_rows: {rows}"):
        cg.schedule(rows + 1, 4096, 1, itemsize, H100_SMS)


def test_the_restart_is_capped_at_the_row_limit_only_where_given():
    with pytest.warns(UserWarning, match="GMRES restart 1000 is more than the 853 basis rows"):
        assert clamp_restart(1000, (64,), torch.float64, 5000, rows_max=853) == 853
    assert clamp_restart(800, (64,), torch.float64, 5000, rows_max=853) == 800
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert clamp_restart(1000, (64,), torch.float64, 5000) == 1000
        # the CPU runs the twin, which takes any number of rows: no cap
        d = torch.linspace(1.0, 1e3, 900, dtype=torch.float64)
        b = torch.ones(900, dtype=torch.float64)
        res = gmres(lambda v: d * v, b, restart=1000, maxiter=1000, rtol=1e-10)
    assert bool(res.converged) and int(res.iterations) > 100


def test_a_w_in_the_span_takes_the_zero_norm_branch():
    V = torch.zeros((2, 4, 50), dtype=torch.float64)
    V[:, 0, 0] = 1.0
    V[:, 1, 7] = 1.0
    w = 3.0 * V[:, 0] + 2.0 * V[:, 1]
    V[:, 2] = float("nan")
    H = cgs2_reference(V, w, 1)
    assert torch.equal(H, torch.tensor([[3.0, 2.0, 0.0]] * 2, dtype=torch.float64))
    assert torch.equal(V[:, 2], torch.zeros((2, 50), dtype=torch.float64))
