"""CGS2's kernels (csrc/cgs2.cu, ``ops/cgs2.py`` ``cgs2``) against their
plain twin (``krylov/gmres.py`` ``cgs2_reference``, the batched products)
on the card: at the 2D consistent cell's shape (B = 8, m = 9,339,136,
float64) on an 11-row basis, at k = 51 on a 53-row basis, at the float64
GMRES cell's shape (B = 1, m = 4,192,256, k up to 117), on rows that are
not 16-byte aligned, in float32, and at the most rows a step stages
(``max_rows``) in both types; a GMRES restart past that limit clamped to
it with a warning; the zero-norm branch; the same bits from two calls;
four counted launches a step, as a profiler sees them; refused steps;
and both GMRES cells' calls through their own entries, every Arnoldi
step on the kernels. These tests need a CUDA card and nvcc; they skip without one.
The file imports no JAX:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda_cgs2.py -q

Tolerances. In float64 the kernels and the twin sum the same products in
other orders (split-K chunks, then the blocks in a fixed order, against
cuBLAS's gemv), so they differ by rounding: a few ulps of the longest
sums, ~1e-15 relative to the Hessenberg column and the new row. 1e-12
leaves three orders of room and still fails any wrong row, lane or
coefficient. Float32: 1e-5 on the same grounds (float32 ulp 1.2e-7). The
basis the kernels build stays orthonormal to 1e-12 (float64) as CGS2's
does.
"""

import numpy as np
import pytest
import torch

from optimal_control_paradiag_torch.krylov.gmres import arnoldi_step, cgs2_reference, gmres
from optimal_control_paradiag_torch.ops import cgs2 as cg
from optimal_control_paradiag_torch.utils.timing import counters
from portbench import cell as cellmod, manifest

torch.set_num_threads(1)

SEED = 2**31 + 2611
AGREE = {torch.float64: 1e-12, torch.float32: 1e-5}
ORTHO = {torch.float64: 1e-12, torch.float32: 1e-5}
CONSISTENT = (8, 9_339_136)  # (B, m): 8 lanes of 2 x 128 x 191^2
GMRES_F64 = (1, 4_192_256)  # 2 x 1024 x 2047


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CGS2 kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def _rel(a, b):
    wide = torch.complex128 if b.is_complex() else torch.float64
    return float(torch.linalg.norm((a - b).reshape(-1).to(wide)) / torch.linalg.norm(b.reshape(-1).to(wide)))


def _randn(shape, dtype, device, gen):
    return torch.randn(shape, dtype=torch.float64, device=device, generator=gen).to(dtype)


def _start(B, rows, m, dtype, device, gen):
    """A ``(B, rows, m)`` basis with a unit first row."""
    V = torch.empty((B, rows, m), dtype=dtype, device=device)
    v0 = _randn((B, m), dtype, device, gen)
    V[:, 0] = v0 / torch.linalg.norm(v0, dim=1, keepdim=True)
    return V


def _w(V, k, gen):
    """An operator output with a sizable part in the span of V[:, :k+1]."""
    B, _, m = V.shape
    c = 10.0 * _randn((B, 1, k + 1), V.dtype, V.device, gen)
    return _randn((B, m), V.dtype, V.device, gen) / m**0.5 + torch.bmm(c, V[:, : k + 1])[:, 0]


def _orthogonality(V, rows):
    Q = V[:, :rows].double()
    gram = torch.bmm(Q, Q.transpose(1, 2))
    return float((gram - torch.eye(rows, dtype=torch.float64, device=V.device)).abs().max())


def _step_against_twin(V, Vt, k, gen):
    """Step k on V by the kernels and on a copy of its active rows by the
    twin; returns the two Hessenberg columns and new rows."""
    w = _w(V, k, gen)
    Vt[:, : k + 1].copy_(V[:, : k + 1])
    before = counters["cgs2.launches"]
    H = cg.cgs2(V, w, k)
    torch.cuda.synchronize()
    assert counters["cgs2.launches"] - before == cg.LAUNCHES_PER_STEP
    Ht = cgs2_reference(Vt, w, k)
    return H, Ht, V[:, k + 1], Vt[:, k + 1]


def _grow(B, rows, m, dtype, device, checked, gen):
    """Build a ``rows``-row basis with the kernels, one step after another,
    holding the steps in ``checked`` to the twin and to orthogonality."""
    V = _start(B, rows, m, dtype, device, gen)
    Vt = torch.empty_like(V)
    for k in range(max(checked) + 1):
        if k not in checked:
            cg.cgs2(V, _w(V, k, gen), k)
            continue
        H, Ht, row, row_t = _step_against_twin(V, Vt, k, gen)
        assert H.shape == Ht.shape == (B, k + 2)
        for lane in range(B):
            assert _rel(H[lane], Ht[lane]) <= AGREE[dtype], (k, lane)
            assert _rel(row[lane], row_t[lane]) <= AGREE[dtype], (k, lane)
        assert _orthogonality(V, k + 2) <= ORTHO[dtype], k


@pytest.mark.cuda
def test_the_consistent_cells_shape(cuda):
    B, m = CONSISTENT
    _grow(B, 11, m, torch.float64, cuda, (0, 1, 5, 9), torch.Generator(cuda).manual_seed(SEED))


@pytest.mark.cuda
def test_k51_on_a_53_row_basis(cuda):
    _grow(CONSISTENT[0], 53, 72_962, torch.float64, cuda, (0, 51), torch.Generator(cuda).manual_seed(SEED + 1))


@pytest.mark.cuda
def test_the_gmres_f64_cells_shape(cuda):
    B, m = GMRES_F64
    _grow(B, 119, m, torch.float64, cuda, (0, 6, 117), torch.Generator(cuda).manual_seed(SEED + 2))


@pytest.mark.cuda
@pytest.mark.parametrize("B,m,dtype", [(3, 36_481, torch.float64), (3, 1_001, torch.float32),
                                       (4, 65_536, torch.float32)],
                         ids=["f64-odd-m", "f32-odd-m", "f32"])
def test_small_and_unaligned_shapes(cuda, B, m, dtype):
    _grow(B, 8, m, dtype, cuda, (0, 1, 3, 6), torch.Generator(cuda).manual_seed(SEED + m))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_a_step_at_the_row_limit(cuda, dtype):
    """k + 1 = max_rows (853 in float64, 1707 in float32), the most a step
    stages at a 16-element chunk: the kernels launch and agree with the
    twin. w is drawn without a part in the span, so its rounding over the
    rows stays a few ulps of the new row."""
    rows, B, m = cg.max_rows(torch.empty((), dtype=dtype).element_size()), 2, 4096
    gen = torch.Generator(cuda).manual_seed(SEED + 5)
    V = torch.empty((B, rows + 1, m), dtype=dtype, device=cuda)
    for lane in range(B):  # orthonormal rows, from a float64 QR
        V[lane, :rows] = torch.linalg.qr(torch.randn((m, rows), dtype=torch.float64, device=cuda,
                                                     generator=gen))[0].T.to(dtype)
    Vt = V.clone()
    w = _randn((B, m), dtype, cuda, gen)
    before = counters["cgs2.launches"]
    H = cg.cgs2(V, w, rows - 1)
    torch.cuda.synchronize()
    assert counters["cgs2.launches"] - before == cg.LAUNCHES_PER_STEP
    Ht = cgs2_reference(Vt, w, rows - 1)
    for lane in range(B):
        assert _rel(H[lane], Ht[lane]) <= AGREE[dtype] and _rel(V[lane, rows], Vt[lane, rows]) <= AGREE[dtype]


@pytest.mark.cuda
def test_a_restart_past_the_row_limit_is_clamped_to_it(cuda):
    d = torch.linspace(1.0, 1e3, 1000, dtype=torch.float64, device=cuda)
    b = torch.ones(1000, dtype=torch.float64, device=cuda)
    before = counters["cgs2.launches"], counters["krylov/step"]
    with pytest.warns(UserWarning, match="GMRES restart 1000 is more than the 853 basis rows"):
        res = gmres(lambda v: d * v, b, restart=1000, maxiter=1000, rtol=1e-10)
    steps = counters["krylov/step"] - before[1]
    assert bool(res.converged) and steps == int(res.iterations) > 100
    assert counters["cgs2.launches"] - before[0] == cg.LAUNCHES_PER_STEP * steps


@pytest.mark.cuda
def test_a_w_in_the_span_takes_the_zero_norm_branch(cuda):
    B, m = 2, 10_000
    V = torch.zeros((B, 4, m), dtype=torch.float64, device=cuda)
    V[:, 0, 0] = 1.0
    V[:, 1, 7] = 1.0
    w = 3.0 * V[:, 0] + 2.0 * V[:, 1]
    V[:, 2] = float("nan")
    H = cg.cgs2(V, w, 1)
    torch.cuda.synchronize()
    want = torch.tensor([[3.0, 2.0, 0.0]] * B, dtype=torch.float64, device=cuda)
    assert torch.equal(H, want)
    assert torch.equal(V[:, 2], torch.zeros_like(V[:, 2]))
    Vt = V.clone()
    assert torch.equal(cgs2_reference(Vt, w, 1), want) and torch.equal(Vt[:, 2], V[:, 2])


@pytest.mark.cuda
def test_two_calls_give_the_same_bits(cuda):
    gen = torch.Generator(cuda).manual_seed(SEED + 3)
    B, m = 8, 2_000_003
    V = _start(B, 7, m, torch.float64, cuda, gen)
    for k in range(5):
        cg.cgs2(V, _w(V, k, gen), k)
    w = _w(V, 5, gen)
    V2 = V.clone()
    H, H2 = cg.cgs2(V, w, 5), cg.cgs2(V2, w, 5)
    torch.cuda.synchronize()
    assert torch.equal(H.view(torch.int64), H2.view(torch.int64))
    assert torch.equal(V.view(torch.int64), V2.view(torch.int64))


@pytest.mark.cuda
def test_the_launches_a_step_match_the_counter(cuda):
    gen = torch.Generator(cuda).manual_seed(SEED + 4)
    V = _start(8, 4, 100_000, torch.float64, cuda, gen)
    w = _w(V, 0, gen)
    cg.cgs2(V, w, 0)
    torch.cuda.synchronize()
    before = counters["cgs2.launches"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        cg.cgs2(V, w, 0)
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
                  and "cgs2_" in e.key)
    assert counters["cgs2.launches"] - before == cg.LAUNCHES_PER_STEP == kernels


@pytest.mark.cuda
def test_a_step_the_kernels_do_not_take_raises(cuda):
    V = torch.zeros((2, 4, 64), dtype=torch.float64, device=cuda)
    V[:, 0, 0] = 1.0
    w = torch.ones((2, 64), dtype=torch.float64, device=cuda)
    before = counters["cgs2.launches"]
    with pytest.raises(ValueError, match="dtype"):
        arnoldi_step(lambda v: v.half(), V.half(), 0, (64,))
    with pytest.raises(ValueError, match="contiguous"):
        cg.cgs2(V.transpose(0, 1).contiguous().transpose(0, 1), w, 0)
    with pytest.raises(ValueError, match="k \\+ 1"):
        cg.cgs2(V, w, 3)
    with pytest.raises(ValueError, match="does not match"):
        cg.cgs2(V, w.float(), 0)
    assert counters["cgs2.launches"] == before


@pytest.mark.cuda
def test_a_complex_basis_keeps_the_batched_products(cuda):
    gen = torch.Generator().manual_seed(5)
    V = torch.zeros((2, 3, 64), dtype=torch.complex128)
    v0 = torch.randn((2, 64), dtype=torch.complex128, generator=gen)
    V[:, 0] = v0 / torch.linalg.norm(v0, dim=1, keepdim=True)
    op = lambda v: 2j * v + torch.roll(v, 1, dims=-1)  # noqa: E731
    Vc = V.to(cuda)
    before = counters["cgs2.launches"]
    H = arnoldi_step(op, Vc, 0, (64,))
    Ht = arnoldi_step(op, V, 0, (64,))
    assert counters["cgs2.launches"] == before
    assert _rel(H.cpu(), Ht) <= 1e-12 and _rel(Vc[:, 1].cpu(), V[:, 1]) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["wave2d_consistent.batch8_f64", "wave1d_headline.gmres_f64"])
def test_every_arnoldi_step_of_a_gmres_cells_call_takes_the_kernels(cuda, name):
    cell = manifest.load_cell(name, trace=False)
    fn = cellmod.entry(cell, cuda)
    b = cellmod.inputs(cell, SEED, cuda)[0]
    fn(b)
    torch.cuda.synchronize()
    keys = ("cgs2.launches", "krylov/step")
    before = {k: counters[k] for k in keys}
    fn(b)
    torch.cuda.synchronize()
    moved = {k: counters[k] - before[k] for k in keys}
    assert moved["krylov/step"] >= 2
    assert moved["cgs2.launches"] == cg.LAUNCHES_PER_STEP * moved["krylov/step"]
