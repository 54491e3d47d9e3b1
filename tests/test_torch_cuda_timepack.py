"""The packed time FFT's pack, split, merge and unpack kernels
(csrc/time_pack.cu) vs their plain PyTorch twins, on the card, and the
direct solves that run them. These tests need a CUDA card and nvcc; they
skip without one. The file imports no JAX, so it runs on a machine without
it:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda_timepack.py -q

No tolerance: the kernels do the twins' float operations in the twins'
order, so every output is bitwise the twin's (``torch.equal``, and the bit
patterns too, signs of zeros included); pack and merge write the layout
cuFFT's plan reads, so the FFTs through them are bitwise the FFTs of the
twins' outputs, and every solve is bitwise the eager composition the port
ran before the kernels (``ops.transforms._time_*_packed_reference``).
"""

import math
import unittest.mock

import numpy as np
import pytest
import torch

from optimal_control_paradiag_torch import HeatControlProblem, ProblemConfig, WaveControlProblem
from optimal_control_paradiag_torch.ops import time_pack as tp
from optimal_control_paradiag_torch.ops import transforms as tr
from optimal_control_paradiag_torch.paradiag import cuda_heat as ch
from optimal_control_paradiag_torch.paradiag import cuda_woodbury as cw
from optimal_control_paradiag_torch.paradiag import spectral
from optimal_control_paradiag_torch.utils.timing import counters

torch.set_num_threads(1)

WAYS = ("pack", "split", "merge", "unpack")
COUNTERS = tuple(f"time_pack.{w}.launches" for w in WAYS)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bits(t):
    r = torch.view_as_real(t.resolve_conj().contiguous()) if t.is_complex() else t.contiguous()
    return r.view(torch.int32 if r.dtype == torch.float32 else torch.int64)


def _same_values(ref, got):
    assert ref.shape == got.shape and ref.dtype == got.dtype
    assert torch.equal(ref, got)
    assert torch.equal(_bits(ref), _bits(got))


def _same(ref, got):
    assert ref.stride() == got.stride()
    _same_values(ref, got)


def _plan_strides(lead, N, n):
    """The strides of the layout cuFFT's plan reads for ``lead`` lanes of
    (N, n) matrices: row-major for one lane, time-fastest for more."""
    if math.prod(lead) > 1:
        return torch.empty(lead + (n, N), device="meta").transpose(-1, -2).stride()
    return torch.empty(lead + (N, n), device="meta").stride()


def _counts():
    return {c: counters[c] for c in COUNTERS}


def _moved(before, **expected):
    return {c: counters[c] - before[c] for c in COUNTERS} == {f"time_pack.{w}.launches": expected.get(w, 0)
                                                              for w in WAYS}


def _randn(rng, shape, dtype, device, complex_=False):
    x = torch.from_numpy(rng.standard_normal(shape)).to(dtype)
    if complex_:
        x = torch.complex(x, torch.from_numpy(rng.standard_normal(shape)).to(dtype))
    return x.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("lead", [(), (3,), (8,)], ids=["single", "b3", "b8"])
@pytest.mark.parametrize("n", [7, 63, 2047])
@pytest.mark.parametrize("N", [9, 10, 16, 33, 130, 1024])
def test_split_and_merge_match_twin(cuda, N, n, lead, dtype):
    """Both directions against the parent's eager composition, bitwise,
    one launch of each kernel on its side of cuFFT."""
    rng = np.random.default_rng(N * n + len(lead))
    K = N // 2 + 1
    s = _randn(rng, lead + (2, N, n), dtype, cuda)
    before = _counts()
    fwd = tr.time_rfft_conj_packed(s, N)
    assert _moved(before, pack=1, split=1)
    _same(tr._time_rfft_conj_packed_reference(s, N), fwd)
    assert fwd.shape == lead + (2, K, n) and fwd.is_contiguous() and not fwd.is_conj()

    xi = _randn(rng, lead + (2, K, n), dtype, cuda, complex_=True)
    before = _counts()
    inv = tr.time_irfft_conj_packed(xi, N)
    assert _moved(before, merge=1, unpack=1)
    _same(tr._time_irfft_conj_packed_reference(xi, N), inv)
    assert inv.shape == lead + (2, N, n) and inv.is_contiguous() and inv.dtype == dtype
    # the merge kernel's output is the tensor torch.cat builds, in the plan's layout
    merged = tp.merge(xi, N)
    assert merged.stride() == _plan_strides(lead, N, n)
    _same_values(tp.merge_reference(xi, N), merged)


# n = 65025 (the 2D cell's columns) only at the short N it runs with
PACK_SHAPES = [(N, n) for N in (9, 10, 64, 1024) for n in (1, 2, 2047, 65025) if N * n <= 64 * 65025]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("lead", [(), (3,), (8,)], ids=["single", "b3", "b8"])
@pytest.mark.parametrize("N,n", PACK_SHAPES)
def test_pack_and_unpack_match_twin(cuda, N, n, lead, dtype):
    """pack: the twin's values in the plan's layout, and cuFFT on it bitwise
    cuFFT on the twin's output (the same plan); unpack: the twin's tensor,
    strides and bits, and bitwise the normalised inverse FFT's ``stack``."""
    rng = np.random.default_rng(N + n + len(lead))
    s = _randn(rng, lead + (2, N, n), dtype, cuda)
    before = _counts()
    packed = tp.pack(s)
    assert _moved(before, pack=1)
    assert packed.stride() == _plan_strides(lead, N, n)
    ref = tp.pack_reference(s)
    _same_values(ref, packed)
    _same(torch.fft.fft(ref, dim=-2), torch.fft.fft(packed, dim=-2))

    Z = _randn(rng, lead + (2, N // 2 + 1, n), dtype, cuda, complex_=True)
    M = tp.merge(Z, N)
    z = torch.fft.ifft(M, dim=-2, norm="forward")
    before = _counts()
    out = tp.unpack(z, N)
    assert _moved(before, unpack=1)
    _same(tp.unpack_reference(z, N), out)
    zn = torch.fft.ifft(tp.merge_reference(Z, N), dim=-2)  # the parent's normalised inverse
    _same(torch.stack([zn.real, zn.imag], dim=-3), out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128], ids=["c64", "c128"])
@pytest.mark.parametrize("N,n,lead", [(10, 7, ()), (33, 63, (3,)), (1024, 2047, (8,)), (64, 65025, (8,))])
def test_split_takes_the_fft_layout(cuda, N, n, lead, dtype):
    """cuFFT's output over dim -2 is column-major, the layout the split and
    unpack kernels read, whatever layout its input had."""
    rng = np.random.default_rng(N + n)
    lanes = lead[0] if lead else 1
    for x in (_randn(rng, lead + (N, n), dtype.to_real(), cuda, complex_=True),
              tp.pack(_randn(rng, lead + (2, N, n), dtype.to_real(), cuda))):
        Z = torch.fft.fft(x, dim=-2)
        assert Z.stride()[-2:] == (1, N) and tp.check_split(Z, N) == lanes == tp.check_unpack(Z, N)
        _same(tp.split_reference(Z, N), tp.split(Z, N))
        _same(tp.unpack_reference(Z, N), tp.unpack(Z, N))


@pytest.mark.cuda
def test_layouts_the_kernels_refuse_raise(cuda):
    """A CUDA tensor a kernel does not take raises, naming the condition,
    and launches nothing: the card never runs the twin."""
    rng = np.random.default_rng(3)
    Z = torch.fft.fft(_randn(rng, (4, 16, 12), torch.float64, cuda, complex_=True), dim=-2)
    xi = _randn(rng, (2, 9, 12), torch.float64, cuda, complex_=True)
    s = _randn(rng, (4, 2, 16, 12), torch.float64, cuda)
    cases = [(tp.split, Z.contiguous(), "column-major"),  # row-major
             (tp.split, Z[..., ::2], "column-major"),  # strided columns
             (tp.split, Z[::2], "one after another"),  # lanes apart
             (tp.split, Z.to(torch.complex64).conj(), "conjugate"),
             (tp.split, Z[..., :0], "elements"),
             (tp.unpack, Z.contiguous(), "column-major"),
             (tp.unpack, Z[::2], "one after another"),
             (tp.unpack, Z.conj(), "conjugate"),
             (tp.unpack, Z.real, "dtype"),
             (tp.merge, xi.transpose(-1, -2).contiguous().transpose(-1, -2), "contiguous"),
             (tp.merge, xi[..., :8, :].contiguous(), "N // 2 \\+ 1"),
             (lambda x, N: tp.pack(x), s.transpose(-1, -2), "contiguous"),
             (lambda x, N: tp.pack(x), s[:, :1], "2, N, n"),
             (lambda x, N: tp.pack(x), s.to(torch.complex128), "dtype"),
             (lambda x, N: tp.pack(x), s.half(), "dtype"),
             (lambda x, N: tp.pack(x), s[..., :0], "elements")]
    for fn, x, why in cases:
        before = _counts()
        with pytest.raises(ValueError, match=why):
            fn(x, 16)
        assert _moved(before)
    with pytest.raises(ValueError, match="bins"):
        tp.unpack(Z, 17)


# (N_x, N_t) of each family's small shape and headline; the 2D lumped
# heat's headline is its benchmark cell's grid
SHAPES = {("wave", "small"): (64, 32), ("heat", "small"): (64, 32), ("heat2d", "small"): (16, 10),
          ("wave", "headline"): (2048, 1024), ("heat", "headline"): (2048, 1024), ("heat2d", "headline"): (256, 64)}


def _solvers(family, size, cuda):
    N_x, N_t = SHAPES[family, size]
    if family == "heat2d":
        cfg = ProblemConfig(N_x=N_x, N_t=N_t, dtype=torch.float32, dim=2, mass="lumped")
    else:
        cfg = ProblemConfig(N_x=N_x, N_t=N_t, dtype=torch.float32)
    if family == "wave":
        prob = WaveControlProblem(cfg, device=cuda)
        return prob.rhs, cw.build_cuda_woodbury_solver(prob.operator)
    prob = HeatControlProblem(cfg, device=cuda)
    return prob.rhs, ch.build_cuda_heat_solver(prob)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [0, 8], ids=["single", "b8"])
@pytest.mark.parametrize("family", ["wave", "heat", "heat2d"])
@pytest.mark.parametrize("size", ["small", "headline"])
def test_solves_equal_the_twin_path(cuda, size, family, batch):
    """B1 and B2 direct solves through the kernels, single and batched, 1D
    and 2D lumped heat (at its benchmark cell's grid), are bitwise the same
    solves with the time transforms run as the eager composition before
    the kernels; each call launches one of each kernel."""
    rhs, solve = _solvers(family, size, cuda)
    b = rhs if not batch else torch.stack([rhs * (1.0 + 0.25 * i) for i in range(batch)])
    before = _counts()
    x = solve(b)
    assert _moved(before, pack=1, split=1, merge=1, unpack=1)
    with unittest.mock.patch.object(spectral, "time_rfft_conj_packed", tr._time_rfft_conj_packed_reference), \
            unittest.mock.patch.object(spectral, "time_irfft_conj_packed", tr._time_irfft_conj_packed_reference):
        x_twin = solve(b)
    assert _moved(before, pack=1, split=1, merge=1, unpack=1)
    _same(x_twin, x)
