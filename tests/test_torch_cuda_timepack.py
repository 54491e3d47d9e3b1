"""The packed time FFT's split and merge kernels (csrc/time_pack.cu) vs
their plain PyTorch twin, on the card, and the direct solves that run them.
These tests need a CUDA card and nvcc; they skip without one. The file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda_timepack.py -q

No tolerance: the kernels do the twin's float operations in the twin's
order, so every output is bitwise the twin's (``torch.equal``, and the bit
patterns too, signs of zeros included), and so is every solve through them.
"""

import unittest.mock

import numpy as np
import pytest
import torch

from optimal_control_paradiag_torch import HeatControlProblem, ProblemConfig, WaveControlProblem
from optimal_control_paradiag_torch.ops import time_pack as tp
from optimal_control_paradiag_torch.ops import transforms as tr
from optimal_control_paradiag_torch.paradiag import cuda_heat as ch
from optimal_control_paradiag_torch.paradiag import cuda_woodbury as cw
from optimal_control_paradiag_torch.utils.timing import counters

torch.set_num_threads(1)

COUNTERS = ("time_pack.split.launches", "time_pack.merge.launches")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bits(t):
    r = torch.view_as_real(t.resolve_conj().contiguous()) if t.is_complex() else t.contiguous()
    return r.view(torch.int32 if r.dtype == torch.float32 else torch.int64)


def _same(ref, got):
    assert ref.shape == got.shape and ref.dtype == got.dtype and ref.stride() == got.stride()
    assert torch.equal(ref, got)
    assert torch.equal(_bits(ref), _bits(got))


def _counts():
    return {c: counters[c] for c in COUNTERS}


def _moved(before):
    return {c: counters[c] - before[c] for c in COUNTERS}


def _randn(rng, shape, dtype, device, complex_=False):
    x = torch.from_numpy(rng.standard_normal(shape)).to(dtype)
    if complex_:
        x = torch.complex(x, torch.from_numpy(rng.standard_normal(shape)).to(dtype))
    return x.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("lead", [(), (3,), (8,)], ids=["single", "b3", "b8"])
@pytest.mark.parametrize("n", [7, 63, 2047])
@pytest.mark.parametrize("N", [9, 10, 16, 33, 1024])
def test_split_and_merge_match_twin(cuda, N, n, lead, dtype):
    """Both directions against the twin, bitwise, one launch each."""
    rng = np.random.default_rng(N * n + len(lead))
    K = N // 2 + 1
    s = _randn(rng, lead + (2, N, n), dtype, cuda)
    before = _counts()
    fwd = tr.time_rfft_conj_packed(s, N)
    assert _moved(before) == {COUNTERS[0]: 1, COUNTERS[1]: 0}
    _same(tr._time_rfft_conj_packed_reference(s, N), fwd)
    assert fwd.shape == lead + (2, K, n) and fwd.is_contiguous() and not fwd.is_conj()

    xi = _randn(rng, lead + (2, K, n), dtype, cuda, complex_=True)
    before = _counts()
    inv = tr.time_irfft_conj_packed(xi, N)
    assert _moved(before) == {COUNTERS[0]: 0, COUNTERS[1]: 1}
    _same(tr._time_irfft_conj_packed_reference(xi, N), inv)
    # the merge kernel's output is the tensor torch.cat builds, in its layout
    _same(tp.merge_reference(xi, N), tp.merge(xi, N))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128], ids=["c64", "c128"])
@pytest.mark.parametrize("N,n,lead", [(10, 7, ()), (33, 63, (3,)), (1024, 2047, (8,))])
def test_split_takes_the_fft_layout(cuda, N, n, lead, dtype):
    """cuFFT's output over dim -2 is column-major, the layout the split
    kernel reads."""
    rng = np.random.default_rng(N + n)
    Z = torch.fft.fft(_randn(rng, lead + (N, n), dtype.to_real(), cuda, complex_=True), dim=-2)
    assert Z.stride()[-2:] == (1, N) and tp.check_split(Z, N) == (lead[0] if lead else 1)
    _same(tp.split_reference(Z, N), tp.split(Z, N))


@pytest.mark.cuda
def test_layouts_the_kernels_refuse_raise(cuda):
    """A CUDA tensor a kernel does not take raises, naming the condition,
    and launches nothing: the card never runs the twin."""
    rng = np.random.default_rng(3)
    Z = torch.fft.fft(_randn(rng, (4, 16, 12), torch.float64, cuda, complex_=True), dim=-2)
    xi = _randn(rng, (2, 9, 12), torch.float64, cuda, complex_=True)
    cases = [(tp.split, Z.contiguous(), "column-major"),  # row-major
             (tp.split, Z[..., ::2], "column-major"),  # strided columns
             (tp.split, Z[::2], "one after another"),  # lanes apart
             (tp.split, Z.to(torch.complex64).conj(), "conjugate"),
             (tp.split, Z[..., :0], "elements"),
             (tp.merge, xi.transpose(-1, -2).contiguous().transpose(-1, -2), "contiguous"),
             (tp.merge, xi[..., :8, :].contiguous(), "N // 2 \\+ 1")]
    for fn, x, why in cases:
        before = _counts()
        with pytest.raises(ValueError, match=why):
            fn(x, 16)
        assert _moved(before) == {COUNTERS[0]: 0, COUNTERS[1]: 0}


def _solvers(family, N_x, N_t, cuda):
    cfg = ProblemConfig(N_x=N_x, N_t=N_t, dtype=torch.float32)
    if family == "wave":
        prob = WaveControlProblem(cfg, device=cuda)
        return prob.rhs, cw.build_cuda_woodbury_solver(prob.operator)
    prob = HeatControlProblem(cfg, device=cuda)
    return prob.rhs, ch.build_cuda_heat_solver(prob)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [0, 8], ids=["single", "b8"])
@pytest.mark.parametrize("family", ["wave", "heat"])
@pytest.mark.parametrize("N_x,N_t", [(64, 32), (2048, 1024)], ids=["small", "headline"])
def test_solves_equal_the_twin_path(cuda, N_x, N_t, family, batch):
    """B1 and B2 direct solves through the kernels, single and batched, are
    bitwise the same solves with the split and merge run by the twin; each
    call launches one split and one merge."""
    rhs, solve = _solvers(family, N_x, N_t, cuda)
    b = rhs if not batch else torch.stack([rhs * (1.0 + 0.25 * i) for i in range(batch)])
    before = _counts()
    x = solve(b)
    assert _moved(before) == {COUNTERS[0]: 1, COUNTERS[1]: 1}
    with unittest.mock.patch.object(tp, "split", tp.split_reference), \
            unittest.mock.patch.object(tp, "merge", tp.merge_reference):
        x_twin = solve(b)
    assert _moved(before) == {COUNTERS[0]: 1, COUNTERS[1]: 1}
    _same(x_twin, x)
