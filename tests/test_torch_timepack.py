"""The packed time FFT's split and merge on the CPU (``ops/time_pack.py``):
CPU tensors run the plain twin and launch nothing, the public transforms
keep their shapes and layouts, and the checks that decide which CUDA
tensors the kernels take (any other raises), which are plain Python. The kernels themselves run only
on the card (``tests/test_torch_cuda_timepack.py``); the JAX parity of the
twin is ``tests/test_torch_spectral.py::test_packed_fft_pair_matches_jax``.
"""

import numpy as np
import pytest
import torch

from optimal_control_paradiag_torch.ops import time_pack as tp
from optimal_control_paradiag_torch.ops import transforms as tr
from optimal_control_paradiag_torch.utils.timing import counters

torch.set_num_threads(1)

COUNTERS = ("time_pack.split.launches", "time_pack.merge.launches")


def _counts():
    return {c: counters[c] for c in COUNTERS}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("lead", [(), (3,)], ids=["single", "b3"])
@pytest.mark.parametrize("N", [9, 10, 16, 33])
def test_cpu_tensors_run_the_twin(N, lead, dtype):
    rng = np.random.default_rng(N)
    K, n = N // 2 + 1, 7
    s = torch.from_numpy(rng.standard_normal(lead + (2, N, n))).to(dtype)
    xi = torch.complex(*(torch.from_numpy(rng.standard_normal(lead + (2, K, n))).to(dtype) for _ in range(2)))
    before = _counts()
    fwd = tr.time_rfft_conj_packed(s, N)
    inv = tr.time_irfft_conj_packed(xi, N)
    assert _counts() == before  # no launch
    assert fwd.shape == lead + (2, K, n) and fwd.is_contiguous() and not fwd.is_conj()
    assert fwd.dtype == (torch.complex64 if dtype == torch.float32 else torch.complex128)
    assert inv.shape == lead + (2, N, n) and inv.is_contiguous() and inv.dtype == dtype
    assert torch.equal(fwd, tr._time_rfft_conj_packed_reference(s, N))
    assert torch.equal(inv, tr._time_irfft_conj_packed_reference(xi, N))
    merged = tp.merge(xi, N)
    assert merged.shape == lead + (N, n) and merged.is_contiguous() and not merged.is_conj()


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)], ids=["single", "b3", "b2x2"])
@pytest.mark.parametrize("N", [2, 10, 33])
def test_split_takes_rule(N, lead):
    """The FFT's own output (column-major, time fastest) is taken; a
    row-major copy, strided, conjugated or real tensors, lanes apart, an
    empty tensor and a length other than N raise, naming the condition."""
    n = 5
    Z = torch.fft.fft(torch.randn(lead + (N, n), dtype=torch.complex64), dim=-2)
    assert tp.check_split(Z, N) == int(np.prod(lead))
    refused = [(Z.contiguous(), N, "column-major"), (Z[..., ::2], N, "column-major"), (Z.conj(), N, "conjugate"),
               (Z.real.contiguous(), N, "dtype"), (Z, N + 1, "bins"), (Z[..., :0], N, "elements")]
    if lead:  # every other lane of twice as many
        wide = torch.fft.fft(torch.randn((2 * lead[0],) + lead[1:] + (N, n), dtype=torch.complex64), dim=-2)
        refused.append((wide[::2], N, "one after another"))
    for x, N_x, why in refused:
        with pytest.raises(ValueError, match=why):
            tp.check_split(x, N_x)


@pytest.mark.parametrize("N", [9, 10])
def test_merge_takes_rule(N):
    K, n = N // 2 + 1, 6
    xi = torch.randn(3, 2, K, n, dtype=torch.complex128)
    assert tp.check_merge(xi, N) == 3 and tp.check_merge(xi[0], N) == 1
    refused = [(xi, N + 2, "N // 2 \\+ 1"), (xi[..., :-1, :], N, "N // 2 \\+ 1"),
               (xi.transpose(-1, -2).contiguous().transpose(-1, -2), N, "contiguous"), (xi.conj(), N, "conjugate"),
               (xi.real.contiguous(), N, "dtype"), (xi[:, :1], N, "2, K, n")]
    for x, N_x, why in refused:
        with pytest.raises(ValueError, match=why):
            tp.check_merge(x, N_x)


def test_twin_is_the_two_rfft_transform():
    """The twin's split and merge are the half-spectrum transform pair
    (float64, 1e-12 relative max-abs, as the JAX parity test holds it)."""
    rng = np.random.default_rng(0)
    N, n = 12, 5
    s = torch.from_numpy(rng.standard_normal((2, N, n)))
    Z = torch.fft.fft(torch.complex(s[0], s[1]), dim=-2)
    ref = torch.fft.rfft(s, dim=-2).conj() / N
    assert ((tp.split_reference(Z, N) - ref).abs().max() <= 1e-12 * ref.abs().max()).item()
    back = torch.fft.ifft(tp.merge_reference(ref, N), dim=-2)
    assert ((torch.stack([back.real, back.imag]) - s).abs().max() <= 1e-12 * s.abs().max()).item()
