"""The packed time FFT's pack, split, merge and unpack on the CPU
(``ops/time_pack.py``): CPU tensors run the plain twins and launch nothing,
the public transforms keep their shapes and layouts, and the rules that
decide which CUDA tensors the kernels take (any other raises) and which
layout pack and merge write, which are plain Python. The kernels
themselves run only on the card (``tests/test_torch_cuda_timepack.py``);
the JAX parity of the twin is
``tests/test_torch_spectral.py::test_packed_fft_pair_matches_jax``.
"""

import numpy as np
import pytest
import torch

from optimal_control_paradiag_torch.ops import time_pack as tp
from optimal_control_paradiag_torch.ops import transforms as tr
from optimal_control_paradiag_torch.utils.timing import counters

torch.set_num_threads(1)

COUNTERS = tuple(f"time_pack.{w}.launches" for w in ("pack", "split", "merge", "unpack"))


def _counts():
    return {c: counters[c] for c in COUNTERS}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("lead", [(), (3,), (1,), (8,), (2, 2)], ids=["single", "b3", "b1", "b8", "b2x2"])
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
    packed = tp.pack(s)
    assert torch.equal(packed, tp.pack_reference(s)) and packed.is_contiguous()
    z = torch.fft.ifft(merged, dim=-2, norm="forward")
    assert torch.equal(tp.unpack(z, N), tp.unpack_reference(z, N))
    assert _counts() == before  # still no launch


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


@pytest.mark.parametrize("lead", [(), (1,), (3,), (2, 2)], ids=["single", "b1", "b3", "b2x2"])
@pytest.mark.parametrize("N", [2, 9, 10])
def test_pack_takes_rule(N, lead):
    """A contiguous real (..., 2, N, n) pair is taken; a strided, complex,
    half-precision, wrongly shaped or empty tensor raises, naming the
    condition."""
    n = 5
    s = torch.randn(lead + (2, N, n), dtype=torch.float64)
    assert tp.check_pack(s) == int(np.prod(lead)) and tp.check_pack(s.float()) == int(np.prod(lead))
    refused = [(s.transpose(-1, -2), "contiguous"), (s[..., ::2], "contiguous"), (s.to(torch.complex128), "dtype"),
               (s.half(), "dtype"), (s[..., :1, :, :], "2, N, n"), (s[..., :0], "elements")]
    if lead and lead[0] > 1:  # every other lane of twice as many
        refused.append((torch.randn((2 * lead[0],) + lead[1:] + (2, N, n))[::2], "contiguous"))
    for x, why in refused:
        with pytest.raises(ValueError, match=why):
            tp.check_pack(x)


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)], ids=["single", "b3", "b2x2"])
@pytest.mark.parametrize("N", [2, 10, 33])
def test_unpack_takes_rule(N, lead):
    """The inverse FFT's own output (column-major, time fastest) is taken,
    whatever layout its input had; a row-major copy, strided, conjugated or
    real tensors, lanes apart, an empty tensor and a length other than N
    raise, naming the condition."""
    n = 5
    M = tp._plan_input(lead, N, n, torch.complex128, "cpu").copy_(torch.randn(lead + (N, n), dtype=torch.complex128))
    for x in (M, M.contiguous()):
        z = torch.fft.ifft(x, dim=-2, norm="forward")
        assert tp.check_unpack(z, N) == int(np.prod(lead))
    refused = [(z.contiguous(), N, "column-major"), (z[..., ::2], N, "column-major"), (z.conj(), N, "conjugate"),
               (z.real.contiguous(), N, "dtype"), (z, N + 1, "bins"), (z[..., :0], N, "elements")]
    if lead:
        wide = torch.fft.ifft(torch.randn((2 * lead[0],) + lead[1:] + (N, n), dtype=torch.complex64), dim=-2)
        refused.append((wide[::2], N, "one after another"))
    for x, N_x, why in refused:
        with pytest.raises(ValueError, match=why):
            tp.check_unpack(x, N_x)


@pytest.mark.parametrize("lead", [(), (1,), (1, 1), (2,), (8,), (2, 3)],
                         ids=["single", "b1", "b1x1", "b2", "b8", "b2x3"])
@pytest.mark.parametrize("N,n", [(10, 7), (64, 1), (9, 2)])
def test_pack_and_merge_write_the_plan_layout(N, n, lead):
    """One (N, n) matrix row-major, as the strided plan reads it in place;
    two or more time-fastest, the buffer torch's FFT copies them to. Either
    is an (..., N, n) tensor whose FFT over dim -2 comes out time-fastest,
    the layout the split and unpack take."""
    lanes = int(np.prod(lead))
    buf = tp._plan_input(lead, N, n, torch.complex64, "cpu")
    assert buf.shape == lead + (N, n) and tp.time_fastest(lanes) == (lanes > 1)
    if lanes > 1:
        assert buf.stride()[-2:] == (1, N) and buf.transpose(-1, -2).is_contiguous()
    else:
        assert buf.is_contiguous()
    buf.copy_(torch.randn(lead + (N, n), dtype=torch.complex64))
    Z = torch.fft.fft(buf, dim=-2)
    assert tp.check_split(Z, N) == lanes == tp.check_unpack(Z, N)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("lead", [(), (3,)], ids=["single", "b3"])
def test_twin_pack_and_unpack_around_the_fft(lead, dtype):
    """pack's twin is ``torch.complex`` of the pair; unpack's twin of the
    unnormalised inverse is the normalised inverse's ``stack`` (bitwise on
    the card, where torch normalises by this product; to rounding here,
    where the CPU's FFT scales inside)."""
    rng = np.random.default_rng(len(lead))
    N, n = 12, 5
    s = torch.from_numpy(rng.standard_normal(lead + (2, N, n))).to(dtype)
    z = tp.pack_reference(s)
    assert torch.equal(z.real, s[..., 0, :, :]) and torch.equal(z.imag, s[..., 1, :, :])
    back = tp.unpack_reference(torch.fft.ifft(torch.fft.fft(z, dim=-2), dim=-2, norm="forward"), N)
    assert back.shape == s.shape and back.is_contiguous() and back.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert ((back - s).abs().max() <= tol * s.abs().max()).item()
