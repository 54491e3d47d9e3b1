"""The packed time FFT's passes around cuFFT, as four hand-written CUDA kernels.

The half-spectrum pipeline's time transform with ``time_transform='fft2'``
(``ops/transforms.py``: :func:`time_rfft_conj_packed`,
:func:`time_irfft_conj_packed`) runs one complex FFT of the packed pair
``s0 + i s1`` each way. On the card nothing but these kernels runs around
it:

- :func:`pack`: the real ``(..., 2, N, n)`` pair to ``s0 + i s1``,
  ``(..., N, n)`` complex, in the layout cuFFT's plan reads
  (:func:`time_fastest`);
- :func:`split`: ``Z = fft(s0 + i s1)`` (``(..., N, n)``, time-fastest, as
  cuFFT leaves it) to ``b_hat = [conj(R0[:K]), conj(R1[:K])] / N``,
  ``(..., 2, K, n)``, the two half spectra by Hermitian symmetry;
- :func:`merge`: ``xi`` (``(..., 2, K, n)``) to the length-N input of the
  inverse FFT, ``(..., N, n)``, in the layout cuFFT's plan reads;
- :func:`unpack`: the inverse FFT's unnormalised output ``z``
  (time-fastest) to the real ``(..., 2, N, n)`` pair ``[re, im]`` of
  ``z * (1/N)``, the normalisation done as torch does it on the card.

Each has its plain PyTorch twin (:func:`pack_reference`,
:func:`split_reference`, :func:`merge_reference`,
:func:`unpack_reference`). On a CUDA tensor the kernel of
``csrc/time_pack.cu`` runs (built with nvcc at first use), one launch for
all leading axes, counted in ``utils.timing.counters['time_pack.<way>.launches']``.
Its output is bitwise the twin's: it does the twin's float operations in
the twin's order (the source's note); pack and merge lay it out as the FFT
that follows reads it. A CUDA tensor a kernel does not take (another
dtype, another layout, an empty tensor, a merge input with K other than
``N // 2 + 1``) raises a ValueError that names the failed condition
(:func:`check_pack`, :func:`check_split`, :func:`check_merge`,
:func:`check_unpack`); only a CPU tensor runs the twin. A failed build or
a refused launch raises too. The kernels sit inside the
``transforms/time_fwd`` and ``transforms/time_inv`` spans; they open none.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from optimal_control_paradiag_torch.cuda_build import check, declare, device_and_stream, load_library
from optimal_control_paradiag_torch.utils.timing import counters

KERNEL_SOURCE = "time_pack.cu"
_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}
_REAL = {c: r for r, c in _COMPLEX.items()}
_NAME = {torch.float32: "f32", torch.float64: "f64", torch.complex64: "f32", torch.complex128: "f64"}
_INT_MAX = 2**31 - 1


def time_fastest(lanes: int) -> bool:
    """Whether cuFFT's plan for the FFT over dim -2 of ``lanes`` row-major
    ``(N, n)`` matrices reads them time-fastest. torch runs one matrix in
    place through a strided plan (time stride n, column stride 1), but
    cannot fold two or more matrices' lanes and columns into one batch
    stride, so it first copies them to a time-fastest buffer (each matrix
    column-major, one after another) and runs a contiguous plan. pack and
    merge write that layout themselves, so the FFT copies nothing and
    runs the plan it ran on the twin's output."""
    return lanes > 1


def _plan_input(lead: tuple, N: int, n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """An empty ``(*lead, N, n)`` complex tensor in the layout cuFFT's plan
    reads (:func:`time_fastest`)."""
    if time_fastest(math.prod(lead)):
        return torch.empty(lead + (n, N), dtype=dtype, device=device).transpose(-1, -2)
    return torch.empty(lead + (N, n), dtype=dtype, device=device)


def pack_reference(s: torch.Tensor) -> torch.Tensor:
    """The pack in plain PyTorch: ``s0 + i s1`` of the real ``(..., 2, N, n)``
    pair, ``(..., N, n)`` complex, as ``torch.complex`` lays it out."""
    return torch.complex(s[..., 0, :, :], s[..., 1, :, :])


def split_reference(Z: torch.Tensor, N: int) -> torch.Tensor:
    """The split in plain PyTorch: ``conj(rfft(s_c))/N`` of both halves of
    the packed pair from ``Z = fft(s0 + i s1)`` over dim -2; returns a
    contiguous ``(..., 2, K, n)`` complex tensor."""
    K = N // 2 + 1
    # Zm[k] = conj(Z[(N - k) % N])
    Zm = torch.roll(torch.flip(Z, dims=(-2,)), 1, dims=-2).conj()
    R0 = 0.5 * (Z + Zm)  # rfft(s0), all N bins (Hermitian)
    R1 = -0.5j * (Z - Zm)  # rfft(s1)
    return torch.stack([R0[..., :K, :].conj(), R1[..., :K, :].conj()], dim=-3) * (1.0 / N)


def merge_reference(xi: torch.Tensor, N: int) -> torch.Tensor:
    """The merge in plain PyTorch: the Hermitian-extended ``(conj(xi0) + i
    conj(xi1)) * N`` of the ``(..., 2, K, n)`` pair, the contiguous
    ``(..., N, n)`` input of the inverse FFT."""
    K = xi.shape[-2]
    a, b = xi[..., 0, :, :].conj(), xi[..., 1, :, :].conj()
    W = (a + 1j * b) * N  # R0 + i R1, bins < K
    W2 = (a - 1j * b) * N  # R0 - i R1
    mirror = torch.flip(W2[..., 1 : N - K + 1, :].conj(), dims=(-2,))  # bins K..N-1
    return torch.cat([W, mirror], dim=-2)


def unpack_reference(z: torch.Tensor, N: int) -> torch.Tensor:
    """The unpack in plain PyTorch: the contiguous real ``(..., 2, N, n)``
    pair ``[re, im]`` of ``z * (1/N)``, from the unnormalised inverse FFT
    ``z`` (``(..., N, n)`` complex). On the card ``ifft(Z, norm='forward')``
    then this is bitwise ``ifft(Z)`` then ``stack``: torch normalises
    cuFFT's output by this product."""
    w = z * (1.0 / N)
    return torch.stack([w.real, w.imag], dim=-3)


_P, _I = ctypes.c_void_p, ctypes.c_int
# (input, output, lanes, N, n, [time_fastest,] device, stream) for each way and real type
SIGNATURES = {f"time_pack_{way}_{real}": [_P, _P, _I, _I, _I] + ([_I] if way in ("pack", "merge") else []) + [_I, _P]
              for way in ("pack", "split", "merge", "unpack") for real in ("f32", "f64")}


@functools.lru_cache(maxsize=None)
def kernel_library() -> ctypes.CDLL:
    """The built kernel library (nvcc at the first call in a process), with
    its ctypes signatures declared."""
    return declare(load_library(KERNEL_SOURCE).lib, SIGNATURES, "time_pack_error_string")


def _refuse(way: str, why: str) -> None:
    raise ValueError(f"time_pack {way}: the kernel does not take this tensor: {why}")


def _check_common(t: torch.Tensor, way: str, dtypes) -> None:
    """The conditions every kernel shares: a resolved tensor of a supported
    dtype, with elements, aligned to its element size."""
    if t.dtype not in dtypes:
        _refuse(way, f"dtype {t.dtype} is not {' or '.join(str(d)[6:] for d in dtypes)}")
    if t.is_conj():
        _refuse(way, "a conjugate view (resolve it first)")
    if t.dim() < 2 or t.numel() == 0:
        _refuse(way, f"shape {tuple(t.shape)} has no (rows, n) matrix with elements")
    if t.data_ptr() % t.element_size() != 0:
        _refuse(way, "the data pointer is not aligned to the element size")


def _fits(way: str, *sizes: int) -> None:
    if max(sizes) > _INT_MAX:
        _refuse(way, "a size does not fit a 32-bit int")


def _check_time_fastest(Z: torch.Tensor, N: int, way: str) -> int:
    """The number of (N, n) matrices in the complex ``Z`` if it lies as
    cuFFT leaves the FFT over dim -2: each matrix column-major (time
    fastest), the matrices one after another."""
    _check_common(Z, way, _REAL)
    if Z.shape[-2] != N:
        _refuse(way, f"the time axis has {Z.shape[-2]} bins, not N = {N}")
    n = Z.shape[-1]
    sk, sj = Z.stride()[-2:]
    if sk != 1 or (sj != N and n != 1):
        _refuse(way, f"strides {(sk, sj)} of the (N, n) matrix are not (1, {N}), cuFFT's column-major layout")
    lanes = 1
    for size, stride in zip(reversed(Z.shape[:-2]), reversed(Z.stride()[:-2])):
        if size != 1 and stride != N * n * lanes:
            _refuse(way, f"the leading axes' strides {Z.stride()[:-2]} do not lay the matrices one after another")
        lanes *= size
    _fits(way, lanes, N, n)
    return lanes


def check_pack(s: torch.Tensor) -> int:
    """The number of (2, N, n) pairs in ``s`` if the pack kernel takes it:
    a contiguous real ``(..., 2, N, n)`` float32 or float64 tensor. Raises
    ValueError naming the first condition ``s`` fails."""
    _check_common(s, "pack", _COMPLEX)
    if s.dim() < 3 or s.shape[-3] != 2:
        _refuse("pack", f"shape {tuple(s.shape)} is not (..., 2, N, n)")
    if not s.is_contiguous():
        _refuse("pack", f"strides {s.stride()} are not contiguous")
    N, n = s.shape[-2:]
    lanes = s.numel() // (2 * N * n)
    _fits("pack", lanes, N, n)
    return lanes


def check_split(Z: torch.Tensor, N: int) -> int:
    """The number of (N, n) matrices in ``Z`` if the split kernel takes it:
    ``(..., N, n)`` complex in the layout torch's FFT over dim -2 leaves,
    each matrix column-major (time fastest), the matrices one after
    another. Raises ValueError naming the first condition ``Z`` fails."""
    return _check_time_fastest(Z, N, "split")


def check_merge(xi: torch.Tensor, N: int) -> int:
    """The number of (2, K, n) pairs in ``xi`` if the merge kernel takes it:
    contiguous ``(..., 2, K, n)`` complex with K = N // 2 + 1. Raises
    ValueError naming the first condition ``xi`` fails."""
    _check_common(xi, "merge", _REAL)
    if xi.dim() < 3 or xi.shape[-3] != 2:
        _refuse("merge", f"shape {tuple(xi.shape)} is not (..., 2, K, n)")
    if xi.shape[-2] != N // 2 + 1:
        _refuse("merge", f"K = {xi.shape[-2]} is not N // 2 + 1 = {N // 2 + 1}")
    if not xi.is_contiguous():
        _refuse("merge", f"strides {xi.stride()} are not contiguous")
    lanes = xi.numel() // (2 * xi.shape[-2] * xi.shape[-1])
    _fits("merge", lanes, N, xi.shape[-1])
    return lanes


def check_unpack(z: torch.Tensor, N: int) -> int:
    """The number of (N, n) matrices in ``z`` if the unpack kernel takes it:
    the inverse FFT's ``(..., N, n)`` complex output as cuFFT leaves it,
    the layout :func:`check_split` takes. Raises ValueError naming the
    first condition ``z`` fails."""
    return _check_time_fastest(z, N, "unpack")


def _launch(way: str, x: torch.Tensor, out: torch.Tensor, *sizes: int) -> None:
    """One launch of ``way``'s kernel for ``x``'s real type, counted."""
    lib = kernel_library()
    fn = getattr(lib, f"time_pack_{way}_{_NAME[x.dtype]}")
    check(lib, f"time_pack {way}", fn(x.data_ptr(), out.data_ptr(), *sizes, *device_and_stream(x)))
    counters[f"time_pack.{way}.launches"] += 1


def pack(s: torch.Tensor) -> torch.Tensor:
    """:func:`pack_reference` of ``s``: on a CUDA tensor the pack kernel
    (one launch, counted in ``counters['time_pack.pack.launches']``; a
    tensor it does not take raises, :func:`check_pack`), its output in the
    layout of cuFFT's plan (:func:`time_fastest`); on the CPU the twin."""
    if s.device.type != "cuda":
        return pack_reference(s)
    lanes = check_pack(s)
    N, n = s.shape[-2:]
    out = _plan_input(s.shape[:-3], N, n, _COMPLEX[s.dtype], s.device)
    _launch("pack", s, out, lanes, N, n, int(time_fastest(lanes)))
    return out


def split(Z: torch.Tensor, N: int) -> torch.Tensor:
    """:func:`split_reference` of ``Z``: on a CUDA tensor the split kernel
    (one launch, counted in ``counters['time_pack.split.launches']``; a
    tensor it does not take raises, :func:`check_split`); on the CPU the
    twin."""
    if Z.device.type != "cuda":
        return split_reference(Z, N)
    lanes, n = check_split(Z, N), Z.shape[-1]
    out = torch.empty(Z.shape[:-2] + (2, N // 2 + 1, n), dtype=Z.dtype, device=Z.device)
    _launch("split", Z, out, lanes, N, n)
    return out


def merge(xi: torch.Tensor, N: int) -> torch.Tensor:
    """:func:`merge_reference` of ``xi``: on a CUDA tensor the merge kernel
    (one launch, counted in ``counters['time_pack.merge.launches']``; a
    tensor it does not take raises, :func:`check_merge`), its output in the
    layout of cuFFT's plan (:func:`time_fastest`); on the CPU the twin."""
    if xi.device.type != "cuda":
        return merge_reference(xi, N)
    lanes, n = check_merge(xi, N), xi.shape[-1]
    out = _plan_input(xi.shape[:-3], N, n, xi.dtype, xi.device)
    _launch("merge", xi, out, lanes, N, n, int(time_fastest(lanes)))
    return out


def unpack(z: torch.Tensor, N: int) -> torch.Tensor:
    """:func:`unpack_reference` of ``z``: on a CUDA tensor the unpack kernel
    (one launch, counted in ``counters['time_pack.unpack.launches']``; a
    tensor it does not take raises, :func:`check_unpack`); on the CPU the
    twin."""
    if z.device.type != "cuda":
        return unpack_reference(z, N)
    lanes, n = check_unpack(z, N), z.shape[-1]
    out = torch.empty(z.shape[:-2] + (2, N, n), dtype=_REAL[z.dtype], device=z.device)
    _launch("unpack", z, out, lanes, N, n)
    return out
