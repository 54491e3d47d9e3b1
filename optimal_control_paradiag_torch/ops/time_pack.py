"""The packed time FFT's two-for-one split and merge, as two hand-written CUDA kernels.

The half-spectrum pipeline's time transform with ``time_transform='fft2'``
(``ops/transforms.py``: :func:`time_rfft_conj_packed`,
:func:`time_irfft_conj_packed`) runs one complex FFT of the packed pair
``s0 + i s1`` each way. Around it lies the glue that splits the two half
spectra out of the packed one by Hermitian symmetry, and merges them back:

- :func:`split_reference` and :func:`merge_reference`: the glue in plain
  PyTorch, the kernels' twin, as the port has always run it;
- :func:`split`: ``Z = fft(s0 + i s1)`` (``(..., N, n)`` complex) to
  ``b_hat = [conj(R0[:K]), conj(R1[:K])] / N``, ``(..., 2, K, n)``;
- :func:`merge`: ``xi`` (``(..., 2, K, n)``) to the length-N input of the
  inverse FFT, ``(..., N, n)``, laid out as ``torch.cat`` lays it out, so
  that cuFFT runs the same plan on it.

On a CUDA tensor the kernel of ``csrc/time_pack.cu`` runs (built with
nvcc at first use), one launch for all leading axes, counted in
``utils.timing.counters['time_pack.split.launches']`` or
``['time_pack.merge.launches']``. Its output is bitwise the twin's: it
does the twin's float operations in the twin's order (the source's note).
A CUDA tensor the kernel does not take (another dtype, a layout other than
cuFFT's, an empty tensor, a merge input with K other than ``N // 2 + 1``)
raises a ValueError that names the failed condition (:func:`check_split`,
:func:`check_merge`); only a CPU tensor runs the twin. A failed build or a
refused launch raises too. The kernels sit inside the
``transforms/time_fwd`` and ``transforms/time_inv`` spans; they open none.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from optimal_control_paradiag_torch.cuda_build import check, declare, device_and_stream, load_library
from optimal_control_paradiag_torch.utils.timing import counters

KERNEL_SOURCE = "time_pack.cu"
_REAL = {torch.complex64: "f32", torch.complex128: "f64"}
_INT_MAX = 2**31 - 1


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


_P, _I = ctypes.c_void_p, ctypes.c_int
# (input, output, lanes, N, n, device, stream) for each way and real type
SIGNATURES = {f"time_pack_{way}_{real}": [_P, _P, _I, _I, _I, _I, _P]
              for way in ("split", "merge") for real in ("f32", "f64")}


@functools.lru_cache(maxsize=None)
def kernel_library() -> ctypes.CDLL:
    """The built kernel library (nvcc at the first call in a process), with
    its ctypes signatures declared."""
    return declare(load_library(KERNEL_SOURCE).lib, SIGNATURES, "time_pack_error_string")


def _refuse(way: str, why: str) -> None:
    raise ValueError(f"time_pack {way}: the kernel does not take this tensor: {why}")


def _check_common(t: torch.Tensor, way: str) -> None:
    """The conditions both kernels share: a resolved complex tensor of a
    supported dtype, with elements, aligned to its element size."""
    if t.dtype not in _REAL:
        _refuse(way, f"dtype {t.dtype} is not complex64 or complex128")
    if t.is_conj():
        _refuse(way, "a conjugate view (resolve it first)")
    if t.dim() < 2 or t.numel() == 0:
        _refuse(way, f"shape {tuple(t.shape)} has no (rows, n) matrix with elements")
    if t.data_ptr() % t.element_size() != 0:
        _refuse(way, "the data pointer is not aligned to the element size")


def check_split(Z: torch.Tensor, N: int) -> int:
    """The number of (N, n) matrices in ``Z`` if the split kernel takes it:
    ``(..., N, n)`` in the layout torch's FFT over dim -2 leaves, each
    matrix column-major (time fastest), the matrices one after another.
    Raises ValueError naming the first condition ``Z`` fails."""
    _check_common(Z, "split")
    if Z.shape[-2] != N:
        _refuse("split", f"the time axis has {Z.shape[-2]} bins, not N = {N}")
    n = Z.shape[-1]
    sk, sj = Z.stride()[-2:]
    if sk != 1 or (sj != N and n != 1):
        _refuse("split", f"strides {(sk, sj)} of the (N, n) matrix are not (1, {N}), cuFFT's column-major layout")
    lanes = 1
    for size, stride in zip(reversed(Z.shape[:-2]), reversed(Z.stride()[:-2])):
        if size != 1 and stride != N * n * lanes:
            _refuse("split", f"the leading axes' strides {Z.stride()[:-2]} do not lay the matrices one after another")
        lanes *= size
    if max(lanes, N, n) > _INT_MAX:
        _refuse("split", "a size does not fit a 32-bit int")
    return lanes


def check_merge(xi: torch.Tensor, N: int) -> int:
    """The number of (2, K, n) pairs in ``xi`` if the merge kernel takes it:
    contiguous ``(..., 2, K, n)`` with K = N // 2 + 1. Raises ValueError
    naming the first condition ``xi`` fails."""
    _check_common(xi, "merge")
    if xi.dim() < 3 or xi.shape[-3] != 2:
        _refuse("merge", f"shape {tuple(xi.shape)} is not (..., 2, K, n)")
    if xi.shape[-2] != N // 2 + 1:
        _refuse("merge", f"K = {xi.shape[-2]} is not N // 2 + 1 = {N // 2 + 1}")
    if not xi.is_contiguous():
        _refuse("merge", f"strides {xi.stride()} are not contiguous")
    lanes = xi.numel() // (2 * xi.shape[-2] * xi.shape[-1])
    if max(lanes, N, xi.shape[-1]) > _INT_MAX:
        _refuse("merge", "a size does not fit a 32-bit int")
    return lanes


def split(Z: torch.Tensor, N: int) -> torch.Tensor:
    """:func:`split_reference` of ``Z``: on a CUDA tensor the split kernel
    (one launch, counted in ``counters['time_pack.split.launches']``; a
    tensor it does not take raises, :func:`check_split`); on the CPU the
    twin."""
    if Z.device.type != "cuda":
        return split_reference(Z, N)
    lanes, n = check_split(Z, N), Z.shape[-1]
    out = torch.empty(Z.shape[:-2] + (2, N // 2 + 1, n), dtype=Z.dtype, device=Z.device)
    lib = kernel_library()
    launch = getattr(lib, f"time_pack_split_{_REAL[Z.dtype]}")
    check(lib, "time_pack split", launch(Z.data_ptr(), out.data_ptr(), lanes, N, n, *device_and_stream(Z)))
    counters["time_pack.split.launches"] += 1
    return out


def merge(xi: torch.Tensor, N: int) -> torch.Tensor:
    """:func:`merge_reference` of ``xi``: on a CUDA tensor the merge kernel
    (one launch, counted in ``counters['time_pack.merge.launches']``; a
    tensor it does not take raises, :func:`check_merge`); on the CPU the
    twin."""
    if xi.device.type != "cuda":
        return merge_reference(xi, N)
    lanes, n = check_merge(xi, N), xi.shape[-1]
    out = torch.empty(xi.shape[:-3] + (N, n), dtype=xi.dtype, device=xi.device)
    lib = kernel_library()
    launch = getattr(lib, f"time_pack_merge_{_REAL[xi.dtype]}")
    check(lib, "time_pack merge", launch(xi.data_ptr(), out.data_ptr(), lanes, N, n, *device_and_stream(xi)))
    counters["time_pack.merge.launches"] += 1
    return out
