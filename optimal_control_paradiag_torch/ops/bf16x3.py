"""The bf16x3 matrix product: ``dst_precision='high'`` and the plans' ``precision='high'``.

The JAX package runs its matmul sine transform (``fem/space.py``) and the
radix products of its four-step plans (``ops/transforms.py``) at
``jax.lax.Precision.HIGH`` on request, which XLA lowers to the three-pass
bf16 product ("bf16x3"): each float32 operand x is split as

    hi = RNE_bf16(x),    lo = RNE_bf16(x - hi)    (the subtraction is exact)

and ``A @ B`` is taken as ``(A_hi B_lo + A_lo B_hi) + A_hi B_hi`` with
float32 sums. torch has no such product (its 'high' float32 matmul is TF32,
a different algorithm), so the port carries its own, on every device:

- :func:`split_bf16`: the split;
- :class:`SplitMatrix` and :func:`split_matrix`: a constant right operand B
  (the DST-I matrix, a radix matrix) split once, its hi and lo planes
  (K, ldb) bf16 with ldb = N rounded up to 8 and the padding zero;
- :func:`bf16x3_matmul_reference`: the plain PyTorch twin. The product of
  two bf16 values is exact in float32, so the twin differs from the kernel
  only in the order of float32 sums;
- :func:`bf16x3_matmul`: the wrapper. On a CUDA tensor it launches the
  hand-written kernel ``csrc/bf16x3_gemm.cu`` (built with nvcc at first
  use) and counts the launch in ``bf16x3_matmul.launches``; on a CPU tensor
  it runs the twin. There is no fallback: a failed build or a refused launch
  raises.

On the CPU the JAX package's XLA backend ignores ``Precision.HIGH`` and
computes full float32; the port runs bf16x3 there too (a deliberate
difference: the option means the same arithmetic on every device).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from optimal_control_paradiag_torch.cuda_build import load_library

KERNEL_SOURCE = "bf16x3_gemm.cu"


def split_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` bf16 tensors with ``hi = RNE(x)``, ``lo = RNE(x - hi)``
    for a float32 ``x``; ``hi + lo`` carries x to about 2^-17 of |x|."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class SplitMatrix:
    """A constant float32 right operand B (K, N), split once.

    ``planes`` is one (2, K, ldb) bf16 tensor, ``[hi, lo]``, ldb = N rounded
    up to a multiple of 8 with the columns past N zero: every row of a plane
    starts on 16 bytes, as the kernel's loads need."""

    planes: torch.Tensor
    n: int

    @property
    def k(self) -> int:
        return self.planes.shape[1]

    @property
    def hi(self) -> torch.Tensor:
        """B's hi plane as a (K, N) view."""
        return self.planes[0, :, : self.n]

    @property
    def lo(self) -> torch.Tensor:
        """B's lo plane as a (K, N) view."""
        return self.planes[1, :, : self.n]

    @property
    def device(self) -> torch.device:
        return self.planes.device


def split_matrix(b: torch.Tensor) -> SplitMatrix:
    """The :class:`SplitMatrix` of a 2D float32 tensor, on its device."""
    if b.dtype != torch.float32 or b.dim() != 2:
        raise ValueError(f"split_matrix takes a 2D float32 tensor, got {tuple(b.shape)} {b.dtype}")
    K, N = b.shape
    planes = torch.zeros((2, K, -(-N // 8) * 8), dtype=torch.bfloat16, device=b.device)
    hi, lo = split_bf16(b)
    planes[0, :, :N] = hi
    planes[1, :, :N] = lo
    return SplitMatrix(planes=planes, n=N)


def bf16x3_matmul_reference(a: torch.Tensor, b_hi: torch.Tensor, b_lo: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: ``(a_hi @ b_lo + a_lo @ b_hi) +
    a_hi @ b_hi`` on float32 tensors that hold the bf16 values, for a
    float32 (M, K) ``a`` and bf16 (K, N) planes."""
    a_hi, a_lo = (p.float() for p in split_bf16(a))
    b_hi, b_lo = b_hi.float(), b_lo.float()
    return (a_hi @ b_lo + a_lo @ b_hi) + a_hi @ b_hi


@functools.lru_cache(maxsize=None)
def _kernel_library() -> ctypes.CDLL:
    """The built kernel library, with its ctypes signatures declared."""
    lib = load_library(KERNEL_SOURCE).lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bf16x3_gemm_f32.argtypes = [p] * 4 + [i] * 5 + [p]
    lib.bf16x3_gemm_f32.restype = i
    lib.bf16x3_error_string.argtypes = [i]
    lib.bf16x3_error_string.restype = ctypes.c_char_p
    return lib


def bf16x3_matmul(a: torch.Tensor, b: SplitMatrix) -> torch.Tensor:
    """``a @ B`` in bf16x3 for a contiguous float32 (M, K) ``a`` and a
    :class:`SplitMatrix` B (K, N) on the same device; returns (M, N)
    float32.

    A CUDA tensor goes to the kernel (one launch, counted in
    ``bf16x3_matmul.launches``; a build failure or a refused or failed
    launch raises); a CPU tensor to :func:`bf16x3_matmul_reference`."""
    if a.dtype != torch.float32 or a.dim() != 2 or a.shape[1] != b.k:
        raise ValueError(f"bf16x3_matmul takes a float32 (M, {b.k}) tensor, got {tuple(a.shape)} {a.dtype}")
    if not a.is_contiguous():
        raise ValueError("bf16x3_matmul takes a contiguous tensor")
    if a.device != b.device:
        raise ValueError(f"the operand lies on {a.device}, the split matrix on {b.device}")
    if a.device.type == "cpu":
        return bf16x3_matmul_reference(a, b.hi, b.lo)
    if a.device.type != "cuda":
        raise ValueError(f"bf16x3_matmul runs on CUDA or CPU tensors, got {a.device}")
    lib = _kernel_library()
    M, K = a.shape
    c = torch.empty((M, b.n), dtype=torch.float32, device=a.device)
    if c.numel() == 0:
        return c
    hi, lo = b.planes[0], b.planes[1]
    device = a.device.index if a.device.index is not None else torch.cuda.current_device()
    err = lib.bf16x3_gemm_f32(
        a.data_ptr(), hi.data_ptr(), lo.data_ptr(), c.data_ptr(), M, b.n, K, b.planes.shape[2], device,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"bf16x3_gemm launch failed: {lib.bf16x3_error_string(err).decode()} ({err})")
    bf16x3_matmul.launches += 1
    return c


bf16x3_matmul.launches = 0
