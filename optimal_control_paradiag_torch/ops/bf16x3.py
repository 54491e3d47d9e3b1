"""The bf16x3 matrix product: ``dst_precision='high'`` and the plans' ``precision='high'``.

The JAX package runs its matmul sine transform (``fem/space.py``) and the
radix products of its four-step plans (``ops/transforms.py``) at
``jax.lax.Precision.HIGH`` on request, which XLA lowers to the three-pass
bf16 product ("bf16x3"): each float32 operand x is split as

    hi = RNE_bf16(x),    lo = RNE_bf16(x - hi)    (the subtraction is exact)

and ``A @ B`` is taken as ``(A_hi B_lo + A_lo B_hi) + A_hi B_hi`` with
float32 sums. torch has no such product (its 'high' float32 matmul is TF32,
a different algorithm), so the port carries its own, on every device:

- :func:`split_bf16`: the split; :func:`split_rows`, a float32 (M, K)
  operand split into its zero-padded (2, M, ld) planes (the split pass),
  and its plain twin :func:`split_rows_reference`;
- :func:`bf16x3_route`: which of the two kernels takes a shape, from
  (N, K) alone: ``'wgmma'`` (``csrc/bf16x3_wgmma.cu``: the split pass,
  then a TMA-fed, warp-specialised ``wgmma`` GEMM) for the compute-bound
  shapes, ``'mma'`` (``csrc/bf16x3_gemm.cu``: ``mma.sync``, A split in
  the kernel) for the small ones;
- :class:`SplitMatrix` and :func:`split_matrix`: a constant right operand B
  (the DST-I matrix, a radix matrix) split once, its hi and lo planes laid
  out for its route: ``'mma'`` (2, K, ldb) with ldb = N rounded up to 8,
  ``'wgmma'`` K-major (2, N, ld) with ld = K rounded up to 64; the
  padding zero, ``.hi`` and ``.lo`` (K, N) views either way;
- :func:`bf16x3_matmul_reference`: the plain PyTorch twin. The product of
  two bf16 values is exact in float32, so the twin differs from the
  kernels only in the order of float32 sums;
- :func:`bf16x3_matmul`: the wrapper, one ``fused/b3`` span. On a CUDA
  tensor it launches the route's kernel (built with nvcc at first use) and
  counts its GEMM launch in ``utils.timing.counters['b3.launches']``, a
  ``'wgmma'`` call also in ``'b3.launches.wgmma'`` and its split pass in
  ``'b3.split.launches'``; on a CPU tensor it runs the twin.
  There is no fallback: a failed build or a refused launch raises, and a
  route never gives way to the other.

On the CPU the JAX package's XLA backend ignores ``Precision.HIGH`` and
computes full float32; the port runs bf16x3 there too (a deliberate
difference: the option means the same arithmetic on every device).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from optimal_control_paradiag_torch.cuda_build import check, declare, device_and_stream, load_library
from optimal_control_paradiag_torch.utils.timing import counters, span

KERNEL_SOURCE = "bf16x3_gemm.cu"  # the 'mma' route
WGMMA_SOURCE = "bf16x3_wgmma.cu"  # the 'wgmma' route and the split pass
ROUTES = ("mma", "wgmma")
# The least N and K that take the 'wgmma' route: the smallest K of
# chip_smoke.py's crossover table (M = 2048, N = K in {32, 64, 96, 128, 255,
# 512, 1023, 2047}) from which 'wgmma' is the faster route on the H100
# (PERF.md, PR 13: 'mma' faster at 64, 'wgmma' at 128 and past it).
WGMMA_MIN_WIDTH = 128
ROW_ALIGN = 64  # the 'wgmma' planes' row length unit: 128 bytes of bf16, one TMA box row


def bf16x3_route(n: int, k: int) -> str:
    """The route of a product with N output columns over K: ``'wgmma'``
    when both reach :data:`WGMMA_MIN_WIDTH`, else ``'mma'``. M does not
    enter: both kernels tile it alike, and the split pass costs M K
    either way against the product's M N K."""
    return "wgmma" if min(n, k) >= WGMMA_MIN_WIDTH else "mma"


def padded_width(k: int) -> int:
    """Row length ``ld`` of the 'wgmma' planes: K rounded up to
    :data:`ROW_ALIGN`."""
    return -(-k // ROW_ALIGN) * ROW_ALIGN


def split_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` bf16 tensors with ``hi = RNE(x)``, ``lo = RNE(x - hi)``
    for a float32 ``x``; ``hi + lo`` carries x to about 2^-17 of |x|."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class SplitMatrix:
    """A constant float32 right operand B (K, N), split once.

    ``planes`` is one bf16 tensor, ``[hi, lo]``, laid out for ``route``:
    ``'mma'`` (2, K, ldb), ldb = N rounded up to 8 (every row starts on 16
    bytes, as the mma.sync kernel's loads need); ``'wgmma'`` K-major (2, N,
    ld), ld = :func:`padded_width` (K), as its TMA boxes read it. The
    padding is zero."""

    planes: torch.Tensor
    k: int
    n: int
    route: str

    @property
    def hi(self) -> torch.Tensor:
        """B's hi plane as a (K, N) view."""
        return self._plane(0)

    @property
    def lo(self) -> torch.Tensor:
        """B's lo plane as a (K, N) view."""
        return self._plane(1)

    def _plane(self, i: int) -> torch.Tensor:
        if self.route == "wgmma":
            return self.planes[i, : self.n, : self.k].T
        return self.planes[i, : self.k, : self.n]

    @property
    def device(self) -> torch.device:
        return self.planes.device


def split_matrix(b: torch.Tensor, route: Optional[str] = None) -> SplitMatrix:
    """The :class:`SplitMatrix` of a 2D float32 tensor, on its device, laid
    out for ``route`` (by default :func:`bf16x3_route` of its shape)."""
    if b.dtype != torch.float32 or b.dim() != 2:
        raise ValueError(f"split_matrix takes a 2D float32 tensor, got {tuple(b.shape)} {b.dtype}")
    K, N = b.shape
    route = bf16x3_route(N, K) if route is None else route
    hi, lo = split_bf16(b)
    if route == "mma":
        planes = torch.zeros((2, K, -(-N // 8) * 8), dtype=torch.bfloat16, device=b.device)
        planes[0, :, :N] = hi
        planes[1, :, :N] = lo
    elif route == "wgmma":
        planes = torch.zeros((2, N, padded_width(K)), dtype=torch.bfloat16, device=b.device)
        planes[0, :, :K] = hi.T
        planes[1, :, :K] = lo.T
    else:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    return SplitMatrix(planes=planes, k=K, n=N, route=route)


def split_rows_reference(a: torch.Tensor, ld: int) -> torch.Tensor:
    """Plain PyTorch twin of the split pass, on ``a``'s device: the
    :func:`split_bf16` planes of a float32 (M, K) ``a`` in a zeroed (2, M,
    ld) bf16 tensor."""
    M, K = a.shape
    planes = torch.zeros((2, M, ld), dtype=torch.bfloat16, device=a.device)
    planes[0, :, :K], planes[1, :, :K] = split_bf16(a)
    return planes


def split_rows(a: torch.Tensor, ld: int) -> torch.Tensor:
    """The split pass: a contiguous float32 (M, K) ``a`` as its (2, M, ld)
    bf16 planes ``[hi, lo]``, zero past K (``ld`` a multiple of
    :data:`ROW_ALIGN`, ``ld >= K``). A CUDA tensor goes to the split kernel
    of ``csrc/bf16x3_wgmma.cu`` (counted in ``counters['b3.split.launches']``,
    as is the split of each 'wgmma' :func:`bf16x3_matmul` call), a CPU tensor to
    :func:`split_rows_reference`; the two are bitwise equal."""
    M, K = a.shape
    if a.dtype != torch.float32 or not a.is_contiguous() or ld < K or ld % ROW_ALIGN:
        raise ValueError(f"split_rows takes a contiguous float32 (M, K <= ld) tensor and ld a multiple of "
                         f"{ROW_ALIGN}; got {tuple(a.shape)} {a.dtype}, ld = {ld}")
    if a.device.type == "cpu":
        return split_rows_reference(a, ld)
    lib = _wgmma_library()
    planes = torch.empty((2, M, ld), dtype=torch.bfloat16, device=a.device)
    check(lib, "bf16x3 split", lib.bf16x3_split_f32(a.data_ptr(), planes.data_ptr(), M, K, ld, *device_and_stream(a)))
    counters["b3.split.launches"] += 1
    return planes


def bf16x3_matmul_reference(a: torch.Tensor, b_hi: torch.Tensor, b_lo: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: ``(a_hi @ b_lo + a_lo @ b_hi) +
    a_hi @ b_hi`` on float32 tensors that hold the bf16 values, for a
    float32 (M, K) ``a`` and bf16 (K, N) planes."""
    a_hi, a_lo = (p.float() for p in split_bf16(a))
    b_hi, b_lo = b_hi.float(), b_lo.float()
    return (a_hi @ b_lo + a_lo @ b_hi) + a_hi @ b_hi


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _kernel_library() -> ctypes.CDLL:
    """The built 'mma' library, with its ctypes signatures declared."""
    return declare(load_library(KERNEL_SOURCE).lib, {"bf16x3_gemm_f32": [_P] * 4 + [_I] * 5 + [_P]},
                    "bf16x3_error_string")


WGMMA_SIGNATURES = {"bf16x3_split_f32": [_P, _P] + [_I] * 4 + [_P], "bf16x3_wgmma_f32": [_P] * 4 + [_I] * 5 + [_P]}


@functools.lru_cache(maxsize=None)
def _wgmma_library() -> ctypes.CDLL:
    """The built 'wgmma' library (the split pass and the GEMM)."""
    return declare(load_library(WGMMA_SOURCE).lib, WGMMA_SIGNATURES, "bf16x3_wgmma_error_string")


def bf16x3_matmul(a: torch.Tensor, b: SplitMatrix) -> torch.Tensor:
    """``a @ B`` in bf16x3 for a contiguous float32 (M, K) ``a`` and a
    :class:`SplitMatrix` B (K, N) on the same device; returns (M, N)
    float32.

    A CUDA tensor goes to the kernel of B's route: one GEMM launch, counted
    in ``counters['b3.launches']``; a 'wgmma' call launches the split pass
    first, and counts the GEMM also in ``counters['b3.launches.wgmma']`` and
    the split in ``counters['b3.split.launches']``. A build failure or a
    refused or failed launch raises. A CPU tensor goes to
    :func:`bf16x3_matmul_reference`. Either is one ``fused/b3`` span, the
    split pass and the GEMM both inside it."""
    with span("fused/b3"):
        return _bf16x3_matmul(a, b)


def _bf16x3_matmul(a: torch.Tensor, b: SplitMatrix) -> torch.Tensor:
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
    if b.route not in ROUTES or not b.planes.is_contiguous():
        raise ValueError(f"the split matrix must have contiguous planes and a route of {ROUTES}")
    M, K = a.shape
    c = torch.empty((M, b.n), dtype=torch.float32, device=a.device)
    if c.numel() == 0:
        return c
    if b.route == "wgmma":
        wgmma_into(_wgmma_library(), a, b, c)
        counters["b3.split.launches"] += 1
        counters["b3.launches.wgmma"] += 1
    else:
        lib = _kernel_library()
        hi = b.planes.data_ptr()
        check(lib, "bf16x3_gemm", lib.bf16x3_gemm_f32(
            a.data_ptr(), hi, hi + 2 * b.planes.stride(0), c.data_ptr(), M, b.n, K, b.planes.shape[2],
            *device_and_stream(a)))
    counters["b3.launches"] += 1
    return c


def wgmma_into(lib: ctypes.CDLL, a: torch.Tensor, b: SplitMatrix, c: torch.Tensor) -> None:
    """The 'wgmma' route's call into ``lib`` (the built library or its
    profile build): A split into a scratch of (2, M, ld) planes,
    then the GEMM into ``c``; arguments as :func:`bf16x3_matmul` checks
    them. Counts nothing."""
    M, K = a.shape
    ld = b.planes.shape[2]
    scratch = torch.empty((2, M, ld), dtype=torch.bfloat16, device=a.device)
    check(lib, "bf16x3_wgmma", lib.bf16x3_wgmma_f32(
        a.data_ptr(), scratch.data_ptr(), b.planes.data_ptr(), c.data_ptr(), M, b.n, K, ld, *device_and_stream(a)))
