"""The fused half-spectrum Woodbury solve, the part both families share.

The wave family's kernels (B1: :mod:`paradiag.cuda_woodbury`,
``csrc/woodbury.cu``, rank 4) and the heat family's (B2:
:mod:`paradiag.cuda_heat`, ``csrc/heat_woodbury.cu``, rank 2) each do the
whole spectral Woodbury pipeline, ``b_hat -> x``, in one launch. Each
source holds two kernels for that function: the slab kernel, which keeps
all K bins of C adjacent columns in shared memory and so reads b and the
constants from device memory once and writes x once; and, for K too long
for even one column's slab, the streaming kernel, which passes over K
2 + 2·refine times. A family describes its source with a
:class:`FusedKernel`; this module holds the rest:

- the schedule rule (:func:`schedule`, :func:`slab_schedule`,
  :func:`streaming_schedule`): which kernel runs at a shape and how, pure
  arithmetic (no CUDA call);
- :func:`phase_table`: the extraction and injection phases of a family's
  boundary rows;
- :func:`check_launch`: the argument checks, on tensor metadata alone;
- :func:`launch`: one launch for a whole batch on the tensor's current
  stream, refused or failed launches raised through ``cuda_build.check``;
  :func:`dispatch`: the launch on a CUDA tensor, the plain twin on a CPU
  one;
- :func:`build_direct_solver`: ``b -> x``: DST matmul, packed time FFT,
  one launch, inverse packed FFT, inverse DST.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from optimal_control_paradiag_torch.cuda_build import check, declare, device_and_stream, load_library
from optimal_control_paradiag_torch.fem.space import require_full_fp32_matmul
from optimal_control_paradiag_torch.paradiag.spectral import make_halfspectrum_transforms, pairing_weights
from optimal_control_paradiag_torch.utils.timing import counters

# Shared memory one block may use on sm_90 (227 KB).
SMEM_PER_BLOCK_MAX = 232_448
# The lanes of a batched launch ride the grid's y axis (gridDim.y <= 65535).
MAX_BATCH = 65535
# The streaming kernels' block: TJ = 16 columns x KS = 32 K-lanes.
_TJ, _KS = 16, 32
_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


@dataclasses.dataclass(frozen=True)
class WoodburySchedule:
    """How the fused solve is launched for one shape.

    ``kind``: ``"slab"`` or ``"streaming"``; ``cols``: columns per block;
    ``lanes``: K-lanes per column; ``stride``: the slab's column stride in
    elements (0 for the streaming kernel); ``smem_bytes``: shared memory per
    block."""

    kind: str
    cols: int
    lanes: int
    stride: int
    smem_bytes: int


@dataclasses.dataclass(frozen=True, eq=False)
class FusedKernel:
    """A family's kernel source as the host layer launches it.

    ``name`` prefixes its launchers, ``<name>_<kind>_<f32|f64>``, which take
    ``(b_hat, x, *constants, K, n, B, refine, [cols, lanes, stride,
    smem_bytes,] device, stream)``, the schedule's ints for the slab only;
    ``error_string`` turns their return codes into text. ``rank``: the
    streaming kernel's partial sums per column. ``slab_bytes(K, cols, lanes,
    stride, itemsize)``: a slab block's shared memory, as the source sizes
    it. ``const_shapes(sched, itemsize)``: the constants a launch of
    ``sched`` passes, fields of the family's constants in argument order,
    each with its shape (``"K"``, ``"n"``, ``"blocks"`` = ceil(n / cols), or
    an int; the constants' ``a11r`` plane is (K, n)). ``aligned``: per kind, the constants the kernel bulk-copies,
    which must be 16-byte aligned. ``counters``: the launch counters to
    bump, ``{kind}`` filled in."""

    name: str
    source: str
    error_string: str
    rank: int
    slab_bytes: Callable[[int, int, int, int, int], int]
    const_shapes: Callable[[WoodburySchedule, int], Dict[str, tuple]]
    aligned: Dict[str, Tuple[str, ...]]
    counters: Tuple[str, ...]


def _slab_stride(K: int, cols: int, lanes: int, itemsize: int) -> int:
    """The slab's column stride: K padded to an odd multiple of ``m`` so
    that the columns one warp touches fall in distinct shared-memory banks.
    With lanes < 32 a warp reads ``32 // lanes`` columns at once in the
    passes (m = lanes); otherwise it writes ``cols`` columns at once in the
    load sweep, one complex element (2 * itemsize bytes) each, 128 bytes per
    wavefront (m = 64 // itemsize // cols)."""
    if cols == 1:
        return K
    m = lanes if lanes < 32 else max(1, 64 // itemsize // cols)
    q = -(-K // m)
    return m * (q + 1 - q % 2)


def streaming_schedule(kernel: FusedKernel, itemsize: int) -> WoodburySchedule:
    """The streaming kernel's fixed launch shape (its static shared memory:
    rank x KS x TJ partials and rank x TJ totals)."""
    return WoodburySchedule("streaming", _TJ, _KS, 0, kernel.rank * (_KS * _TJ + _TJ) * itemsize)


def slab_schedule(kernel: FusedKernel, K: int, cols: int, itemsize: int) -> WoodburySchedule:
    """The slab kernel with ``cols`` columns per block (a power of two
    <= 32), whether or not it fits a block: 128 threads for cols <= 4, 256
    above, so 128 / cols or 256 / cols K-lanes per column."""
    lanes = (128 if cols <= 4 else 256) // cols
    stride = _slab_stride(K, cols, lanes, itemsize)
    return WoodburySchedule("slab", cols, lanes, stride, kernel.slab_bytes(K, cols, lanes, stride, itemsize))


def schedule(kernel: FusedKernel, K: int, n: int, itemsize: int) -> WoodburySchedule:
    """The schedule of the fused solve for K bins, n columns and reals of
    ``itemsize`` bytes: the slab with the largest power-of-two column count
    C <= 32 (and no wider than n needs) that fits the shared memory a block
    may use, or the streaming kernel when not even one column fits."""
    cols = min(32, 1 << max(0, (n - 1).bit_length()))
    while cols >= 1:
        sched = slab_schedule(kernel, K, cols, itemsize)
        if sched.smem_bytes <= SMEM_PER_BLOCK_MAX:
            return sched
        cols //= 2
    return streaming_schedule(kernel, itemsize)


def phase_table(N_t: int, rows) -> np.ndarray:
    """(K, 2 * len(rows)) float64: for each (time index t, sign, scale) of
    ``rows``, the re/im columns of exp(sign 2 pi i t k / N_t) over the K
    bins k, times the pairing weights (a weighted extraction) where scale
    is None, else times scale."""
    K = N_t // 2 + 1
    k = np.arange(K)
    wgt = pairing_weights(N_t)
    phases = np.zeros((K, 2 * len(rows)))
    for col, (t, sign, scale) in enumerate(rows):
        z = np.exp(sign * 2j * np.pi * t * k / N_t)
        z = z * (wgt if scale is None else scale)
        phases[:, 2 * col] = z.real
        phases[:, 2 * col + 1] = z.imag
    return phases


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def library(kernel: FusedKernel) -> ctypes.CDLL:
    """The built library of ``kernel`` (nvcc at the first call in a
    process), its launchers declared."""
    return declare_library(kernel, load_library(kernel.source).lib)


def declare_library(kernel: FusedKernel, lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``, a build of ``kernel``'s source, with its launchers' ctypes
    signatures declared (``cuda_build.declare``)."""
    signatures = {}
    for sched in (slab_schedule(kernel, 1, 1, 4), streaming_schedule(kernel, 4)):
        ints = 5 + (4 if sched.kind == "slab" else 0)
        for suffix in _SUFFIX.values():
            signatures[f"{kernel.name}_{sched.kind}_{suffix}"] = (
                [_P] * (2 + len(kernel.const_shapes(sched, 4))) + [_I] * ints + [_P])
    return declare(lib, signatures, kernel.error_string)


def check_launch(kernel: FusedKernel, b_hat: torch.Tensor, consts, refine: int, sched: WoodburySchedule):
    """Check a launch of ``sched`` before any pointer reaches a kernel, on
    tensor metadata alone; returns the launcher's arguments between x and
    the device: the constants' pointers, then (K, n, B, refine) and, for a
    slab, the schedule's (cols, lanes, stride, smem_bytes).

    ``sched.kind`` is ``"slab"`` or ``"streaming"``. Constants that carry
    the ``schedule`` their slab image was packed for take a slab launch only
    of its columns and stride. The constants ``kernel.aligned`` names are
    16-byte aligned. ``b_hat`` is a contiguous, resolved (2, K, n) or (B, 2,
    K, n) complex tensor, 1 <= B <= :data:`MAX_BATCH` (the lanes ride the
    grid's y axis and share the constants); each constant of
    ``kernel.const_shapes`` contiguous, of the matching real dtype, on
    ``b_hat``'s device and of its shape, K and n taken from the constants'
    ``a11r`` plane; ``refine`` a non-negative int. A refusal raises a
    ValueError."""
    if sched.kind not in ("slab", "streaming"):
        raise ValueError(f"unknown schedule kind {sched.kind!r}")
    packed = getattr(consts, "schedule", None)
    if sched.kind == "slab" and packed is not None and (
            packed.kind != "slab" or (packed.cols, packed.stride) != (sched.cols, sched.stride)):
        raise ValueError(f"the constants' slab image is packed for {packed}, not for {sched}")
    aligned = kernel.aligned.get(sched.kind, ())
    if any(getattr(consts, f).data_ptr() % 16 for f in aligned):
        raise ValueError(f"the slab kernel bulk-copies {', '.join(aligned)}: each must be 16-byte aligned")
    real = _REAL.get(b_hat.dtype)
    K, n = consts.a11r.shape
    shapes = kernel.const_shapes(sched, consts.a11r.element_size())
    if (real is None or tuple(b_hat.shape[-3:]) != (2, K, n) or b_hat.dim() not in (3, 4)
            or not b_hat.is_contiguous() or b_hat.is_conj()):
        raise ValueError(
            f"b_hat must be a contiguous, resolved (2, {K}, {n}) or (B, 2, {K}, {n}) complex tensor; "
            f"got {tuple(b_hat.shape)} {b_hat.dtype}"
        )
    batch = b_hat.shape[0] if b_hat.dim() == 4 else 1
    if not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"a batched launch takes 1 to {MAX_BATCH} lanes (the grid's y axis); got B = {batch}")
    dims = {"K": K, "n": n, "blocks": -(-n // sched.cols)}
    ptrs = []
    for field, shape in shapes.items():
        t = getattr(consts, field)
        if t.dtype != real or t.device != b_hat.device or not t.is_contiguous():
            raise ValueError(f"constant {field} must be contiguous {real} on {b_hat.device}")
        if tuple(t.shape) != tuple(dims.get(d, d) for d in shape):
            raise ValueError("packed constants have inconsistent shapes")
        ptrs.append(t.data_ptr())
    if not isinstance(refine, int) or refine < 0:
        raise ValueError(f"refine must be a non-negative int, got {refine!r}")
    sizes = (K, n, batch, refine)
    if sched.kind == "slab":
        sizes += (sched.cols, sched.lanes, sched.stride, sched.smem_bytes)
    return ptrs, sizes


def launch(kernel: FusedKernel, b_hat: torch.Tensor, consts, refine: int, sched: WoodburySchedule,
           lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """x = the kernel ``sched`` names applied to ``b_hat``, a CUDA tensor,
    in one launch on the current stream of its device, counted in
    ``kernel.counters``. ``lib`` is another build of the source, declared
    with :func:`declare_library` (``chip_smoke.py``'s profile and plane
    builds), else :func:`library`'s. Refused arguments raise a ValueError
    (:func:`check_launch`); a build failure, or a launch the launcher or
    the card refuses, raises."""
    if b_hat.device.type != "cuda":
        raise ValueError(f"the fused {kernel.name} kernels run on CUDA tensors, got {b_hat.device}")
    ptrs, sizes = check_launch(kernel, b_hat, consts, refine, sched)
    lib = library(kernel) if lib is None else lib
    x = torch.empty_like(b_hat)
    name = f"{kernel.name}_{sched.kind}"
    fn = getattr(lib, f"{name}_{_SUFFIX[_REAL[b_hat.dtype]]}")
    check(lib, name, fn(b_hat.data_ptr(), x.data_ptr(), *ptrs, *sizes, *device_and_stream(b_hat)))
    for c in kernel.counters:
        counters[c.format(kind=sched.kind)] += 1
    return x


def dispatch(kernel: FusedKernel, b_hat: torch.Tensor, consts, refine: int, reference: Callable) -> torch.Tensor:
    """``reference(b_hat, consts, refine)``, the kernel's plain twin, on a
    CPU tensor; on a CUDA tensor one :func:`launch` of the schedule the
    constants carry, else of the one :func:`schedule` picks for their
    shape."""
    if b_hat.device.type == "cpu":
        return reference(b_hat, consts, refine)
    if b_hat.device.type != "cuda":
        raise ValueError(f"the fused {kernel.name} solve runs on CUDA or CPU tensors, got {b_hat.device}")
    sched = getattr(consts, "schedule", None) or schedule(kernel, *consts.a11r.shape, consts.a11r.element_size())
    return launch(kernel, b_hat, consts, refine, sched)


def build_direct_solver(kernel: FusedKernel, space, N_t: int, dtype, pack: Callable, fused: Callable,
                        refine: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """Direct solver ``b -> x``: DST matmul and the packed time FFT
    (``time_transform='fft2'``) around ``fused(b_hat, consts, refine)``, one
    kernel launch for the whole spectral Woodbury pipeline, ``refine``
    included, with ``consts = pack()``. On a CUDA space the kernel is built
    here."""
    require_full_fp32_matmul()
    consts = pack()
    if space.device.type == "cuda":
        library(kernel)
    to_spectral, from_spectral = make_halfspectrum_transforms(space, N_t, dtype, time_transform="fft2")

    def solve(b: torch.Tensor) -> torch.Tensor:
        return from_spectral(fused(to_spectral(b), consts, refine))

    return solve
