"""CGS2, the Arnoldi step's orthogonalisation, as hand-written CUDA kernels.

GMRES's device step (``krylov/gmres.py`` :func:`arnoldi_step`) makes the
operator's output ``w`` (B lanes) orthogonal to the active basis rows
``V[:, :k+1]`` by classical Gram-Schmidt with one re-orthogonalisation,
writes ``V[:, k+1] = w / |w|`` and returns the B Hessenberg columns
``[h_0, ..., h_k, |w|]``. On a real CUDA basis with no sharded layout
(``krylov/gmres.py`` ``takes_cgs2_kernels``) :func:`cgs2` runs that step as
``csrc/cgs2.cu`` (built with nvcc at first use): three split-K passes over
the basis and a scale, four launches a step for all lanes (and a memset
of the step's tickets), each launch counted in
``utils.timing.counters['cgs2.launches']``; the sums are taken in a
fixed order, so one input gives the same bits on every run. Its plain
twin, the batched products, is ``krylov/gmres.py`` ``cgs2_reference``,
which the CPU, complex bases and sharded layouts run. A tensor the
kernels do not take raises a ValueError that names the failed condition
(:func:`check_cgs2`).

The launch schedule (:func:`schedule`) is pure arithmetic: the chunk of
the state a block stages (double buffered, so it shrinks as the rows grow)
and the blocks a lane, about four an SM in all. A step stages at most
:func:`max_rows` active rows; GMRES's restart clamp caps the restart there
on the kernels' route.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from optimal_control_paradiag_torch.cuda_build import check, declare, device_and_stream, load_library
from optimal_control_paradiag_torch.utils.timing import counters

KERNEL_SOURCE = "cgs2.cu"
LAUNCHES_PER_STEP = 4  # three passes and the scale
THREADS = 256
WARPS = THREADS // 32
STAGES = 2  # the chunk buffers a block double-buffers
CHUNK_ALIGN = 16  # elements: every chunk starts 16-byte aligned in either type
CHUNK_MAX = 4096
# Shared memory a block aims at, so four blocks share an SM (228 KB, 1 KB
# reserved a block, a few bytes static) at 256 threads each.
SMEM_TARGET = 57_088
SMEM_PER_SM = 233_472
SMEM_PER_BLOCK_MAX = 232_448
SMEM_STATIC = 16  # the pass kernel's static shared memory (one int), rounded up
SMEM_RESERVED = 1_024 + SMEM_STATIC
MAX_LANES = 65535
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


@dataclasses.dataclass(frozen=True)
class Cgs2Schedule:
    """How a step launches: ``chunk`` elements a staged chunk, ``blocks``
    a lane, ``smem_bytes`` of shared memory a pass block."""

    chunk: int
    blocks: int
    smem_bytes: int


def segments(rows: int) -> int:
    """The pieces each row's chunk is cut into for the dots, so the block's
    eight warps all have one at few rows."""
    return max(1, WARPS // rows)


def smem_bytes(rows: int, chunk: int, itemsize: int) -> int:
    """Dynamic shared memory of a pass block, as ``csrc/cgs2.cu`` sizes it
    at its launch: two ``(rows + 1, chunk)`` tiles, the update's
    coefficients, the dots' running sums and a warp reduction."""
    return (STAGES * (rows + 1) * chunk + rows + rows * segments(rows) + WARPS) * itemsize


def max_rows(itemsize: int) -> int:
    """The most active rows (k + 1) a step stages: those whose pass block
    fits a block's shared memory at a 16-element chunk (853 in float64,
    1707 in float32)."""
    return ((SMEM_PER_BLOCK_MAX - SMEM_STATIC) // itemsize - STAGES * CHUNK_ALIGN - WARPS) // (STAGES * CHUNK_ALIGN + 2)


def schedule(rows: int, m: int, lanes: int, itemsize: int, sms: int) -> Cgs2Schedule:
    """The schedule of a step over ``rows`` = k + 1 active rows of ``m``
    elements, ``lanes`` lanes, on a card of ``sms`` SMs: the largest chunk
    (a multiple of 16, at most 4096 and no longer than the state needs)
    whose block fits the target, and as many blocks a lane as fill the
    card once at the blocks an SM that shared memory allows, at most one a
    chunk. Raises ValueError where even a 16-element chunk of the rows
    exceeds a block's shared memory."""
    fixed = smem_bytes(rows, 0, itemsize)
    chunk = (SMEM_TARGET - fixed) // (STAGES * (rows + 1) * itemsize) // CHUNK_ALIGN * CHUNK_ALIGN
    chunk = max(CHUNK_ALIGN, min(chunk, CHUNK_MAX, -(-m // CHUNK_ALIGN) * CHUNK_ALIGN))
    smem = smem_bytes(rows, chunk, itemsize)
    if smem + SMEM_STATIC > SMEM_PER_BLOCK_MAX:
        raise ValueError(f"cgs2: k + 1 = {rows} rows of a 16-element chunk need {smem + SMEM_STATIC} bytes of "
                         f"shared memory, over a block's {SMEM_PER_BLOCK_MAX} (max_rows: {max_rows(itemsize)})")
    per_sm = max(1, min(2048 // THREADS, SMEM_PER_SM // (smem + SMEM_RESERVED)))
    blocks = max(1, min(-(-m // chunk), -(-per_sm * sms // lanes)))
    return Cgs2Schedule(chunk=chunk, blocks=blocks, smem_bytes=smem)


def scratch_elements(lanes: int, rows: int, blocks: int, itemsize: int) -> int:
    """Elements of a step's scratch: the blocks' partial sums and the two
    projections in the working type, then a 32-bit ticket a lane and
    pass for the last-block reductions (zeroed by the step)."""
    return lanes * rows * (blocks + 2) + -(-3 * lanes * 4 // itemsize)


def _refuse(why: str) -> None:
    raise ValueError(f"cgs2: the kernels do not take this step: {why}")


def check_cgs2(V: torch.Tensor, w: torch.Tensor, k: int) -> Tuple[int, int, int]:
    """``(B, k + 1, m)`` if the kernels take step ``k`` on the basis ``V``
    and the operator's output ``w``: V a contiguous float32 or float64
    ``(B, R + 1, m)`` tensor with elements and ``0 <= k < R``, at most 65535
    lanes; w ``(B, m)`` of V's dtype on V's device with unit element
    stride. Raises ValueError naming the first condition that fails."""
    if V.dtype not in _SUFFIX:
        _refuse(f"dtype {V.dtype} is not float32 or float64")
    if V.dim() != 3 or V.numel() == 0:
        _refuse(f"the basis's shape {tuple(V.shape)} is not a (B, R + 1, m) tensor with elements")
    B, R1, m = V.shape
    if not V.is_contiguous():
        _refuse(f"the basis's strides {V.stride()} are not contiguous")
    if V.data_ptr() % V.element_size() != 0:
        _refuse("the basis's data pointer is not aligned to the element size")
    if not 0 <= k < R1 - 1:
        _refuse(f"k + 1 = {k + 1} is not in 1..R = 1..{R1 - 1}: step k writes row k + 1 of the basis's R + 1 rows")
    if B > MAX_LANES:
        _refuse(f"{B} lanes are more than {MAX_LANES}")
    if w.dtype != V.dtype or w.device != V.device:
        _refuse(f"w ({w.dtype} on {w.device}) does not match the basis ({V.dtype} on {V.device})")
    if tuple(w.shape) != (B, m):
        _refuse(f"w's shape {tuple(w.shape)} is not (B, m) = {(B, m)}")
    if m > 1 and w.stride(1) != 1:
        _refuse(f"w's strides {w.stride()} have no unit element stride")
    if B > 1 and w.stride(0) < m:
        _refuse(f"w's lanes overlap (strides {w.stride()})")
    if w.data_ptr() % w.element_size() != 0:
        _refuse("w's data pointer is not aligned to the element size")
    return B, k + 1, m


_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# (V, ldv, m, w, ldw, B, K1, H, scratch, C, G, device, stream)
SIGNATURES = {f"cgs2_step_{s}": [_P, _LL, _LL, _P, _LL, _I, _I, _P, _P, _I, _I, _I, _P]
              for s in _SUFFIX.values()}


@functools.lru_cache(maxsize=None)
def kernel_library() -> ctypes.CDLL:
    """The built kernel library (nvcc at the first call in a process), with
    its ctypes signatures declared."""
    return declare(load_library(KERNEL_SOURCE).lib, SIGNATURES, "cgs2_error_string")


def cgs2(V: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """Step ``k`` of CGS2 on a CUDA basis by the kernels: four launches,
    counted in ``counters['cgs2.launches']``; a step they do not take
    raises (:func:`check_cgs2`; a tensor off the card too). Writes ``V[:,
    k+1]``; returns the Hessenberg columns ``(B, k+2)``. ``w`` is only
    read."""
    if V.device.type != "cuda":
        _refuse(f"the basis is on {V.device}, not on a CUDA device (the CPU runs krylov/gmres.py cgs2_reference)")
    B, rows, m = check_cgs2(V, w, k)
    index, stream = device_and_stream(V)
    sched = schedule(rows, m, B, V.element_size(), torch.cuda.get_device_properties(index).multi_processor_count)
    H = torch.empty((B, rows + 1), dtype=V.dtype, device=V.device)
    scratch = torch.empty(scratch_elements(B, rows, sched.blocks, V.element_size()), dtype=V.dtype,
                          device=V.device)
    lib = kernel_library()
    fn = getattr(lib, f"cgs2_step_{_SUFFIX[V.dtype]}")
    ldw = w.stride(0) if B > 1 else m
    check(lib, "cgs2", fn(V.data_ptr(), V.stride(0), m, w.data_ptr(), ldw, B, rows, H.data_ptr(),
                          scratch.data_ptr(), sched.chunk, sched.blocks, index, stream))
    counters["cgs2.launches"] += LAUNCHES_PER_STEP
    return H
