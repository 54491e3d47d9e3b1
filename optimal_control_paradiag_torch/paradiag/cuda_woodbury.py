"""The fused half-spectrum Woodbury solve as ONE hand-written CUDA kernel.

The counterpart of ``optimal_control_paradiag_tpu/paradiag/pallas_woodbury.py``.
The plain half-spectrum solve (``paradiag/spectral.py``) spends its
non-transform time in ~30 elementwise passes over the ``(K, n)`` spectral
state (K = N_t//2 + 1): D^{-1}, 4 slice extractions, the 4x4 capacity mix,
rank-1 injections, D^{-1}, then per ``refine`` step the exact operator A_hat
and a second Woodbury pass. The kernel (``csrc/woodbury.cu``) does all of it,
``b_hat -> x``, in one launch; its source comment gives the design.

``csrc/woodbury.cu`` holds two kernels for the same function, and
:func:`woodbury_schedule` picks one from the shape: the slab kernel, which
keeps all K bins of C adjacent columns in shared memory and so reads b and
the constants from device memory once and writes x once; and, for K too
long for even one column's slab, the streaming kernel, which passes over K
2 + 2·refine times.

The pieces, in the order the solve uses them:

- :func:`pack_constants`: the per-(k, j) constants a11r, a11i, invdet (from
  the float64 a11/det, then cast), the per-column rows m1, kap1, tm1, mk1,
  the capacity matrices G and the phases, in the working dtype on the
  operator's device;
- :func:`woodbury_schedule`: the schedule rule, pure arithmetic on the
  shape (no CUDA call);
- :func:`fused_woodbury`: the wrapper. On a CUDA tensor it launches the
  kernel the schedule names (and counts the launch in
  ``fused_woodbury.launches``); on a CPU tensor it runs
  :func:`fused_woodbury_reference`, the plain PyTorch twin of the kernel
  body on the same packed constants;
- :func:`build_cuda_woodbury_solver`: ``b -> x``: DST matmul, packed time
  FFT, one kernel launch, inverse packed FFT, inverse DST.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from optimal_control_paradiag_torch.cuda_build import launch_fused_solve, load_library
from optimal_control_paradiag_torch.fem.space import require_full_fp32_matmul
from optimal_control_paradiag_torch.ops.allatonce import AllAtOnceOperator
from optimal_control_paradiag_torch.paradiag.spectral import (
    _real_capacity_matrices,
    _spectral_plan,
    make_halfspectrum_transforms,
    pairing_weights,
)
from optimal_control_paradiag_torch.utils.constants import to_device

KERNEL_SOURCE = "woodbury.cu"


@dataclasses.dataclass(frozen=True)
class WoodburyConstants:
    """Packed constants of the fused solve, working dtype, one device."""

    a11r: torch.Tensor  # (K, n) Re a11
    a11i: torch.Tensor  # (K, n) Im a11
    invdet: torch.Tensor  # (K, n) 1 / (|a11|^2 + tm^2)
    colc: torch.Tensor  # (4, n) rows m1, kap1, tm1, mk1
    gc: torch.Tensor  # (16, n) G[a][b] of column j at row 4a + b
    phases: torch.Tensor  # (K, 16) phi (weighted extraction) and psi (injection), re/im


def pack_constants(op: AllAtOnceOperator) -> WoodburyConstants:
    """Host float64 constant packing (``pallas_woodbury.py:157-222``) without
    the Pallas column padding: the kernel guards ``j < n`` itself."""
    plan = _spectral_plan(op)
    N_t, n = plan.N_t, plan.n
    K = N_t // 2 + 1
    rdtype, dev = plan.rdtype, plan.device
    a11_h = plan.a11_h[:K]
    det_h = plan.det_h[:K]
    muM, muK = plan.muM64, plan.muK64
    colc = np.stack([muM, plan.c * muK, plan.theta * muM, muM + plan.c * muK])

    gc = _real_capacity_matrices(plan).transpose(1, 2, 0).reshape(16, n)

    k = np.arange(K)
    wgt = pairing_weights(N_t)
    phases = np.zeros((K, 16))
    for col, (i, sign, scale) in enumerate(
        [
            (N_t - 1, -1, None),  # phi_uNm1 (weighted)
            (N_t - 2, -1, None),  # phi_uNm2
            (0, -1, None),  # phi_p0
            (1, -1, None),  # phi_p1
            (0, 1, 1.0 / N_t),  # psi_u0
            (1, 1, 1.0 / N_t),  # psi_u1
            (N_t - 1, 1, 1.0 / N_t),  # psi_pNm1
            (N_t - 2, 1, 1.0 / N_t),  # psi_pNm2
        ]
    ):
        z = np.exp(sign * 2j * np.pi * i * k / N_t)
        z = z * (wgt if scale is None else scale)
        phases[:, 2 * col] = z.real
        phases[:, 2 * col + 1] = z.imag

    put = lambda a: to_device(a, rdtype, dev)
    return WoodburyConstants(
        a11r=put(a11_h.real),
        a11i=put(a11_h.imag),
        invdet=put(1.0 / det_h),
        colc=put(colc),
        gc=put(gc),
        phases=put(phases),
    )


def fused_woodbury_reference(
    b_hat: torch.Tensor, c: WoodburyConstants, refine: int
) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: the Pallas kernel body
    (``pallas_woodbury.py:57-140``) on split real (K, n) planes. ``b_hat``
    is a (2, K, n) or (B, 2, K, n) complex tensor; returns the same."""
    br = torch.view_as_real(b_hat)
    bur, bui = br[..., 0, :, :, 0], br[..., 0, :, :, 1]
    bpr, bpi = br[..., 1, :, :, 0], br[..., 1, :, :, 1]
    a11r, a11i, invdet = c.a11r, c.a11i, c.invdet
    m1, kap1, tm1, mk1 = c.colc[0], c.colc[1], c.colc[2], c.colc[3]
    gc = c.gc
    ph = [c.phases[:, i : i + 1] for i in range(16)]

    def d_inv(ur, ui, pr, pi):
        # yu = (conj(a11) u + tm p) / det ; yp = (a11 p - tm u) / det
        yur = (a11r * ur + a11i * ui + tm1 * pr) * invdet
        yui = (a11r * ui - a11i * ur + tm1 * pi) * invdet
        ypr = (a11r * pr - a11i * pi - tm1 * ur) * invdet
        ypi = (a11r * pi + a11i * pr - tm1 * ui) * invdet
        return yur, yui, ypr, ypi

    def extract(ur, ui, pr, pi):
        # Real part of sum_k phi_k y_k with the pairing weights in phi.
        uN1 = torch.sum(ph[0] * ur - ph[1] * ui, dim=-2)
        uN2 = torch.sum(ph[2] * ur - ph[3] * ui, dim=-2)
        p0 = torch.sum(ph[4] * pr - ph[5] * pi, dim=-2)
        p1 = torch.sum(ph[6] * pr - ph[7] * pi, dim=-2)
        return uN1, uN2, p0, p1

    def psi_outer(w0, w1, w2, w3):
        w0, w1, w2, w3 = (w[..., None, :] for w in (w0, w1, w2, w3))  # rows against (..., K, n)
        return (
            ph[8] * w0 + ph[10] * w1,
            ph[9] * w0 + ph[11] * w1,
            ph[12] * w2 + ph[14] * w3,
            ph[13] * w2 + ph[15] * w3,
        )

    def wb_apply(rur, rui, rpr, rpi):
        yur, yui, ypr, ypi = d_inv(rur, rui, rpr, rpi)
        z = extract(yur, yui, ypr, ypi)
        w = [
            gc[4 * a + 0] * z[0] + gc[4 * a + 1] * z[1] + gc[4 * a + 2] * z[2] + gc[4 * a + 3] * z[3]
            for a in range(4)
        ]
        dur, dui, dpr, dpi = d_inv(*psi_outer(*w))
        return yur - dur, yui - dui, ypr - dpr, ypi - dpi

    def a_hat(ur, ui, pr, pi):
        # D x  (a22 = conj(a11); tm real), plus the rank-4 boundary rows
        dur = a11r * ur - a11i * ui - tm1 * pr
        dui = a11r * ui + a11i * ur - tm1 * pi
        dpr = tm1 * ur + a11r * pr + a11i * pi
        dpi = tm1 * ui + a11r * pi - a11i * pr
        uN1, uN2, p0, p1 = extract(ur, ui, pr, pi)
        r0 = m1 * (2.0 * uN1 - uN2) - kap1 * uN2 + 0.5 * tm1 * p0
        r1 = -mk1 * uN1
        r2 = m1 * (2.0 * p0 - p1) - kap1 * p1 - 0.5 * tm1 * uN1
        r3 = -mk1 * p0
        iur, iui, ipr, ipi = psi_outer(r0, r1, r2, r3)
        return dur + iur, dui + iui, dpr + ipr, dpi + ipi

    xur, xui, xpr, xpi = wb_apply(bur, bui, bpr, bpi)
    for _ in range(refine):
        aur, aui, apr, api = a_hat(xur, xui, xpr, xpi)
        cur, cui, cpr, cpi = wb_apply(bur - aur, bui - aui, bpr - apr, bpi - api)
        xur, xui = xur + cur, xui + cui
        xpr, xpi = xpr + cpr, xpi + cpi

    out = torch.stack([torch.stack([xur, xui], -1), torch.stack([xpr, xpi], -1)], dim=-4)
    return torch.view_as_complex(out.contiguous())


# Shared memory one block may use on sm_90 (227 KB).
SMEM_PER_BLOCK_MAX = 232_448
# The streaming kernel's block: TJ = 16 columns x KS = 32 K-lanes.
_TJ, _KS = 16, 32


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


def _slab_bytes(K: int, cols: int, lanes: int, stride: int, itemsize: int) -> int:
    """Shared memory of a slab block, as ``csrc/woodbury.cu:slab_bytes``: the
    phase table (the 16 phases of a bin and 16 bytes of padding per bin), 11
    reals per bin of each column (b and x complex, a11 complex, invdet), and
    two buffers of cross-warp partials when a column spans several warps."""
    red = 2 * cols * (lanes // 32) * 4 * itemsize if lanes > 32 else 0
    return (cols * stride * 11 + (16 + 16 // itemsize) * K) * itemsize + red


def streaming_schedule(itemsize: int) -> WoodburySchedule:
    """The streaming kernel's fixed launch shape (its static shared memory:
    4 x KS x TJ partials and 4 x TJ totals)."""
    return WoodburySchedule("streaming", _TJ, _KS, 0, (4 * _KS * _TJ + 4 * _TJ) * itemsize)


def slab_schedule(K: int, cols: int, itemsize: int, slab_bytes=_slab_bytes) -> WoodburySchedule:
    """The slab kernel with ``cols`` columns per block (a power of two
    <= 32), whether or not it fits a block: 128 threads for cols <= 4, 256
    above, so 128 / cols or 256 / cols K-lanes per column. ``slab_bytes``
    sizes the kernel's shared memory (this kernel's, or the heat family's
    with the same signature)."""
    lanes = (128 if cols <= 4 else 256) // cols
    stride = _slab_stride(K, cols, lanes, itemsize)
    return WoodburySchedule("slab", cols, lanes, stride, slab_bytes(K, cols, lanes, stride, itemsize))


def widest_slab(K: int, n: int, itemsize: int, slab_bytes, streaming: WoodburySchedule) -> WoodburySchedule:
    """The slab schedule with the largest power-of-two column count C <= 32
    (and no wider than n needs) whose slab, as ``slab_bytes`` sizes it, fits
    the shared memory a block may use; ``streaming`` when not even one
    column fits."""
    cols = min(32, 1 << max(0, (n - 1).bit_length()))
    while cols >= 1:
        sched = slab_schedule(K, cols, itemsize, slab_bytes)
        if sched.smem_bytes <= SMEM_PER_BLOCK_MAX:
            return sched
        cols //= 2
    return streaming


def woodbury_schedule(K: int, n: int, itemsize: int) -> WoodburySchedule:
    """The schedule of the fused solve for K bins, n columns and reals of
    ``itemsize`` bytes: the widest slab that fits a block, or the streaming
    kernel when not even one column fits."""
    return widest_slab(K, n, itemsize, _slab_bytes, streaming_schedule(itemsize))


@functools.lru_cache(maxsize=None)
def _kernel_library() -> ctypes.CDLL:
    """The built kernel library, with its ctypes signatures declared."""
    lib = load_library(KERNEL_SOURCE).lib
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.woodbury_streaming_f32, lib.woodbury_streaming_f64):
        fn.argtypes = [p] * 8 + [i] * 5 + [p]
        fn.restype = i
    for fn in (lib.woodbury_slab_f32, lib.woodbury_slab_f64):
        fn.argtypes = [p] * 8 + [i] * 9 + [p]
        fn.restype = i
    lib.woodbury_error_string.argtypes = [i]
    lib.woodbury_error_string.restype = ctypes.c_char_p
    return lib


_CONST_SHAPES = {
    "a11r": ("K", "n"),
    "a11i": ("K", "n"),
    "invdet": ("K", "n"),
    "colc": (4, "n"),
    "gc": (16, "n"),
    "phases": ("K", 16),
}


def _launch(b_hat: torch.Tensor, consts: WoodburyConstants, refine: int, sched: WoodburySchedule) -> torch.Tensor:
    """Launch the kernel ``sched`` names on CUDA tensors and count it."""
    if b_hat.device.type != "cuda":
        raise ValueError(f"the fused Woodbury kernels run on CUDA tensors, got {b_hat.device}")
    lib = _kernel_library()
    if sched.kind == "slab":
        if consts.phases.data_ptr() % 16:
            raise ValueError("the slab kernel copies the phase table in 16-byte pieces: it must be 16-byte aligned")
        fns = {torch.float32: lib.woodbury_slab_f32, torch.float64: lib.woodbury_slab_f64}
        extra = (sched.cols, sched.lanes, sched.stride, sched.smem_bytes)
    elif sched.kind == "streaming":
        fns = {torch.float32: lib.woodbury_streaming_f32, torch.float64: lib.woodbury_streaming_f64}
        extra = ()
    else:
        raise ValueError(f"unknown schedule kind {sched.kind!r}")
    x = launch_fused_solve(
        f"woodbury_{sched.kind}", fns, lib.woodbury_error_string, b_hat, consts, _CONST_SHAPES, refine, extra
    )
    fused_woodbury.launches += 1
    return x


def fused_woodbury(b_hat: torch.Tensor, consts: WoodburyConstants, refine: int) -> torch.Tensor:
    """``x = A_hat^{-1} b_hat`` on the half spectrum, with ``refine`` defect
    corrections. ``b_hat`` is a contiguous (2, K, n) complex tensor, or a
    batch of them, (B, 2, K, n).

    A CUDA tensor goes to the kernel :func:`woodbury_schedule` picks for its
    shape: one launch for the whole batch, counted once in
    ``fused_woodbury.launches``; a build failure or a refused or failed
    launch raises. A CPU tensor goes to :func:`fused_woodbury_reference`."""
    if b_hat.device.type == "cpu":
        return fused_woodbury_reference(b_hat, consts, refine)
    if b_hat.device.type != "cuda":
        raise ValueError(f"fused_woodbury runs on CUDA or CPU tensors, got {b_hat.device}")
    K, n = consts.a11r.shape
    return _launch(b_hat, consts, refine, woodbury_schedule(K, n, consts.a11r.element_size()))


fused_woodbury.launches = 0


def _fused_woodbury_streaming(b_hat: torch.Tensor, consts: WoodburyConstants, refine: int) -> torch.Tensor:
    """The streaming kernel at any shape, on CUDA tensors: the yardstick the
    card tests and ``chip_smoke.py`` hold the slab kernel against. No solver
    reaches it."""
    return _launch(b_hat, consts, refine, streaming_schedule(consts.a11r.element_size()))


def build_cuda_woodbury_solver(
    op: AllAtOnceOperator, refine: int = 1, pack_fft: bool = True
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Direct solver ``b -> x``: DST matmul and time FFT (``pack_fft``: one
    packed complex FFT of u + i p, else two rffts) around ONE fused kernel
    launch for the whole spectral Woodbury pipeline, ``refine`` included. On
    a CUDA operator the kernel is built (from ``csrc/woodbury.cu``) here."""
    require_full_fp32_matmul()
    consts = pack_constants(op)
    if op.space.device.type == "cuda":
        _kernel_library()
    to_spectral, from_spectral = make_halfspectrum_transforms(
        op.space, op.N_t, op.space.dtype, time_transform="fft2" if pack_fft else "fft"
    )

    def solve(b: torch.Tensor) -> torch.Tensor:
        return from_spectral(fused_woodbury(to_spectral(b), consts, refine))

    return solve
