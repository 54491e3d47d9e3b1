"""The heat family's fused half-spectrum Woodbury solve as ONE hand-written
CUDA kernel.

The counterpart of ``optimal_control_paradiag_tpu/paradiag/pallas_heat.py``,
shaped like :mod:`paradiag.cuda_woodbury` (the wave family's kernel) at
rank 2: D^{-1}, the extractions phi_uN and phi_p1, the real 2x2 capacity mix,
the injections psi_u1 and psi_pN, D^{-1}, then per ``refine`` step the exact
operator A_hat = D + (m1 uN, m1 p1) injected and a second Woodbury pass. The
kernel (``csrc/heat_woodbury.cu``) does all of it, ``b_hat -> x``, in one
launch; its source comment gives the design.

``csrc/heat_woodbury.cu`` holds two kernels for the same function, and
:func:`heat_schedule` picks one from the shape: the slab kernel, which keeps
all K bins of C adjacent columns in shared memory, so reads b and the
constants from device memory once and writes x once, and brings in each
block's constants with one bulk copy from an image packed for it; and, for K too
long for even one column's slab, the streaming kernel, which passes over K
2 + 2·refine times.

The pieces, in the order the solve uses them:

- :func:`pack_heat_constants`: a11r, a11i, invdet per (k, j) from the
  float64 host plan, the per-column rows m1, tm1, G00, G01, G10, G11 and the
  phases, in the working dtype on the problem's device; the schedule of the
  shape; and the slab kernel's copies, laid out as it keeps them in shared
  memory: the phase table padded per bin, and a11r, a11i, invdet in one
  image chunk per block (:func:`_slab_image`);
- :func:`heat_schedule`: the schedule rule, pure arithmetic on the shape;
- :func:`fused_heat`: the wrapper. On a CUDA tensor it launches the kernel
  the constants' schedule names (and counts the launch in
  ``fused_heat.launches``, and by kind in ``fused_heat.kinds``); on a CPU
  tensor it runs :func:`fused_heat_reference`, the plain PyTorch twin of the
  kernel body on the same (K, n) constants;
- :func:`build_cuda_heat_solver`: ``b -> x``: DST matmul, packed time FFT,
  one kernel launch, inverse packed FFT, inverse DST.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from optimal_control_paradiag_torch.cuda_build import launch_fused_solve, load_library
from optimal_control_paradiag_torch.fem.space import require_full_fp32_matmul
from optimal_control_paradiag_torch.paradiag.cuda_woodbury import (
    WoodburySchedule,
    slab_schedule,
    widest_slab,
)
from optimal_control_paradiag_torch.paradiag.spectral import (
    make_halfspectrum_transforms,
    pairing_weights,
)
from optimal_control_paradiag_torch.utils.constants import to_device

KERNEL_SOURCE = "heat_woodbury.cu"
# The streaming kernel's block: TJ = 16 columns x KS = 32 K-lanes.
_TJ, _KS = 16, 32


def _image_reals(slab: int, itemsize: int) -> int:
    """Reals of one block's constant image, as ``csrc/heat_woodbury.cu:
    image_reals``: the a11 pairs and invdet of its ``slab`` = cols * stride
    bins, padded to a whole number of 16-byte pieces."""
    e = 16 // itemsize
    return -(-3 * slab // e) * e


def _heat_slab_bytes(K: int, cols: int, lanes: int, stride: int, itemsize: int) -> int:
    """Shared memory of a heat slab block, as ``csrc/heat_woodbury.cu:
    slab_bytes``: 16 bytes for the mbarrier, the phase table (the 8 phases of
    a bin and 16 bytes of padding per bin), the constant image, b and x
    (complex, 4 reals per bin of each column), and two buffers of cross-warp
    partials when a column spans several warps."""
    slab = cols * stride
    red = 2 * cols * (lanes // 32) * 2 * itemsize if lanes > 32 else 0
    return 16 + ((8 + 16 // itemsize) * K + _image_reals(slab, itemsize) + 8 * slab) * itemsize + red


def heat_streaming_schedule(itemsize: int) -> WoodburySchedule:
    """The streaming kernel's fixed launch shape (its static shared memory:
    2 x KS x TJ partials and 2 x TJ totals)."""
    return WoodburySchedule("streaming", _TJ, _KS, 0, (2 * _KS * _TJ + 2 * _TJ) * itemsize)


def heat_slab_schedule(K: int, cols: int, itemsize: int) -> WoodburySchedule:
    """The heat slab kernel with ``cols`` columns per block, whether or not
    it fits a block (the lanes and stride rule of the wave slab)."""
    return slab_schedule(K, cols, itemsize, _heat_slab_bytes)


def heat_schedule(K: int, n: int, itemsize: int) -> WoodburySchedule:
    """The schedule of the fused heat solve for K bins, n columns and reals
    of ``itemsize`` bytes: the slab kernel with the largest power-of-two
    column count C <= 32 (and no wider than n needs) whose slab fits the
    shared memory a block may use, or the streaming kernel when not even one
    column fits (K > 2525 in float32, K > 1382 in float64)."""
    return widest_slab(K, n, itemsize, _heat_slab_bytes, heat_streaming_schedule(itemsize))


@dataclasses.dataclass(frozen=True)
class HeatConstants:
    """Packed constants of the fused heat solve, working dtype, one device."""

    a11r: torch.Tensor  # (K, n) Re a11
    a11i: torch.Tensor  # (K, n) Im a11
    invdet: torch.Tensor  # (K, n) 1 / (|a11|^2 + tm^2)
    colc: torch.Tensor  # (6, n) rows m1, tm1, G00, G01, G10, G11
    phases: torch.Tensor  # (K, 8) phi_uN, phi_p1 (weighted), psi_u1, psi_pN; re/im
    schedule: WoodburySchedule  # the kernel that runs, chosen once for the shape
    # The slab kernel's copies of the phases and of a11r, a11i, invdet, in the
    # layout it keeps them in shared memory, each brought in by one bulk copy:
    table: torch.Tensor  # (K, 8 + 16 // itemsize) the phases, 16 bytes of padding per bin
    # (ceil(n / C), _image_reals(C * stride)), one chunk per block; (0, 0) for
    # the streaming schedule
    image: torch.Tensor


def _slab_image(a11r: torch.Tensor, a11i: torch.Tensor, invdet: torch.Tensor, sched: WoodburySchedule) -> torch.Tensor:
    """a11r, a11i and invdet in the order and at the column stride the slab
    kernel keeps them in shared memory: per block of C = ``sched.cols``
    columns, C x stride (a11r, a11i) pairs, then C x stride invdet, then
    zeros up to a whole number of 16-byte pieces; column c, bin k at
    c * stride + k. Bins past K and columns past n are zero. Bitwise copies
    of the (K, n) planes."""
    K, n = a11r.shape
    C, ks = sched.cols, sched.stride
    blocks = -(-n // C)
    grid = lambda t: torch.nn.functional.pad(t, (0, blocks * C - n, 0, ks - K)).reshape(ks, blocks, C).permute(1, 2, 0)
    pairs = torch.stack([grid(a11r), grid(a11i)], dim=-1).reshape(blocks, 2 * C * ks)
    chunk = _image_reals(C * ks, a11r.element_size())
    tail = torch.zeros(blocks, chunk - 3 * C * ks, dtype=a11r.dtype, device=a11r.device)
    return torch.cat([pairs, grid(invdet).reshape(blocks, C * ks), tail], dim=1).contiguous()


def pack_heat_constants(prob) -> HeatConstants:
    """Host float64 constant packing of a heat problem
    (``pallas_heat.py:134-182``) without the Pallas column padding and its
    two spare colc rows: the kernel guards ``j < n`` itself. Adds the
    schedule of the shape (:func:`heat_schedule`) and the slab kernel's
    copies: the padded phase table and, for a slab schedule, the constant
    image."""
    N_t = prob.config.N_t
    K = N_t // 2 + 1
    _, muM64, _, a11_h, tm_h, det_h = prob._plan()
    G_h = prob._capacity_2x2()
    colc = np.stack([muM64, tm_h[0], G_h[:, 0, 0], G_h[:, 0, 1], G_h[:, 1, 0], G_h[:, 1, 1]])

    k = np.arange(K)
    wgt = pairing_weights(N_t)
    phases = np.zeros((K, 8))
    for col, (i, sign, scale) in enumerate(
        [
            (N_t - 1, -1, None),  # phi_uN (weighted extraction)
            (0, -1, None),  # phi_p1
            (0, 1, 1.0 / N_t),  # psi_u1 (injection)
            (N_t - 1, 1, 1.0 / N_t),  # psi_pN
        ]
    ):
        z = np.exp(sign * 2j * np.pi * i * k / N_t)
        z = z * (wgt if scale is None else scale)
        phases[:, 2 * col] = z.real
        phases[:, 2 * col + 1] = z.imag

    put = lambda a: to_device(a, prob.config.dtype, prob.device)
    a11r, a11i, invdet = put(a11_h[:K].real), put(a11_h[:K].imag), put(1.0 / det_h[:K])
    schedule = heat_schedule(K, a11r.shape[1], a11r.element_size())
    if schedule.kind == "slab":
        image = _slab_image(a11r, a11i, invdet, schedule)
    else:
        image = a11r.new_zeros(0, 0)
    phases = put(phases)
    table = torch.nn.functional.pad(phases, (0, 16 // phases.element_size()))
    return HeatConstants(
        a11r=a11r, a11i=a11i, invdet=invdet, colc=put(colc), phases=phases, schedule=schedule, table=table, image=image
    )


def fused_heat_reference(b_hat: torch.Tensor, c: HeatConstants, refine: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: the Pallas kernel body
    (``pallas_heat.py:42-113``) on split real (K, n) planes. ``b_hat`` is a
    (2, K, n) or (B, 2, K, n) complex tensor; returns the same."""
    br = torch.view_as_real(b_hat)
    bur, bui = br[..., 0, :, :, 0], br[..., 0, :, :, 1]
    bpr, bpi = br[..., 1, :, :, 0], br[..., 1, :, :, 1]
    a11r, a11i, invdet = c.a11r, c.a11i, c.invdet
    m1, tm1, g00, g01, g10, g11 = (c.colc[i] for i in range(6))
    ph = [c.phases[:, i : i + 1] for i in range(8)]

    def d_inv(ur, ui, pr, pi):
        # yu = (conj(a11) u + tm p) / det ; yp = (a11 p - tm u) / det
        yur = (a11r * ur + a11i * ui + tm1 * pr) * invdet
        yui = (a11r * ui - a11i * ur + tm1 * pi) * invdet
        ypr = (a11r * pr - a11i * pi - tm1 * ur) * invdet
        ypi = (a11r * pi + a11i * pr - tm1 * ui) * invdet
        return yur, yui, ypr, ypi

    def extract(ur, ui, pr, pi):
        # Real part of sum_k phi_k y_k, pairing weights folded into phi.
        uN = torch.sum(ph[0] * ur - ph[1] * ui, dim=-2)
        p1 = torch.sum(ph[2] * pr - ph[3] * pi, dim=-2)
        return uN, p1

    def psi_outer(wu, wp):
        # psi (x) w: u row 0 and p row N_t - 1 (w real per wavenumber)
        wu, wp = wu[..., None, :], wp[..., None, :]
        return ph[4] * wu, ph[5] * wu, ph[6] * wp, ph[7] * wp

    def wb_apply(rur, rui, rpr, rpi):
        yur, yui, ypr, ypi = d_inv(rur, rui, rpr, rpi)
        z0, z1 = extract(yur, yui, ypr, ypi)
        dur, dui, dpr, dpi = d_inv(*psi_outer(g00 * z0 + g01 * z1, g10 * z0 + g11 * z1))
        return yur - dur, yui - dui, ypr - dpr, ypi - dpi

    def a_hat(ur, ui, pr, pi):
        # D x (a22 = conj(a11); tm real), then the rank-2 injection.
        dur = a11r * ur - a11i * ui - tm1 * pr
        dui = a11r * ui + a11i * ur - tm1 * pi
        dpr = tm1 * ur + a11r * pr + a11i * pi
        dpi = tm1 * ui + a11r * pi - a11i * pr
        uN, p1 = extract(ur, ui, pr, pi)
        iur, iui, ipr, ipi = psi_outer(m1 * uN, m1 * p1)
        return dur + iur, dui + iui, dpr + ipr, dpi + ipi

    xur, xui, xpr, xpi = wb_apply(bur, bui, bpr, bpi)
    for _ in range(refine):
        aur, aui, apr, api = a_hat(xur, xui, xpr, xpi)
        cur, cui, cpr, cpi = wb_apply(bur - aur, bui - aui, bpr - apr, bpi - api)
        xur, xui = xur + cur, xui + cui
        xpr, xpi = xpr + cpr, xpi + cpi

    out = torch.stack([torch.stack([xur, xui], -1), torch.stack([xpr, xpi], -1)], dim=-4)
    return torch.view_as_complex(out.contiguous())


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the ctypes signatures of a build of ``csrc/heat_woodbury.cu``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.heat_streaming_f32, lib.heat_streaming_f64):
        fn.argtypes = [p] * 7 + [i] * 5 + [p]
        fn.restype = i
    for fn in (lib.heat_slab_f32, lib.heat_slab_f64):
        fn.argtypes = [p] * 8 + [i] * 9 + [p]
        fn.restype = i
    lib.heat_woodbury_error_string.argtypes = [i]
    lib.heat_woodbury_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _kernel_library() -> ctypes.CDLL:
    """The built kernel library, with its ctypes signatures declared."""
    return _declare(load_library(KERNEL_SOURCE).lib)


_STREAMING_SHAPES = {
    "a11r": ("K", "n"),
    "a11i": ("K", "n"),
    "invdet": ("K", "n"),
    "colc": (6, "n"),
    "phases": ("K", 8),
}


def _launch(
    b_hat: torch.Tensor, consts: HeatConstants, refine: int, sched: WoodburySchedule, lib: Optional[ctypes.CDLL] = None
) -> torch.Tensor:
    """Launch the kernel ``sched`` names on CUDA tensors and count it. A slab
    schedule must have the columns and stride the constants' image was
    packed for. ``lib`` is another build of the source (chip_smoke.py's
    profile and plane-load variants), else the library itself."""
    if b_hat.device.type != "cuda":
        raise ValueError(f"the fused heat kernels run on CUDA tensors, got {b_hat.device}")
    lib = lib or _kernel_library()
    if sched.kind == "slab":
        packed = consts.schedule
        if packed.kind != "slab" or (packed.cols, packed.stride) != (sched.cols, sched.stride):
            raise ValueError(f"the constants' slab image is packed for {packed}, not for {sched}")
        if consts.table.data_ptr() % 16 or consts.image.data_ptr() % 16:
            raise ValueError("the slab kernel bulk-copies the phase table and the constant image: "
                             "both must be 16-byte aligned")
        n, itemsize = consts.a11r.shape[1], consts.a11r.element_size()
        fns = {torch.float32: lib.heat_slab_f32, torch.float64: lib.heat_slab_f64}
        shapes = {
            "a11r": ("K", "n"),
            "a11i": ("K", "n"),
            "invdet": ("K", "n"),
            "colc": (6, "n"),
            "table": ("K", 8 + 16 // itemsize),
            "image": (-(-n // sched.cols), _image_reals(sched.cols * sched.stride, itemsize)),
        }
        extra = (sched.cols, sched.lanes, sched.stride, sched.smem_bytes)
    elif sched.kind == "streaming":
        fns = {torch.float32: lib.heat_streaming_f32, torch.float64: lib.heat_streaming_f64}
        shapes, extra = _STREAMING_SHAPES, ()
    else:
        raise ValueError(f"unknown schedule kind {sched.kind!r}")
    x = launch_fused_solve(
        f"heat_{sched.kind}", fns, lib.heat_woodbury_error_string, b_hat, consts, shapes, refine, extra
    )
    fused_heat.launches += 1
    fused_heat.kinds[sched.kind] += 1
    return x


def fused_heat(b_hat: torch.Tensor, consts: HeatConstants, refine: int) -> torch.Tensor:
    """``x = A_hat^{-1} b_hat`` of the heat family on the half spectrum, with
    ``refine`` defect corrections. ``b_hat`` is a contiguous (2, K, n)
    complex tensor, or a batch of them, (B, 2, K, n): one launch for the
    whole batch.

    A CUDA tensor goes to the kernel the constants' schedule names (one
    launch, counted in ``fused_heat.launches`` and by kind in
    ``fused_heat.kinds``); a build failure or a refused or failed launch
    raises. A CPU tensor goes to :func:`fused_heat_reference`."""
    if b_hat.device.type == "cpu":
        return fused_heat_reference(b_hat, consts, refine)
    if b_hat.device.type != "cuda":
        raise ValueError(f"fused_heat runs on CUDA or CPU tensors, got {b_hat.device}")
    return _launch(b_hat, consts, refine, consts.schedule)


fused_heat.launches = 0
fused_heat.kinds = collections.Counter()


def _fused_heat_streaming(b_hat: torch.Tensor, consts: HeatConstants, refine: int) -> torch.Tensor:
    """The streaming kernel at any shape, on CUDA tensors: the yardstick the
    card tests and ``chip_smoke.py`` hold the slab kernel against. No solver
    reaches it."""
    return _launch(b_hat, consts, refine, heat_streaming_schedule(consts.a11r.element_size()))


def build_cuda_heat_solver(prob, refine: int = 1, pack_fft: bool = True) -> Callable[[torch.Tensor], torch.Tensor]:
    """Direct solver ``b -> x`` for a heat problem on a sine-diagonalizable
    space: DST matmul and time FFT (``pack_fft``: one packed complex FFT of
    u + i p, else two rffts) around ONE fused kernel launch for the whole
    rank-2 spectral Woodbury pipeline, ``refine`` included. On a CUDA problem
    the kernel is built (from ``csrc/heat_woodbury.cu``) here."""
    require_full_fp32_matmul()
    if not prob.space.diagonalizable:
        raise ValueError("the fused heat kernel needs a sine-diagonalizable space")
    consts = pack_heat_constants(prob)
    if prob.device.type == "cuda":
        _kernel_library()
    to_spectral, from_spectral = make_halfspectrum_transforms(
        prob.space, prob.config.N_t, prob.config.dtype, time_transform="fft2" if pack_fft else "fft"
    )

    def solve(b: torch.Tensor) -> torch.Tensor:
        return from_spectral(fused_heat(to_spectral(b), consts, refine))

    return solve
