"""The heat family's fused half-spectrum Woodbury solve as ONE hand-written
CUDA kernel.

The counterpart of ``optimal_control_paradiag_tpu/paradiag/pallas_heat.py``,
shaped like :mod:`paradiag.cuda_woodbury` (the wave family's kernel) at
rank 2: D^{-1}, the extractions phi_uN and phi_p1, the real 2x2 capacity mix,
the injections psi_u1 and psi_pN, D^{-1}, then per ``refine`` step the exact
operator A_hat = D + (m1 uN, m1 p1) injected and a second Woodbury pass. The
kernel (``csrc/heat_woodbury.cu``) does all of it, ``b_hat -> x``, in one
launch; its source comment gives the design.

``csrc/heat_woodbury.cu`` holds the slab and the streaming kernel of
:mod:`paradiag.fused`, which holds what the wave family shares: the
schedule rule, the argument checks, the launch and the direct solver. The
heat slab kernel brings in each block's constants with one bulk copy from
an image packed for it. This module holds what is the heat family's own,
in the order the solve uses it:

- :data:`KERNEL`: the source as ``fused`` launches it, with the slab's
  shared memory (:func:`_heat_slab_bytes`);
- :func:`pack_heat_constants`: a11r, a11i, invdet per (k, j) from the
  float64 host plan, the per-column rows m1, tm1, G00, G01, G10, G11 and the
  phases, in the working dtype on the problem's device; the schedule of the
  shape; and the slab kernel's copies, laid out as it keeps them in shared
  memory: the phase table padded per bin, and a11r, a11i, invdet in one
  image chunk per block (:func:`_slab_image`);
- :func:`fused_heat`: the wrapper, one ``fused/b2`` span. On a CUDA tensor
  it launches the kernel the constants' schedule names (and counts the
  launch in ``utils.timing.counters['b2.launches']``, and by kind in
  ``'b2.launches.<kind>'``); on a CPU
  tensor it runs :func:`fused_heat_reference`, the plain PyTorch twin of the
  kernel body on the same (K, n) constants;
- :func:`build_cuda_heat_solver`: ``b -> x``: DST matmul, packed time FFT,
  one kernel launch, inverse packed FFT, inverse DST.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from optimal_control_paradiag_torch.paradiag.fused import (
    FusedKernel,
    WoodburySchedule,
    build_direct_solver,
    dispatch,
    phase_table,
    schedule,
)
from optimal_control_paradiag_torch.utils.constants import to_device
from optimal_control_paradiag_torch.utils.timing import span


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


def _const_shapes(sched: WoodburySchedule, itemsize: int) -> dict:
    """The constants of a launch of ``sched``: the (K, n) planes and the
    rows for the streaming kernel; the planes, the rows, the padded phase
    table and the image chunk of each block for the slab."""
    shapes = {"a11r": ("K", "n"), "a11i": ("K", "n"), "invdet": ("K", "n"), "colc": (6, "n")}
    if sched.kind == "streaming":
        return {**shapes, "phases": ("K", 8)}
    return {**shapes, "table": ("K", 8 + 16 // itemsize),
            "image": ("blocks", _image_reals(sched.cols * sched.stride, itemsize))}


KERNEL = FusedKernel(
    name="heat",
    source="heat_woodbury.cu",
    error_string="heat_woodbury_error_string",
    rank=2,
    slab_bytes=_heat_slab_bytes,
    const_shapes=_const_shapes,
    aligned={"slab": ("table", "image")},  # the slab kernel bulk-copies both
    counters=("b2.launches", "b2.launches.{kind}"),
)


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
    schedule of the shape (``fused.schedule``) and the slab kernel's
    copies: the padded phase table and, for a slab schedule, the constant
    image."""
    N_t = prob.config.N_t
    K = N_t // 2 + 1
    _, muM64, _, a11_h, tm_h, det_h = prob._plan()
    G_h = prob._capacity_2x2()
    colc = np.stack([muM64, tm_h[0], G_h[:, 0, 0], G_h[:, 0, 1], G_h[:, 1, 0], G_h[:, 1, 1]])

    phases = phase_table(
        N_t,
        [
            (N_t - 1, -1, None),  # phi_uN (weighted extraction)
            (0, -1, None),  # phi_p1
            (0, 1, 1.0 / N_t),  # psi_u1 (injection)
            (N_t - 1, 1, 1.0 / N_t),  # psi_pN
        ],
    )

    put = lambda a: to_device(a, prob.config.dtype, prob.device)
    a11r, a11i, invdet = put(a11_h[:K].real), put(a11_h[:K].imag), put(1.0 / det_h[:K])
    sched = schedule(KERNEL, K, a11r.shape[1], a11r.element_size())
    if sched.kind == "slab":
        image = _slab_image(a11r, a11i, invdet, sched)
    else:
        image = a11r.new_zeros(0, 0)
    phases = put(phases)
    table = torch.nn.functional.pad(phases, (0, 16 // phases.element_size()))
    return HeatConstants(
        a11r=a11r, a11i=a11i, invdet=invdet, colc=put(colc), phases=phases, schedule=sched, table=table, image=image
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


def fused_heat(b_hat: torch.Tensor, consts: HeatConstants, refine: int) -> torch.Tensor:
    """``x = A_hat^{-1} b_hat`` of the heat family on the half spectrum, with
    ``refine`` defect corrections. ``b_hat`` is a contiguous (2, K, n)
    complex tensor, or a batch of them, (B, 2, K, n): one launch for the
    whole batch.

    A CUDA tensor goes to the kernel the constants' schedule names (one
    launch, counted in ``counters['b2.launches']`` and by kind in
    ``counters['b2.launches.<kind>']``); a build failure or a refused or
    failed launch raises. A CPU tensor goes to :func:`fused_heat_reference`.
    Either is one ``fused/b2`` span."""
    with span("fused/b2"):
        return dispatch(KERNEL, b_hat, consts, refine, fused_heat_reference)


def build_cuda_heat_solver(prob, refine: int = 1) -> Callable[[torch.Tensor], torch.Tensor]:
    """Direct solver ``b -> x`` for a heat problem on a sine-diagonalizable
    space (``fused.build_direct_solver``): ONE fused kernel launch, from
    ``csrc/heat_woodbury.cu``, between the packed transforms."""
    if not prob.space.diagonalizable:
        raise ValueError("the fused heat kernel needs a sine-diagonalizable space")
    return build_direct_solver(KERNEL, prob.space, prob.config.N_t, prob.config.dtype,
                               lambda: pack_heat_constants(prob), fused_heat, refine)
