"""The fused half-spectrum Woodbury solve as ONE hand-written CUDA kernel.

The counterpart of ``optimal_control_paradiag_tpu/paradiag/pallas_woodbury.py``.
The plain half-spectrum solve (``paradiag/spectral.py``) spends its
non-transform time in ~30 elementwise passes over the ``(K, n)`` spectral
state (K = N_t//2 + 1): D^{-1}, 4 slice extractions, the 4x4 capacity mix,
rank-1 injections, D^{-1}, then per ``refine`` step the exact operator A_hat
and a second Woodbury pass. The kernel (``csrc/woodbury.cu``) does all of it,
``b_hat -> x``, in one launch; its source comment gives the design.

``csrc/woodbury.cu`` holds the slab and the streaming kernel of
:mod:`paradiag.fused`, which holds what the heat family shares: the
schedule rule, the argument checks, the launch and the direct solver. This
module holds what is the wave family's own, in the order the solve uses
it:

- :func:`pack_constants`: the per-(k, j) constants a11r, a11i, invdet (from
  the float64 a11/det, then cast), the per-column rows m1, kap1, tm1, mk1,
  the capacity matrices G and the phases, in the working dtype on the
  operator's device;
- :data:`KERNEL`: the source as ``fused`` launches it, with the slab's
  shared memory (:func:`_slab_bytes`);
- :func:`fused_woodbury`: the wrapper, one ``fused/b1`` span. On a CUDA
  tensor it launches the kernel the schedule names (and counts the launch
  in ``utils.timing.counters['b1.launches']``); on a CPU tensor it runs
  :func:`fused_woodbury_reference`, the plain PyTorch twin of the kernel
  body on the same packed constants;
- :func:`build_cuda_woodbury_solver`: ``b -> x``: DST matmul, packed time
  FFT, one kernel launch, inverse packed FFT, inverse DST.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from optimal_control_paradiag_torch.ops.allatonce import AllAtOnceOperator
from optimal_control_paradiag_torch.paradiag.fused import (
    FusedKernel,
    build_direct_solver,
    dispatch,
    phase_table,
)
from optimal_control_paradiag_torch.paradiag.spectral import _real_capacity_matrices, _spectral_plan
from optimal_control_paradiag_torch.utils.constants import to_device
from optimal_control_paradiag_torch.utils.timing import span


@dataclasses.dataclass(frozen=True)
class WoodburyConstants:
    """Packed constants of the fused solve, working dtype, one device."""

    a11r: torch.Tensor  # (K, n) Re a11
    a11i: torch.Tensor  # (K, n) Im a11
    invdet: torch.Tensor  # (K, n) 1 / (|a11|^2 + tm^2)
    colc: torch.Tensor  # (4, n) rows m1, kap1, tm1, mk1
    gc: torch.Tensor  # (16, n) G[a][b] of column j at row 4a + b
    phases: torch.Tensor  # (K, 16) phi (weighted extraction) and psi (injection), re/im


def pack_constants(op: AllAtOnceOperator, mass_surrogate: bool = False) -> WoodburyConstants:
    """Host float64 constant packing (``pallas_woodbury.py:157-222``) without
    the Pallas column padding: the kernel guards ``j < n`` itself.
    ``mass_surrogate=True``: the constants of the tensor-mass surrogate
    (``_spectral_plan(op, mass_surrogate=True)``), the operator the kernel
    then solves exactly on the 2D consistent mass."""
    plan = _spectral_plan(op, mass_surrogate=mass_surrogate)
    N_t, n = plan.N_t, plan.n
    K = N_t // 2 + 1
    rdtype, dev = plan.rdtype, plan.device
    a11_h = plan.a11_h[:K]
    det_h = plan.det_h[:K]
    muM, muK = plan.muM64, plan.muK64
    colc = np.stack([muM, plan.c * muK, plan.theta * muM, muM + plan.c * muK])

    gc = _real_capacity_matrices(plan).transpose(1, 2, 0).reshape(16, n)

    phases = phase_table(
        N_t,
        [
            (N_t - 1, -1, None),  # phi_uNm1 (weighted)
            (N_t - 2, -1, None),  # phi_uNm2
            (0, -1, None),  # phi_p0
            (1, -1, None),  # phi_p1
            (0, 1, 1.0 / N_t),  # psi_u0
            (1, 1, 1.0 / N_t),  # psi_u1
            (N_t - 1, 1, 1.0 / N_t),  # psi_pNm1
            (N_t - 2, 1, 1.0 / N_t),  # psi_pNm2
        ],
    )

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


def _slab_bytes(K: int, cols: int, lanes: int, stride: int, itemsize: int) -> int:
    """Shared memory of a slab block, as ``csrc/woodbury.cu:slab_bytes``: the
    phase table (the 16 phases of a bin and 16 bytes of padding per bin), 11
    reals per bin of each column (b and x complex, a11 complex, invdet), and
    two buffers of cross-warp partials when a column spans several warps."""
    red = 2 * cols * (lanes // 32) * 4 * itemsize if lanes > 32 else 0
    return (cols * stride * 11 + (16 + 16 // itemsize) * K) * itemsize + red


_CONST_SHAPES = {
    "a11r": ("K", "n"),
    "a11i": ("K", "n"),
    "invdet": ("K", "n"),
    "colc": (4, "n"),
    "gc": (16, "n"),
    "phases": ("K", 16),
}

KERNEL = FusedKernel(
    name="woodbury",
    source="woodbury.cu",
    error_string="woodbury_error_string",
    rank=4,
    slab_bytes=_slab_bytes,
    const_shapes=lambda sched, itemsize: _CONST_SHAPES,
    aligned={"slab": ("phases",)},  # the slab kernel copies the phase table in 16-byte pieces
    counters=("b1.launches",),
)


def fused_woodbury(b_hat: torch.Tensor, consts: WoodburyConstants, refine: int) -> torch.Tensor:
    """``x = A_hat^{-1} b_hat`` on the half spectrum, with ``refine`` defect
    corrections. ``b_hat`` is a contiguous (2, K, n) complex tensor, or a
    batch of them, (B, 2, K, n).

    A CUDA tensor goes to the kernel ``fused.schedule`` picks for its
    shape: one launch for the whole batch, counted once in
    ``counters['b1.launches']``; a build failure or a refused or failed
    launch raises. A CPU tensor goes to :func:`fused_woodbury_reference`.
    Either is one ``fused/b1`` span."""
    with span("fused/b1"):
        return dispatch(KERNEL, b_hat, consts, refine, fused_woodbury_reference)


def build_cuda_woodbury_solver(op: AllAtOnceOperator, refine: int = 1,
                               mass_surrogate: bool = False) -> Callable[[torch.Tensor], torch.Tensor]:
    """Direct solver ``b -> x`` (``fused.build_direct_solver``): ONE fused
    kernel launch, from ``csrc/woodbury.cu``, between the packed transforms.
    ``mass_surrogate=True``: the exact solve of the tensor-mass surrogate
    (:func:`pack_constants`), the preconditioner of the 2D consistent
    mass's tensor GMRES."""
    return build_direct_solver(KERNEL, op.space, op.N_t, op.space.dtype,
                               lambda: pack_constants(op, mass_surrogate=mass_surrogate), fused_woodbury, refine)
