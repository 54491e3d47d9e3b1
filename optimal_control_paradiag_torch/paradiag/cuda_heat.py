"""The heat family's fused half-spectrum Woodbury solve as ONE hand-written
CUDA kernel.

The counterpart of ``optimal_control_paradiag_tpu/paradiag/pallas_heat.py``,
shaped like :mod:`paradiag.cuda_woodbury` (the wave family's kernel) at
rank 2: D^{-1}, the extractions phi_uN and phi_p1, the real 2x2 capacity mix,
the injections psi_u1 and psi_pN, D^{-1}, then per ``refine`` step the exact
operator A_hat = D + (m1 uN, m1 p1) injected and a second Woodbury pass. The
kernel (``csrc/heat_woodbury.cu``) does all of it, ``b_hat -> x``, in one
launch; its source comment gives the schedule.

Three pieces, in the order the solve uses them:

- :func:`pack_heat_constants`: a11r, a11i, invdet per (k, j) from the
  float64 host plan, the per-column rows m1, tm1, G00, G01, G10, G11 and the
  phases, in the working dtype on the problem's device;
- :func:`fused_heat`: the wrapper. On a CUDA tensor it launches the kernel
  (and counts the launch in ``fused_heat.launches``); on a CPU tensor it
  runs :func:`fused_heat_reference`, the plain PyTorch twin of the kernel
  body on the same packed constants;
- :func:`build_cuda_heat_solver`: ``b -> x``: DST matmul, packed time FFT,
  one kernel launch, inverse packed FFT, inverse DST.
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
from optimal_control_paradiag_torch.paradiag.spectral import (
    make_halfspectrum_transforms,
    pairing_weights,
)
from optimal_control_paradiag_torch.utils.constants import to_device

KERNEL_SOURCE = "heat_woodbury.cu"


@dataclasses.dataclass(frozen=True)
class HeatConstants:
    """Packed constants of the fused heat solve, working dtype, one device."""

    a11r: torch.Tensor  # (K, n) Re a11
    a11i: torch.Tensor  # (K, n) Im a11
    invdet: torch.Tensor  # (K, n) 1 / (|a11|^2 + tm^2)
    colc: torch.Tensor  # (6, n) rows m1, tm1, G00, G01, G10, G11
    phases: torch.Tensor  # (K, 8) phi_uN, phi_p1 (weighted), psi_u1, psi_pN; re/im


def pack_heat_constants(prob) -> HeatConstants:
    """Host float64 constant packing of a heat problem
    (``pallas_heat.py:134-182``) without the Pallas column padding and its
    two spare colc rows: the kernel guards ``j < n`` itself."""
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
    return HeatConstants(
        a11r=put(a11_h[:K].real),
        a11i=put(a11_h[:K].imag),
        invdet=put(1.0 / det_h[:K]),
        colc=put(colc),
        phases=put(phases),
    )


def fused_heat_reference(b_hat: torch.Tensor, c: HeatConstants, refine: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: the Pallas kernel body
    (``pallas_heat.py:42-113``) on split real (K, n) planes. ``b_hat`` is a
    (2, K, n) complex tensor; returns the same."""
    br = torch.view_as_real(b_hat)
    bur, bui, bpr, bpi = br[0, ..., 0], br[0, ..., 1], br[1, ..., 0], br[1, ..., 1]
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
        uN = torch.sum(ph[0] * ur - ph[1] * ui, dim=0)
        p1 = torch.sum(ph[2] * pr - ph[3] * pi, dim=0)
        return uN, p1

    def psi_outer(wu, wp):
        # psi (x) w: u row 0 and p row N_t - 1 (w real per wavenumber)
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

    out = torch.stack([torch.stack([xur, xui], -1), torch.stack([xpr, xpi], -1)])
    return torch.view_as_complex(out.contiguous())


@functools.lru_cache(maxsize=None)
def _kernel_library() -> ctypes.CDLL:
    """The built kernel library, with its ctypes signatures declared."""
    lib = load_library(KERNEL_SOURCE).lib
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.heat_woodbury_fused_f32, lib.heat_woodbury_fused_f64):
        fn.argtypes = [p] * 7 + [i, i, i, i, p]
        fn.restype = i
    lib.heat_woodbury_error_string.argtypes = [i]
    lib.heat_woodbury_error_string.restype = ctypes.c_char_p
    return lib


def fused_heat(b_hat: torch.Tensor, consts: HeatConstants, refine: int) -> torch.Tensor:
    """``x = A_hat^{-1} b_hat`` of the heat family on the half spectrum, with
    ``refine`` defect corrections. ``b_hat`` is a contiguous (2, K, n)
    complex tensor.

    A CUDA tensor goes to the CUDA kernel (one launch, counted in
    ``fused_heat.launches``); a build or launch failure raises. A CPU tensor
    goes to :func:`fused_heat_reference`."""
    if b_hat.device.type == "cpu":
        return fused_heat_reference(b_hat, consts, refine)
    if b_hat.device.type != "cuda":
        raise ValueError(f"fused_heat runs on CUDA or CPU tensors, got {b_hat.device}")
    lib = _kernel_library()
    x = launch_fused_solve(
        "heat_woodbury_fused",
        {torch.float32: lib.heat_woodbury_fused_f32, torch.float64: lib.heat_woodbury_fused_f64},
        lib.heat_woodbury_error_string,
        b_hat,
        consts,
        {
            "a11r": ("K", "n"),
            "a11i": ("K", "n"),
            "invdet": ("K", "n"),
            "colc": (6, "n"),
            "phases": ("K", 8),
        },
        refine,
    )
    fused_heat.launches += 1
    return x


fused_heat.launches = 0


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
