"""Time-axis and space-axis Fourier transforms (PyTorch).

The counterpart of ``optimal_control_paradiag_tpu/ops/transforms.py``. Three
families, all with the numpy fft conventions of the JAX package:

- **DFT-by-matmul**: F = C +- iS with real cos/sin matrices, applied as real
  matmuls on the split (re, im) parts over the time axis of ``(..., N_t, n)``
  states (dim -2; leading axes are a batch) (``dft_matrices``, ``time_ifft_mm``, ...);
- **four-step** (Cooley-Tukey N = a*b): the half-spectrum time transforms
  (``FourStepPlan``) and the DST-I over the last axis (``DstFourStepPlan``)
  as two small-radix real matmul stages with a twiddle multiply between;
- **two-for-one ("packed")**: the half-spectrum pipeline transforms a REAL
  pair (u, p); packing z = u + i p runs ONE complex FFT over the time axis
  instead of two real rffts, and the two half-spectra split out by
  Hermitian symmetry (the pack, split, merge and unpack around cuFFT:
  ``ops/time_pack.py``, a hand-written CUDA kernel each on the card).

Conventions of the half-spectrum transforms (c in {u, p}):

  forward:  xi_c = conj(rfft(s_c, axis=-2)) / N
  inverse:  t_c  = irfft(conj(xi_c), n=N, axis=-2) * N

The matrices are built in float64 numpy, cast once to the working dtype and
copied to the device once. Every matmul runs in full float32 (or float64),
except the plans' radix products with ``precision='high'`` in float32: the
JAX package's ``Precision.HIGH``, the bf16x3 product of ``ops/bf16x3.py``
(its kernel on the card). The port takes the precision as a string
(``None`` or ``'highest'``: full precision; ``'high'``) where the JAX
package takes a ``jax.lax.Precision``; anything else raises ``ValueError``.
The plans refuse TF32 as the solver builders do. On the card the FFTs are
cuFFT and the full-precision matmuls cuBLAS: library work, as XLA lowered
them to library calls for the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from optimal_control_paradiag_torch.fem.space import require_full_fp32_matmul
from optimal_control_paradiag_torch.ops import time_pack
from optimal_control_paradiag_torch.ops.bf16x3 import bf16x3_matmul, split_matrix
from optimal_control_paradiag_torch.utils.constants import resolve_device, to_device


def _radix_splits(plan, precision, rdtype, names) -> dict:
    """Check a plan's ``precision`` (``None``, ``'highest'`` or ``'high'``)
    and return the bf16x3 splits of the transposed radix matrices ``names``
    where the plan's products run in bf16x3 (``'high'`` in float32), else
    an empty dict."""
    if precision not in (None, "highest", "high"):
        raise ValueError(f"precision must be None, 'highest' or 'high', got {precision!r}")
    require_full_fp32_matmul()
    if precision != "high" or rdtype != torch.float32:
        return {}
    return {name: split_matrix(getattr(plan, name).T.contiguous()) for name in names}


def _radix(p, eq: str, name: str, x: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, M, x)`` for the plan's radix matrix ``M =
    p.<name>``, ``eq`` of the form ``'XY,...<x>->...<out>'`` (Y contracted,
    X placed where ``out`` says). In bf16x3 the contracted axis is moved
    last and the product taken as ``x @ M^T`` on the kernel's rows."""
    split = p.splits.get(name)
    if split is None:
        return torch.einsum(eq, getattr(p, name), x)
    lhs, rhs = eq.split("->")
    m_idx, x_idx = lhs.split(",")
    x_idx, out = x_idx[3:], rhs[3:]  # past the '...'
    assert x_idx.replace(m_idx[1], "") == out.replace(m_idx[0], ""), eq
    y = x.movedim(x_idx.index(m_idx[1]) - len(x_idx), -1).contiguous()
    z = bf16x3_matmul(y.reshape(-1, y.shape[-1]), split).reshape(y.shape[:-1] + (split.n,))
    return z.movedim(-1, out.index(m_idx[0]) - len(out))


def dft_matrices(N: int, dtype, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Constants ``C[k, j] = cos(2 pi j k / N)``, ``S[k, j] = sin(...)`` on
    ``device``."""
    k = np.arange(N)
    ang = 2.0 * np.pi * np.outer(k, k) / N
    dev = resolve_device(device)
    return to_device(np.cos(ang), dtype, dev), to_device(np.sin(ang), dtype, dev)


def _apply(C, S, xr, xi, sign: int, scale: float):
    """(C + sign*i*S)(xr + i*xi) * scale over the time axis (dim -2 of
    ``(..., N_t, n)`` states), as real contractions."""
    cr = torch.einsum("kt,...tn->...kn", C, xr)
    ci = torch.einsum("kt,...tn->...kn", C, xi)
    sr = torch.einsum("kt,...tn->...kn", S, xr)
    si = torch.einsum("kt,...tn->...kn", S, xi)
    re = cr - sign * si
    im = ci + sign * sr
    return re * scale, im * scale


def time_ifft_mm(x: torch.Tensor, C, S) -> torch.Tensor:
    """numpy ``ifft`` over the time axis: (1/N)(C + iS) applied to complex x."""
    N = C.shape[0]
    re, im = _apply(C, S, x.real, x.imag, sign=+1, scale=1.0 / N)
    return torch.complex(re, im)


def time_fft_mm(x: torch.Tensor, C, S) -> torch.Tensor:
    """numpy ``fft`` over the time axis: (C - iS) applied to complex x."""
    re, im = _apply(C, S, x.real, x.imag, sign=-1, scale=1.0)
    return torch.complex(re, im)


def time_ifft_real_mm(x: torch.Tensor, C, S) -> torch.Tensor:
    """ifft of a REAL x: two matmuls instead of four."""
    N = C.shape[0]
    re = torch.einsum("kt,...tn->...kn", C, x) * (1.0 / N)
    im = torch.einsum("kt,...tn->...kn", S, x) * (1.0 / N)
    return torch.complex(re, im)


def time_fft_real_part_mm(x: torch.Tensor, C, S) -> torch.Tensor:
    """real(fft(x)) for complex x: two matmuls (the imaginary output is
    discarded by the ParaDiag apply anyway)."""
    return torch.einsum("kt,...tn->...kn", C, x.real) + torch.einsum("kt,...tn->...kn", S, x.imag)


# ---------------------------------------------------------------------------
# Four-step (Cooley-Tukey N = a*b) time transforms as small-radix matmuls
# ---------------------------------------------------------------------------
#
# Derivation (t = t1 + a*t2, k = k1*b + k2, omega = e^{+2 pi i / N} -- the
# CONJUGATED-forward sign):
#   X[k2 + b*k1] = sum_{t1} omega_a^{t1 k1} [ omega_N^{t1 k2} *
#                  sum_{t2} omega_b^{t2 k2} x[t1 + a t2] ]
# i.e. stage 1 = radix-b DFT over t2, twiddle, stage 2 = radix-a DFT over
# t1; the inverse factorizes symmetrically after Hermitian extension of the
# conjugated half spectrum. All matrices are real cos/sin constants and the
# complex arithmetic is explicit split-real, as in the JAX package.


def factor_pair(N: int) -> Tuple[int, int]:
    """(a, b) with a*b = N and a <= b as close to sqrt(N) as N's divisors
    allow (a is the stage-2 radix, b the stage-1 radix)."""
    a = int(np.sqrt(N))
    while a > 1 and N % a:
        a -= 1
    return a, N // a


class FourStepPlan:
    """The matrices of the four-step time transforms for one (N, dtype) on
    ``device``. Build once at setup; raises ``ValueError`` for a prime N
    (no nontrivial radix split). ``precision``: the radix products' (module
    note); with ``'high'`` in float32 their matrices are split once here."""

    def __init__(self, N: int, rdtype, precision=None, device="cuda"):
        a, b = factor_pair(N)
        if a < 2:
            raise ValueError(f"N={N} has no nontrivial factorization; use the fft path")
        self.N, self.a, self.b, self.K = N, a, b, N // 2 + 1
        dev = resolve_device(device)
        c = lambda v: to_device(v, rdtype, dev)
        tb = np.arange(b)
        ta = np.arange(a)
        # stage-1 forward: radix-b DFT over t2, scaled by 1/N (fold the rfft
        # conj convention's 1/N here, where the operand is still real).
        ang_b = 2.0 * np.pi * np.outer(tb, tb) / b
        self.Cb = c(np.cos(ang_b) / N)
        self.Sb = c(np.sin(ang_b) / N)
        # twiddle W[k2, t1] = omega_N^{k2 t1}
        ang_w = 2.0 * np.pi * np.outer(tb, ta) / N
        self.Wre = c(np.cos(ang_w))
        self.Wim = c(np.sin(ang_w))
        # stage-2 forward: radix-a DFT over t1
        ang_a = 2.0 * np.pi * np.outer(ta, ta) / a
        self.Ca = c(np.cos(ang_a))
        self.Sa = c(np.sin(ang_a))
        # inverse reuses the same (unscaled) radix matrices; the forward's
        # 1/N and the inverse's *N cancel by construction.
        self.Cb1 = c(np.cos(ang_b))
        self.Sb1 = c(np.sin(ang_b))
        self.precision = precision
        self.splits = _radix_splits(self, precision, rdtype, ("Cb", "Sb", "Ca", "Sa", "Cb1", "Sb1"))


def time_rfft_conj_mm4(x: torch.Tensor, p: FourStepPlan) -> torch.Tensor:
    """``conj(rfft(x, axis=-2)) / N`` of a real ``(..., N, n)`` state via the
    four-step factorization (module note). Returns ``(..., K, n)`` complex."""
    lead, (N, n) = x.shape[:-2], x.shape[-2:]
    x4 = x.reshape(lead + (p.b, p.a, n))  # [t2, t1]
    yre = _radix(p, "KT,...Tan->...Kan", "Cb", x4)
    yim = _radix(p, "KT,...Tan->...Kan", "Sb", x4)
    wre, wim = p.Wre[:, :, None], p.Wim[:, :, None]
    zre = yre * wre - yim * wim
    zim = yre * wim + yim * wre
    Xre = _radix(p, "AT,...KTn->...AKn", "Ca", zre) - _radix(p, "AT,...KTn->...AKn", "Sa", zim)
    Xim = _radix(p, "AT,...KTn->...AKn", "Ca", zim) + _radix(p, "AT,...KTn->...AKn", "Sa", zre)
    out = lambda X: X.reshape(lead + (N, n))[..., : p.K, :]
    return torch.complex(out(Xre), out(Xim))


def time_irfft_conj_mm4(xi: torch.Tensor, p: FourStepPlan) -> torch.Tensor:
    """``irfft(conj(xi), n=N, axis=-2) * N`` of a ``(..., K, n)`` half
    spectrum via the four-step factorization; returns the real
    ``(..., N, n)`` state."""
    lead, (K, n) = xi.shape[:-2], xi.shape[-2:]
    N = p.N
    # Hermitian extension of conj(xi): Z[k] = conj(xi)[k] for k < K,
    # Z[N-k] = xi[k] for the mirrored bins (works for N odd and even).
    mre, mim = xi.real[..., 1 : N - K + 1, :], xi.imag[..., 1 : N - K + 1, :]
    Zre = torch.cat([xi.real, torch.flip(mre, dims=(-2,))], dim=-2)
    Zim = torch.cat([-xi.imag, torch.flip(mim, dims=(-2,))], dim=-2)
    Z4re = Zre.reshape(lead + (p.a, p.b, n))  # [k1, k2]
    Z4im = Zim.reshape(lead + (p.a, p.b, n))
    # stage 1: radix-a DFT over k1 (output index t1)
    are = _radix(p, "TA,...AKn->...TKn", "Ca", Z4re) - _radix(p, "TA,...AKn->...TKn", "Sa", Z4im)
    aim = _radix(p, "TA,...AKn->...TKn", "Ca", Z4im) + _radix(p, "TA,...AKn->...TKn", "Sa", Z4re)
    # twiddle W[k2, t1] applied as [t1, k2]
    wre = p.Wre.T[:, :, None]
    wim = p.Wim.T[:, :, None]
    bre = are * wre - aim * wim
    bim = are * wim + aim * wre
    # stage 2: radix-b DFT over k2, REAL part only (output index t2)
    out = _radix(p, "TK,...tKn->...Ttn", "Cb1", bre) - _radix(p, "TK,...tKn->...Ttn", "Sb1", bim)
    return out.reshape(lead + (N, n))


# ---------------------------------------------------------------------------
# Four-step DST-I over the LAST axis (the spatial sine transform)
# ---------------------------------------------------------------------------
#
# DST-I(x)_k = -0.5 Im fft([0, x, 0, -flip(x)])_{k+1} (the odd-extension
# identity, length N = 2 N_x), and that FFT factorizes into two
# radix-~sqrt(N) real matmul stages exactly like the time transform above:
# O(N_x^1.5) flops per row instead of O(N_x^2), and only the IMAGINARY part
# of the final stage is computed (2 matmuls). Conventions match
# fem/space.P1Space.dst (V[i,j] = sin((i+1)(j+1)pi/N_x)).


class DstFourStepPlan:
    """The matrices of the four-step DST-I for one (N_x, dtype) on
    ``device``; ``precision`` as :class:`FourStepPlan`'s."""

    def __init__(self, N_x: int, rdtype, precision=None, device="cuda"):
        N = 2 * N_x
        a, b = factor_pair(N)
        if a < 2:
            raise ValueError(f"2*N_x={N} has no nontrivial factorization")
        self.N_x, self.N, self.a, self.b = N_x, N, a, b
        dev = resolve_device(device)
        c = lambda v: to_device(v, rdtype, dev)
        tb = np.arange(b)
        ta = np.arange(a)
        ang_b = 2.0 * np.pi * np.outer(tb, tb) / b
        self.Cb = c(np.cos(ang_b))
        self.Sb = c(np.sin(ang_b))
        ang_w = 2.0 * np.pi * np.outer(tb, ta) / N  # W[k2, t1]
        self.Wre = c(np.cos(ang_w))
        self.Wim = c(np.sin(ang_w))
        ang_a = 2.0 * np.pi * np.outer(ta, ta) / a
        self.Ca = c(np.cos(ang_a))
        self.Sa = c(np.sin(ang_a))
        self.precision = precision
        self.splits = _radix_splits(self, precision, rdtype, ("Cb", "Sb", "Ca", "Sa"))


def dst1_mm4(x: torch.Tensor, p: DstFourStepPlan) -> torch.Tensor:
    """DST-I of a REAL tensor over its last axis (length N_x - 1) via the
    odd-extension four-step factorization; equals
    ``x @ sin((i+1)(j+1)pi/N_x)`` to rounding."""
    n = p.N_x - 1
    z = x.new_zeros(x.shape[:-1] + (1,))
    ext = torch.cat([z, x, z, -torch.flip(x, dims=(-1,))], dim=-1)
    e4 = ext.reshape(x.shape[:-1] + (p.b, p.a))  # [t2, t1]
    # stage 1: radix-b DFT over t2, sign - (numpy fft): (Cb - i Sb) e
    yre = _radix(p, "KT,...Ta->...Ka", "Cb", e4)
    yim = -_radix(p, "KT,...Ta->...Ka", "Sb", e4)
    # twiddle e^{-2 pi i k2 t1 / N} = Wre - i Wim
    zre = yre * p.Wre + yim * p.Wim
    zim = yim * p.Wre - yre * p.Wim
    # stage 2: radix-a DFT over t1, imaginary part only:
    # Im((Ca - i Sa)(zre + i zim)) = Ca zim - Sa zre
    Xim = _radix(p, "AT,...KT->...AK", "Ca", zim) - _radix(p, "AT,...KT->...AK", "Sa", zre)
    X = Xim.reshape(x.shape[:-1] + (p.N,))  # a copy where the einsum left [A, K] strided
    return -0.5 * X[..., 1 : n + 1]


# ---------------------------------------------------------------------------
# Two-for-one ("packed") half-spectrum time transforms
# ---------------------------------------------------------------------------


def _packed_fft(s: torch.Tensor) -> torch.Tensor:
    """``fft(s0 + i s1)`` over the time axis of a real ``(..., 2, N, n)``
    pair: the one complex FFT of the two-for-one transform."""
    return torch.fft.fft(torch.complex(s[..., 0, :, :], s[..., 1, :, :]), dim=-2)


def _packed_ifft(Z: torch.Tensor) -> torch.Tensor:
    """The real ``(..., 2, N, n)`` pair ``[re, im]`` of ``ifft(Z)`` over the
    time axis: the one complex inverse FFT of the two-for-one transform."""
    z = torch.fft.ifft(Z, dim=-2)
    return torch.stack([z.real, z.imag], dim=-3)


def time_rfft_conj_packed(s: torch.Tensor, N: int) -> torch.Tensor:
    """``conj(rfft(s, axis=-2))/N`` of a real ``(..., 2, N, n)`` pair via one
    packed complex FFT; returns a contiguous ``(..., 2, K, n)`` complex
    tensor. On the card three launches: ``ops.time_pack.pack`` writes the
    buffer cuFFT's plan reads, cuFFT, ``ops.time_pack.split`` (``s`` is
    made contiguous first, a copy only where the sine transform left it
    strided); bitwise :func:`_time_rfft_conj_packed_reference`, which the
    CPU runs."""
    if s.device.type != "cuda":
        return _time_rfft_conj_packed_reference(s, N)
    return time_pack.split(torch.fft.fft(time_pack.pack(s.contiguous()), dim=-2), N)


def time_irfft_conj_packed(xi: torch.Tensor, N: int) -> torch.Tensor:
    """``irfft(conj(xi_c), n=N, axis=-2) * N`` for the ``(..., 2, K, n)``
    pair via one packed complex inverse FFT; returns the contiguous real
    ``(..., 2, N, n)`` pair. On the card three launches:
    ``ops.time_pack.merge`` writes the buffer cuFFT's plan reads, cuFFT
    unnormalised, ``ops.time_pack.unpack`` (the 1/N and the real pair);
    bitwise :func:`_time_irfft_conj_packed_reference`, which the CPU runs."""
    if xi.device.type != "cuda":
        return _time_irfft_conj_packed_reference(xi, N)
    return time_pack.unpack(torch.fft.ifft(time_pack.merge(xi, N), dim=-2, norm="forward"), N)


def _time_rfft_conj_packed_reference(s: torch.Tensor, N: int) -> torch.Tensor:
    """:func:`time_rfft_conj_packed` in plain PyTorch on every device:
    ``torch.complex``, the FFT and the eager split
    (``time_pack.split_reference``)."""
    return time_pack.split_reference(_packed_fft(s), N)


def _time_irfft_conj_packed_reference(xi: torch.Tensor, N: int) -> torch.Tensor:
    """:func:`time_irfft_conj_packed` in plain PyTorch on every device: the
    eager merge (``time_pack.merge_reference``), the normalised inverse FFT
    and ``stack``."""
    return _packed_ifft(time_pack.merge_reference(xi, N))
