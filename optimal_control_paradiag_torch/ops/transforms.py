"""Two-for-one ("packed") half-spectrum time transforms on ``torch.fft``.

The counterpart of ``time_rfft_conj_packed`` / ``time_irfft_conj_packed`` in
``optimal_control_paradiag_tpu/ops/transforms.py``. The half-spectrum
pipeline transforms a REAL pair (u, p): packing z = u + i p runs ONE complex
FFT over the time axis instead of two real rffts, and the two half-spectra
split out by Hermitian symmetry. Conventions (c in {u, p}):

  forward:  xi_c = conj(rfft(s_c, axis=1)) / N
  inverse:  t_c  = irfft(conj(xi_c), n=N, axis=1) * N

On the card these are cuFFT calls: library work, as XLA lowered them to a
library FFT for the JAX package.
"""

from __future__ import annotations

import torch


def time_rfft_conj_packed(s: torch.Tensor, N: int) -> torch.Tensor:
    """``conj(rfft(s, axis=1))/N`` of a real ``(2, N, n)`` pair via one
    packed complex FFT; returns a contiguous ``(2, K, n)`` complex tensor."""
    K = N // 2 + 1
    Z = torch.fft.fft(torch.complex(s[0], s[1]), dim=0)
    # Zm[k] = conj(Z[(N - k) % N])
    Zm = torch.roll(torch.flip(Z, dims=(0,)), 1, dims=0).conj()
    R0 = 0.5 * (Z + Zm)  # rfft(s0), all N bins (Hermitian)
    R1 = -0.5j * (Z - Zm)  # rfft(s1)
    return torch.stack([R0[:K].conj(), R1[:K].conj()]) * (1.0 / N)


def time_irfft_conj_packed(xi: torch.Tensor, N: int) -> torch.Tensor:
    """``irfft(conj(xi_c), n=N, axis=1) * N`` for the ``(2, K, n)`` pair via
    one packed complex inverse FFT; returns the real ``(2, N, n)`` pair."""
    K = xi.shape[1]
    a, b = xi[0].conj(), xi[1].conj()
    W = (a + 1j * b) * N  # R0 + i R1, bins < K
    W2 = (a - 1j * b) * N  # R0 - i R1
    mirror = torch.flip(W2[1 : N - K + 1].conj(), dims=(0,))  # bins K..N-1
    z = torch.fft.ifft(torch.cat([W, mirror], dim=0), dim=0)
    return torch.stack([z.real, z.imag])
