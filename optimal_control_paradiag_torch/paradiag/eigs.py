"""Circulant time-stencil eigenvalues and the closed-form 2x2 decoupling.

(A copy of ``optimal_control_paradiag_tpu/paradiag/eigs.py``, which is numpy
only: importing it from there would run the JAX package's ``__init__``.)

The ParaDiag preconditioner replaces the Toeplitz time stencils
B1 = [1, -2, 1] (second difference) and B2 = [1, 0, 1] (two-step average) by
their circulant analogues. With ``omega_k = exp(2*pi*i*k/N_t)`` their
eigenvalues are (ref ``Control_Wave_PC.py:387-388``):

    Lambda_1(k) = 1 - 2 omega_k + omega_k^2 = (1 - omega_k)^2
    Lambda_2(k) = 1 + omega_k^2

FFT convention (verified against the reference's apply pipeline, ref
``:499-501, 546-550``, and its ``mat_test.ipynb``): the circulant acting
*forward in time* is ``fft o diag(Lambda(omega)) o ifft`` with numpy-normalized
transforms; the adjoint (backward-in-time) stencils get conjugated eigenvalues.

After row-normalizing by Lambda_2 the per-mode 2x2 (u, p) block is (ref
``:396-398, 414-425``):

    Lambda(k) = [[ m1,  m2 ],      m1 = Lambda_1/Lambda_2   (real),
                 [ m3,  conj(m1) ]]  m2 = -dt^2/(conj(Lambda_2) sqrt(gamma)),
                                      m3 =  dt^2/(Lambda_2 sqrt(gamma)).

Closed-form eigendecomposition (the reference derives it at ``:393-412`` then
overwrites it with a per-mode LAPACK ``eig`` loop at ``:414-437``; here the
closed form -- verified in the reference's ``mat_test.ipynb`` -- is used
directly, fully vectorized, no LAPACK):

    S1 = sqrt(m3/m2), S2 = -conj(S1), |S1| = 1,
    S = [[1, S2], [S1, 1]],  S^{-1} = 1/2 [[1, -S2], [-S1, 1]]  (det = 2),
    Sigma_1 = m1 + m2 S1,  Sigma_2 = m1 + m3 S2 = conj(Sigma_1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np


@dataclasses.dataclass(frozen=True)
class CirculantEigs:
    """Per-mode spectral data for the ParaDiag preconditioner (numpy arrays of
    length N_t, complex)."""

    N_t: int
    dt: float
    gamma: float
    Lambda1: np.ndarray
    Lambda2: np.ndarray
    S1: np.ndarray
    S2: np.ndarray
    Sigma1: np.ndarray
    Sigma2: np.ndarray

    def mix_matrices(self):
        """(S, S^{-1}) entries as tuples ((s11, s12), (s21, s22)) of arrays."""
        one = np.ones_like(self.S1)
        S = ((one, self.S2), (self.S1, one))
        Sinv = ((0.5 * one, -0.5 * self.S2), (-0.5 * self.S1, 0.5 * one))
        return S, Sinv


def circulant_eigs(N_t: int, dt: float, gamma: float) -> CirculantEigs:
    """Compute all per-mode spectral data in float64 on host (setup-time only,
    the analogue of ``DiagFFTPC.initialize``, ref ``:380-437``)."""
    k = np.arange(N_t)
    omega = np.exp(2j * np.pi * k / N_t)
    Lambda1 = (1.0 - omega) ** 2
    Lambda2 = 1.0 + omega**2

    sg = math.sqrt(gamma)
    m1 = Lambda1 / Lambda2
    m2 = -(dt * dt) / (np.conj(Lambda2) * sg)
    m3 = (dt * dt) / (Lambda2 * sg)

    S1 = np.sqrt(m3 / m2)
    S2 = -np.conj(S1)
    Sigma1 = m1 + m2 * S1
    Sigma2 = m1 + m3 * S2

    return CirculantEigs(
        N_t=N_t,
        dt=dt,
        gamma=gamma,
        Lambda1=Lambda1,
        Lambda2=Lambda2,
        S1=S1,
        S2=S2,
        Sigma1=Sigma1,
        Sigma2=Sigma2,
    )


def mode_block_matrix(e: CirculantEigs, k: int) -> np.ndarray:
    """The 2x2 row-normalized per-mode block Lambda(k) (ref ``:418-419``) --
    used by tests to verify ``Lambda S = S Sigma`` (the reference's
    ``mat_test.ipynb`` identity, residual ~1e-16)."""
    sg = math.sqrt(e.gamma)
    l1, l2 = e.Lambda1[k], e.Lambda2[k]
    return np.array(
        [
            [l1 / l2, -e.dt**2 / sg / np.conj(l2)],
            [e.dt**2 / sg / l2, np.conj(l1) / np.conj(l2)],
        ]
    )
