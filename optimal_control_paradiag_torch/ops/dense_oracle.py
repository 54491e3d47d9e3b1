"""Independent dense assembly of the all-at-once system -- test oracle
(PyTorch port).

The counterpart of ``optimal_control_paradiag_tpu/ops/dense_oracle.py``: a
deliberately naive, loop-per-row numpy transcription of the reference's
``Build_L`` branches (``Control_Wave_PC.py:86-179``), kept structurally as
close to the reference's case analysis as possible (separate i=0 / interior /
i=N_t-1 branches, explicit data substitution for out-of-range indices per ref
``:93-110``). Used only in tests to validate the vectorized matrix-free
operator in :mod:`optimal_control_paradiag_torch.ops.allatonce` -- the two
are written independently so a transcription error in one is caught by the
other. It reads the space's dense mass and stiffness (tensors on any
device) as float64 host arrays.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from optimal_control_paradiag_torch.fem.space import P1Space
from optimal_control_paradiag_torch.utils.constants import host_f64


def assemble_dense(
    space: P1Space,
    N_t: int,
    dt: float,
    gamma: float,
    scaled: bool,
    f: np.ndarray,
    g: np.ndarray,
    u0: np.ndarray,
    u1: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Return (A, b) with A of shape (2*N_t*n, 2*N_t*n), b of length 2*N_t*n.

    Unknown ordering matches the framework layout: u-block rows first
    (time-major, space-minor), then p-block rows.
    """
    n = space.n
    M = host_f64(space.mass_dense())
    K = host_f64(space.stiffness_dense())
    d2 = dt * dt

    c_up = d2 / math.sqrt(gamma) if scaled else d2 / gamma
    c_pu = d2 / math.sqrt(gamma) if scaled else d2

    m = 2 * N_t * n
    A = np.zeros((m, m))
    b = np.zeros(m)

    def ub(i):  # u-block slice for time slice i
        return slice(i * n, (i + 1) * n)

    def pb(i):  # p-block slice
        return slice(N_t * n + i * n, N_t * n + (i + 1) * n)

    f = np.asarray(f, dtype=np.float64)
    g = np.asarray(g, dtype=np.float64)
    u0 = np.asarray(u0, dtype=np.float64)
    u1 = np.asarray(u1, dtype=np.float64)

    for i in range(N_t):
        # ---- u-row (ref :113-118 for i=0; :137-139/:146-148 final; :157-159
        # interior -- final and interior u-rows share one stencil).
        if i == 0:
            A[ub(0), ub(0)] += M + 0.5 * d2 * K
            A[ub(0), pb(0)] += -(c_up / 2.0) * M
            b[ub(0)] += M @ (0.5 * d2 * f[0] + dt * u1 + u0)
        else:
            A[ub(i), ub(i)] += M + 0.5 * d2 * K
            A[ub(i), ub(i - 1)] += -2.0 * M
            if i >= 2:
                A[ub(i), ub(i - 2)] += M + 0.5 * d2 * K
            else:  # i == 1: u_{i-2} is the initial datum u0 (ref :94-95)
                b[ub(i)] += -(M @ u0 + 0.5 * d2 * (K @ u0))
            A[ub(i), pb(i)] += -c_up * M
            b[ub(i)] += d2 * (M @ f[i])

        # ---- p-row (ref :120-123 i=0; :141-144 terminal; :161-164 interior).
        if i == N_t - 1:
            A[pb(i), pb(i)] += M + 0.5 * d2 * K
            A[pb(i), ub(i)] += (c_pu / 2.0) * M
            b[pb(i)] += 0.5 * d2 * (M @ g[i])
        else:
            A[pb(i), pb(i)] += M + 0.5 * d2 * K
            A[pb(i), pb(i + 1)] += -2.0 * M
            if i + 2 <= N_t - 1:
                A[pb(i), pb(i + 2)] += M + 0.5 * d2 * K
            # i == N_t-2: p_{i+2} = 0 terminal condition (ref :102-103)
            A[pb(i), ub(i)] += c_pu * M
            b[pb(i)] += d2 * (M @ g[i])

    return A, b
