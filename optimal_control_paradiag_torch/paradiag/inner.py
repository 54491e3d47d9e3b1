"""Per-mode inner solvers of the ParaDiag ``eig`` preconditioner (PyTorch).

The counterpart of ``optimal_control_paradiag_tpu/paradiag/inner.py``. Each
returns ``solve(sigma, rhs)``: the solutions of ``(sigma_k M + dt^2/2 K) w_k
= rhs_k`` for per-mode complex shifts ``sigma`` (N_t, 1) and right-hand sides
(N_t, n), batched over the modes and over any leading axes of ``rhs``
(lanes of a batched solve):

- **dst**: the exact sine-spectral inverse; needs M and K sine-diagonalizable
  (1D, or 2D lumped);
- **tridiag** (1D): batched complex Thomas or PCR solves on the assembled
  diagonals (``ops/tridiag.py``), exact for either mass;
- **cocg** (2D consistent mass): COCG preconditioned by the tensor-part mass
  sine-spectral inverse (``P1Space.spectrum_tensor``);
- **cocg_jacobi** (unstructured meshes): COCG preconditioned by the inverse
  of the shifted operator's diagonal.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from optimal_control_paradiag_torch.fem.space import P1Space
from optimal_control_paradiag_torch.krylov.cocg import cocg
from optimal_control_paradiag_torch.ops.tridiag import solve_scalar_shifted
from optimal_control_paradiag_torch.utils.constants import to_device


def _row(space: P1Space, values) -> torch.Tensor:
    """A host spectrum as a (1, n) row of the space's dtype on its device."""
    return to_device(np.asarray(values)[None, :], space.dtype, space.device)


def make_dst_inner_solver(space: P1Space, dt: float) -> Callable:
    """Exact sine-spectral solve of ``(sigma M + dt^2/2 K) w = r``."""
    muM, muK = space.spectrum
    if muM is None:
        raise ValueError("space is not sine-diagonalizable; use cocg")
    c = 0.5 * dt * dt
    muM, muK = _row(space, muM), _row(space, muK)

    def solve(sigma, rhs):
        return space.idst(space.dst(rhs) / (sigma * muM + c * muK))

    return solve


def make_tridiag_inner_solver(space: P1Space, dt: float, method: str = "pcr") -> Callable:
    """1D batched tridiagonal solve on assembled diagonals (Thomas or PCR)."""
    if space.dim != 1:
        raise ValueError("tridiag inner solver is 1D-only")
    h = space.h
    c = 0.5 * dt * dt
    if space.mass == "lumped":
        m_diag, m_off = h, 0.0
    else:
        m_diag, m_off = 4.0 * h / 6.0, h / 6.0
    k_diag, k_off = 2.0 / h, -1.0 / h

    def solve(sigma, rhs):
        return solve_scalar_shifted(sigma, m_diag, m_off, k_diag, k_off, c, rhs, method)

    return solve


def make_jacobi_cocg_inner_solver(space, dt: float, tol: float = 1e-10, maxiter: int = 200) -> Callable:
    """Batched Jacobi-preconditioned COCG for ``(sigma M + dt^2/2 K) w = r``
    on a general (unstructured) space: any space with ``apply_mass``,
    ``apply_stiffness``, ``mass_diag`` and ``stiffness_diag``
    (:class:`fem.general.GeneralP1Space`). The unstructured counterpart of
    :func:`make_cocg_inner_solver`, which needs the sine spectrum; the exact
    alternative is ``pc_variant='blockdense'``."""
    if not hasattr(space, "mass_diag"):
        raise ValueError(
            "inner='cocg_jacobi' needs a general (unstructured) space with mass_diag and "
            "stiffness_diag; structured spaces have the dst, tridiag and cocg inner solvers"
        )
    c = 0.5 * dt * dt
    mdiag = _row(space, np.asarray(space.mass_diag(), np.float64))
    kdiag = _row(space, np.asarray(space.stiffness_diag(), np.float64))

    def solve(sigma, rhs):
        x, _ = cocg(
            lambda w: sigma * space.apply_mass(w) + c * space.apply_stiffness(w),
            rhs,
            M=lambda r: r / (sigma * mdiag + c * kdiag),
            dot_axes=(-1,),
            tol=tol,
            maxiter=maxiter,
            batch_dims=rhs.ndim - 2,
        )
        return x

    return solve


def make_cocg_inner_solver(space: P1Space, dt: float, tol: float = 1e-10, maxiter: int = 50) -> Callable:
    """Batched preconditioned COCG for ``(sigma M + dt^2/2 K) w = r`` with the
    consistent 2D mass matrix; the preconditioner is the exact tensor-part
    mass spectral inverse. Unconjugated inner products throughout (complex
    symmetry). At modes whose shift sits near the negative real axis COCG
    can stall; the JAX package's direct inner solves are the robust route
    there."""
    c = 0.5 * dt * dt
    _, muK = space.spectrum
    muK = _row(space, muK)
    muMt = _row(space, space.spectrum_tensor)

    def solve(sigma, rhs):
        x, _ = cocg(
            lambda w: sigma * space.apply_mass(w) + c * space.apply_stiffness(w),
            rhs,
            M=lambda r: space.idst(space.dst(r) / (sigma * muMt + c * muK)),
            dot_axes=(-1,),
            tol=tol,
            maxiter=maxiter,
            batch_dims=rhs.ndim - 2,
        )
        return x

    return solve
