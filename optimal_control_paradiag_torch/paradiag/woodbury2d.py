"""Direct and tensor-preconditioned solves of the spaces the sine transform
does not diagonalize (PyTorch): the 2D consistent mass and unstructured
meshes.

The counterpart of ``optimal_control_paradiag_tpu/paradiag/woodbury2d.py``.
The all-at-once matrix splits, for every space, as

    A = P + Psi R Phi*,

P the block-circulant part (solved exactly by the ``blockline`` or
``blockband`` factorization), ``Phi*`` the extraction of the four time
slices (u_{N-1}, u_{N-2}, p_0, p_1), ``R`` their map to the four corrected
boundary rows through M and K applies

    r_u0   = M (2 u_{N-1} - u_{N-2}) - c K u_{N-2} + (theta/2) M p_0
    r_u1   = -(M + c K) u_{N-1}
    r_pN-1 = M (2 p_0 - p_1) - c K p_1 - (theta/2) M u_{N-1}
    r_pN-2 = -(M + c K) p_0,

and ``Psi`` their injection into the time rows (u_0, u_1, p_{N-1}, p_{N-2}).
Sherman-Morrison-Woodbury then gives the direct solve

    A^{-1} b = y - P^{-1} Psi q,   y = P^{-1} b,
    (I + R Phi* P^{-1} Psi) q = R Phi* y,

whose 4n-dimensional capacity system GMRES solves, one P^{-1} apply per
iteration (:func:`build_woodbury2d_solver`). The mesh-independent path of
the 2D consistent mass is :func:`build_tensor_gmres_solver`: GMRES on A,
preconditioned by the exact Woodbury solve of the tensor-mass surrogate.

States carry leading batch axes ``(..., 2, N_t, n)``; a batch ``(B, 2, N_t,
n)`` runs its Krylov solves lane by lane in lock-step
(:func:`krylov.gmres.gmres_batched`), as the JAX package's ``vmap`` does.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from optimal_control_paradiag_torch.krylov.gmres import gmres, gmres_batched
from optimal_control_paradiag_torch.ops.allatonce import AllAtOnceOperator
from optimal_control_paradiag_torch.paradiag.pc import build_preconditioner
from optimal_control_paradiag_torch.paradiag.spectral import _build_woodbury_half, _capacity_CW, _spectral_plan
from optimal_control_paradiag_torch.utils.constants import to_device
from optimal_control_paradiag_torch.utils.timing import counters, spanned


def solve_lanes(matvec, b: torch.Tensor, lane_ndim: int, **kwargs):
    """GMRES on ``b``: one system when ``b`` has ``lane_ndim`` axes, else a
    batch along its first axis (:func:`gmres_batched`, per-lane records)."""
    krylov = gmres if b.ndim == lane_ndim else gmres_batched
    return krylov(matvec, b, **kwargs)


def time_corner_maps(op: AllAtOnceOperator):
    """(phi_star, R, psi): the space-generic rank-4-in-time splitting
    ``A = P + Psi R Phi*`` (module docstring), on states ``(..., 2, N_t,
    n)`` and slices ``(..., 4, n)``."""
    sp = op.space
    N_t = op.N_t
    c = 0.5 * op.dt * op.dt
    theta = op.dt * op.dt / np.sqrt(op.gamma)

    def phi_star(x):
        return torch.stack([x[..., 0, N_t - 1, :], x[..., 0, N_t - 2, :], x[..., 1, 0, :], x[..., 1, 1, :]], dim=-2)

    def R(z):
        zu1, zu2, zp0, zp1 = z.unbind(-2)
        M, K = sp.apply_mass, sp.apply_stiffness
        r0 = M(2.0 * zu1 - zu2) - c * K(zu2) + 0.5 * theta * M(zp0)
        r1 = -(M(zu1) + c * K(zu1))
        r2 = M(2.0 * zp0 - zp1) - c * K(zp1) - 0.5 * theta * M(zu1)
        r3 = -(M(zp0) + c * K(zp0))
        return torch.stack([r0, r1, r2, r3], dim=-2)

    def psi(r):
        x = r.new_zeros(r.shape[:-2] + (2, N_t, r.shape[-1]))
        x[..., 0, 0, :] = r[..., 0, :]
        x[..., 0, 1, :] = r[..., 1, :]
        x[..., 1, N_t - 1, :] = r[..., 2, :]
        x[..., 1, N_t - 2, :] = r[..., 3, :]
        return x

    return phi_star, R, psi


def build_woodbury2d_solver(
    op: AllAtOnceOperator,
    cap_rtol: float = 1e-10,
    cap_maxiter: int = 300,
    pinv_variant: Optional[str] = None,
    refine: int = 0,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Direct solver ``b -> x`` for non-sine-diagonalizable spaces by SMW
    over an exact circulant factorization.

    - Structured 2D grids (default ``pinv_variant='blockline'``): capacity
      GMRES preconditioned by the closed-form TENSOR-mass capacity inverse
      ``(I + C_j W_j)^{-1}`` per sine wavenumber.
    - Unstructured meshes (``pinv_variant='blockband'``, picked when the
      space has no ``n1d``): the RCM-banded ``P^{-1}``; no sine basis
      exists, so the capacity GMRES runs unpreconditioned.

    ``cap_rtol``/``cap_maxiter`` bound the capacity GMRES (one ``P^{-1}``
    apply per iteration). ``refine``: outer defect-correction passes ``x +=
    solve(b - A x)``; when the capacity solve stops at relative accuracy
    eps, each pass multiplies the true residual by ~eps."""
    sp = op.space
    if sp.diagonalizable:
        raise ValueError(
            "space is sine-diagonalizable: use the exact rank-4 Woodbury "
            "(paradiag.spectral.build_woodbury_solver)"
        )
    if pinv_variant is None:
        pinv_variant = "blockline" if hasattr(sp, "n1d") else "blockband"

    Pinv = build_preconditioner(op, variant=pinv_variant)
    phi_star, R, psi = time_corner_maps(op)

    cap_pc = None
    if hasattr(sp, "n1d") and hasattr(sp, "spectrum_tensor"):
        # the tensor-mass surrogate's capacity inverse per sine wavenumber
        # (real to float precision: the Hermitian k-pairing cancels the
        # imaginary parts); structured grids only (it needs the sine basis)
        C, W = _capacity_CW(_spectral_plan(op, mass_surrogate=True))
        Minv = np.linalg.inv(np.eye(4)[None] + C @ W)
        if not float(np.abs(Minv.imag).max()) < 1e-8 * float(np.abs(Minv.real).max()):
            raise ArithmeticError("the tensor-mass capacity inverses are not real")
        Minv_r = to_device(Minv.real, sp.dtype, sp.device)  # (n, 4, 4)

        def cap_pc(q):
            return sp.idst(torch.einsum("nab,...bn->...an", Minv_r, sp.dst(q)))

    def cap_matvec(q):
        return q + R(phi_star(Pinv(psi(q))))

    def smw(b: torch.Tensor) -> torch.Tensor:
        y = Pinv(b)
        res = solve_lanes(cap_matvec, R(phi_star(y)), 2, M=cap_pc, restart=cap_maxiter,
                          rtol=cap_rtol, maxiter=cap_maxiter)
        return y - Pinv(psi(res.x))

    def solve(b: torch.Tensor) -> torch.Tensor:
        x = smw(b)
        for _ in range(refine):
            x = x + smw(b - op.matvec(x))
        return x

    return solve


def build_tensor_gmres_solver(
    op: AllAtOnceOperator,
    rtol: float = 1e-10,
    maxiter: int = 60,
    restart: Optional[int] = None,
    with_result: bool = False,
    surrogate_solve: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Mesh-independent solve of the 2D CONSISTENT-mass all-at-once system:
    GMRES on the physical operator, preconditioned by the EXACT direct solve
    of the TENSOR-mass surrogate operator.

    The Friedrichs-Keller consistent mass splits as ``M = M_t + E``: ``M_t``
    the sine-diagonal tensor part (spectrum ``(h^2/12)(6 + 2 cos a + 2 cos b
    + 2 cos a cos b)``, ``P1Space.spectrum_tensor``), and ``E = (h^2/24) D_x
    (x) D_y`` (D the centred-difference matrix) with a ZERO sine diagonal.
    The surrogate operator ``A_t`` (the same time structure and stiffness,
    mass ``M_t``) is sine-diagonalizable, so the rank-4 Woodbury identity
    solves it exactly. As a left preconditioner it leaves ``I +
    A_t^{-1} Delta_E``, whose symbol ratio ``~ (cos a cos b) / (3 + cos a +
    cos b)`` is bounded below 1 uniformly in the mesh and the mode, so GMRES
    converges at an N-independent rate (the JAX package measures 7 / 7 / 8
    iterations at rtol 1e-10 for N_x = N_t = 16 / 32 / 64 in float64).

    ``surrogate_solve``: the surrogate's exact solve ``b -> A_t^{-1} b``.
    The wave model passes B1 between the packed 'fft2' time transforms
    (``cuda_woodbury.build_cuda_woodbury_solver(op, refine=0,
    mass_surrogate=True)``) under ``use_pallas=True``; ``None`` (the
    default, and ``use_pallas=False``) builds the eager composition,
    ``spectral._build_woodbury_half`` over the ``mass_surrogate`` plan at
    refine 0, torch's rfft in time. Each apply is a ``pc/apply`` span,
    counted in ``utils.timing.counters['pc.tensor_mass.applies']``; each
    call of ``solve`` in ``counters['solve.tensor_gmres']``. A
    left-preconditioned call applies it once more than its (slowest lane's)
    Arnoldi steps, a restart once more again.

    ``solve(b)`` returns x, or ``(x, GmresResult)`` with ``with_result``;
    a batch ``(B, 2, N_t, n)`` gets per-lane records."""
    sp = op.space
    if sp.diagonalizable:
        raise ValueError(
            "space is sine-diagonalizable: use the exact rank-4 Woodbury "
            "(paradiag.spectral.build_woodbury_solver)"
        )
    if surrogate_solve is None:
        surrogate_solve = _build_woodbury_half(op, _spectral_plan(op, mass_surrogate=True), refine=0)
    if restart is None:
        restart = maxiter

    def apply_pc(r: torch.Tensor) -> torch.Tensor:
        counters["pc.tensor_mass.applies"] += 1
        return surrogate_solve(r)

    W_t = spanned("pc/apply", apply_pc)

    def solve(b: torch.Tensor):
        counters["solve.tensor_gmres"] += 1
        res = solve_lanes(op.matvec, b, 3, M=W_t, restart=restart, rtol=rtol, maxiter=maxiter)
        return (res.x, res) if with_result else res.x

    return solve
