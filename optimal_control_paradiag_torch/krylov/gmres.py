"""Restarted GMRES, left or right preconditioned, real or complex (PyTorch).

The counterpart of ``optimal_control_paradiag_tpu/krylov/gmres.py``, with its
semantics: PETSc-style LEFT preconditioning by default (convergence on the
preconditioned residual norm, relative to the preconditioned initial
residual), ``side='right'`` converging on the true residual, classical
Gram-Schmidt with one re-orthogonalisation (CGS2), restart cycles, and a
residual history of length ``maxiter + 1``.

The JAX package runs the whole solve as two nested ``lax.while_loop``s on the
device. Here each Arnoldi step is split in three:

1. on the device (:func:`arnoldi_step`): the operator, two projections onto
   the active basis rows ``V[:k+1]`` and two expansions (matrix-vector
   products in the working dtype, float32 in full FP32), the new basis row;
2. one copy of the step's Hessenberg column (k + 2 numbers) to the host: the
   step's only host synchronisation;
3. on the host (:func:`givens_update`), in numpy in the working dtype and in
   the JAX code's order of operations: the Givens rotations, the residual
   estimate and the convergence test.

At the end of a cycle the k x k triangular system is solved on the host and
the update ``y @ V[:k]`` runs on the device. Each cycle adds two more host
synchronisations: the norm of its starting residual, and the copy of ``y``
to the device.
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from optimal_control_paradiag_torch.fem.space import require_full_fp32_matmul
from optimal_control_paradiag_torch.utils.constants import np_dtype

# Krylov-basis memory budget (bytes) for the restart clamp, the JAX
# package's rule and knob: the basis V is (restart+1, *state), and at the
# headline state (2, 1024, 2047) a restart of 300 would take 5.0 GB in
# float32, 10.1 GB in float64. Override with PARADIAG_GMRES_BASIS_BUDGET.
_BASIS_BUDGET_BYTES = int(float(os.environ.get("PARADIAG_GMRES_BASIS_BUDGET", 4e9)))


def clamp_restart(restart: int, shape, dtype, maxiter: int) -> int:
    """Largest restart (<= the requested one, >= 4) whose Krylov basis
    ``(restart+1, *shape)`` fits the budget; warns when it clamps."""
    restart = min(restart, maxiter)
    state_bytes = int(np.prod(shape)) * np_dtype(dtype).itemsize
    fit = max(4, _BASIS_BUDGET_BYTES // max(state_bytes, 1) - 1)
    if restart > fit:
        warnings.warn(
            f"GMRES restart {restart} needs a {(restart + 1) * state_bytes / 1e9:.1f} GB "
            f"Krylov basis for state shape {tuple(shape)}; clamping to {fit} "
            f"(budget {_BASIS_BUDGET_BYTES / 1e9:.1f} GB, override with "
            "PARADIAG_GMRES_BASIS_BUDGET)",
            stacklevel=3,
        )
        return int(fit)
    return restart


class GmresResult(NamedTuple):
    """Solution and convergence record. ``x`` lies on the right-hand side's
    device; the record, computed on the host, stays there (CPU tensors)."""

    x: torch.Tensor
    iterations: torch.Tensor  # total Arnoldi steps taken
    converged: torch.Tensor  # bool
    residual_norm: torch.Tensor  # final (preconditioned, for side='left') residual norm
    residual_history: torch.Tensor  # (maxiter+1,), NaN beyond `iterations`


def _givens(a, b):
    """Complex-safe Givens rotation of two numpy scalars: ``(c real, s, r)``
    with ``c*a + s*b = r`` and ``-conj(s)*a + c*b = 0``."""
    abs_a = np.abs(a)
    abs_b = np.abs(b)
    rho = np.sqrt(abs_a * abs_a + abs_b * abs_b)
    if not rho > 0:
        return rho.dtype.type(1), a.dtype.type(0), a.dtype.type(0) * rho
    # a == 0 -> swap rotation (c = 0, s = conj(b)/|b|).
    phase_a = a / abs_a if abs_a > 0 else a.dtype.type(1)
    c = abs_a / rho
    s = phase_a * np.conj(b) / rho
    return c.real, s, phase_a * rho


def arnoldi_step(op: Callable, V: torch.Tensor, k: int, shape) -> torch.Tensor:
    """The device part of Arnoldi step ``k``: ``w = op(V[k])``, made
    orthogonal to ``V[:k+1]`` by CGS2, and ``V[k+1] = w / |w|`` (``w`` itself
    where ``|w| = 0``). ``V`` is the flat basis ``(restart+1, m)``. Returns the
    step's Hessenberg column ``[h_0, ..., h_k, |w|]`` on the device."""
    Vk = V[: k + 1]
    Vh = Vk.conj() if V.is_complex() else Vk
    w = op(V[k].view(shape)).reshape(-1)
    h1 = torch.mv(Vh, w)
    w = w - h1 @ Vk
    h2 = torch.mv(Vh, w)
    w = w - h2 @ Vk
    hk1 = torch.linalg.norm(w)
    V[k + 1] = w / torch.where(hk1 > 0, hk1, torch.ones_like(hk1))
    return torch.cat([h1 + h2, hk1.to(V.dtype).reshape(1)])


def givens_update(hcol: np.ndarray, k: int, R: np.ndarray, cs: np.ndarray, sn: np.ndarray, g: np.ndarray):
    """The host part of Arnoldi step ``k``: apply the stored rotations
    0..k-1 to the new column ``hcol`` (numpy, working dtype), make and store
    the rotation that eliminates its subdiagonal, and update ``R[:, k]`` and
    the rotated right-hand side ``g``. Returns the residual estimate
    ``|g[k+1]|``."""
    for j in range(k):
        a, bb = hcol[j], hcol[j + 1]
        hcol[j] = cs[j] * a + sn[j] * bb
        hcol[j + 1] = -np.conj(sn[j]) * a + cs[j] * bb
    ck, sk, rk = _givens(hcol[k], hcol[k + 1])
    cs[k] = ck
    sn[k] = sk
    R[: k + 1, k] = hcol[: k + 1]
    R[k, k] = rk
    gk = g[k]
    g[k] = ck * gk
    g[k + 1] = -np.conj(sk) * gk
    return np.abs(g[k + 1])


def gmres(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    *,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    x0: Optional[torch.Tensor] = None,
    restart: int = 30,
    rtol: float = 1e-5,
    atol: float = 0.0,
    maxiter: int = 1000,
    side: str = "left",
) -> GmresResult:
    """Solve ``A x = b`` with preconditioner ``M ~= A^{-1}``.

    ``matvec`` and ``M`` map states to states of ``b``'s shape and dtype
    (real or complex), on ``b``'s device. ``side``: 'left' (PETSc's default;
    convergence on the preconditioned residual norm, the reference's
    monitored counts) or 'right' (convergence on the true residual norm).
    """
    if side not in ("left", "right"):
        raise ValueError(f"unknown side {side!r}")
    require_full_fp32_matmul()
    if M is None:
        M = lambda v: v
    shape = b.shape
    np_t = np_dtype(b.dtype)
    np_r = np.empty((), np_t).real.dtype
    if x0 is None:
        x0 = torch.zeros_like(b)
    restart = clamp_restart(restart, shape, b.dtype, maxiter)
    op = (lambda v: M(matvec(v))) if side == "left" else (lambda v: matvec(M(v)))

    def pres(x):
        r = b - matvec(x)
        return M(r) if side == "left" else r

    # rows past the active k + 1 are never read, so the basis starts empty
    V = torch.empty((restart + 1, b.numel()), dtype=b.dtype, device=b.device)
    x, it, tol, res = x0, 0, None, None
    hist = np.full((maxiter + 1,), np.nan, np_r)
    while tol is None or (res > tol and it < maxiter):
        r = pres(x)  # the (preconditioned) residual of x: a restart after the first cycle
        beta_t = torch.linalg.norm(r.reshape(-1))
        beta = beta_t.cpu().numpy()[()].astype(np_r)
        if tol is None:
            tol = np.maximum(np_r.type(rtol) * beta, np_r.type(atol))
            hist[0] = beta
        V[0] = (r / beta_t if beta > 0 else r).reshape(-1)
        R = np.zeros((restart, restart), np_t)
        cs = np.zeros((restart,), np_r)
        sn = np.zeros((restart,), np_t)
        g = np.zeros((restart + 1,), np_t)
        g[0] = beta
        k, res = 0, beta
        while k < restart and res > tol and it + k < maxiter:
            hcol = arnoldi_step(op, V, k, shape).cpu().numpy()  # the step's one sync
            res = givens_update(hcol, k, R, cs, sn, g)
            hist[it + k + 1] = res
            k += 1
        if k:
            y = torch.linalg.solve_triangular(
                torch.from_numpy(R[:k, :k].copy()), torch.from_numpy(g[:k].copy())[:, None], upper=True
            )[:, 0]
            dx = (y.to(b.device) @ V[:k]).view(shape)
            x = x + (dx if side == "left" else M(dx))
        it += k

    return GmresResult(
        x=x,
        iterations=torch.tensor(it),
        converged=torch.tensor(bool(res <= tol)),
        residual_norm=torch.from_numpy(np.asarray(res, np_r)),
        residual_history=torch.from_numpy(hist),
    )
