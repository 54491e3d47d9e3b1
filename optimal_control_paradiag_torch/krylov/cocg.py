"""Batched preconditioned COCG (Conjugate Orthogonal CG), PyTorch.

The counterpart of ``optimal_control_paradiag_tpu/krylov/cocg.py``: the
Krylov method for complex *symmetric* systems (A^T = A, not Hermitian), the
CG recurrences with the unconjugated bilinear form <a, b> = sum(a*b). The
form is reduced over ``dot_axes`` only: every other axis is an independent
system with its own alpha and beta.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch


def cocg(
    A: Callable,
    b: torch.Tensor,
    *,
    M: Optional[Callable] = None,
    dot_axes: Sequence[int],
    tol: float = 1e-10,
    maxiter: int = 50,
):
    """Solve A x = b for complex-symmetric A, batched outside ``dot_axes``.

    ``M`` is an (also complex-symmetric) preconditioner approximating A^{-1}.
    Returns (x, iterations). Stops when max |r| <= tol * max |b| across the
    whole batch: all systems share the trip count, as in the JAX package.
    The test reads a device scalar, so each iteration synchronises the host
    once.
    """
    if M is None:
        M = lambda v: v
    axes = tuple(dot_axes)

    def dot_T(a, c):
        return torch.sum(a * c, dim=axes, keepdim=True)

    def nonzero(t):
        return torch.where(t.abs() > 0, t, torch.ones_like(t))

    bnorm = torch.clamp_min(b.abs().max(), 1e-300)
    x = torch.zeros_like(b)
    r = b
    z = M(r)
    p = z
    rho = dot_T(r, z)
    it = 0
    while it < maxiter and bool(r.abs().max() > tol * bnorm):
        q = A(p)
        alpha = rho / nonzero(dot_T(p, q))
        x = x + alpha * p
        r = r - alpha * q
        z = M(r)
        rho_new = dot_T(r, z)
        p = z + (rho_new / nonzero(rho)) * p
        rho = rho_new
        it += 1
    return x, it
