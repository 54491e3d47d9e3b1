"""Batched preconditioned COCG (Conjugate Orthogonal CG), PyTorch.

The counterpart of ``optimal_control_paradiag_tpu/krylov/cocg.py``: the
Krylov method for complex *symmetric* systems (A^T = A, not Hermitian), the
CG recurrences with the unconjugated bilinear form <a, b> = sum(a*b). The
form is reduced over ``dot_axes`` only: every other axis is an independent
system with its own alpha and beta. The leading ``batch_dims`` axes are
lanes with a stopping test each (the JAX package's ``jax.vmap`` of its
``cocg``): a lane that has met its test keeps its state while the others
run.
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
    batch_dims: int = 0,
):
    """Solve A x = b for complex-symmetric A, batched outside ``dot_axes``.

    ``M`` is an (also complex-symmetric) preconditioner approximating A^{-1}.
    Returns (x, iterations). A lane stops when max |r| <= tol * max |b| over
    its axes past the first ``batch_dims``: all systems of a lane share the
    trip count, as in the JAX package. The test reads a device tensor, so
    each iteration synchronises the host once; ``iterations`` is the trip
    count of the slowest lane.
    """
    if M is None:
        M = lambda v: v
    axes = tuple(dot_axes)

    def dot_T(a, c):
        return torch.sum(a * c, dim=axes, keepdim=True)

    def nonzero(t):
        return torch.where(t.abs() > 0, t, torch.ones_like(t))

    lane_axes = tuple(range(batch_dims, b.ndim))

    def lane_max(t):  # max over each lane's axes, kept for broadcasting
        return torch.amax(t.abs(), dim=lane_axes, keepdim=True)

    bnorm = torch.clamp_min(lane_max(b), 1e-300)
    x = torch.zeros_like(b)
    r = b
    z = M(r)
    p = z
    rho = dot_T(r, z)
    it = 0
    while it < maxiter:
        active = lane_max(r) > tol * bnorm
        if not bool(active.any()):
            break
        q = A(p)
        alpha = rho / nonzero(dot_T(p, q))
        x_new = x + alpha * p
        r_new = r - alpha * q
        z = M(r_new)
        rho_new = dot_T(r_new, z)
        p_new = z + (rho_new / nonzero(rho)) * p
        if batch_dims:  # lanes that have met their test keep their state
            x, r, p, rho = (torch.where(active, new, old)
                            for new, old in ((x_new, x), (r_new, r), (p_new, p), (rho_new, rho)))
        else:  # one lane: it is active, or the loop has ended
            x, r, p, rho = x_new, r_new, p_new, rho_new
        it += 1
    return x, it
