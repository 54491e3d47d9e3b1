"""Preconditioned MINRES for symmetric (possibly indefinite) systems with an
SPD preconditioner (PyTorch).

The counterpart of ``optimal_control_paradiag_tpu/krylov/minres.py``: the
Lanczos + Givens recurrences of Paige and Saunders, in the same order of
operations, with the same :class:`MinresResult`. The scalar recurrences stay
device tensors; the stopping test ``phibar > tol`` is read on the host once
per iteration, the solve's only synchronisation per step.

``batch_dims`` leading axes of ``b`` are independent systems (lanes): every
scalar of the recurrence then has that batch shape, each lane stops on its
own test, and a lane that has stopped keeps its state while the others run,
as the JAX package's ``jax.vmap`` of its ``lax.while_loop`` does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class MinresResult(NamedTuple):
    """Solution and convergence record; with a batch, every field has the
    batch's leading axes. All on ``b``'s device."""

    x: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor
    residual_norm: torch.Tensor  # final phibar, the preconditioned residual norm
    residual_history: torch.Tensor  # (..., maxiter+1), NaN beyond `iterations`


def minres(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    *,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    x0: Optional[torch.Tensor] = None,
    rtol: float = 1e-5,
    maxiter: int = 1000,
    batch_dims: int = 0,
) -> MinresResult:
    """Solve symmetric ``A x = b``; ``M`` must be symmetric positive definite
    (preconditioned residual norms are measured in the M-inner product).
    ``matvec`` and ``M`` act on states of ``b``'s shape, batch included."""
    if M is None:
        M = lambda v: v
    lanes = b.shape[:batch_dims]
    axes = tuple(range(batch_dims, b.ndim))

    def dot(a, c):
        return torch.sum(a * c, dim=axes)

    def bc(s):  # a per-lane scalar against a state
        return s.reshape(lanes + (1,) * len(axes))

    def nz(s, fill=1.0):
        return torch.where(s > 0, s, torch.full_like(s, fill))

    if x0 is None:
        x0 = torch.zeros_like(b)
    r1 = b - matvec(x0)
    y = M(r1)
    beta1 = torch.sqrt(torch.clamp_min(dot(r1, y), 0.0))
    tol = rtol * beta1
    zero = torch.zeros_like(beta1)
    hist = torch.full(lanes + (maxiter + 1,), float("nan"), dtype=b.dtype, device=b.device)
    hist[..., 0] = beta1
    s = dict(
        x=x0, r1=r1, r2=r1, y=y, beta=beta1, beta_prev=zero, dbar=zero, epsln=zero, phibar=beta1,
        cs=-torch.ones_like(beta1), sn=zero, w=torch.zeros_like(b), w2=torch.zeros_like(b),
        it=torch.zeros(lanes, dtype=torch.int64, device=b.device), hist=hist,
    )

    while True:
        active = (s["phibar"] > tol) & (s["it"] < maxiter)
        if not bool(active.any()):  # the step's one host synchronisation
            break
        v = s["y"] / bc(nz(s["beta"]))
        yv = matvec(v)
        yv = torch.where(bc(s["it"] >= 1), yv - bc(s["beta"] / nz(s["beta_prev"])) * s["r1"], yv)
        alfa = dot(v, yv)
        yv = yv - bc(alfa / nz(s["beta"])) * s["r2"]
        yn = M(yv)
        beta_new = torch.sqrt(torch.clamp_min(dot(yv, yn), 0.0))

        # the previous rotation applied to the new column of T
        oldeps = s["epsln"]
        delta = s["cs"] * s["dbar"] + s["sn"] * alfa
        gbar = s["sn"] * s["dbar"] - s["cs"] * alfa
        epsln_new = s["sn"] * beta_new
        dbar_new = -s["cs"] * beta_new

        gamma = torch.sqrt(gbar * gbar + beta_new * beta_new)
        gamma = nz(gamma, 1e-300)
        cs_new = gbar / gamma
        sn_new = beta_new / gamma
        phi = s["cs"] * 0.0 + cs_new * s["phibar"]
        phibar_new = sn_new * s["phibar"]

        w1 = s["w2"]
        w2n = s["w"]
        wn = (v - bc(oldeps) * w1 - bc(delta) * w2n) / bc(gamma)
        it = s["it"] + 1
        new = dict(
            x=s["x"] + bc(phi) * wn, r1=s["r2"], r2=yv, y=yn, beta=beta_new, beta_prev=s["beta"],
            dbar=dbar_new, epsln=epsln_new, phibar=phibar_new, cs=cs_new, sn=sn_new, w=wn, w2=w2n, it=it,
            hist=s["hist"].scatter(-1, it[..., None], phibar_new[..., None]),
        )
        # lanes that had stopped keep their state
        keep = dict.fromkeys(("x", "r1", "r2", "y", "w", "w2"), bc(active))
        keep["hist"] = active[..., None]
        s = {k: torch.where(keep.get(k, active), v_, s[k]) for k, v_ in new.items()}

    return MinresResult(
        x=s["x"],
        iterations=s["it"],
        converged=s["phibar"] <= tol,
        residual_norm=s["phibar"],
        residual_history=s["hist"],
    )
