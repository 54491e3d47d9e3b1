"""Optimality system via autodiff of the discrete Lagrangian (PyTorch).

The counterpart of ``optimal_control_paradiag_tpu/models/wave_lagrangian.py``,
the reference's prototype derivation path (``Func_Version.py:7-167`` and the
flat script ``mumps_1D.py``): build the discrete Lagrangian

  S(u, p) = sum_i [ dt/2 ||u_i - g_i||_M^2 + dt/(2 gamma) ||p_i||_M^2
            + dt p_i^T M ((u_i - 2u_{i-1} + u_{i-2})/dt^2 - f_i)
            - dt/gamma ||p_i||_M^2 + dt p_i^T K (u_i + u_{i-2})/2 ]

(``Func_Version.py:86-95``, with the control eliminated as ``u~ = p/gamma``)
and obtain the KKT system as its gradient -- the reference calls
``fd.derivative(S, U)`` (``Func_Version.py:102``); here ``torch.func.grad``
does the same, and the (symmetric) KKT operator is applied matrix-free as a
Hessian-vector product (``torch.func.jvp`` over ``torch.func.grad``,
forward over reverse). This model doubles as a derivation oracle: an
independently derived discretization of the same control problem,
converging to the same analytic solution as the production all-at-once
path.

Prototype quirks reproduced (documented, not hidden):
- ``N_t - 1`` unknown slices (vs. N_t in the production path);
- ghost start ``u_{-1} = u0 + dt*u1`` (``Func_Version.py:65,69``; note
  ``mumps_1D.py:56,60`` used the opposite sign -- we follow Func_Version);
- 1D data indexed at ``t = (i-1)*dt`` (``Func_Version.py:49-54``), 2D data at
  ``t = i*dt`` (``Func_Version.py:34-38``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from optimal_control_paradiag_torch.config import ProblemConfig
from optimal_control_paradiag_torch.fem.space import make_space
from optimal_control_paradiag_torch.krylov.gmres import GmresResult, gmres
from optimal_control_paradiag_torch.models.analytic import manufactured
from optimal_control_paradiag_torch.utils.constants import host_f64, resolve_device, to_device

# unit vectors per vmap call when the direct solve forms the Hessian
_HVP_CHUNK = 256


class LagrangianSolution(NamedTuple):
    u: torch.Tensor  # (N_t-1, n)
    p: torch.Tensor  # (N_t-1, n)
    result: Optional[GmresResult]


class LagrangianWaveProblem:
    """Direct (unpreconditioned / dense) solver for the KKT system derived by
    autodiff from the discrete Lagrangian. ``device``: 'cuda' by default;
    without a card the constructor raises unless ``device='cpu'``."""

    def __init__(self, config: ProblemConfig, device="cuda"):
        if config.scaled:
            raise ValueError(
                "the Lagrangian prototype path is unscaled (Func_Version.py "
                "has no sqrt(gamma) mode); pass scaled=False"
            )
        self.config = config
        self.device = resolve_device(device)
        self.space = make_space(config.dim, config.N_x, mass=config.mass, dtype=config.dtype, device=self.device)
        self.analytic = manufactured(config.dim, config.T, config.gamma)
        self.N = config.N_t - 1  # unknown slices (Func_Version.py:63 loops N-1)
        self._build_data()

    def _build_data(self):
        cfg = self.config
        sp = self.space
        dt = cfg.dt
        # 1D: data at t=(i-1)dt (Func_Version.py:49-54); 2D: at t=i*dt (:34-38).
        off = -1 if cfg.dim == 1 else 0
        f = np.stack(
            [np.asarray(sp.interpolate(lambda *x: self.analytic.f(*x, (i + off) * dt))) for i in range(self.N)]
        )
        g = np.stack(
            [np.asarray(sp.interpolate(lambda *x: self.analytic.g(*x, (i + off) * dt))) for i in range(self.N)]
        )
        self.f = to_device(f, cfg.dtype, self.device)
        self.g = to_device(g, cfg.dtype, self.device)
        self.u0 = to_device(np.asarray(sp.interpolate(self.analytic.u0)), cfg.dtype, self.device)
        self.u1 = to_device(np.asarray(sp.interpolate(self.analytic.u1)), cfg.dtype, self.device)

    # ------------------------------------------------------------ Lagrangian

    def lagrangian(self, u: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """The discrete Lagrangian S(u, p) (Func_Version.py:86-95)."""
        cfg = self.config
        sp = self.space
        dt = cfg.dt
        gamma = cfg.gamma
        ghost = self.u0 + dt * self.u1  # u_{-1} (Func_Version.py:65,69)

        # u_{i-1}, u_{i-2} with the prototype's ghost substitutions.
        N = u.shape[0]
        um1 = torch.cat([ghost[None], u[: N - 1]])
        um2 = torch.cat([self.u0[None], ghost[None], u[: max(N - 2, 0)]])[:N]

        d2u = (u - 2.0 * um1 + um2) / (dt * dt)
        ubar = 0.5 * (u + um2)

        def mdot(a, b):
            return torch.sum(a * sp.apply_mass(b))

        def kdot(a, b):
            return torch.sum(a * sp.apply_stiffness(b))

        S = 0.5 * dt * mdot(u - self.g, u - self.g)
        S = S + 0.5 * dt / gamma * mdot(p, p)
        S = S + dt * (mdot(p, d2u) - mdot(p, self.f) - mdot(p, p) / gamma)
        S = S + dt * kdot(p, ubar)
        return S

    def kkt_residual(self, u: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """grad S -- the optimality system (the reference's
        ``fd.derivative(S, U)``, Func_Version.py:102), ``(2, N_t-1, n)``."""
        return torch.func.grad(lambda up: self.lagrangian(up[0], up[1]))(torch.stack([u, p]))

    def hvp(self, v: torch.Tensor) -> torch.Tensor:
        """``H v``, H the (constant) Hessian of S: forward-mode ``jvp`` over
        the reverse-mode gradient, at the origin."""
        grad_fn = lambda x: self.kkt_residual(x[0], x[1])
        return torch.func.jvp(grad_fn, (torch.zeros_like(v),), (v,))[1]

    # ----------------------------------------------------------------- solve

    def solve(self, method: str = "direct", rtol: float = 1e-10, maxiter: int = 2000) -> LagrangianSolution:
        """Newton-step solve: S is quadratic, so one linear solve of
        ``H x = -grad S(0)`` with H applied as a Hessian-vector product.

        'direct' (default) materializes H column by column through HVPs
        (``torch.func.vmap`` over chunks of 256 unit vectors) and LU-solves
        -- the analogue of the prototype's MUMPS path (``Func_Version.py:105``;
        the unpreconditioned saddle KKT system is too ill-conditioned for
        plain Krylov). 'gmres' is the matrix-free route for
        experimentation."""
        n = self.space.n
        shape = (2, self.N, n)
        zero = torch.zeros(shape, dtype=self.config.dtype, device=self.device)
        b = -self.kkt_residual(zero[0], zero[1])

        if method == "direct":
            m = 2 * self.N * n
            eye = torch.eye(m, dtype=self.config.dtype, device=self.device)
            col = torch.func.vmap(lambda e: self.hvp(e.reshape(shape)).reshape(-1))
            cols = torch.cat([col(eye[i : i + _HVP_CHUNK]) for i in range(0, m, _HVP_CHUNK)])
            x = torch.linalg.solve(cols.T, b.reshape(-1)).reshape(shape)
            res_norm = torch.linalg.norm(self.hvp(x).reshape(-1) - b.reshape(-1))
            b_norm = torch.linalg.norm(b.reshape(-1))
            result = GmresResult(
                x=x,
                iterations=torch.tensor(0),
                converged=(res_norm < 1e-6 * b_norm).cpu(),
                residual_norm=res_norm.cpu(),
                residual_history=torch.full((1,), float("nan"), dtype=self.config.dtype),
            )
            return LagrangianSolution(u=x[0], p=x[1], result=result)

        res = gmres(self.hvp, b, restart=200, rtol=rtol, maxiter=maxiter)
        return LagrangianSolution(u=res.x[0], p=res.x[1], result=res)

    def error_vs_analytic(self, sol: LagrangianSolution) -> float:
        """Max-over-time nodal-l2 u error at the prototype's own staggering:
        the i=0 row centers the PDE at t_1 with u_{-1}, u_{-2} ghosts, so
        ``u[i] ~ u(t_{i+1})``."""
        dt = self.config.dt
        u = host_f64(sol.u)
        errs = []
        for i in range(self.N):
            ua = host_f64(self.space.interpolate(lambda *x: self.analytic.u(*x, (i + 1) * dt)))
            errs.append(np.linalg.norm(u[i] - ua))
        return float(np.max(errs))
