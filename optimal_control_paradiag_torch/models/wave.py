"""The wave-equation optimal-control problem (PyTorch).

The counterpart of ``optimal_control_paradiag_tpu/models/wave.py``: space and
operator setup, the manufactured data (f, g, u0, u1), the right-hand side,
the solve, and validation against the manufactured solution. The port has
the diagonalizable ``method='woodbury'`` branch, with ``polish``; the other
methods raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from optimal_control_paradiag_torch.config import ProblemConfig, SolverConfig
from optimal_control_paradiag_torch.fem.space import P1Space, make_space
from optimal_control_paradiag_torch.models.analytic import manufactured
from optimal_control_paradiag_torch.ops.allatonce import build_operator, build_rhs
from optimal_control_paradiag_torch.paradiag.spectral import (
    build_polished_solver,
    build_woodbury_solver,
    spectral_relative_residual,
)
from optimal_control_paradiag_torch.utils.constants import host_f64, resolve_device, to_device

# Where each method that the port does not have yet stands in ROADMAP Queue A.
_NOT_PORTED = {
    "gmres": "item 5 (GMRES + ParaDiag preconditioner)",
    "minres": "item 8 (MINRES, spectral GMRES and direct)",
    "spectral": "item 8 (MINRES, spectral GMRES and direct)",
    "direct": "item 8 (MINRES, spectral GMRES and direct)",
}


class WaveSolution(NamedTuple):
    """Physical (unscaled) solution trajectories and the solver record."""

    u: torch.Tensor  # (N_t, n) -- u_sol[i] lives at output time t_{i+2}
    p: torch.Tensor  # (N_t, n) -- p_sol[i] lives at output time t_{i+1}
    result: Optional[object]  # iterative-solver record; None for direct solves


class WaveControlProblem:
    """All-at-once optimal control of the wave equation, 1D or 2D.

    ``device``: where the solve runs, 'cuda' by default; without a CUDA card
    the constructor raises unless ``device='cpu'`` is passed.
    ``data``: nodal data ``{'f': (N_t, n), 'g': (N_t, n), 'u0': (n,),
    'u1': (n,)}`` (f, u0, u1 already scaled by sqrt(gamma) in scaled mode),
    by default the manufactured problem's."""

    def __init__(self, config: ProblemConfig, device="cuda", data: Optional[Dict] = None):
        self.config = config
        self.device = resolve_device(device)
        self.space: P1Space = make_space(
            config.dim,
            config.N_x,
            mass=config.mass,
            dtype=config.dtype,
            device=self.device,
            dst_precision=config.dst_precision,
            dst_method=config.dst_method,
        )
        self.operator = build_operator(
            self.space, config.N_t, config.dt, config.gamma, scaled=config.scaled
        )
        self.analytic = manufactured(config.dim, config.T, config.gamma)
        self._data = self._build_data() if data is None else {
            name: to_device(np.asarray(data[name]), config.dtype, self.device)
            for name in ("f", "g", "u0", "u1")
        }
        self._solver_cache: Dict[SolverConfig, callable] = {}

    # ------------------------------------------------------------------ data

    def _build_data(self) -> Dict[str, torch.Tensor]:
        """Nodal data: f at t = i*dt, g at t = (i+1)*dt, ICs at t = 0; in
        scaled mode f, u0, u1 carry the sqrt(gamma) factor, g never does."""
        cfg = self.config
        sp = self.space
        dt = cfg.dt
        f = np.stack(
            [np.asarray(sp.interpolate(lambda *x: self.analytic.f(*x, i * dt))) for i in range(cfg.N_t)]
        )
        g = np.stack(
            [np.asarray(sp.interpolate(lambda *x: self.analytic.g(*x, (i + 1) * dt))) for i in range(cfg.N_t)]
        )
        u0 = np.asarray(sp.interpolate(self.analytic.u0))
        u1 = np.asarray(sp.interpolate(self.analytic.u1))
        scale = math.sqrt(cfg.gamma) if cfg.scaled else 1.0
        return {
            "f": to_device(scale * f, cfg.dtype, self.device),
            "g": to_device(g, cfg.dtype, self.device),
            "u0": to_device(scale * u0, cfg.dtype, self.device),
            "u1": to_device(scale * u1, cfg.dtype, self.device),
        }

    @functools.cached_property
    def rhs(self) -> torch.Tensor:
        """The assembled right-hand side ``(2, N_t, n)``, cached."""
        d = self._data
        return build_rhs(self.operator, d["f"], d["g"], d["u0"], d["u1"])

    # ----------------------------------------------------------------- solve

    def _unscale(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Scaled unknowns -> physical (u_hat = sqrt(gamma) u; p unscaled)."""
        scale = math.sqrt(self.config.gamma) if self.config.scaled else 1.0
        return x[0] / scale, x[1]

    def _make_solver(self, solver: SolverConfig):
        op = self.operator
        if solver.method != "woodbury":
            raise NotImplementedError(
                f"method={solver.method!r} is not ported yet: ROADMAP Queue A "
                f"{_NOT_PORTED[solver.method]}"
            )
        if not self.space.diagonalizable:
            raise NotImplementedError(
                "the Woodbury solve of non-sine-diagonalizable spaces (2D consistent "
                "mass) is not ported yet: ROADMAP Queue A item 9"
            )
        if solver.use_pallas:
            from optimal_control_paradiag_torch.paradiag.cuda_woodbury import (
                build_cuda_woodbury_solver,
            )

            # CUDA kernel on a CUDA device; its plain twin on device='cpu'.
            wb = build_cuda_woodbury_solver(op, refine=solver.refine)
        else:
            wb = build_woodbury_solver(op, refine=solver.refine)
        if solver.polish:
            # physical-space defect correction on top of either solve
            wb = build_polished_solver(op, polish=solver.polish, base_solver=wb)

        def run(b, x0=None):
            return wb(b), None

        return run

    def make_solver_fn(self, solver: Optional[SolverConfig] = None):
        """The cached solve function ``b -> (x_scaled, result)`` for a
        given config."""
        solver = solver or SolverConfig()
        if solver not in self._solver_cache:
            self._solver_cache[solver] = self._make_solver(solver)
        return self._solver_cache[solver]

    def solve(
        self, solver: Optional[SolverConfig] = None, x0: Optional[torch.Tensor] = None
    ) -> WaveSolution:
        """Solve the all-at-once system; returns physical (unscaled) u, p.
        ``x0`` is accepted for the iterative methods; the direct solve
        ignores it."""
        x, res = self.make_solver_fn(solver)(self.rhs, x0)
        u, p = self._unscale(x)
        return WaveSolution(u=u, p=p, result=res)

    def residual_norm(self, sol: WaveSolution) -> torch.Tensor:
        """|| A x - b || of the scaled system, in the working dtype."""
        scale = math.sqrt(self.config.gamma) if self.config.scaled else 1.0
        x = torch.stack([sol.u * scale, sol.p])
        return torch.linalg.norm((self.operator.matvec(x) - self.rhs).reshape(-1))

    def relative_residual_f64(self, sol: WaveSolution) -> float:
        """``||A x - b|| / ||b||`` via the host float64 spectral oracle
        (:func:`paradiag.spectral.spectral_relative_residual`): it measures
        the true residual of float32 solutions, below the float32 matvec's
        cancellation noise floor (~1e-3)."""
        scale = math.sqrt(self.config.gamma) if self.config.scaled else 1.0
        x = np.stack([host_f64(sol.u) * scale, host_f64(sol.p)])
        return spectral_relative_residual(self.operator, x, host_f64(self.rhs))

    # ------------------------------------------------------------ validation

    def output_trajectories(self, sol: WaveSolution) -> Tuple[np.ndarray, np.ndarray]:
        """Map staggered unknowns to the output time grid t_i = i*dt,
        i = 0..N_t, as the reference's ``write()`` does:

          u_out(t_0) = u0,  u_out(t_1) = cos(pi dt) u0 + dt u1,
          u_out(t_i) = u_sol[i-2] (2 <= i <= N_t, u_sol[N_t-2] reused at
          i = N_t);  p_out(t_0) = 0, p_out(t_i) = p_sol[i-1] (1 <= i < N_t),
          p_out(t_N_t) = 0.
        """
        cfg = self.config
        n = self.space.n
        u = host_f64(sol.u)
        p = host_f64(sol.p)
        scale = math.sqrt(cfg.gamma) if cfg.scaled else 1.0
        u0 = host_f64(self._data["u0"]) / scale
        u1 = host_f64(self._data["u1"]) / scale
        u_out = np.zeros((cfg.N_t + 1, n))
        p_out = np.zeros((cfg.N_t + 1, n))
        u_out[0] = u0
        u_out[1] = math.cos(math.pi * cfg.dt) * u0 + cfg.dt * u1
        for i in range(2, cfg.N_t + 1):
            u_out[i] = u[min(i - 2, cfg.N_t - 2)]
        for i in range(1, cfg.N_t):
            p_out[i] = p[i - 1]
        return u_out, p_out

    def error_vs_analytic(self, sol: WaveSolution) -> float:
        """The reference's published error metric: max over output times
        t_i, i = 2..N_t, of the nodal-l2 error of u against the analytic
        solution. It carries the reference's one-step output lag (see
        :meth:`error_aligned`)."""
        cfg = self.config
        u_out, _ = self.output_trajectories(sol)
        errs = []
        for i in range(2, cfg.N_t + 1):
            ua = host_f64(self.space.interpolate(lambda *x: self.analytic.u(*x, i * cfg.dt)))
            errs.append(np.linalg.norm(u_out[i] - ua))
        return float(np.max(errs))

    def error_aligned(self, sol: WaveSolution) -> float:
        """Lag-corrected error metric: each unknown at the time the discrete
        equations place it (``u_sol[j] ~ u(t_{j+1})``); max over j of the
        nodal-l2 u-error."""
        cfg = self.config
        u = host_f64(sol.u)
        errs = []
        for j in range(cfg.N_t):
            ua = host_f64(
                self.space.interpolate(lambda *x: self.analytic.u(*x, (j + 1) * cfg.dt))
            )
            errs.append(np.linalg.norm(u[j] - ua))
        return float(np.max(errs))
