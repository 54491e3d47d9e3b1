"""The wave-equation optimal-control problem (PyTorch).

The counterpart of ``optimal_control_paradiag_tpu/models/wave.py``: space and
operator setup, the manufactured data (f, g, u0, u1), the right-hand side,
the solve, and validation against the manufactured solution. Methods:

- ``'gmres'``, the reference's own algorithm: restarted GMRES with the
  ParaDiag preconditioner (``fulldiag`` or ``eig`` with its inner solvers);
- ``'woodbury'``, the direct solve, with ``polish``: the rank-4 Woodbury
  identity where the sine transform diagonalizes the space; on the 2D
  consistent mass GMRES preconditioned by the exact solve of its tensor-mass
  surrogate (``paradiag/woodbury2d.py``); on a triangle mesh the same
  identity over the mesh's pencil eigenbasis (``paradiag/eigbasis.py``),
  inside GMRES up to n = 2000 and as Richardson steps above; with
  ``pc_variant='blockline'`` (structured) / ``'blockband'`` (unstructured
  meshes) the Sherman-Morrison-Woodbury solve over an exact circulant
  factorization;
- ``'spectral'``: GMRES in ParaDiag-diagonalized coordinates;
- ``'minres'``: MINRES on the block-row-swapped symmetric system;
- ``'direct'``: dense LU of the assembled matrix (small problems).

:meth:`WaveControlProblem.make_batched_solver_fn` solves B systems at once.
A problem takes a structured space (1D, 2D lumped or consistent mass) from
its config, or any prebuilt space, such as a
:class:`fem.general.GeneralP1Space` on a triangle mesh.
"""

from __future__ import annotations

import functools
import math
import warnings
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from optimal_control_paradiag_torch.config import ProblemConfig, SolverConfig
from optimal_control_paradiag_torch.fem.space import P1Space, make_space
from optimal_control_paradiag_torch.krylov.gmres import GmresResult, gmres, gmres_batched
from optimal_control_paradiag_torch.krylov.minres import minres
from optimal_control_paradiag_torch.models.analytic import manufactured
from optimal_control_paradiag_torch.ops.allatonce import build_operator, build_rhs, dense_lu_solver
from optimal_control_paradiag_torch.paradiag.blockband import band_profile, blockband_entries
from optimal_control_paradiag_torch.paradiag.blockline import blockline_entries
from optimal_control_paradiag_torch.paradiag.eigbasis import (
    RICHARDSON_MIN_N,
    build_eig_basis,
    build_eig_direct_fn,
    build_eig_gmres_solver,
    default_richardson_steps,
)
from optimal_control_paradiag_torch.paradiag.inner import (
    make_cocg_inner_solver,
    make_dst_inner_solver,
    make_jacobi_cocg_inner_solver,
    make_tridiag_inner_solver,
)
from optimal_control_paradiag_torch.paradiag.pc import build_preconditioner
from optimal_control_paradiag_torch.paradiag.spectral import (
    build_polished_solver,
    build_spectral_system,
    build_woodbury_solver,
    spectral_relative_residual,
)
from optimal_control_paradiag_torch.paradiag.symmetric import build_symmetric_system
from optimal_control_paradiag_torch.paradiag.woodbury2d import build_tensor_gmres_solver, build_woodbury2d_solver
from optimal_control_paradiag_torch.utils.constants import host_f64, resolve_device, to_device
from optimal_control_paradiag_torch.utils.timing import counted_span, spanned


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
    by default the manufactured problem's.
    ``space``: a prebuilt space in place of the structured one of the
    config, e.g. a :class:`fem.general.GeneralP1Space` on a triangle mesh;
    it must be 2D (``config.N_x`` then plays no part in the geometry) and
    lie on ``device``.

    On a triangle mesh above n = 2000 the direct solve builds the mesh's
    pencil eigenbasis once and keeps it (``_eig_basis``; the seconds of its
    setup phases in ``eig_setup_s``), whatever solver configs follow."""

    def __init__(self, config: ProblemConfig, device="cuda", data: Optional[Dict] = None, space=None):
        self.config = config
        self.device = resolve_device(device)
        if space is not None and torch.device(space.device).type != self.device.type:
            raise ValueError(f"the space lies on {space.device}, the problem on {self.device}")
        self.space: P1Space = space if space is not None else make_space(
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
        self._eig_basis = None
        self.eig_setup_s: Dict[str, float] = {}

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

    def _make_solver(self, solver: SolverConfig, batched: bool = False):
        """``run(b, x0=None) -> (x, result)``; ``batched``: b is ``(B, 2,
        N_t, n)``, and the iterative methods keep a record per lane. Each
        call is inside the span ``entry/wave.<method>`` (the direct solve of
        a large triangle mesh: ``entry/wave.eig_richardson``)."""
        richardson = (solver.method == "woodbury" and not self.space.diagonalizable
                      and self._eig_richardson_route(solver))
        method = "eig_richardson" if richardson else solver.method
        return spanned("entry/wave." + method, self._make_run(solver, batched))

    def _make_run(self, solver: SolverConfig, batched: bool):
        op = self.operator
        krylov = gmres_batched if batched else gmres
        if solver.method == "gmres":
            return self._make_gmres_solver(solver, krylov)
        if solver.method == "direct":
            return dense_lu_solver(op.dense(), op.shape)
        if solver.method == "spectral":
            if solver.use_pallas:
                raise ValueError(
                    "the fused spectral-step Pallas kernel was removed after "
                    "losing to the XLA-fused jnp path on hardware (v5e, "
                    "N_x=2048/N_t=1024: 0.392 vs 0.357 ms per step, 592 ms "
                    "either way end-to-end); use_pallas now applies to "
                    "method='woodbury' (the fused full-solve kernel, which "
                    "wins)"
                )
            A_hat, D_inv, to_s, from_s = build_spectral_system(op)

            def run(b, x0=None):
                res = krylov(A_hat, to_s(b), M=D_inv, x0=None if x0 is None else to_s(x0),
                             restart=solver.restart, rtol=solver.rtol, atol=solver.atol, maxiter=solver.maxiter)
                return from_s(res.x), res

            return run
        if solver.method == "minres":
            # the block-row swap makes the system exactly symmetric; the SPD
            # preconditioner is the scalar absolute-value circulant
            # (paradiag/symmetric.py)
            matvec_sym, pc_spd, swap_rhs = build_symmetric_system(op)
            M = pc_spd if solver.pc == "paradiag" else None

            def run(b, x0=None):
                res = minres(matvec_sym, swap_rhs(b), M=M, x0=x0, rtol=solver.rtol, maxiter=solver.maxiter,
                             batch_dims=int(batched))
                return res.x, res

            return run
        if not self.space.diagonalizable:
            if self._eig_richardson_route(solver):
                return self._make_eig_richardson_solver(solver)
            wb = self._nondiagonal_direct_solver(solver)
        elif solver.use_pallas:
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

    def _nondiagonal_direct_solver(self, solver: SolverConfig):
        """The direct-solve API (``method='woodbury'``) on a space the sine
        transform does not diagonalize, as the JAX package routes it: on the
        2D consistent mass GMRES preconditioned by the exact tensor-mass
        Woodbury solve (mesh-independent), or with ``pc_variant='blockline'``
        the SMW solve over block-Thomas; on an unstructured mesh up to n =
        2000 GMRES preconditioned by the exact eigenbasis Woodbury solve (1
        iteration with a float64 basis, a mesh-independent handful with a
        float32 one), or with ``pc_variant='blockband'`` the SMW solve over
        the RCM-banded factorization. The GMRES tolerance is ``solver.rtol``
        below 1e-6, else 1e-10 in float64 and 1e-5 in float32.

        The tensor GMRES's surrogate solve: with ``use_pallas=True`` B1
        between the packed 'fft2' time transforms
        (``build_cuda_woodbury_solver(op, refine=0, mass_surrogate=True)``:
        one launch an apply on a CUDA space, the kernel's plain twin on the
        CPU); with ``use_pallas=False`` the eager composition over torch's
        rfft. Either runs at refine 0, whatever ``solver.refine`` says: in
        float64 the surrogate's solve is exact but for rounding. The other
        routes take no ``use_pallas``."""
        op = self.operator
        f64 = self.config.dtype == torch.float64
        tight = solver.rtol if solver.rtol < 1e-6 else (1e-10 if f64 else 1e-5)
        structured = hasattr(self.space, "n1d")
        if solver.pc_variant == ("blockline" if structured else "blockband"):
            return build_woodbury2d_solver(op, cap_rtol=tight)
        if not structured:
            return build_eig_gmres_solver(op, rtol=tight)
        surrogate = None
        if solver.use_pallas:
            from optimal_control_paradiag_torch.paradiag.cuda_woodbury import build_cuda_woodbury_solver

            surrogate = build_cuda_woodbury_solver(op, refine=0, mass_surrogate=True)
        return build_tensor_gmres_solver(op, rtol=tight, surrogate_solve=surrogate)

    def _eig_richardson_route(self, solver: SolverConfig) -> bool:
        """Whether the direct solve takes the eigenbasis Richardson route: a
        triangle mesh above n = 2000 without ``pc_variant='blockband'``."""
        return (not hasattr(self.space, "n1d") and solver.pc_variant != "blockband"
                and self.space.n > RICHARDSON_MIN_N)

    def _make_eig_richardson_solver(self, solver: SolverConfig):
        """The direct solve of a large triangle mesh: the argument-form
        Richardson solve over the pencil eigenbasis
        (``eigbasis.build_eig_direct_fn``), ``default_richardson_steps(basis)
        + solver.polish`` steps (0 for a float64 host basis, 2 for float32
        LAPACK, 8 for divide and conquer). The basis is built once per
        problem (``build_eig_basis``'s 'auto': cuSOLVER on the card).

        The solve is not adaptive. Its record is a ``GmresResult`` with the
        steps as its iteration count and the measured relative residual
        ``||b - A_acc x|| / ||b||`` (times ``||b||`` as the residual norm),
        converged when that is at most ``rtol`` (float64) or ``max(rtol,
        5e-4)`` (float32: a float32 basis floors near 1e-4); reading it is
        the solve's one host synchronization, and a solve that misses it
        warns."""
        if self._eig_basis is None:
            self._eig_basis = build_eig_basis(self.space, timings=self.eig_setup_s)
        basis = self._eig_basis
        steps = default_richardson_steps(basis) + solver.polish
        fn = build_eig_direct_fn(self.operator, basis, steps=steps, with_residual=True)
        f64 = self.config.dtype == torch.float64
        rtol_eig = solver.rtol if f64 else max(solver.rtol, 5e-4)

        def run(b, x0=None):
            x, rel = fn(b, basis.V)
            bn = torch.linalg.norm(b.reshape(b.shape[:-3] + (-1,)), dim=-1)
            with counted_span("host/sync"):
                rel_h, bn_h = torch.stack([rel, bn]).cpu()
            res = GmresResult(
                x=x,
                iterations=torch.full(rel_h.shape, steps, dtype=torch.int64),
                converged=rel_h <= rtol_eig,
                residual_norm=rel_h * bn_h,
                residual_history=(rel_h * bn_h)[..., None],
            )
            if not bool(torch.all(res.converged)):
                warnings.warn(
                    f"eig-basis Richardson ({steps} steps) measured relative residual "
                    f"{float(rel_h.max()):.3e} > rtol {rtol_eig:.1e}; add polish steps, use float64, "
                    "or rebuild the basis with method='host'",
                    stacklevel=2,
                )
            return x, res

        return run

    def _auto_variant(self, solver: SolverConfig):
        """``(variant, inner)`` of ``inner='auto'`` on a space the sine
        transform does not diagonalize, the JAX package's rule. Structured 2D
        consistent mass: the block-Thomas factorization while its factors
        fit (4e8 entries), else the coupled block COCG. Unstructured: the
        dense per-mode inverses up to 3e8 entries, then the RCM-banded
        factorization up to 4e8, then 'eig' with Jacobi-COCG."""
        cfg, sp = self.config, self.space
        if hasattr(sp, "n1d"):
            return ("blockline" if blockline_entries(cfg.N_t, sp.n1d) <= 4e8 else "block"), None
        if cfg.N_t * (2 * sp.n) ** 2 <= 3e8:
            return "blockdense", None
        _, m_band = band_profile(sp)
        if blockband_entries(cfg.N_t, sp.n, m_band) <= 4e8:
            return "blockband", None
        return "eig", make_jacobi_cocg_inner_solver(sp, cfg.dt, solver.inner_tol, solver.inner_maxiter)

    def _make_gmres_solver(self, solver: SolverConfig, krylov=gmres):
        """GMRES (``krylov``: :func:`gmres`, or :func:`gmres_batched` for a
        batch) on the all-at-once system, preconditioned as the JAX
        package's ``gmres`` branch routes it: ``inner='auto'`` keeps
        ``pc_variant``; an explicit inner solver selects the ``eig`` variant
        with that per-mode solve."""
        op = self.operator
        cfg = self.config
        pc_apply = None
        if solver.pc == "paradiag":
            variant = solver.pc_variant
            inner = None
            if solver.inner == "auto":
                # an explicit pc_variant is always kept
                if not self.space.diagonalizable and variant == "fulldiag":
                    variant, inner = self._auto_variant(solver)
            elif solver.inner == "dst":
                variant = "eig"
                inner = make_dst_inner_solver(self.space, cfg.dt)
            elif solver.inner in ("tridiag_thomas", "tridiag_pcr"):
                variant = "eig"
                inner = make_tridiag_inner_solver(self.space, cfg.dt, method=solver.inner.split("_")[1])
            elif solver.inner == "cocg":
                variant = "eig"
                inner = make_cocg_inner_solver(self.space, cfg.dt, solver.inner_tol, solver.inner_maxiter)
            elif solver.inner == "cocg_jacobi":
                variant = "eig"
                inner = make_jacobi_cocg_inner_solver(
                    self.space, cfg.dt, solver.inner_tol, solver.inner_maxiter
                )
            pc_apply = build_preconditioner(op, variant=variant, inner_solver=inner)

        # float32 on non-sine-diagonalizable spaces (2D consistent, triangle
        # meshes): GMRES on op.matvec stalls on the stencil's smooth-mode
        # cancellation noise (the JAX package measures 69 iterations on its
        # perturbed-mesh bench problem); the cancellation-aware matvec keeps
        # the float64 iteration counts. float64 keeps the plain stencils.
        f32 = cfg.dtype == torch.float32
        mv = op.matvec_accurate if (f32 and not self.space.diagonalizable) else op.matvec

        def run(b, x0=None):
            res = krylov(
                mv,
                b,
                M=pc_apply,
                x0=x0,
                restart=solver.restart,
                rtol=solver.rtol,
                atol=solver.atol,
                maxiter=solver.maxiter,
                side=solver.pc_side,
            )
            return res.x, res

        return run

    def make_solver_fn(self, solver: Optional[SolverConfig] = None):
        """The cached solve function ``b -> (x_scaled, result)`` for a
        given config."""
        solver = solver or SolverConfig()
        if solver not in self._solver_cache:
            self._solver_cache[solver] = self._make_solver(solver)
        return self._solver_cache[solver]

    def make_batched_solver_fn(self, solver: Optional[SolverConfig] = None):
        """Solve many all-at-once systems at once: ``bs (B, 2, N_t, n) ->
        (xs (B, 2, N_t, n), results)``, the counterpart of the JAX package's
        ``jax.jit(jax.vmap(...))`` of the single solve, cached under
        ``(solver, 'batched')``. The batch axis rides every layer: the
        transforms and matvecs run on the whole batch, and a fused Woodbury
        solve is ONE kernel launch (B1 takes a batch axis). ``x0``, if
        given, is ``(B, 2, N_t, n)``.

        The iterative methods run their lanes in lock-step, as ``vmap`` does:
        the batch pays for its slowest lane, each lane keeps its own count
        and history, and every field of the returned ``GmresResult`` /
        ``MinresResult`` has a leading B axis. The direct methods return
        ``None`` for the results."""
        solver = solver or SolverConfig()
        key = (solver, "batched")
        if key not in self._solver_cache:
            self._solver_cache[key] = self._make_solver(solver, batched=True)
        return self._solver_cache[key]

    def solve(
        self, solver: Optional[SolverConfig] = None, x0: Optional[torch.Tensor] = None
    ) -> WaveSolution:
        """Solve the all-at-once system; returns physical (unscaled) u, p.
        ``x0``: the warm-start iterate of the iterative methods, in scaled
        unknowns ``(2, N_t, n)`` (rtol is then relative to its initial
        residual, PETSc's rule); the direct solves ignore it."""
        x, res = self.make_solver_fn(solver)(self.rhs, x0)
        u, p = self._unscale(x)
        return WaveSolution(u=u, p=p, result=res)

    def residual_norm(self, sol: WaveSolution) -> torch.Tensor:
        """|| A x - b || of the scaled system, in the working dtype."""
        scale = math.sqrt(self.config.gamma) if self.config.scaled else 1.0
        x = torch.stack([sol.u * scale, sol.p])
        return torch.linalg.norm((self.operator.matvec(x) - self.rhs).reshape(-1))

    def relative_residual_f64(self, sol: WaveSolution) -> float:
        """``||A x - b|| / ||b||`` via a host float64 oracle: it measures the
        true residual of float32 solutions, below the float32 matvec's
        cancellation noise floor (~1e-3). Sine-diagonalizable grids use the
        spectral-coordinate oracle
        (:func:`paradiag.spectral.spectral_relative_residual`), other spaces
        (2D consistent mass, triangle meshes) the space-generic numpy matvec
        (:meth:`ops.allatonce.AllAtOnceOperator.matvec_host_f64`)."""
        scale = math.sqrt(self.config.gamma) if self.config.scaled else 1.0
        x = np.stack([host_f64(sol.u) * scale, host_f64(sol.p)])
        b = host_f64(self.rhs)
        if self.space.diagonalizable and hasattr(self.space, "grid_shape"):
            return spectral_relative_residual(self.operator, x, b)
        r = self.operator.matvec_host_f64(x) - b
        return float(np.linalg.norm(r.ravel()) / np.linalg.norm(b.ravel()))

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

