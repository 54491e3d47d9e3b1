"""Optimal control of the HEAT equation (PyTorch): the second model family.

The counterpart of ``optimal_control_paradiag_tpu/models/heat.py``. The
parabolic tracking problem

    min 1/2 ||u - g||^2 + gamma/2 ||us||^2
    s.t.  u_t - Lap u = f + us,  u|_bnd = 0,  u(0) = u0,

with the control eliminated through the adjoint (``us = p / gamma``),
backward Euler in time (step ``tau = T / N_t``) and P1 elements in space, on
the sqrt(gamma)-scaled state ``uh = sqrt(g) u``. Unknowns ``u_i ~ u(t_{i+1})``,
``p_i ~ p(t_{i+1})``, i = 0..N_t-1:

    u-row i: M(uh_i - uh_{i-1}) + tau K uh_i - (tau/sqrt(g)) M p_i
               = tau M fh_i  (+ M uh_0 on row 0)
    p-row i: M(p_i - p_{i+1}) + tau K p_i + (tau/sqrt(g)) M uh_i
               = tau M g_i   (p_{N_t} = 0)

Per (time mode k, sine wavenumber j) the block circulant part is the 2x2
block ``a11 = (1 - omega_k) muM + tau muK``, ``a22 = conj(a11)``, coupling
``-+ tm = (tau/sqrt(g)) muM``; the true operator differs from it by a RANK-2
time correction (the wraparound touches only u-row 0, reading u_{N_t-1}, and
p-row N_t-1, reading p_0), so the direct solve is a 2x2-capacity
Sherman-Morrison-Woodbury identity on the ``K = N_t//2 + 1`` half-spectrum
bins, exactly parallel to the wave family's rank-4 one.

``method='woodbury'`` is the direct solve on diagonalizable spaces (1D, or
2D with ``mass='lumped'``): ``use_pallas=True`` routes it to the
hand-written CUDA kernel (``paradiag/cuda_heat.py``), and ``polish`` adds
physical-space defect correction. On the 2D consistent mass it is GMRES
preconditioned by the exact SMW solve of the tensor-mass surrogate
(:meth:`HeatControlProblem.build_tensor_gmres_solver`). ``method='gmres'`` runs GMRES with the circulant ParaDiag
preconditioner (:meth:`HeatControlProblem.build_preconditioner`),
``method='minres'`` MINRES on the symmetrized system
(:meth:`HeatControlProblem.build_symmetric_system`) and ``method='direct'``
dense LU (:meth:`HeatControlProblem.dense`). The operators and the solver
builders take states with leading batch axes, ``(..., 2, N_t, n)``, the
counterpart of the JAX package's ``jax.vmap`` over them.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from optimal_control_paradiag_torch.config import ProblemConfig, SolverConfig
from optimal_control_paradiag_torch.fem.space import P1Space, _np_shift, make_space, require_full_fp32_matmul
from optimal_control_paradiag_torch.krylov.gmres import gmres
from optimal_control_paradiag_torch.paradiag.woodbury2d import solve_lanes
from optimal_control_paradiag_torch.krylov.minres import minres
from optimal_control_paradiag_torch.ops.allatonce import dense_lu_solver, dense_matrix, join_state, split_state, tshift
from optimal_control_paradiag_torch.paradiag import spectral
from optimal_control_paradiag_torch.paradiag.symmetric import _swap
from optimal_control_paradiag_torch.paradiag.spectral import (
    make_halfspectrum_transforms,
    pairing_weights,
)
from optimal_control_paradiag_torch.utils.constants import complex_dtype, host_f64, resolve_device, to_device

def _not_ported(what: str, item: str):
    raise NotImplementedError(f"heat model: {what} is not ported yet: ROADMAP Queue A {item}")


class HeatSolution(NamedTuple):
    u: torch.Tensor  # (N_t, n), u_sol[i] ~ u(t_{i+1}), physical (unscaled)
    p: torch.Tensor  # (N_t, n), p_sol[i] ~ p(t_{i+1})
    result: Optional[object]  # iterative-solver record; None for direct solves


class HeatControlProblem:
    """All-at-once heat-equation optimal control, scaled form.

    ``device``: where the solve runs, 'cuda' by default; without a CUDA card
    the constructor raises unless ``device='cpu'`` is passed.
    ``data``: nodal data ``{'f': (N_t, n), 'g': (N_t, n), 'u0': (n,)}`` (f and
    u0 already scaled by sqrt(gamma)), by default the manufactured
    problem's."""

    def __init__(self, config: ProblemConfig, device="cuda", data: Optional[Dict] = None):
        if not config.scaled:
            raise ValueError("the heat model is implemented in scaled ('pc') form")
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
        self.tau = config.T / config.N_t
        self._data = self._build_data() if data is None else {
            name: to_device(np.asarray(data[name]), config.dtype, self.device)
            for name in ("f", "g", "u0")
        }
        self._cache: Dict[SolverConfig, Callable] = {}

    @property
    def _theta(self) -> float:
        """The coupling coefficient ``tau / sqrt(gamma)``."""
        return self.tau / math.sqrt(self.config.gamma)

    # ------------------------------------------------------------------ data

    def _analytic(self):
        """The manufactured optimality pair, any dim (callables of
        ``(*coords, t)``):

            u = prod_d sin(pi x_d) e^{-t},   p = prod_d sin(pi x_d)(e^{t-T} - 1),

        with ``-Lap`` eigenvalue ``dim * pi^2``, ``f = u_t - Lap u - p/gamma``
        and ``g = u - p_t - Lap p``. Returns ``(u, p, f, g)``."""
        T, g = self.config.T, self.config.gamma
        pi = math.pi
        lam = self.config.dim * pi * pi

        def shape(*xs):
            out = np.sin(pi * xs[0])
            for x in xs[1:]:
                out = out * np.sin(pi * x)
            return out

        u = lambda *a: shape(*a[:-1]) * np.exp(-a[-1])
        p = lambda *a: shape(*a[:-1]) * (np.exp(a[-1] - T) - 1.0)
        f = lambda *a: shape(*a[:-1]) * (
            -np.exp(-a[-1]) + lam * np.exp(-a[-1]) - (np.exp(a[-1] - T) - 1.0) / g
        )
        gt = lambda *a: shape(*a[:-1]) * (
            np.exp(-a[-1]) - np.exp(a[-1] - T) + lam * (np.exp(a[-1] - T) - 1.0)
        )
        return u, p, f, gt

    def _build_data(self) -> Dict[str, torch.Tensor]:
        """Nodal data: f and g at ``t = (i+1) tau``, u0 at t = 0; f and u0
        carry the sqrt(gamma) factor, g does not."""
        cfg = self.config
        sp = self.space
        tau = self.tau
        ua, _, fa, ga = self._analytic()
        f = np.stack([np.asarray(sp.interpolate(lambda *x: fa(*x, (i + 1) * tau))) for i in range(cfg.N_t)])
        g = np.stack([np.asarray(sp.interpolate(lambda *x: ga(*x, (i + 1) * tau))) for i in range(cfg.N_t)])
        u0 = np.asarray(sp.interpolate(lambda *x: ua(*x, 0.0)))
        s = math.sqrt(cfg.gamma)
        return {
            "f": to_device(s * f, cfg.dtype, self.device),
            "g": to_device(g, cfg.dtype, self.device),
            "u0": to_device(s * u0, cfg.dtype, self.device),
        }

    # -------------------------------------------------------------- operator

    def _rows(self, x: torch.Tensor, stiffness) -> torch.Tensor:
        sp, tau, th = self.space, self.tau, self._theta
        u, p = split_state(x)
        row_u = sp.apply_mass(u - tshift(u, 1)) + tau * stiffness(u) - th * sp.apply_mass(p)
        row_p = sp.apply_mass(p - tshift(p, -1)) + tau * stiffness(p) + th * sp.apply_mass(u)
        return join_state(row_u, row_p)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x on scaled states ``(..., 2, N_t, n)`` (module docstring)."""
        return self._rows(x, self.space.apply_stiffness)

    def matvec_accurate(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x in cancellation-aware form. The backward-Euler difference
        ``u_i - u_{i-1}`` already is the nested first difference; the one
        remaining float32 cancellation, the stiffness on smooth states, goes
        through :meth:`P1Space.apply_stiffness_nested`. The polish ladder
        (``paradiag.spectral.build_polished_solver``) measures defects with
        it."""
        return self._rows(x, self.space.apply_stiffness_nested)

    @functools.cached_property
    def rhs(self) -> torch.Tensor:
        """``(tau M f + M u0 on row 0, tau M g)``, ``(2, N_t, n)``, cached."""
        d = self._data
        sp, tau = self.space, self.tau
        bu = tau * sp.apply_mass(d["f"])
        bu[0] = bu[0] + sp.apply_mass(d["u0"])
        bp = tau * sp.apply_mass(d["g"])
        return torch.stack([bu, bp])

    # ------------------------------------------------------- spectral pieces

    def _plan(self, mass_surrogate: bool = False):
        """Host float64 constants of the diagonalized system:
        ``(L1, muM, muK, a11, tm, det)`` with ``L1 = 1 - omega_k`` (N_t,),
        ``a11`` and ``det`` (N_t, n), ``tm`` (1, n). ``mass_surrogate``: on
        the 2D consistent mass use the tensor-part mass spectrum
        (``P1Space.spectrum_tensor``), a plan of the surrogate operator for
        preconditioners only."""
        muM, muK = self.space.spectrum
        if muM is None:
            if not mass_surrogate:
                raise ValueError("heat spectral solves need a sine-diagonalizable space")
            muM = self.space.spectrum_tensor
        N_t = self.config.N_t
        muM = np.asarray(muM, np.float64)
        muK = np.asarray(muK, np.float64)
        k = np.arange(N_t)
        L1 = 1.0 - np.exp(2j * np.pi * k / N_t)  # circulant symbol of (I - T^-)
        a11 = L1[:, None] * muM[None, :] + self.tau * muK[None, :]
        tm = self._theta * muM[None, :]
        det = np.abs(a11) ** 2 + tm * tm
        return L1, muM, muK, a11, tm, det

    def _capacity_2x2(self, mass_surrogate: bool = False) -> np.ndarray:
        """Per-wavenumber REAL 2x2 capacity matrices ``G = (I + C W)^{-1} C``
        (float64 host), ``W = Phi* D^{-1} Psi`` with extractions (u slice
        N_t-1, p slice 0) and injections (u row 0, p row N_t-1), ``C =
        diag(muM, muM)``. The Hermitian pairing makes G real; raises if not."""
        N_t = self.config.N_t
        _, muM64, _, a11_h, tm_h, det_h = self._plan(mass_surrogate=mass_surrogate)
        kf = np.arange(N_t)
        phiE = lambda i: np.exp(-2j * np.pi * i * kf / N_t)
        psiI = lambda i: np.exp(2j * np.pi * i * kf / N_t) / N_t
        E = {
            ("u", "u"): np.conj(a11_h) / det_h,
            ("u", "p"): tm_h / det_h + 0j,  # D^{-1}[u,p] = +tm/det
            ("p", "u"): -tm_h / det_h + 0j,
            ("p", "p"): a11_h / det_h,
        }
        rows = [("u", phiE(N_t - 1)), ("p", phiE(0))]
        cols = [("u", psiI(0)), ("p", psiI(N_t - 1))]
        n = self.space.n
        W = np.zeros((n, 2, 2), np.complex128)
        for a, (ca, pa) in enumerate(rows):
            for b, (cb, pb) in enumerate(cols):
                W[:, a, b] = np.einsum("k,kn,k->n", pa, E[(ca, cb)], pb)
        C = np.zeros((n, 2, 2), np.float64)
        C[:, 0, 0] = muM64
        C[:, 1, 1] = muM64
        G_h = np.linalg.solve(np.eye(2)[None] + C @ W, C.astype(np.complex128))
        if not float(np.abs(G_h.imag).max()) < 1e-9 * max(float(np.abs(G_h.real).max()), 1.0):
            raise ArithmeticError("half-spectrum heat capacity matrices are not real")
        return G_h.real

    def build_woodbury_solver(
        self,
        refine: int = 1,
        mass_surrogate: bool = False,
        layout=None,
        time_transform: Optional[str] = None,
    ) -> Callable[[torch.Tensor], torch.Tensor]:
        """Half-spectrum rank-2 SMW direct solve ``b -> x`` in plain PyTorch
        (module docstring); ``refine`` spectral defect corrections polish
        float32. The per-(mode, wavenumber) diagonal is formed in working
        precision from its 1D factors, as the JAX package's jnp path does
        (the fused kernel packs it from the float64 plan instead).
        ``time_transform``: 'fft2' (packed FFT, default), 'fft', 'dft' or
        'mxu' (``paradiag.spectral.make_halfspectrum_transforms``). With
        ``mass_surrogate`` it is the exact solve of the TENSOR-mass surrogate
        operator (the 2D consistent mass's preconditioner)."""
        require_full_fp32_matmul()
        if layout is not None:
            _not_ported("the sharded Woodbury solve", "item 14")
        time_transform = "fft2" if time_transform is None else time_transform
        cfg = self.config
        N_t = cfg.N_t
        K = N_t // 2 + 1
        rdtype, dev = cfg.dtype, self.device
        np_c = np.dtype(np.complex64 if rdtype == torch.float32 else np.complex128)
        L1, muM64, muK64, _, _, _ = self._plan(mass_surrogate=mass_surrogate)

        k = np.arange(K)
        wgt = pairing_weights(N_t)
        # Extraction phases carry the pairing weight; injections use plain bins.
        phiw = lambda i: to_device(wgt * np.exp(-2j * np.pi * i * k / N_t), np_c, dev)
        psi = lambda i: to_device(np.exp(2j * np.pi * i * k / N_t) / N_t, np_c, dev)
        phi_uN, phi_p1 = phiw(N_t - 1), phiw(0)
        psi_u1, psi_pN = psi(0), psi(N_t - 1)
        G_h = self._capacity_2x2(mass_surrogate=mass_surrogate)
        G = [[to_device(G_h[:, a, b], rdtype, dev) for b in range(2)] for a in range(2)]

        m1 = to_device(muM64, rdtype, dev)
        a11 = to_device(L1[:K], np_c, dev)[:, None] * m1[None, :] + self.tau * to_device(
            muK64, rdtype, dev
        )[None, :]
        a22 = a11.conj()
        tm = self._theta * m1[None, :]
        inv_det = 1.0 / (torch.square(a11.real) + torch.square(a11.imag) + torch.square(tm))

        col = lambda v: v[..., None, :]  # a per-wavenumber row against (..., K, n)

        def D_inv(r):
            ru, rp = split_state(r)
            return join_state((a22 * ru + tm * rp) * inv_det, (a11 * rp - tm * ru) * inv_det)

        def extract(y):
            yu, yp = split_state(y)
            return (
                torch.sum(phi_uN[:, None] * yu, dim=-2).real,
                torch.sum(phi_p1[:, None] * yp, dim=-2).real,
            )

        def A_hat(xi):
            xu, xp = split_state(xi)
            du = a11 * xu - tm * xp
            dp = tm * xu + a22 * xp
            uN, p1 = extract(xi)
            du = du + psi_u1[:, None] * col(m1 * uN)
            dp = dp + psi_pN[:, None] * col(m1 * p1)
            return join_state(du, dp)

        def wb_apply(r):
            y = D_inv(r)
            z = extract(y)
            w = [G[a][0] * z[0] + G[a][1] * z[1] for a in range(2)]
            return y - D_inv(join_state(psi_u1[:, None] * col(w[0]), psi_pN[:, None] * col(w[1])))

        to_spectral, from_spectral = make_halfspectrum_transforms(
            self.space, N_t, rdtype, time_transform=time_transform
        )

        def solve(b):
            b_hat = to_spectral(b)
            x = wb_apply(b_hat)
            for _ in range(refine):
                x = x + wb_apply(b_hat - A_hat(x))
            return from_spectral(x)

        return solve

    def _base_solver(self, refine: int, use_pallas: bool) -> Callable[[torch.Tensor], torch.Tensor]:
        if use_pallas:
            from optimal_control_paradiag_torch.paradiag.cuda_heat import build_cuda_heat_solver

            # CUDA kernel on a CUDA device; its plain twin on device='cpu'.
            return build_cuda_heat_solver(self, refine=refine)
        return self.build_woodbury_solver(refine=refine)

    def build_polished_solver(
        self, polish: int = 1, dword: bool = False, refine: int = 1, use_pallas: bool = False
    ) -> Callable[[torch.Tensor], object]:
        """Rank-2 SMW direct solve + physical-space defect correction
        (``paradiag.spectral.build_polished_solver`` with this problem as the
        operator): each polish step measures the defect with
        :meth:`matvec_accurate` and keeps the correction as an exact
        two-float pair; ``dword=True`` returns ``(x, e)``, whose float64 sum
        carries the residual below the float32 representation floor."""
        base = self._base_solver(refine, use_pallas)
        return spectral.build_polished_solver(self, polish=polish, dword=dword, base_solver=base)

    def build_preconditioner(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """The circulant ParaDiag preconditioner, the heat family's
        ``fulldiag``: rfft over time of ``dst(r)`` (conjugated, scaled by
        1/N_t), the per-(mode, wavenumber) 2x2 Cramer inverse from the
        float64 :meth:`_plan`, then irfft and idst. Raises ``ValueError`` on
        the 2D consistent mass, as the plan does."""
        require_full_fp32_matmul()
        sp = self.space
        N_t = self.config.N_t
        K = N_t // 2 + 1
        rdtype, dev = self.config.dtype, self.device
        cdtype = complex_dtype(rdtype)
        _, _, _, a11_h, tm_h, det_h = self._plan()
        a11 = to_device(a11_h[:K], cdtype, dev)
        a22 = to_device(np.conj(a11_h[:K]), cdtype, dev)
        tm = to_device(tm_h, rdtype, dev)
        invdet = to_device(1.0 / det_h[:K], rdtype, dev)

        def apply_pc(r):
            ru, rp = split_state(torch.conj_physical(torch.fft.rfft(sp.dst(r), dim=-2)) * (1.0 / N_t))
            yu = (a22 * ru + tm * rp) * invdet
            yp = (a11 * rp - tm * ru) * invdet
            y = torch.fft.irfft(torch.conj_physical(join_state(yu, yp)), n=N_t, dim=-2) * float(N_t)
            return sp.idst(y)

        return apply_pc

    def build_symmetric_system(self, layout=None, time_transform: Optional[str] = None):
        """``(matvec_sym, pc_spd, swap)``, the wave family's symmetrized
        ParaDiag (``paradiag/symmetric.py``) for the heat KKT system:
        swapping the (u, p) block rows gives the exactly symmetric
        ``[[th M, B^T], [B, -th M]]``, ``B = (I - T^-) (x) M + tau (x) K``.
        Per (mode, wavenumber) the swapped circulant part is the traceless
        Hermitian ``[[t, conj(a11)], [a11, -t]]`` with eigenvalues ``+/-
        sqrt(det)``, so the SPD preconditioner is the scalar ``T^{-1}
        det^{-1/2} T`` on the half spectrum (``time_transform``: the packed
        FFT 'fft2' by default). The 2D consistent mass uses the tensor-part
        surrogate spectrum in the preconditioner only."""
        if layout is not None:
            _not_ported("the sharded symmetric system", "item 14")
        require_full_fp32_matmul()
        sp = self.space
        N_t = self.config.N_t
        K = N_t // 2 + 1
        _, _, _, _, _, det_h = self._plan(mass_surrogate=not sp.diagonalizable)
        inv_sqrt_det = to_device(1.0 / np.sqrt(det_h[:K]), self.config.dtype, self.device)
        to_s, from_s = make_halfspectrum_transforms(
            sp, N_t, self.config.dtype, time_transform="fft2" if time_transform is None else time_transform
        )

        def matvec_sym(x):
            return _swap(self.matvec(x))

        def pc_spd(r):
            return from_s(to_s(r) * inv_sqrt_det)

        return matvec_sym, pc_spd, _swap

    def build_tensor_gmres_solver(
        self, rtol: float = 1e-10, maxiter: int = 60, with_result: bool = False
    ) -> Callable[[torch.Tensor], object]:
        """Mesh-independent 2D consistent-mass solve: GMRES preconditioned by
        the EXACT tensor-mass surrogate SMW solve, the heat counterpart of
        ``paradiag.woodbury2d.build_tensor_gmres_solver`` (the JAX package
        measures 3-4 iterations at rtol 1e-10 across N). ``solve(b)``
        returns x, or ``(x, GmresResult)`` with ``with_result``; a batch
        ``(B, 2, N_t, n)`` gets per-lane records."""
        W_t = self.build_woodbury_solver(refine=0, mass_surrogate=True)

        def solve(b):
            res = solve_lanes(self.matvec, b, 3, M=W_t, restart=maxiter, rtol=rtol, maxiter=maxiter)
            return (res.x, res) if with_result else res.x

        return solve

    def dense(self, chunk: int = 256) -> torch.Tensor:
        """The dense all-at-once matrix ``(m, m)``, ``m = 2 N_t n``, on the
        problem's device (small-size oracle and the direct solve)."""
        return dense_matrix(self.matvec, (2, self.config.N_t, self.space.n), self.config.dtype, self.device, chunk)

    # ----------------------------------------------------------------- solve

    def _make_solver(self, solver: SolverConfig):
        if solver.method == "gmres":
            # as the JAX package: left-preconditioned, from x0 = 0
            pc = self.build_preconditioner() if solver.pc == "paradiag" else None

            def run(b):
                res = gmres(self.matvec, b, M=pc, restart=solver.restart, rtol=solver.rtol,
                            atol=solver.atol, maxiter=solver.maxiter)
                return res.x, res

            return run
        if solver.method == "minres":
            # as the JAX package: the SPD preconditioner whatever solver.pc
            matvec_sym, pc_spd, swap = self.build_symmetric_system()

            def run_minres(b):
                res = minres(matvec_sym, swap(b), M=pc_spd, rtol=solver.rtol, maxiter=solver.maxiter)
                return res.x, res

            return run_minres
        if solver.method == "direct":
            return dense_lu_solver(self.dense(), (2, self.config.N_t, self.space.n))
        if solver.method != "woodbury":
            raise NotImplementedError(f"heat model: method {solver.method!r}")
        if not self.space.diagonalizable:
            # as the JAX package: tensor GMRES to rtol below 1e-6, else to
            # 1e-10 (float64) / 1e-5 (float32); polish does not apply
            f64 = self.config.dtype == torch.float64
            tight = solver.rtol if solver.rtol < 1e-6 else (1e-10 if f64 else 1e-5)
            return self.build_tensor_gmres_solver(rtol=tight, with_result=True)
        if solver.polish:
            wb = self.build_polished_solver(
                polish=solver.polish, refine=solver.refine, use_pallas=solver.use_pallas
            )
        else:
            wb = self._base_solver(solver.refine, solver.use_pallas)
        return lambda b: (wb(b), None)

    def solve(self, solver: Optional[SolverConfig] = None) -> HeatSolution:
        """Solve the all-at-once system; returns physical (unscaled) u, p."""
        solver = solver or SolverConfig(method="woodbury")
        if solver not in self._cache:
            self._cache[solver] = self._make_solver(solver)
        x, res = self._cache[solver](self.rhs)
        s = math.sqrt(self.config.gamma)
        return HeatSolution(u=x[0] / s, p=x[1], result=res)

    # ------------------------------------------------------------ validation

    def matvec_host_f64(self, x: np.ndarray) -> np.ndarray:
        """Host float64 numpy twin of :meth:`matvec`: the residual oracle of
        float32 solutions."""
        sp, tau, th = self.space, self.tau, self._theta
        x = np.asarray(x, np.float64)
        u, p = x[..., 0, :, :], x[..., 1, :, :]
        um1 = _np_shift(u, 1, -2)
        pp1 = _np_shift(p, -1, -2)
        row_u = (
            sp.apply_mass_host_f64(u - um1)
            + tau * sp.apply_stiffness_host_f64(u)
            - th * sp.apply_mass_host_f64(p)
        )
        row_p = (
            sp.apply_mass_host_f64(p - pp1)
            + tau * sp.apply_stiffness_host_f64(p)
            + th * sp.apply_mass_host_f64(u)
        )
        return np.stack([row_u, row_p], axis=-3)

    def relative_residual_f64(self, sol: HeatSolution) -> float:
        """True ``||A x - b|| / ||b||`` of the (dtype-rounded) system via the
        PHYSICAL host float64 matvec."""
        s = math.sqrt(self.config.gamma)
        x = np.stack([host_f64(sol.u) * s, host_f64(sol.p)])
        b = host_f64(self.rhs)
        r = self.matvec_host_f64(x) - b
        return float(np.linalg.norm(r.ravel()) / np.linalg.norm(b.ravel()))

    def relative_residual(self, sol: HeatSolution) -> float:
        """``||A x - b|| / ||b||`` in the working dtype, on the problem's
        device."""
        s = math.sqrt(self.config.gamma)
        x = torch.stack([sol.u * s, sol.p])
        r = self.matvec(x) - self.rhs
        return float(torch.linalg.norm(r.reshape(-1)) / torch.linalg.norm(self.rhs.reshape(-1)))

    def error_vs_analytic(self, sol: HeatSolution) -> float:
        """Max over time of the nodal-l2 u-error against the manufactured
        solution (``u_sol[i] ~ u(t_{i+1})``), any dim: O(tau + h^2)."""
        ua, _, _, _ = self._analytic()
        tau = self.tau
        u = host_f64(sol.u)
        errs = [
            np.linalg.norm(u[i] - np.asarray(self.space.interpolate(lambda *x: ua(*x, (i + 1) * tau))))
            for i in range(self.config.N_t)
        ]
        return float(np.max(errs))
