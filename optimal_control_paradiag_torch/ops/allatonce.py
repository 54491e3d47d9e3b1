"""The all-at-once KKT operator and right-hand side (PyTorch).

The counterpart of ``optimal_control_paradiag_tpu/ops/allatonce.py``. For time
slices ``i = 0..N_t-1`` with mass M and stiffness K:

u-rows (state, forward in time):
  i = 0:   (M + dt^2/2 K) u_0 - (c_up/2) M p_0
  i >= 1:  M (u_i - 2 u_{i-1} + u_{i-2}) + dt^2/2 K (u_i + u_{i-2}) - c_up M p_i
p-rows (adjoint, backward in time):
  i < N_t-1:  c_pu M u_i + M (p_i - 2 p_{i+1} + p_{i+2}) + dt^2/2 K (p_i + p_{i+2})
  i = N_t-1:  (M + dt^2/2 K) p_{N-1} + (c_pu/2) M u_{N-1}

with out-of-range unknowns zero, c_up = c_pu = dt^2/sqrt(gamma) (scaled) or
c_up = dt^2/gamma, c_pu = dt^2 (unscaled).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from optimal_control_paradiag_torch.fem.space import P1Space, _np_shift, shift


def tshift(x: torch.Tensor, s: int) -> torch.Tensor:
    """y[..., i, :] = x[..., i-s, :] along the time axis (dim -2), zero-padded."""
    return shift(x, s, -2)


def split_state(x):
    """(u, p) of a state ``(..., 2, N_t, n)``: dim -3 holds the two blocks."""
    return x[..., 0, :, :], x[..., 1, :, :]


def join_state(u, p):
    """The state ``(..., 2, N_t, n)`` of blocks u and p: :func:`split_state`'s
    inverse."""
    return torch.stack([u, p], dim=-3)


@dataclasses.dataclass(frozen=True)
class AllAtOnceOperator:
    """Matrix-free all-at-once operator A acting on states ``(2, N_t, n)``,
    batched over leading axes ``(..., 2, N_t, n)``."""

    space: P1Space
    N_t: int
    dt: float
    gamma: float
    scaled: bool
    # the (cu, cp) columns of _half_rows, one pair per (dtype, device)
    _half_cache: dict = dataclasses.field(default_factory=dict, init=False, repr=False, compare=False)

    @property
    def c_up(self) -> float:
        """u-row coupling coefficient (enters with a minus sign)."""
        d2 = self.dt * self.dt
        return d2 / math.sqrt(self.gamma) if self.scaled else d2 / self.gamma

    @property
    def c_pu(self) -> float:
        """p-row coupling coefficient (enters with a plus sign)."""
        d2 = self.dt * self.dt
        return d2 / math.sqrt(self.gamma) if self.scaled else d2

    @property
    def shape(self):
        return (2, self.N_t, self.space.n)

    @property
    def size(self) -> int:
        return 2 * self.N_t * self.space.n

    def _half_rows(self, x: torch.Tensor):
        """(cu, cp): the 1/2 coupling weights of the i=0 u-row and the
        i=N_t-1 p-row, as (N_t, 1) columns of x's dtype. Every matvec needs
        them, so they are made once per dtype and device: making them
        writes two Python scalars into device tensors."""
        key = (x.dtype, x.device)
        if key not in self._half_cache:
            cu = torch.ones((self.N_t, 1), dtype=x.dtype, device=x.device)
            cp = torch.ones((self.N_t, 1), dtype=x.dtype, device=x.device)
            cu[0, 0] = 0.5
            cp[-1, 0] = 0.5
            self._half_cache[key] = (cu, cp)
        return self._half_cache[key]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x for x of shape ``(..., 2, N_t, n)``."""
        sp = self.space
        u, p = split_state(x)
        half_d2 = 0.5 * self.dt * self.dt
        mu, mp = sp.apply_mass(u), sp.apply_mass(p)
        ku, kp = sp.apply_stiffness(u), sp.apply_stiffness(p)
        cu, cp = self._half_rows(x)

        au = (mu - 2.0 * tshift(mu, 1) + tshift(mu, 2)) + half_d2 * (ku + tshift(ku, 2))
        au = au - self.c_up * cu * mp

        ap = (mp - 2.0 * tshift(mp, -1) + tshift(mp, -2)) + half_d2 * (kp + tshift(kp, -2))
        ap = ap + self.c_pu * cp * mu

        return join_state(au, ap)

    def matvec_accurate(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x in cancellation-aware form: algebraically :meth:`matvec`,
        numerically far more accurate in float32 on smooth states. Two
        rewrites, in this order:

        1. the time second difference acts on the RAW state as nested first
           differences ``(u_i - u_{i-1}) - (u_{i-1} - u_{i-2})``, and the mass
           matrix afterwards (it commutes with the time stencil);
        2. the nested stiffness (:meth:`P1Space.apply_stiffness_nested`) acts
           on the raw state once, and its small results are shift-added. The
           opposite order, ``K_nested(u_i + u_{i-2})``, is 70x worse than even
           the plain form: the pre-addition seeds per-entry rounding that the
           spatial differences amplify by 1/h.

        The physical-space defect correction
        (``paradiag.spectral.build_polished_solver``) measures ``b - A x``
        with it, below the float32 representation floor of x."""
        sp = self.space
        u, p = split_state(x)
        half_d2 = 0.5 * self.dt * self.dt
        du1 = u - tshift(u, 1)
        d2u = du1 - tshift(du1, 1)
        dp1 = p - tshift(p, -1)
        d2p = dp1 - tshift(dp1, -1)
        ku, kp = sp.apply_stiffness_nested(u), sp.apply_stiffness_nested(p)
        cu, cp = self._half_rows(x)
        au = sp.apply_mass(d2u) + half_d2 * (ku + tshift(ku, 2))
        au = au - self.c_up * cu * sp.apply_mass(p)
        ap = sp.apply_mass(d2p) + half_d2 * (kp + tshift(kp, -2))
        ap = ap + self.c_pu * cp * sp.apply_mass(u)
        return join_state(au, ap)

    def matvec_flat(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x for flat x of length ``2 * N_t * n`` (batched: ``(..., size)``)."""
        return self.matvec(x.reshape(x.shape[:-1] + self.shape)).reshape(x.shape)

    def matvec_host_f64(self, x: np.ndarray) -> np.ndarray:
        """A @ x in float64 numpy on the host: the residual oracle twin of
        :meth:`matvec`."""
        sp = self.space
        x = np.asarray(x, np.float64)
        u, p = x[..., 0, :, :], x[..., 1, :, :]
        half_d2 = 0.5 * self.dt * self.dt
        mu, mp = sp.apply_mass_host_f64(u), sp.apply_mass_host_f64(p)
        ku, kp = sp.apply_stiffness_host_f64(u), sp.apply_stiffness_host_f64(p)
        cu = np.ones((self.N_t, 1))
        cu[0, 0] = 0.5
        cp = np.ones((self.N_t, 1))
        cp[-1, 0] = 0.5
        sh = lambda a, s: _np_shift(a, s, -2)
        au = (mu - 2.0 * sh(mu, 1) + sh(mu, 2)) + half_d2 * (ku + sh(ku, 2))
        au = au - self.c_up * cu * mp
        ap = (mp - 2.0 * sh(mp, -1) + sh(mp, -2)) + half_d2 * (kp + sh(kp, -2))
        ap = ap + self.c_pu * cp * mu
        return np.stack([au, ap], axis=-3)

    def dense(self, chunk: int = 256) -> torch.Tensor:
        """A as a dense ``(size, size)`` matrix on the space's device (small
        problems: the direct solve, and the test oracle)."""
        return dense_matrix(self.matvec, self.shape, self.space.dtype, self.space.device, chunk)


def build_operator(space: P1Space, N_t: int, dt: float, gamma: float, scaled: bool = True) -> AllAtOnceOperator:
    return AllAtOnceOperator(space=space, N_t=N_t, dt=dt, gamma=gamma, scaled=scaled)


def dense_matrix(matvec, shape, dtype, device, chunk: int = 256) -> torch.Tensor:
    """The dense ``(m, m)`` matrix of a linear ``matvec`` on states ``(...,
    *shape)``, m their size: its columns built ``chunk`` unit vectors at a
    time through the batched matvec, as the JAX package's ``lax.map(...,
    batch_size=256)`` does."""
    m = int(np.prod(shape))
    A = torch.empty((m, m), dtype=dtype, device=device)
    for j0 in range(0, m, chunk):
        w = min(chunk, m - j0)
        eye = torch.zeros((w, m), dtype=dtype, device=device)
        rows = torch.arange(w, device=device)
        eye[rows, j0 + rows] = 1.0
        A[:, j0 : j0 + w] = matvec(eye.reshape((w,) + tuple(shape))).reshape(w, m).T
    return A


def dense_lu_solver(A: torch.Tensor, shape):
    """``run(b, x0=None) -> (x, None)``: the LU factors of a dense matrix
    ``A`` (``torch.linalg.lu_factor``; cuSOLVER on the card), made once,
    and a solve of b ``(..., *shape)`` per call; ``x0`` is ignored."""
    LU, piv = torch.linalg.lu_factor(A)

    def run(b, x0=None):
        lead = b.shape[: b.dim() - len(shape)]
        rhs = b.reshape((-1, A.shape[0])).T
        return torch.linalg.lu_solve(LU, piv, rhs).T.reshape(lead + tuple(shape)), None

    return run


def _nonzeros(csr) -> set:
    """The (row, column) pairs of a CSR matrix's nonzero entries."""
    rows = np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr))
    keep = csr.data != 0
    return set(zip(rows[keep].tolist(), csr.indices[keep].tolist()))


def operator_nnz(op: AllAtOnceOperator) -> int:
    """Exact nonzero count of the assembled all-at-once matrix (the 'aij'
    matrix the reference hands to MUMPS). Per time level the u-row at time i
    touches u through the M+K pattern at level i, M alone at level i-1, M+K
    at level i-2, and p through M at level i; p-rows mirror it backward.
    Spatial pattern sizes on the interior grid (m = n1d):

      1D: M, K, and their union are tridiagonal: 3m - 2.
      2D consistent: M is the 7-point FK stencil (7m^2 - 8m + 2), K the
        5-point (5m^2 - 4m), union = M's pattern.
      2D lumped: M diagonal (m^2), union = K's 5-point pattern.
      Unstructured: counted from the assembled CSR patterns.
    """
    sp = op.space
    if not hasattr(sp, "n1d"):
        pM = sp.M_csr.nnz
        pMK = len(_nonzeros(sp.M_csr) | _nonzeros(sp.K_csr))
    elif sp.dim == 1:
        m = sp.n1d
        tri = 3 * m - 2
        pM = m if sp.mass == "lumped" else tri
        pMK = tri
    else:
        m = sp.n1d
        five = 5 * m * m - 4 * m
        seven = 7 * m * m - 8 * m + 2
        pM = m * m if sp.mass == "lumped" else seven
        pMK = five if sp.mass == "lumped" else seven
    N_t = op.N_t
    per_block = N_t * pMK + (N_t - 1) * pM + (N_t - 2) * pMK + N_t * pM
    return 2 * per_block


def build_rhs(
    op: AllAtOnceOperator,
    f: torch.Tensor,
    g: torch.Tensor,
    u0: torch.Tensor,
    u1: torch.Tensor,
) -> torch.Tensor:
    """Right-hand side b of A x = b, shape ``(2, N_t, n)``.

    ``f``/``g`` are nodal data ``(N_t, n)`` (f at ``i*dt``, g at
    ``(i+1)*dt``); ``u0``/``u1`` the initial data ``(n,)``. In scaled mode
    f, u0, u1 come already multiplied by sqrt(gamma).

      b_u[0]   = M (dt^2/2 f_0 + dt u1 + u0)
      b_u[1]   = dt^2 M f_1 - (M + dt^2/2 K) u0
      b_u[i>1] = dt^2 M f_i
      b_p[i]   = dt^2 M g_i,  b_p[N_t-1] = dt^2/2 M g_{N_t-1}
    """
    sp = op.space
    d2 = op.dt * op.dt
    bu = d2 * sp.apply_mass(f)
    bu[0] = sp.apply_mass(0.5 * d2 * f[0] + op.dt * u1 + u0)
    bu[1] = bu[1] + (-(sp.apply_mass(u0) + 0.5 * d2 * sp.apply_stiffness(u0)))
    bp = d2 * sp.apply_mass(g)
    bp[-1] = 0.5 * d2 * sp.apply_mass(g[-1])
    return torch.stack([bu, bp])
