"""A solve of the reference system, in a chosen precision: the control of ``correct``.

The sine transform S, ``S_ij = sin(pi i j / N_x)`` (``S S = (N_x / 2) I``),
diagonalizes the 1D mass and stiffness and the 2D lumped ones (their
eigenvalues below, from the stencils of ``model.py``); per wavenumber the
time rows of ``model.time_rows`` leave a banded system in the interleaved
unknowns (u_0, p_0, u_1, p_1, ...), solved here as block tridiagonal with
4 x 4 blocks (two time slices each; an odd N_t gets a trailing slice that
is coupled to nothing and solves to zero) by block elimination, every
wavenumber and lane at once. That sine solve is the whole of ``solve`` on
those spaces.

S does not diagonalize the 2D consistent mass: its diagonal pair of
neighbours, (1, 1) and (-1, -1), is not symmetric under x -> -x alone.
There ``solve`` runs right-preconditioned GMRES on ``model.matvec``, in
flexible form (it keeps the preconditioned vectors, so the answer is what
the Arnoldi relation says, whatever the rounding inside the
preconditioner), one lane at a time, each with its own Krylov space. The
preconditioner is the sine solve of the surrogate: the same time rows and
5-point stiffness, and the mass whose diagonal pair is spread over all four
diagonals, with the symbol (h^2/12)(6 + 2c_i + 2c_j + 2c_i c_j). Alone,
without the correction, the surrogate is ``surrogate_solve``.

On a triangle mesh (``model.Elements``; its configuration is the
unperturbed N_x grid's 2D consistent mass) ``solve`` runs the same GMRES on
the mesh's matvec, preconditioned by the sine solve of that grid's
surrogate; ``surrogate_solve`` is that sine solve alone, a program that
solved the unmoved grid instead of the mesh.

``precision`` sets the arithmetic, the step below a configuration's own
that would tempt a later change:

- 'float64' and 'float32': the whole solve in that dtype (full float32
  products, never TF32);
- 'tf32': float32, with both operands of the transforms' products rounded to
  TF32 (10 mantissa bits) first, as tensor cores take them, and summed in
  float32; in GMRES also the vector operand of every mass and stiffness
  product of the matvec (their stencils' weights 1, 4 and 6 are exact;
  the scalars h^2/12, dt^2/2 multiply in float32) and, on a mesh, every
  element value (areas and gradient products) beside it;
- 'bf16': the same with bfloat16 operands (7 mantissa bits).

GMRES stops by a fixed rule: in 'float64' it restarts every ``RESTART``
steps until the float64 relative residual ||b - A x|| / ||b|| is at most
``F64_TOL`` (and raises after ``F64_CYCLES`` cycles); in the lower
precisions it runs one cycle that ends once its estimate of the relative
residual falls below ``LOW_TOL`` or after ``LOW_STEPS`` steps, and the
answer is the last iterate.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, List, Optional

import numpy as np
import torch

from portbench.reference import model

KEEP_BITS = {"tf32": 10, "bf16": 7}
F64_TOL, RESTART, F64_CYCLES = 1e-13, 60, 20
LOW_TOL, LOW_STEPS = 1e-7, 60


def control_precision(traffic: dict) -> str:
    """The control of a traffic mix: float32 for float64; for float32, TF32
    (the port keeps TF32 off) or, where the transforms are bf16x3
    (``dst_precision='high'``), bfloat16."""
    if traffic["dtype"] == "float64":
        return "float32"
    return "bf16" if traffic["dst_precision"] == "high" else "tf32"


def round_mantissa(x: torch.Tensor, keep: int) -> torch.Tensor:
    """float32 ``x`` rounded to nearest even with ``keep`` mantissa bits."""
    drop = 23 - keep
    u = x.contiguous().view(torch.int32)
    u = u + ((1 << (drop - 1)) - 1) + ((u >> drop) & 1)
    return (u & ~((1 << drop) - 1)).view(torch.float32)


def _rounding(precision: str) -> Callable[[torch.Tensor], torch.Tensor]:
    keep = KEEP_BITS.get(precision)
    return (lambda a: round_mantissa(a, keep)) if keep else (lambda a: a)


def diagonalizable(pc: dict) -> bool:
    """Whether the sine transform diagonalizes the space (all but the 2D
    consistent mass, which a mesh's configuration states)."""
    return pc["dim"] == 1 or pc["mass"] == "lumped"


def eigenvalues(pc: dict):
    """(mass, stiffness) eigenvalues of each sine mode, flat like the state
    (row-major over (y, x) in 2D), float64 host tensors."""
    N, dim, h = pc["N_x"], pc["dim"], 1.0 / pc["N_x"]
    c = torch.cos(math.pi * torch.arange(1, N, dtype=torch.float64) / N)
    if dim == 1:
        k = (2.0 / h) * (1.0 - c)
        m = torch.full_like(k, h) if pc["mass"] == "lumped" else (h / 6.0) * (4.0 + 2.0 * c)
        return m, k
    if pc["mass"] != "lumped":
        raise ValueError("the sine transform does not diagonalize the 2D consistent mass")
    k = (2.0 * (1.0 - c)[:, None] + 2.0 * (1.0 - c)[None, :]).reshape(-1)
    return torch.full_like(k, h * h), k


def symbols(pc: dict):
    """(mass, stiffness) eigenvalues of the sine solve: the space's own where
    S diagonalizes it; for the 2D consistent mass, the surrogate's."""
    if diagonalizable(pc):
        return eigenvalues(pc)
    N, h = pc["N_x"], 1.0 / pc["N_x"]
    c = torch.cos(math.pi * torch.arange(1, N, dtype=torch.float64) / N)
    cy, cx = c[:, None], c[None, :]
    m = (h * h / 12.0) * (6.0 + 2.0 * cy + 2.0 * cx + 2.0 * cy * cx)
    k = 2.0 * (1.0 - cy) + 2.0 * (1.0 - cx)
    return m.reshape(-1), k.reshape(-1)


def _transform(pc: dict, x: torch.Tensor, S: torch.Tensor, precision: str) -> torch.Tensor:
    """x S along each grid axis (no scaling); operands rounded per precision."""
    rnd = _rounding(precision)
    S = rnd(S)
    if pc["dim"] == 1:
        return rnd(x) @ S
    m = pc["N_x"] - 1
    g = rnd(x.reshape(x.shape[:-1] + (m, m))) @ S
    g = rnd(g.transpose(-1, -2).contiguous()) @ S
    return g.transpose(-1, -2).reshape(x.shape)


def _blocks(problem: str, pc: dict, m: torch.Tensor, k: torch.Tensor, dtype):
    """(lower, diagonal, upper) blocks ``(ceil(N_t/2), J, 4, 4)`` of the time
    system of every wavenumber; for an odd N_t the last block's second slice
    is the identity, coupled to nothing."""
    N = pc["N_t"]
    J = m.shape[0]
    B = torch.zeros((3, (N + 1) // 2, J, 4, 4), dtype=torch.float64, device=m.device)
    i = torch.arange(N, device=m.device)
    for row, terms in enumerate(model.time_rows(problem, pc)):
        for src, s, a, b, w in terms:
            j = i - s
            ok = (j >= 0) & (j < N)
            r, c = 2 * i[ok] + row, 2 * j[ok] + src
            weight = torch.ones(int(ok.sum()), dtype=torch.float64, device=m.device)
            if w is not None:
                weight[i[ok] == w[0]] = w[1]
            val = weight[:, None] * (a * m + b * k)[None, :]
            band = c // 4 - r // 4 + 1  # 0: the block before, 1: the diagonal, 2: the block after
            for q in range(3):
                sel = band == q  # each (row, column) once per term
                B[q][(r // 4)[sel], :, (r % 4)[sel], (c % 4)[sel]] += val[sel]
    if N % 2:
        B[1, -1, :, 2, 2] = B[1, -1, :, 3, 3] = 1.0
    return B[0].to(dtype), B[1].to(dtype), B[2].to(dtype)


def _block_tridiagonal(L, D, U, r):
    """Solve per (J) the block tridiagonal system; r ``(nb, J, 4, lanes)``."""
    nb = D.shape[0]
    X = [None] * nb  # D'_k^{-1} U_k
    y = [None] * nb
    for q in range(nb):
        Dq, rq = D[q], r[q]
        if q:
            Dq = Dq - L[q] @ X[q - 1]
            rq = rq - L[q] @ y[q - 1]
        sol = torch.linalg.solve(Dq, torch.cat([U[q], rq], dim=-1))
        X[q], y[q] = sol[..., :4], sol[..., 4:]
    x = [None] * nb
    x[-1] = y[-1]
    for q in range(nb - 2, -1, -1):
        x[q] = y[q] - X[q] @ x[q + 1]
    return torch.stack(x)


def _sine_solver(problem: str, pc: dict, precision: str, device, m: torch.Tensor, k: torch.Tensor):
    """``apply(r)``: x of P x = r for r ``(lanes, 2, N_t, n)`` in the
    precision's dtype, P the operator whose sine modes have the mass and
    stiffness eigenvalues (m, k)."""
    dtype = torch.float64 if precision == "float64" else torch.float32
    N_x, N, dim = pc["N_x"], pc["N_t"], pc["dim"]
    m, k = m.to(device), k.to(device)
    idx = torch.arange(1, N_x, dtype=torch.float64, device=device)
    S = torch.sin(math.pi * torch.outer(idx, idx) / N_x).to(dtype)
    L, D, U = _blocks(problem, pc, m, k, dtype)
    nb = D.shape[0]

    def apply(r: torch.Tensor) -> torch.Tensor:
        n = r.shape[-1]
        bt = _transform(pc, r, S, precision) * ((2.0 / N_x) ** dim)
        lanes = bt.shape[0]
        # (lanes, 2, N, J) -> interleaved (2N, J, lanes), zero-padded to whole blocks -> (nb, J, 4, lanes)
        z = bt.permute(2, 1, 3, 0).reshape(2 * N, n, lanes)
        if N % 2:
            z = torch.cat([z, z.new_zeros((2, n, lanes))])
        z = z.reshape(nb, 4, n, lanes).permute(0, 2, 1, 3)
        xz = _block_tridiagonal(L, D, U, z.contiguous())
        xt = xz.permute(0, 2, 1, 3).reshape(4 * nb, n, lanes)[: 2 * N].reshape(N, 2, n, lanes).permute(3, 1, 0, 2)
        return _transform(pc, xt.contiguous(), S, precision)

    return apply


@contextlib.contextmanager
def _full_float32():
    """Full float32 products inside (TF32 off), the caller's setting restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _gmres(A: Callable, P: Callable, b: torch.Tensor, precision: str) -> tuple:
    """x of A x = b for one lane ``b`` (flat), right-preconditioned GMRES in
    flexible form (A P^-1 u = b, x = x_0 + Z y, Z = P^-1 V) by the module's
    stopping rule; returns (x, steps). Classical Gram-Schmidt, twice; the
    Hessenberg least squares by Givens rotations in b's dtype on the host."""
    f64 = precision == "float64"
    steps_cap = RESTART if f64 else LOW_STEPS
    npdt = np.float64 if f64 else np.float32
    b_norm = float(torch.linalg.vector_norm(b))
    V = b.new_zeros((steps_cap + 1, b.numel()))
    Z = b.new_zeros((steps_cap, b.numel()))
    x, r, steps = torch.zeros_like(b), b, 0
    for _ in range(F64_CYCLES if f64 else 1):
        beta = torch.linalg.vector_norm(r)
        V[0] = r / beta
        H = np.zeros((steps_cap + 1, steps_cap), dtype=npdt)
        cs, sn = np.zeros(steps_cap, dtype=npdt), np.zeros(steps_cap, dtype=npdt)
        g = np.zeros(steps_cap + 1, dtype=npdt)
        g[0] = npdt(float(beta))
        j = 0
        while j < steps_cap:
            Z[j] = P(V[j])
            w = A(Z[j])
            h = V[: j + 1] @ w
            w = w - V[: j + 1].T @ h
            h2 = V[: j + 1] @ w
            w = w - V[: j + 1].T @ h2
            col = np.zeros(steps_cap + 1, dtype=npdt)
            col[: j + 1] = (h + h2).cpu().numpy()
            col[j + 1] = npdt(float(torch.linalg.vector_norm(w)))
            V[j + 1] = w / float(col[j + 1])
            for i in range(j):  # the earlier rotations
                col[i], col[i + 1] = cs[i] * col[i] + sn[i] * col[i + 1], -sn[i] * col[i] + cs[i] * col[i + 1]
            rho = np.hypot(col[j], col[j + 1])
            cs[j], sn[j] = col[j] / rho, col[j + 1] / rho
            col[j], col[j + 1] = rho, 0
            g[j + 1], g[j] = -sn[j] * g[j], cs[j] * g[j]
            H[:, j] = col
            j += 1
            steps += 1
            if abs(float(g[j])) <= (F64_TOL if f64 else LOW_TOL) * b_norm:
                break
        y = np.zeros(j, dtype=npdt)
        for i in range(j - 1, -1, -1):  # H[:j, :j] y = g[:j], upper triangular
            y[i] = (g[i] - H[i, i + 1: j] @ y[i + 1:]) / H[i, i]
        x = x + Z[:j].T @ torch.from_numpy(y).to(b.device)
        if not f64:
            return x, steps
        r = b - A(x)
        if float(torch.linalg.vector_norm(r)) <= F64_TOL * b_norm:
            return x, steps
    raise RuntimeError(f"float64 GMRES left a relative residual above {F64_TOL} after {F64_CYCLES} cycles")


def solve(problem: str, pc: dict, b: torch.Tensor, precision: str = "float64",
          iterations: Optional[List[int]] = None, mesh: Optional[model.Elements] = None) -> torch.Tensor:
    """x of A x = b for b ``(..., 2, N_t, n)`` (any leading lanes), on the
    grid or on ``mesh``, computed in ``precision``; returned in the dtype of
    that precision. On the 2D consistent mass and a mesh (GMRES) each
    lane's number of steps is appended to ``iterations`` where it is a
    list."""
    dtype = torch.float64 if precision == "float64" else torch.float32
    N, n = pc["N_t"], b.shape[-1]
    lead = b.shape[:-3]
    lanes = b.to(dtype).reshape((-1, 2, N, n))
    with _full_float32():
        P = _sine_solver(problem, pc, precision, b.device, *symbols(pc))
        if mesh is None and diagonalizable(pc):
            return P(lanes).reshape(lead + (2, N, n))
        rnd, shape = _rounding(precision), (1, 2, N, n)
        mesh = None if mesh is None else mesh.to(dtype, rnd)

        def A(v):  # one lane, flat
            return model.matvec(problem, pc, rnd(v).reshape(shape), mesh).reshape(-1)

        def P1(v):
            return P(v.reshape(shape)).reshape(-1)

        out = []
        for lane in lanes:
            x, steps = _gmres(A, P1, lane.reshape(-1), precision)
            out.append(x.reshape(2, N, n))
            if iterations is not None:
                iterations.append(steps)
        return torch.stack(out).reshape(lead + (2, N, n))


def surrogate_solve(problem: str, pc: dict, b: torch.Tensor) -> torch.Tensor:
    """The sine solve of the surrogate alone, in float64, with no correction
    (on a space S diagonalizes, the space's own solve; for a mesh, the
    unperturbed grid's surrogate)."""
    N, n = pc["N_t"], b.shape[-1]
    with _full_float32():
        P = _sine_solver(problem, pc, "float64", b.device, *symbols(pc))
        return P(b.to(torch.float64).reshape((-1, 2, N, n))).reshape(b.shape)
