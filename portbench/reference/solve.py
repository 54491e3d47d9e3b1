"""A direct solve of the reference system, in a chosen precision: the control of ``correct``.

The sine transform S, ``S_ij = sin(pi i j / N_x)`` (``S S = (N_x / 2) I``),
diagonalizes the 1D mass and stiffness and the 2D lumped ones (their
eigenvalues below, from the stencils of ``model.py``); per wavenumber the
time rows of ``model.time_rows`` leave a banded system in the interleaved
unknowns (u_0, p_0, u_1, p_1, ...), solved here as block tridiagonal with
4 x 4 blocks (two time slices each) by block elimination, every wavenumber
and lane at once.

``precision`` sets the arithmetic, the step below a configuration's own
that would tempt a later change:

- 'float64' and 'float32': the whole solve in that dtype (full float32
  products, never TF32);
- 'tf32': float32, with both operands of the transforms' products rounded to
  TF32 (10 mantissa bits) first, as tensor cores take them, and summed in
  float32;
- 'bf16': the same with bfloat16 operands (7 mantissa bits).
"""

from __future__ import annotations

import math

import torch

from portbench.reference.model import time_rows

KEEP_BITS = {"tf32": 10, "bf16": 7}


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


def _transform(pc: dict, x: torch.Tensor, S: torch.Tensor, precision: str) -> torch.Tensor:
    """x S along each grid axis (no scaling); operands rounded per precision."""
    keep = KEEP_BITS.get(precision)
    rnd = (lambda a: round_mantissa(a, keep)) if keep else (lambda a: a)
    S = rnd(S)
    if pc["dim"] == 1:
        return rnd(x) @ S
    m = pc["N_x"] - 1
    g = rnd(x.reshape(x.shape[:-1] + (m, m))) @ S
    g = rnd(g.transpose(-1, -2).contiguous()) @ S
    return g.transpose(-1, -2).reshape(x.shape)


def _blocks(problem: str, pc: dict, m: torch.Tensor, k: torch.Tensor, dtype):
    """(lower, diagonal, upper) blocks ``(N_t/2, J, 4, 4)`` of the time
    system of every wavenumber."""
    N = pc["N_t"]
    if N % 2:
        raise ValueError("the block solve pairs time slices: N_t must be even")
    J = m.shape[0]
    B = torch.zeros((3, N // 2, J, 4, 4), dtype=torch.float64, device=m.device)
    i = torch.arange(N, device=m.device)
    for row, terms in enumerate(time_rows(problem, pc)):
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


def solve(problem: str, pc: dict, b: torch.Tensor, precision: str = "float64") -> torch.Tensor:
    """x of A x = b for b ``(..., 2, N_t, n)`` (any leading lanes), computed
    in ``precision``; returned in the dtype of that precision."""
    dtype = torch.float64 if precision == "float64" else torch.float32
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        N_x, N, dim = pc["N_x"], pc["N_t"], pc["dim"]
        dev = b.device
        m, k = (t.to(dev) for t in eigenvalues(pc))
        idx = torch.arange(1, N_x, dtype=torch.float64, device=dev)
        S = torch.sin(math.pi * torch.outer(idx, idx) / N_x).to(dtype)
        lead = b.shape[:-3]
        n = b.shape[-1]
        bt = _transform(pc, b.to(dtype).reshape((-1, 2, N, n)), S, precision) * ((2.0 / N_x) ** dim)
        lanes = bt.shape[0]
        # (lanes, 2, N, J) -> interleaved (2N, J, lanes) -> (N/2, J, 4, lanes)
        z = bt.permute(2, 1, 3, 0).reshape(2 * N, n, lanes).reshape(N // 2, 4, n, lanes).permute(0, 2, 1, 3)
        L, D, U = _blocks(problem, pc, m, k, dtype)
        xz = _block_tridiagonal(L, D, U, z.contiguous())
        xt = xz.permute(0, 2, 1, 3).reshape(2 * N, n, lanes).reshape(N, 2, n, lanes).permute(3, 1, 0, 2)
        x = _transform(pc, xt.contiguous(), S, precision)
        return x.reshape(lead + (2, N, n))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
