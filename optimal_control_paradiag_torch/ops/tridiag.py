"""Batched tridiagonal solvers: Thomas and parallel cyclic reduction (PyTorch).

The counterpart of ``optimal_control_paradiag_tpu/ops/tridiag.py``: in 1D
each per-Fourier-mode operator ``Sigma_k M + dt^2/2 K`` of the ParaDiag inner
solve is complex tridiagonal, and all mode systems solve as one batch. Both
algorithms take the three diagonals and solve over the last axis, batched
over the leading ones, real or complex:

- :func:`thomas`: the O(n) forward and backward sweeps, a Python loop over
  the space axis whose every step is one batched elementwise op over all
  modes;
- :func:`pcr`: parallel cyclic reduction, ceil(log2 n) rounds of shift-adds
  over the whole (batch, n) state.
"""

from __future__ import annotations

import torch


def _shift(x: torch.Tensor, s: int, fill=0.0) -> torch.Tensor:
    """y[..., i] = x[..., i-s], filled with ``fill`` out of range."""
    if s == 0:
        return x
    n = x.shape[-1]
    k = min(abs(s), n)
    pad = torch.full(x.shape[:-1] + (k,), fill, dtype=x.dtype, device=x.device)
    if s > 0:
        return torch.cat([pad, x[..., : n - k]], -1)
    return torch.cat([x[..., k:], pad], -1)


def thomas(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve tridiag(dl, d, du) x = b over the last axis, batched over the rest.

    ``dl[..., 0]`` and ``du[..., n-1]`` are ignored. No pivoting: fine for
    the diagonally dominant complex-shifted FEM systems this serves.
    """
    dl, d, du, b = torch.broadcast_tensors(dl, d, du, b)
    n = b.shape[-1]
    cp = dp = torch.zeros_like(b[..., 0])
    cps, dps = [], []
    for i in range(n):
        a_i = dl[..., i]
        denom = d[..., i] - a_i * cp
        cp = du[..., i] / denom
        dp = (b[..., i] - a_i * dp) / denom
        cps.append(cp)
        dps.append(dp)
    x = torch.zeros_like(b[..., 0])
    xs = [None] * n
    for i in reversed(range(n)):
        x = dps[i] - cps[i] * x
        xs[i] = x
    return torch.stack(xs, dim=-1)


def pcr(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Parallel cyclic reduction over the last axis, batched over the rest.

    ceil(log2 n) rounds; out-of-range rows act as identity equations
    (a = c = 0, b = 1, rhs = 0), which the shift fills implement.
    """
    dl, d, du, b = torch.broadcast_tensors(dl, d, du, b)
    n = b.shape[-1]
    a = dl.clone()
    a[..., 0] = 0
    c = du.clone()
    c[..., n - 1] = 0
    diag, rhs = d, b
    s = 1
    while s < n:
        # Row i-s and i+s coefficients (identity rows out of range).
        alpha = -a / _shift(diag, s, fill=1.0)
        beta = -c / _shift(diag, -s, fill=1.0)
        diag = diag + alpha * _shift(c, s) + beta * _shift(a, -s)
        rhs = rhs + alpha * _shift(rhs, s) + beta * _shift(rhs, -s)
        a = alpha * _shift(a, s)
        c = beta * _shift(c, -s)
        s *= 2
    return rhs / diag


def solve_scalar_shifted(
    sigma: torch.Tensor,
    m_diag: float,
    m_off: float,
    k_diag: float,
    k_off: float,
    c: float,
    rhs: torch.Tensor,
    method: str = "pcr",
) -> torch.Tensor:
    """Solve ``(sigma_k M + c K) w_k = rhs_k`` for Toeplitz tridiagonal M, K.

    ``sigma`` broadcasts over the batch axes of ``rhs`` (e.g. shape (N_t, 1)
    against rhs (N_t, n)); M = tridiag(m_off, m_diag, m_off), likewise K.
    """
    d = torch.broadcast_to(sigma * m_diag + c * k_diag, rhs.shape)
    off = torch.broadcast_to(sigma * m_off + c * k_off, rhs.shape)
    solver = {"thomas": thomas, "pcr": pcr}[method]
    return solver(off, d, off, rhs)
