"""The all-at-once KKT operator and right-hand side of both families, float64.

P1 elements on the uniform grid of the unit interval or square (interior
nodes, row-major over (y, x)), h = 1 / N_x:

- 1D: consistent mass (h/6)[1 4 1], lumped h; stiffness (1/h)[-1 2 -1];
- 2D (right triangles, diagonals along (1, 1)): consistent mass
  (h^2/12)(6 at the node, 1 at the six neighbours (0, +-1), (+-1, 0),
  (1, 1), (-1, -1)), lumped h^2; stiffness the 5-point [-1 4 -1].

Unknowns u_i, p_i, i = 0 .. N_t - 1, zero outside that range; the time
rows of a family are lists of terms (src, s, a, b, w): row i gains
``w_i (a M + b K) src_{i-s}``, w_i = 1 but at one boundary row.

Wave (step dt, the scaled system: c_up = c_pu = dt^2 / sqrt(gamma); unscaled
c_up = dt^2 / gamma, c_pu = dt^2):
  u-row i: M(u_i - 2u_{i-1} + u_{i-2}) + dt^2/2 K(u_i + u_{i-2}) - c_up w M p_i, w_0 = 1/2
  p-row i: M(p_i - 2p_{i+1} + p_{i+2}) + dt^2/2 K(p_i + p_{i+2}) + c_pu w M u_i, w_{N_t-1} = 1/2
  b_u[0] = M(dt^2/2 f_0 + dt u1 + u0), b_u[1] = dt^2 M f_1 - (M + dt^2/2 K) u0,
  b_u[i>1] = dt^2 M f_i; b_p[i] = dt^2 M g_i, b_p[N_t-1] = dt^2/2 M g_{N_t-1}.
Heat (backward Euler, step tau, theta = tau / sqrt(gamma), scaled only):
  u-row i: M(u_i - u_{i-1}) + tau K u_i - theta M p_i
  p-row i: M(p_i - p_{i+1}) + tau K p_i + theta M u_i
  b_u = tau M f (+ M u0 on row 0); b_p = tau M g.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Term = Tuple[int, int, float, float, Tuple[int, float]]  # (src, s, a, b, (row, w) or None)


def _shift(x: torch.Tensor, s: int, dim: int) -> torch.Tensor:
    """y[i] = x[i - s] along ``dim``, zero where i - s is out of range."""
    if s == 0:
        return x
    y = torch.zeros_like(x)
    n = x.shape[dim]
    if abs(s) >= n:
        return y
    if s > 0:
        y.narrow(dim, s, n - s).copy_(x.narrow(dim, 0, n - s))
    else:
        y.narrow(dim, 0, n + s).copy_(x.narrow(dim, -s, n + s))
    return y


def _grid(pc: dict, x: torch.Tensor) -> torch.Tensor:
    m = pc["N_x"] - 1
    return x.reshape(x.shape[:-1] + (m,) * pc["dim"])


def mass(pc: dict, x: torch.Tensor) -> torch.Tensor:
    h = 1.0 / pc["N_x"]
    if pc["mass"] == "lumped":
        return h ** pc["dim"] * x
    if pc["dim"] == 1:
        return (h / 6.0) * (4.0 * x + _shift(x, 1, -1) + _shift(x, -1, -1))
    g = _grid(pc, x)
    acc = 6.0 * g
    for sy, sx in ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (-1, -1)):
        acc = acc + _shift(_shift(g, sx, -1), sy, -2)
    return (h * h / 12.0 * acc).reshape(x.shape)


def stiffness(pc: dict, x: torch.Tensor) -> torch.Tensor:
    h = 1.0 / pc["N_x"]
    if pc["dim"] == 1:
        return (1.0 / h) * (2.0 * x - _shift(x, 1, -1) - _shift(x, -1, -1))
    g = _grid(pc, x)
    acc = 4.0 * g
    for sy, sx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        acc = acc - _shift(_shift(g, sx, -1), sy, -2)
    return acc.reshape(x.shape)


def time_rows(problem: str, pc: dict) -> List[List[Term]]:
    """The terms of the u-rows (index 0) and p-rows (index 1); src 0 is u, 1 is p."""
    N, T, gam = pc["N_t"], pc["T"], pc["gamma"]
    dt = T / N
    if problem == "wave":
        d2 = dt * dt
        c_up, c_pu = (d2 / math.sqrt(gam), d2 / math.sqrt(gam)) if pc["scaled"] else (d2 / gam, d2)
        return [
            [(0, 0, 1.0, d2 / 2, None), (0, 1, -2.0, 0.0, None), (0, 2, 1.0, d2 / 2, None), (1, 0, -c_up, 0.0, (0, 0.5))],
            [(1, 0, 1.0, d2 / 2, None), (1, -1, -2.0, 0.0, None), (1, -2, 1.0, d2 / 2, None),
             (0, 0, c_pu, 0.0, (N - 1, 0.5))],
        ]
    if problem == "heat":
        if not pc["scaled"]:
            raise ValueError("the heat system is defined in scaled form only")
        th = dt / math.sqrt(gam)
        return [
            [(0, 0, 1.0, dt, None), (0, 1, -1.0, 0.0, None), (1, 0, -th, 0.0, None)],
            [(1, 0, 1.0, dt, None), (1, -1, -1.0, 0.0, None), (0, 0, th, 0.0, None)],
        ]
    raise ValueError(f"unknown problem {problem!r}")


def matvec(problem: str, pc: dict, x: torch.Tensor) -> torch.Tensor:
    """A @ x for states ``(..., 2, N_t, n)``, in x's dtype."""
    out = torch.zeros_like(x)
    for row, terms in enumerate(time_rows(problem, pc)):
        acc = out[..., row, :, :]
        for src, s, a, b, w in terms:
            v = _shift(x[..., src, :, :], s, -2)
            t = a * mass(pc, v) if b == 0.0 else a * mass(pc, v) + b * stiffness(pc, v)
            if w is not None:
                t[..., w[0], :] *= w[1]
            acc += t
    return out


def rhs(problem: str, pc: dict, data: Dict[str, torch.Tensor]) -> torch.Tensor:
    """b of A x = b, ``(2, N_t, n)``, from the nodal data (f, u0, u1 scaled)."""
    dt = pc["T"] / pc["N_t"]
    f, g, u0 = data["f"], data["g"], data["u0"]
    if problem == "wave":
        d2 = dt * dt
        bu = d2 * mass(pc, f)
        bu[0] = mass(pc, 0.5 * d2 * f[0] + dt * data["u1"] + u0)
        bu[1] = bu[1] - (mass(pc, u0) + 0.5 * d2 * stiffness(pc, u0))
        bp = d2 * mass(pc, g)
        bp[-1] = 0.5 * d2 * mass(pc, g[-1])
        return torch.stack([bu, bp])
    bu = dt * mass(pc, f)
    bu[0] = bu[0] + mass(pc, u0)
    return torch.stack([bu, dt * mass(pc, g)])


def rel_residual(problem: str, pc: dict, data: Dict[str, torch.Tensor], x: torch.Tensor) -> float:
    """||A x - b|| / ||b|| in float64 for one answer x ``(2, N_t, n)``; inf
    when x holds a value that is not finite."""
    x = x.to(torch.float64)
    if not bool(torch.isfinite(x).all()):
        return math.inf
    b = rhs(problem, pc, data)
    return float(torch.linalg.norm(matvec(problem, pc, x) - b) / torch.linalg.norm(b))
