"""Manufactured solutions and data for the wave-control test problems.

(A copy of ``optimal_control_paradiag_tpu/models/analytic.py``, which is
numpy only: importing it from there would run the JAX package's
``__init__``.)

1D (the reference's production test, ``Control_Wave_PC.py:48-83, 295-300``):
  u(x,t) = sin(pi x) cos(pi t)
  p(x,t) = sin(pi x) (e^t - e^T)^2
  f(x,t) = -(1/gamma) sin(pi x) (e^t - e^T)^2            (ref ``:55``)
  g(x,t) = 2 (2 e^{2t} - e^{T+t}) sin(pi x)
           + pi^2 sin(pi x)(e^t - e^T)^2 + sin(pi x) cos(pi t)   (ref ``:70-72``)
  u(0)   = sin(pi x),  u_t(0) = 0                         (ref ``:79-83``)

2D (the reference scaffolds 2D meshes but builds data only in the prototype,
``Func_Version.py:33-44``; first-class here):
  u(x,y,t) = e^t sin(pi x) sin(pi y)
  p(x,y,t) = (t - T)^2 sin(pi x) sin(pi y)
  f = (1 + 2 pi^2) e^t sin sin - (1/gamma)(t-T)^2 sin sin
  g = (e^t + 2 + 2 pi^2 (t-T)^2) sin sin
  u(0) = u_t(0) = sin(pi x) sin(pi y)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np


@dataclasses.dataclass(frozen=True)
class ManufacturedProblem:
    """Closed-form data/solution bundle; all callables take nodal coordinate
    arrays (x[, y]) plus scalar time t and broadcast."""

    dim: int
    u: Callable
    p: Callable
    f: Callable  # source (includes the -p/gamma control elimination term)
    g: Callable  # tracking target
    u0: Callable
    u1: Callable


def manufactured(dim: int, T: float, gamma: float) -> ManufacturedProblem:
    pi = math.pi
    eT = math.exp(T)

    if dim == 1:

        def u(x, t):
            return np.sin(pi * x) * math.cos(pi * t)

        def p(x, t):
            return np.sin(pi * x) * (math.exp(t) - eT) ** 2

        def f(x, t):
            return -(1.0 / gamma) * np.sin(pi * x) * (math.exp(t) - eT) ** 2

        def g(x, t):
            return (
                2.0 * (2.0 * math.exp(2 * t) - math.exp(T + t)) * np.sin(pi * x)
                + pi**2 * np.sin(pi * x) * (math.exp(t) - eT) ** 2
                + np.sin(pi * x) * math.cos(pi * t)
            )

        def u0(x):
            return np.sin(pi * x)

        def u1(x):
            return np.zeros_like(x)

        return ManufacturedProblem(dim=1, u=u, p=p, f=f, g=g, u0=u0, u1=u1)

    def ss(x, y):
        return np.sin(pi * x) * np.sin(pi * y)

    def u(x, y, t):
        return math.exp(t) * ss(x, y)

    def p(x, y, t):
        return (t - T) ** 2 * ss(x, y)

    def f(x, y, t):
        return (1.0 + 2.0 * pi**2) * math.exp(t) * ss(x, y) - (1.0 / gamma) * (
            t - T
        ) ** 2 * ss(x, y)

    def g(x, y, t):
        return (math.exp(t) + 2.0 + 2.0 * pi**2 * (t - T) ** 2) * ss(x, y)

    def u0(x, y):
        return ss(x, y)

    def u1(x, y):
        return ss(x, y)

    return ManufacturedProblem(dim=2, u=u, p=p, f=f, g=g, u0=u0, u1=u1)
