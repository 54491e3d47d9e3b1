"""The one generator of the benchmark's inputs: a pool of data sets drawn from the seed.

A data set is the nodal data of one all-at-once system, the dict the port's
problems take as ``data=`` (``f``, ``g``, ``u0`` and, for the wave family,
``u1``; f, u0, u1 already carry sqrt(gamma), as the port expects).

The data is the configuration's manufactured solution family, moved to a
spatial mode: the wave family's is the reference code's test problem
(``Control_Wave_PC.py``: u = sin(pi x) cos(pi t), p = sin(pi x) (e^t - e^T)^2
in 1D), the heat family's u = sin(pi x) e^-t, p = sin(pi x) (e^(t-T) - 1);
member ``i`` of a pool puts ``sin(k pi x)`` (``sin(k pi x) sin(k pi y)`` in
2D) in place of the first mode, ``k = 1 + i % MODES``, and derives f and g
for that mode as the source derives them for the first (a manufactured
solution at every k). So every pool holds the same modes at the same places.
The seed scales each member as a whole by a factor, log-uniform in [1/2, 2]:
a solve's work does not change with the scale (the Krylov methods stop at a
relative tolerance), so every seed gives the program the same work, where a
factor of each field of its own would change the mix of the fields and, with
it, GMRES's iterations (5 to 9 per mode on the card). Member 0 is the
configuration's manufactured data itself, unscaled, the same in every run
(the end-to-end residual reads it). Every member is rounded to the traffic's
dtype, so the program and the reference get the same numbers.
"""

from __future__ import annotations

import functools
import math
from typing import Dict

import numpy as np

MODES = 8  # the spatial modes 1..MODES, in turn along the pool
NP_DTYPES = {"float32": np.float32, "float64": np.float64}


def coords(pc: dict):
    """Interior node coordinates, flat, row-major over (y, x) in 2D."""
    pts = np.arange(1, pc["N_x"]) / pc["N_x"]
    if pc["dim"] == 1:
        return (pts,)
    X, Y = np.meshgrid(pts, pts, indexing="xy")
    return (X.ravel(), Y.ravel())


def times(problem: str, pc: dict) -> Dict[str, np.ndarray]:
    """The time of each slice of f and g: the wave family's f at i dt and g
    at (i + 1) dt; the heat family's both at (i + 1) tau."""
    dt = pc["T"] / pc["N_t"]
    i = np.arange(pc["N_t"], dtype=np.float64)
    return {"f": (i if problem == "wave" else i + 1) * dt, "g": (i + 1) * dt}


def fields(problem: str) -> tuple:
    return ("f", "g", "u0", "u1") if problem == "wave" else ("f", "g", "u0")


def mode(index: int) -> int:
    """The spatial mode of member ``index``."""
    return 1 + index % MODES


@functools.lru_cache(maxsize=MODES)
def _manufactured(problem: str, pc: tuple, k: int) -> Dict[str, np.ndarray]:
    return manufactured(problem, dict(pc), k)


def manufactured(problem: str, pc: dict, k: int = 1) -> Dict[str, np.ndarray]:
    """The manufactured data of the configuration's family at spatial mode
    ``k``, float64; ``k = 1`` is the configuration's own (the port's
    ``models/analytic.py`` and ``HeatControlProblem._analytic``). Each field
    is a time profile times the mode's shape."""
    T, gam, dim = pc["T"], pc["gamma"], pc["dim"]
    s = math.sqrt(gam) if pc.get("scaled", True) else 1.0
    shape = np.prod([np.sin(k * math.pi * x) for x in coords(pc)], axis=0)
    lam = dim * (k * math.pi) ** 2  # -Laplace of the shape
    tt = times(problem, pc)
    tf, tg = tt["f"], tt["g"]
    if problem == "heat":
        f = -np.exp(-tf) + lam * np.exp(-tf) - (np.exp(tf - T) - 1.0) / gam
        g = np.exp(-tg) - np.exp(tg - T) + lam * (np.exp(tg - T) - 1.0)
        prof = {"f": s * f, "g": g, "u0": s}
    elif dim == 1:  # u = sin cos(k pi t), p = sin (e^t - e^T)^2
        eT = math.exp(T)
        f = -(1.0 / gam) * (np.exp(tf) - eT) ** 2
        g = 2.0 * (2.0 * np.exp(2 * tg) - np.exp(T + tg)) + lam * (np.exp(tg) - eT) ** 2 + np.cos(k * math.pi * tg)
        prof = {"f": s * f, "g": g, "u0": s, "u1": 0.0}
    else:  # u = e^t sin sin, p = (t - T)^2 sin sin
        f = (1.0 + lam) * np.exp(tf) - (1.0 / gam) * (tf - T) ** 2
        g = np.exp(tg) + 2.0 + lam * (tg - T) ** 2
        prof = {"f": s * f, "g": g, "u0": s, "u1": s}
    return {name: np.outer(p, shape) if np.ndim(p) else p * shape for name, p in prof.items()}


def fixed(index: int) -> bool:
    """Whether data set ``index`` is the same in every run (member 0)."""
    return index == 0


def member(problem: str, pc: dict, dtype: str, seed: int, index: int) -> Dict[str, np.ndarray]:
    """Data set ``index`` of the pool of ``seed``: float64 arrays holding
    values of ``dtype``."""
    scale = 1.0 if fixed(index) else 2.0 ** np.random.default_rng([seed % 2**63, index]).uniform(-1.0, 1.0)
    np_dtype = NP_DTYPES[dtype]
    base = _manufactured(problem, tuple(sorted(pc.items())), mode(index))  # a pool computes each mode once
    return {k: (scale * v).astype(np_dtype).astype(np.float64) for k, v in base.items()}
