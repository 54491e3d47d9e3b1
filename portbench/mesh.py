"""The triangle meshes a configuration may carry, built from its ``"mesh"`` fields in numpy.

    "mesh": {"kind": "perturbed_unit_square", "jitter": 0.18, "seed": 0}

``perturbed_unit_square`` is the JAX bench's perturbed mesh (``bench.py``
``stage_unstructured``, ``stage_unstructured_eig``): the unit square's
(N + 1)^2 grid points, N = ``problem_config``'s ``N_x``, row-major over
(y, x); each grid cell cut into two triangles along (i, j)-(i + 1, j + 1)
(the port's ``diagonal='left'``, the only cut this kind has: the reference
code's ``UnitSquareMesh``); then every interior point moved by
``default_rng(seed).uniform(-jitter / N, jitter / N)`` in x and y, drawn in
point order. The interior points (grid indices i, j not 0 or N) carry the
unknowns, in point order: the grid's order.

Only the wave family takes a mesh, with ``problem_config``'s own fields
``dim = 2`` and ``mass = "consistent"``. It imports nothing of
the port or of the JAX package: the benchmark makes the mesh and hands the
same points and triangles to the program and to the reference.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np

KIND = "perturbed_unit_square"
FIELDS = ("kind", "jitter", "seed")  # a "mesh" entry's keys, each required


@dataclasses.dataclass(frozen=True)
class Mesh:
    points: np.ndarray  # (n_points, 2) float64, every point
    triangles: np.ndarray  # (n_triangles, 3) int32
    interior: np.ndarray  # (n_points,) bool: the points that carry unknowns

    @property
    def coords(self) -> Tuple[np.ndarray, np.ndarray]:
        """Interior x and y, in point order."""
        pts = self.points[self.interior]
        return pts[:, 0], pts[:, 1]


def spec(config: dict) -> Optional[dict]:
    """The configuration's mesh, checked against its problem, as the fields
    ``build`` takes: its ``"mesh"`` entry's and ``N`` (``N_x``); None on a grid."""
    m = config.get("mesh")
    if m is None:
        return None
    if config["problem"] != "wave":
        raise ValueError(f"the {config['problem']!r} family takes no mesh: only the wave problem takes a space")
    if sorted(m) != sorted(FIELDS):
        raise ValueError(f"a mesh entry has the keys {FIELDS}, not {tuple(sorted(m))} (N is problem_config's N_x)")
    if m["kind"] != KIND:
        raise ValueError(f"unknown mesh kind {m['kind']!r}")
    pc = config["problem_config"]
    if (pc["dim"], pc["mass"]) != (2, "consistent"):
        raise ValueError("a mesh's problem_config has dim = 2 and mass = 'consistent'")
    return dict(m, N=int(pc["N_x"]))


def build(m: dict) -> Mesh:
    """The mesh of ``spec``'s fields (read only; the same object for the same fields)."""
    return _perturbed_unit_square(int(m["N"]), float(m["jitter"]), int(m["seed"]))


@functools.lru_cache(maxsize=4)
def _perturbed_unit_square(N: int, jitter: float, seed: int) -> Mesh:
    xs = np.linspace(0.0, 1.0, N + 1)
    X, Y = np.meshgrid(xs, xs, indexing="xy")
    points = np.stack([X.ravel(), Y.ravel()], axis=1)
    j, i = np.divmod(np.arange((N + 1) ** 2), N + 1)
    interior = (i > 0) & (i < N) & (j > 0) & (j < N)
    cj, ci = np.divmod(np.arange(N * N), N)  # grid cells, row-major over (y, x)
    a = cj * (N + 1) + ci
    b, c, d = a + 1, a + N + 1, a + N + 2  # (i+1, j), (i, j+1), (i+1, j+1)
    triangles = np.stack([np.stack(t, axis=1) for t in ((a, b, d), (a, d, c))], axis=1).reshape(-1, 3).astype(np.int32)
    rng = np.random.default_rng(seed)
    points[interior] += rng.uniform(-jitter / N, jitter / N, size=(int(interior.sum()), 2))
    for arr in (points, triangles, interior):
        arr.flags.writeable = False
    return Mesh(points=points, triangles=triangles, interior=interior)
