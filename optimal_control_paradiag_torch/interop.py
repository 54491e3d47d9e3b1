"""Carry a problem's state from the JAX package to the port.

The system has no weights: its state is the two configs and the nodal data
(``f, g, u0, u1`` for the wave family, ``f, g, u0`` for the heat family),
and, for a problem on a triangle mesh, the mesh (``points``, ``triangles``
and, where given, the ``interior`` mask) and the mesh's pencil eigenbasis
(``lam``, ``V``), its one expensive setup artifact. These functions rebuild the port's
objects from plain dicts (``dataclasses.asdict`` of the JAX configs) and
numpy arrays, so the two packages can run on identical inputs. Nothing here imports JAX: a JAX
dtype arrives as anything ``numpy.dtype`` understands (its name, or the
scalar type itself).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from optimal_control_paradiag_torch.config import ProblemConfig, SolverConfig
from optimal_control_paradiag_torch.fem.general import GeneralP1Space, make_general_space
from optimal_control_paradiag_torch.models.heat import HeatControlProblem
from optimal_control_paradiag_torch.models.wave import WaveControlProblem
from optimal_control_paradiag_torch.utils.constants import to_device

_TORCH_OF_NP = {"float32": torch.float32, "float64": torch.float64}


def torch_dtype(dtype) -> torch.dtype:
    """A real torch dtype from a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name
    if name not in _TORCH_OF_NP:
        raise ValueError(f"unsupported problem dtype {name!r}: use float32 or float64")
    return _TORCH_OF_NP[name]


def _config(problem_fields: Mapping) -> ProblemConfig:
    fields = dict(problem_fields)
    fields["dtype"] = torch_dtype(fields.get("dtype", "float64"))
    return ProblemConfig(**fields)


def space_from_mesh(mesh: Mapping, dtype, device="cuda") -> GeneralP1Space:
    """The port's :class:`fem.general.GeneralP1Space` of a JAX
    ``GeneralP1Space``'s mesh: ``{'points', 'triangles'}`` and, optionally,
    ``'interior'`` as numpy arrays (the JAX space's fields of those names).
    Both packages assemble the same matrices from it with the same native
    code."""
    interior = mesh.get("interior")
    return make_general_space(
        np.asarray(mesh["points"]),
        np.asarray(mesh["triangles"]),
        dtype=torch_dtype(dtype),
        interior=None if interior is None else np.asarray(interior, bool),
        device=device,
    )


def problem_from_jax(
    problem_fields: Mapping, data: Dict[str, np.ndarray], device="cuda", mesh: Optional[Mapping] = None
) -> WaveControlProblem:
    """The port's :class:`WaveControlProblem` for a JAX ``ProblemConfig``'s
    fields and the JAX problem's nodal data (``{'f', 'g', 'u0', 'u1'}`` as
    numpy arrays, scaled as the JAX package stores them). ``mesh``: the
    triangle mesh of a JAX problem on a ``GeneralP1Space``
    (:func:`space_from_mesh`), built in the problem's dtype."""
    cfg = _config(problem_fields)
    space = None if mesh is None else space_from_mesh(mesh, cfg.dtype, device)
    return WaveControlProblem(cfg, device=device, data=data, space=space)


def heat_problem_from_jax(
    problem_fields: Mapping, data: Dict[str, np.ndarray], device="cuda"
) -> HeatControlProblem:
    """The port's :class:`HeatControlProblem` for a JAX ``ProblemConfig``'s
    fields and the JAX heat problem's nodal data (``{'f', 'g', 'u0'}`` as
    numpy arrays; f and u0 scaled by sqrt(gamma), as the JAX package stores
    them)."""
    return HeatControlProblem(_config(problem_fields), device=device, data=data)


def eig_basis_from_arrays(space, lam, V, quality: str = "f32"):
    """The port's :class:`paradiag.eigbasis.EigBasisSpace` over ``space``
    (a :class:`fem.general.GeneralP1Space`) from a pencil eigenbasis as
    numpy arrays: ``lam`` (n,) and ``V`` (n, n), such as the JAX package's
    ``EigBasisSpace`` holds and its ``save_eig_basis`` writes. ``V`` goes to
    the space's device in its dtype; ``quality`` is the basis grade
    (``'f64'``, ``'f32'``, ``'f32_sdc'``), which the JAX files do not
    carry."""
    from optimal_control_paradiag_torch.paradiag.eigbasis import EigBasisSpace

    V = np.asarray(V)
    if V.shape != (space.n, space.n):
        raise ValueError(f"basis shape {V.shape} does not match space n={space.n}")
    return EigBasisSpace(base=space, lam=np.asarray(lam, np.float64), V=to_device(V, space.dtype, space.device),
                         quality=quality)


def solver_from_jax(solver_fields: Mapping) -> SolverConfig:
    """The port's :class:`SolverConfig` for a JAX ``SolverConfig``'s fields."""
    return SolverConfig(**dict(solver_fields))
