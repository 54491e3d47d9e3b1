"""Carry a problem's state from the JAX package to the port.

The system has no weights: its state is the two configs and the nodal data
``f, g, u0, u1``. These functions rebuild the port's objects from plain
dicts (``dataclasses.asdict`` of the JAX configs) and numpy arrays, so the
two packages can run on identical inputs. Nothing here imports JAX: a JAX
dtype arrives as anything ``numpy.dtype`` understands (its name, or the
scalar type itself).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from optimal_control_paradiag_torch.config import ProblemConfig, SolverConfig
from optimal_control_paradiag_torch.models.wave import WaveControlProblem

_TORCH_OF_NP = {"float32": torch.float32, "float64": torch.float64}


def torch_dtype(dtype) -> torch.dtype:
    """A real torch dtype from a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name
    if name not in _TORCH_OF_NP:
        raise ValueError(f"unsupported problem dtype {name!r}: use float32 or float64")
    return _TORCH_OF_NP[name]


def problem_from_jax(
    problem_fields: Mapping, data: Dict[str, np.ndarray], device="cuda"
) -> WaveControlProblem:
    """The port's :class:`WaveControlProblem` for a JAX ``ProblemConfig``'s
    fields and the JAX problem's nodal data (``{'f', 'g', 'u0', 'u1'}`` as
    numpy arrays, scaled as the JAX package stores them)."""
    fields = dict(problem_fields)
    fields["dtype"] = torch_dtype(fields.get("dtype", "float64"))
    return WaveControlProblem(ProblemConfig(**fields), device=device, data=data)


def solver_from_jax(solver_fields: Mapping) -> SolverConfig:
    """The port's :class:`SolverConfig` for a JAX ``SolverConfig``'s fields."""
    return SolverConfig(**dict(solver_fields))
