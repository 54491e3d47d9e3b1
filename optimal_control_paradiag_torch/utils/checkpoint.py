"""Checkpoint / resume of solver runs.

The counterpart of the single-process part of
``optimal_control_paradiag_tpu/utils/checkpoint.py``, in the same npz
format, so a file written by either package loads in the other:
:func:`save_solution` / :func:`load_solution` keep a whole solution (``u``
and ``p`` in the working dtype) and :func:`warm_start` turns one into the
``x0`` of a resumed ``WaveControlProblem.solve(..., x0=...)``. The sharded
checkpoints (:func:`save_sharded`, :func:`load_sharded`) belong to the
multi-device layer, which is not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from optimal_control_paradiag_torch.utils.constants import host_array, to_device


def save_solution(path: str, problem, sol, extra: Optional[Dict[str, Any]] = None) -> str:
    """Persist a solved state; resumable/inspectable with :func:`load_solution`."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "u": host_array(sol.u),
        "p": host_array(sol.p),
        "config": json.dumps(dataclasses.asdict(problem.config), default=str),
    }
    if sol.result is not None:
        payload["iterations"] = host_array(sol.result.iterations)
        payload["residual_history"] = host_array(sol.result.residual_history)
    if extra:
        payload["extra"] = json.dumps(extra, default=str)
    np.savez_compressed(path, **payload)
    return path if path.endswith(".npz") else path + ".npz"


def load_solution(path: str) -> Dict[str, Any]:
    d = np.load(path, allow_pickle=False)
    out = {k: d[k] for k in d.files if k not in ("config", "extra")}
    out["config"] = json.loads(str(d["config"]))
    if "extra" in d.files:
        out["extra"] = json.loads(str(d["extra"]))
    return out


def _not_ported(name: str):
    raise NotImplementedError(
        f"{name}: the sharded checkpoints belong to the multi-device layer, which is "
        "not ported yet: ROADMAP Queue A item 14"
    )


def save_sharded(path_prefix: str, arr) -> str:
    """Per-shard checkpoint of a sharded array (not ported yet)."""
    _not_ported("save_sharded")


def load_sharded(path_prefix: str, sharding=None):
    """Reload of a :func:`save_sharded` checkpoint (not ported yet)."""
    _not_ported("load_sharded")


def warm_start(problem, checkpoint_path: str) -> torch.Tensor:
    """Return an x0 state ``(2, N_t, n)`` on ``problem.device`` from a
    checkpoint, in scaled unknowns, for restarted solves (e.g. continuing a
    tightened-tolerance run)."""
    d = load_solution(checkpoint_path)
    cfg = problem.config
    scale = math.sqrt(cfg.gamma) if cfg.scaled else 1.0
    u = to_device(d["u"] * scale, cfg.dtype, problem.device)
    p = to_device(d["p"], cfg.dtype, problem.device)
    return torch.stack([u, p])
