"""Checkpoint / resume of solver runs.

The counterpart of ``optimal_control_paradiag_tpu/utils/checkpoint.py``, in
the same npz formats, so a file written by either package loads in the
other. Two tiers:

- :func:`save_solution` / :func:`load_solution` keep a whole solution (``u``
  and ``p`` in the working dtype) and :func:`warm_start` turns one into the
  ``x0`` of a resumed ``WaveControlProblem.solve(..., x0=...)``;
- :func:`save_sharded` / :func:`load_sharded`: per-rank files of a sharded
  state. Each rank writes ``{prefix}_p{rank:03d}.npz`` with its block and
  the block's global index range (the JAX package's keys: ``global_shape``,
  ``dtype``, ``n_shards``, ``shard{i}_data`` / ``_start`` / ``_stop``), and
  a reload serves each rank's block from whatever pieces cover it, under
  the same layout or any other; no rank gathers the global array.
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


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def save_sharded(path_prefix: str, arr, layout=None, shape=None, stage: str = "canonical") -> str:
    """Write this rank's piece of a state to ``{path_prefix}_p{rank:03d}.npz``
    (rank of the default group; 0 without one). Unsharded (``layout=None``)
    ``arr`` is the whole array and the file covers it. With a ``layout``
    (``parallel.sharding.ParallelLayout``) ``arr`` is this rank's ``stage``
    block (``(..., l, n)``: the last two axes split) of the global ``shape``,
    and the file records that block's index range."""
    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    data = host_array(arr)
    if layout is None:
        shape = data.shape
        start = [0] * data.ndim
    else:
        if shape is None:
            raise ValueError("save_sharded with a layout needs the global shape")
        shape = tuple(int(v) for v in shape)
        l0, _, n0, _ = layout.box(stage, shape[-2], shape[-1])
        start = [0] * (len(shape) - 2) + [l0, n0]
    stop = [a + b for a, b in zip(start, data.shape)]
    payload: Dict[str, Any] = {
        "global_shape": np.asarray(shape, np.int64),
        "dtype": np.asarray(str(data.dtype)),
        "n_shards": np.asarray(1, np.int64),
        "shard0_data": data,
        "shard0_start": np.asarray(start, np.int64),
        "shard0_stop": np.asarray(stop, np.int64),
    }
    fname = f"{path_prefix}_p{_rank():03d}.npz"
    np.savez_compressed(fname, **payload)
    return fname


def load_sharded(path_prefix: str, layout=None, stage: str = "canonical", device=None):
    """Reload a :func:`save_sharded` checkpoint, of either package.

    ``layout=None``: assemble and return the whole array as numpy (the files
    present must cover it). With a ``layout``: this rank's ``stage`` block of
    the saved global shape, served from the saved pieces, as a tensor on
    ``device`` (the layout's by default). Raises ``ValueError`` when the
    pieces do not cover the requested region (a checkpoint written under a
    layout whose files are not all here)."""
    import glob

    files = sorted(glob.glob(f"{path_prefix}_p*.npz"))
    if not files:
        raise FileNotFoundError(f"no checkpoint files match {path_prefix}_p*.npz")
    pieces = []
    shape = dtype = None
    for f in files:
        d = np.load(f)
        shape = tuple(int(v) for v in d["global_shape"])
        dtype = np.dtype(str(d["dtype"]))
        for i in range(int(d["n_shards"])):
            idx = tuple(slice(int(a), int(b)) for a, b in zip(d[f"shard{i}_start"], d[f"shard{i}_stop"]))
            pieces.append((idx, d[f"shard{i}_data"]))

    def assemble(region):
        out = np.empty(tuple(sl.stop - sl.start for sl in region), dtype)
        filled = np.zeros(out.shape, bool)
        for idx, data in pieces:
            inter = [(max(r.start, p.start), min(r.stop, p.stop)) for r, p in zip(region, idx)]
            if all(lo < hi for lo, hi in inter):
                dst = tuple(slice(lo - r.start, hi - r.start) for (lo, hi), r in zip(inter, region))
                src = tuple(slice(lo - p.start, hi - p.start) for (lo, hi), p in zip(inter, idx))
                out[dst] = data[src]
                filled[dst] = True
        if not filled.all():
            raise ValueError(
                f"checkpoint {path_prefix} does not cover requested region {region} "
                "(a sharded checkpoint loaded under a mismatched layout?)"
            )
        return out

    if layout is None:
        return assemble(tuple(slice(0, s) for s in shape))
    l0, l1, n0, n1 = layout.box(stage, shape[-2], shape[-1])
    region = tuple(slice(0, s) for s in shape[:-2]) + (slice(l0, l1), slice(n0, n1))
    return torch.from_numpy(assemble(region)).to(layout.device if device is None else device)


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
