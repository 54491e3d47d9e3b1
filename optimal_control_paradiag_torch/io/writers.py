"""Solution writers.

The counterpart of ``optimal_control_paradiag_tpu/io/writers.py``, which
replaces the reference's output layer (``write()``,
``Control_Wave_PC.py:247-333``): VTK time series of (u_out, p_out, g_out)
and analytic fields plus ``np.savetxt`` point slices. Here, in the same
formats as the JAX package:

- one ``.npz`` archive with the full output-grid trajectories, analytic
  fields, coordinates, and config -- the machine-readable artifact the
  plotting layer consumes;
- optional legacy-VTK (ASCII) file series loadable in ParaView, one file per
  output time plus a ``.series`` JSON index (the ``.pvd`` analogue).

Boundary nodes (zero by the Dirichlet conditions) are included in the written
grids so fields render correctly. Tensors come to the host through
``utils.constants`` (a CUDA tensor has no numpy view).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from optimal_control_paradiag_torch.utils.constants import host_array, host_f64


def _with_boundary(space, flat: np.ndarray) -> np.ndarray:
    """Interior nodal values -> full grid/mesh including zero boundary nodes."""
    flat = host_f64(flat)
    if hasattr(space, "triangles"):  # unstructured space: all-node vector
        out = np.zeros((flat.shape[0], space.points.shape[0]))
        out[:, np.flatnonzero(host_array(space.interior))] = flat
        return out
    if space.dim == 1:
        out = np.zeros((flat.shape[0], space.N_x + 1))
        out[:, 1:-1] = flat
        return out
    n1 = space.n1d
    g = flat.reshape(flat.shape[0], n1, n1)
    out = np.zeros((flat.shape[0], space.N_x + 1, space.N_x + 1))
    out[:, 1:-1, 1:-1] = g
    return out


def write_solution(problem, sol, path_prefix: str, vtk: bool = False) -> str:
    """Write output-grid trajectories for a solved problem; returns the npz
    path. ``problem`` is a :class:`models.wave.WaveControlProblem`."""
    cfg = problem.config
    sp = problem.space
    u_out, p_out = problem.output_trajectories(sol)
    times = np.arange(cfg.N_t + 1) * cfg.dt
    u_ana = np.stack([host_f64(sp.interpolate(lambda *x: problem.analytic.u(*x, t))) for t in times])
    p_ana = np.stack([host_f64(sp.interpolate(lambda *x: problem.analytic.p(*x, t))) for t in times])

    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    npz_path = path_prefix + ".npz"
    extra = {}
    if hasattr(sp, "triangles"):  # unstructured: ship the mesh itself
        extra = {
            "points": host_array(sp.points),
            "triangles": host_array(sp.triangles),
            "interior": host_array(sp.interior),
        }
    np.savez_compressed(
        npz_path,
        times=times,
        u_out=_with_boundary(sp, u_out),
        p_out=_with_boundary(sp, p_out),
        u_ana=_with_boundary(sp, u_ana),
        p_ana=_with_boundary(sp, p_ana),
        coords=np.stack([host_f64(c) for c in sp.coords]),
        config=json.dumps(dataclasses.asdict(cfg), default=str),
        **extra,
    )

    if vtk:
        if hasattr(sp, "triangles"):
            _write_vtk_unstructured_series(sp, path_prefix, times, u_out, p_out, u_ana, p_ana)
        else:
            _write_vtk_series(sp, path_prefix, times, u_out, p_out, u_ana, p_ana)
    return npz_path


def _write_series_index(prefix: str, names, times) -> None:
    """ParaView ``.series`` index (the ``.pvd`` analogue)."""
    with open(prefix + ".vtk.series", "w") as f:
        json.dump(
            {
                "file-series-version": "1.0",
                "files": [{"name": n, "time": float(t)} for n, t in zip(names, times)],
            },
            f,
            indent=1,
        )


def _fields(sp, u_out, p_out, u_ana, p_ana):
    return {
        "u_out": _with_boundary(sp, u_out),
        "p_out": _with_boundary(sp, p_out),
        "u_ana": _with_boundary(sp, u_ana),
        "p_ana": _with_boundary(sp, p_ana),
    }


def _write_vtk_unstructured_series(sp, prefix, times, u_out, p_out, u_ana, p_ana):
    """Legacy-VTK UNSTRUCTURED_GRID (triangle cells) file series for
    solutions on an unstructured triangle mesh (a space with ``points``,
    ``triangles`` and an ``interior`` mask) -- the any-mesh output the
    reference gets from Firedrake's VTK writer (``Control_Wave_PC.py:
    251-256``)."""
    names = []
    fields = _fields(sp, u_out, p_out, u_ana, p_ana)
    pts = host_f64(sp.points)
    tris = host_array(sp.triangles).astype(np.int64)
    npoints, ntri = pts.shape[0], tris.shape[0]
    for i, t in enumerate(times):
        path = f"{prefix}_{i:04d}.vtk"
        names.append(os.path.basename(path))
        with open(path, "w") as f:
            f.write("# vtk DataFile Version 3.0\n")
            f.write(f"wave control solution t={t}\nASCII\nDATASET UNSTRUCTURED_GRID\n")
            f.write(f"POINTS {npoints} double\n")
            for x, y in pts:
                f.write(f"{x} {y} 0\n")
            f.write(f"CELLS {ntri} {4 * ntri}\n")
            for a, b, c in tris:
                f.write(f"3 {a} {b} {c}\n")
            f.write(f"CELL_TYPES {ntri}\n")
            f.write("5\n" * ntri)  # VTK_TRIANGLE
            f.write(f"POINT_DATA {npoints}\n")
            for name, arr in fields.items():
                f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
                np.savetxt(f, arr[i].ravel()[:, None])
    _write_series_index(prefix, names, times)


def _write_vtk_series(sp, prefix, times, u_out, p_out, u_ana, p_ana):
    names = []
    fields = _fields(sp, u_out, p_out, u_ana, p_ana)
    npts = sp.N_x + 1
    coords1d = np.linspace(0.0, 1.0, npts)
    for i, t in enumerate(times):
        path = f"{prefix}_{i:04d}.vtk"
        names.append(os.path.basename(path))
        with open(path, "w") as f:
            f.write("# vtk DataFile Version 3.0\n")
            f.write(f"wave control solution t={t}\nASCII\nDATASET STRUCTURED_GRID\n")
            if sp.dim == 1:
                f.write(f"DIMENSIONS {npts} 1 1\nPOINTS {npts} double\n")
                for x in coords1d:
                    f.write(f"{x} 0 0\n")
                npoints = npts
            else:
                f.write(f"DIMENSIONS {npts} {npts} 1\nPOINTS {npts * npts} double\n")
                for y in coords1d:
                    for x in coords1d:
                        f.write(f"{x} {y} 0\n")
                npoints = npts * npts
            f.write(f"POINT_DATA {npoints}\n")
            for name, arr in fields.items():
                f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
                np.savetxt(f, arr[i].ravel()[:, None])
    _write_series_index(prefix, names, times)
