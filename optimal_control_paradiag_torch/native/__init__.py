"""ctypes bindings of the native host runtime (``native/paradiag_host.cpp``).

The counterpart of ``optimal_control_paradiag_tpu/native/__init__.py``, with
the same functions and ctypes signatures: O(nnz) P1 CSR assembly (triangle
meshes and 1D intervals), reverse Cuthill-McKee ordering, block-row
partitioning, and the structured unit-square triangulation (pure numpy).

The library is built from the repository's one C++ source with ``g++`` on
first use, into the port's build directory (``csrc/_build/``), under a name
that carries a hash of the source and the flags. The compiler writes a
temporary file that is then renamed into place, so processes that build at
once never load a half-written library. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "paradiag_host.cpp")
_BUILD = os.path.join(_PKG, "csrc", "_build")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


def _build() -> str:
    try:
        with open(_SRC, "rb") as fh:
            digest = hashlib.sha256(fh.read() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    except OSError as exc:
        raise NativeUnavailable(f"cannot read {_SRC}: {exc}") from exc
    path = os.path.join(_BUILD, f"libparadiag_host-{digest}.so")
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True, capture_output=True, text=True, timeout=300)
        os.replace(tmp, path)
    except (subprocess.CalledProcessError, FileNotFoundError, subprocess.TimeoutExpired) as exc:
        detail = getattr(exc, "stderr", "") or str(exc)
        raise NativeUnavailable(f"could not build {path}: {detail}") from exc
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load() -> ctypes.CDLL:
    """Load (building if needed) the native library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build())
        i64 = ctypes.c_int64
        p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.p1_symbolic.restype = i64
        lib.p1_symbolic.argtypes = [p_i32, i64, i64, p_i64, p_i32, i64]
        lib.p1_numeric.restype = None
        lib.p1_numeric.argtypes = [p_f64, p_i32, i64, p_i64, p_i32, p_f64, p_f64]
        lib.p1_interval.restype = i64
        lib.p1_interval.argtypes = [i64, ctypes.c_double, p_i64, p_i32, p_f64, p_f64]
        lib.rcm_order.restype = None
        lib.rcm_order.argtypes = [p_i64, p_i32, i64, p_i32]
        lib.partition_rows.restype = None
        lib.partition_rows.argtypes = [i64, i64, p_i32]
        _lib = lib
        return lib


def available() -> bool:
    try:
        load()
        return True
    except NativeUnavailable:
        return False


def assemble_p1_triangles(
    points: np.ndarray, triangles: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(indptr, indices, mass_data, stiff_data) CSR over ALL nodes of an
    arbitrary P1 triangle mesh."""
    lib = load()
    pts = np.ascontiguousarray(points, np.float64)
    tris = np.ascontiguousarray(triangles, np.int32)
    n_pts = pts.shape[0]
    n_tri = tris.shape[0]
    cap = n_pts + 12 * n_tri  # adjacency bound: self + 6 pairs per triangle x2
    indptr = np.zeros(n_pts + 1, np.int64)
    indices = np.zeros(cap, np.int32)
    nnz = lib.p1_symbolic(tris, n_tri, n_pts, indptr, indices, cap)
    if nnz < 0:
        raise RuntimeError("nnz capacity bound exceeded")
    indices = indices[:nnz].copy()
    mass = np.zeros(nnz, np.float64)
    stiff = np.zeros(nnz, np.float64)
    lib.p1_numeric(pts, tris, n_tri, indptr, indices, mass, stiff)
    return indptr, indices, mass, stiff


def assemble_p1_interval(n_el: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Tridiagonal CSR (all nodes incl. boundary) of the 1D P1 mass/stiffness."""
    lib = load()
    n = n_el + 1
    indptr = np.zeros(n + 1, np.int64)
    indices = np.zeros(3 * n, np.int32)
    mass = np.zeros(3 * n, np.float64)
    stiff = np.zeros(3 * n, np.float64)
    nnz = lib.p1_interval(n_el, 1.0 / n_el, indptr, indices, mass, stiff)
    return indptr, indices[:nnz].copy(), mass[:nnz].copy(), stiff[:nnz].copy()


def rcm_permutation(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of a CSR adjacency graph."""
    lib = load()
    n = len(indptr) - 1
    perm = np.zeros(n, np.int32)
    lib.rcm_order(np.ascontiguousarray(indptr, np.int64), np.ascontiguousarray(indices, np.int32), n, perm)
    return perm


def partition_rows(n: int, n_parts: int) -> np.ndarray:
    """Balanced contiguous block-row partition (PETSc-style)."""
    lib = load()
    part = np.zeros(n, np.int32)
    lib.partition_rows(n, n_parts, part)
    return part


def unit_square_mesh(N: int, diagonal: str = "left") -> Tuple[np.ndarray, np.ndarray]:
    """Structured triangulation of the unit square (the reference's
    ``UnitSquareMesh``): (points, triangles); ``diagonal='left'`` splits each
    cell along (i, j)-(i+1, j+1)."""
    xs = np.linspace(0.0, 1.0, N + 1)
    X, Y = np.meshgrid(xs, xs, indexing="xy")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)
    idx = lambda i, j: j * (N + 1) + i
    tris = []
    for j in range(N):
        for i in range(N):
            a, b, c, d = idx(i, j), idx(i + 1, j), idx(i, j + 1), idx(i + 1, j + 1)
            if diagonal == "left":
                tris.append((a, b, d))
                tris.append((a, d, c))
            else:
                tris.append((a, b, c))
                tris.append((b, d, c))
    return pts, np.asarray(tris, np.int32)
