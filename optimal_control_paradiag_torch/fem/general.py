"""P1 space on an arbitrary triangle mesh, the unstructured path (PyTorch).

The counterpart of ``optimal_control_paradiag_tpu/fem/general.py``:

- assembly: the native C++ O(nnz) P1 assembler (``native/paradiag_host.cpp``
  through :mod:`optimal_control_paradiag_torch.native`) builds the CSR mass
  and stiffness over all nodes;
- Dirichlet elimination: boundary nodes (the endpoints of edges that belong
  to one triangle only) are dropped, leaving interior-DoF operators like the
  structured space's;
- apply: the ELL SpMV of :class:`ops.sparse.CSRMatrix`, batched over
  leading axes.

No sine transform diagonalizes these operators (``diagonalizable =
False``): the ParaDiag inner solves use the dense per-mode factorization
(``pc_variant='blockdense'``), the RCM-banded one (``'blockband'``) or
Jacobi-preconditioned COCG (``inner='cocg_jacobi'``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from optimal_control_paradiag_torch.ops.sparse import CSRMatrix, csr_from_parts
from optimal_control_paradiag_torch.utils.constants import host_const, resolve_device, to_device


def boundary_nodes(n_points: int, triangles: np.ndarray) -> np.ndarray:
    """Boolean mask of boundary nodes: endpoints of edges that belong to
    exactly one triangle."""
    tris = np.asarray(triangles, np.int64)
    edges = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [0, 2]]])
    edges = np.sort(edges, axis=1)
    uniq, counts = np.unique(edges, axis=0, return_counts=True)
    mask = np.zeros(n_points, bool)
    mask[uniq[counts == 1].ravel()] = True
    return mask


def _interior_csr(indptr, indices, data, keep: np.ndarray, dtype, device) -> CSRMatrix:
    """Restrict a full-node CSR to the ``keep`` (interior) rows and columns,
    keeping each row's entry order."""
    n_full = len(indptr) - 1
    new_id = -np.ones(n_full, np.int64)
    new_id[keep] = np.arange(keep.sum())
    rows = np.repeat(np.arange(n_full), np.diff(indptr))
    sel = keep[rows] & (new_id[indices] >= 0)
    counts = np.bincount(new_id[rows[sel]], minlength=int(keep.sum()))
    n = int(keep.sum())
    return csr_from_parts(
        (n, n),
        np.concatenate([[0], np.cumsum(counts)]).astype(np.int32),
        new_id[indices[sel]].astype(np.int32),
        np.asarray(data, np.float64)[sel],
        dtype=dtype,
        device=device,
    )


@dataclasses.dataclass(frozen=True)
class GeneralP1Space:
    """Interior-DoF P1 space on a triangle mesh. It has what the operator,
    problem and preconditioner layers use of :class:`fem.space.P1Space`
    (``dim, n, dtype, device, coords, interpolate, apply_mass,
    apply_stiffness, apply_stiffness_nested``, the host float64 applies,
    ``mass_dense, stiffness_dense, diagonalizable, spectrum``) and the
    diagonals of its matrices (``mass_diag, stiffness_diag``)."""

    points: np.ndarray  # (n_points, 2) float64, all nodes
    triangles: np.ndarray  # (n_tri, 3) int32
    dtype: Any
    device: torch.device
    interior: np.ndarray  # (n_points,) bool
    M_csr: CSRMatrix
    K_csr: CSRMatrix

    dim: int = 2
    diagonalizable: bool = False

    @property
    def n(self) -> int:
        return self.M_csr.shape[0]

    @property
    def spectrum(self) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        """No sine-transform diagonalization on general meshes."""
        return (None, None)

    @property
    def coords(self) -> Tuple[np.ndarray, ...]:
        pts = self.points[self.interior]
        return (pts[:, 0].copy(), pts[:, 1].copy())

    def interpolate(self, fn: Callable[..., Any]) -> np.ndarray:
        """Nodal interpolation onto the interior nodes, as a host numpy
        array of the working dtype."""
        return host_const(np.asarray(fn(*self.coords), np.float64), self.dtype)

    def apply_mass(self, x: torch.Tensor) -> torch.Tensor:
        return self.M_csr.spmv(x)

    def apply_stiffness(self, x: torch.Tensor) -> torch.Tensor:
        return self.K_csr.spmv(x)

    @functools.cached_property
    def _element_grad_data(self):
        """Per-triangle P1 gradient factors ``(b, c, inv4A, idx)`` of the
        element-form stiffness ``K_e = (b b^T + c c^T) / (4 A)``, ``b_i = y_j
        - y_k``, ``c_i = x_k - x_j`` (cyclic); flipping a triangle negates b
        AND c, so every product is orientation-safe, and the area enters as
        ``|A|``. ``idx`` maps triangle vertices to interior slots, boundary
        vertices to the zero ghost slot ``n``."""
        pts, tris = self.points, self.triangles
        x, y = pts[:, 0], pts[:, 1]
        i0, i1, i2 = tris[:, 0], tris[:, 1], tris[:, 2]
        b = np.stack([y[i1] - y[i2], y[i2] - y[i0], y[i0] - y[i1]], axis=1)
        c = np.stack([x[i2] - x[i1], x[i0] - x[i2], x[i1] - x[i0]], axis=1)
        twoA = (x[i1] - x[i0]) * (y[i2] - y[i0]) - (x[i2] - x[i0]) * (y[i1] - y[i0])
        inv4A = 1.0 / (2.0 * np.abs(twoA))
        slot = np.full(pts.shape[0], self.n, np.int64)
        slot[np.flatnonzero(self.interior)] = np.arange(self.n)
        idx = slot[tris]
        dt, dev = self.dtype, self.device
        return (
            to_device(b, dt, dev),
            to_device(c, dt, dev),
            to_device(inv4A, dt, dev),
            torch.from_numpy(idx.reshape(-1)).to(dev),
        )

    def apply_stiffness_nested(self, x: torch.Tensor) -> torch.Tensor:
        """K @ x in cancellation-aware ELEMENT form: the unstructured
        counterpart of :meth:`fem.space.P1Space.apply_stiffness_nested`.

        The CSR form sums O(1) products that cancel to the O(h^2) answer on
        smooth fields, so its float32 rounding is amplified by ~1/h^2. Here
        each element gradient comes from adjacent-value differences ``u_j -
        u_0`` (exact by Sterbenz) times geometry factors, and only the final
        per-node scatter carries one O(h) -> O(h^2) cancellation: ~1/h.
        Algebraically :meth:`apply_stiffness`; the float32 GMRES of
        non-diagonalizable spaces and the polish ladder measure defects with
        it (``AllAtOnceOperator.matvec_accurate``)."""
        b, c, inv4A, idx = self._element_grad_data
        lead = x.shape[:-1]
        x_ext = torch.cat([x, x.new_zeros(lead + (1,))], dim=-1)
        g = x_ext.index_select(-1, idx).reshape(lead + (-1, 3))
        d1 = g[..., 1] - g[..., 0]
        d2 = g[..., 2] - g[..., 0]
        wx = (b[:, 1] * d1 + b[:, 2] * d2) * inv4A
        wy = (c[:, 1] * d1 + c[:, 2] * d2) * inv4A
        contrib = b * wx[..., None] + c * wy[..., None]  # (..., n_tri, 3)
        out = x.new_zeros(lead + (self.n + 1,))
        out.index_add_(-1, idx, contrib.reshape(lead + (-1,)))
        return out[..., : self.n]

    def apply_mass_host_f64(self, x: np.ndarray) -> np.ndarray:
        """Float64 numpy twin of :meth:`apply_mass` (residual oracle)."""
        return self.M_csr.spmv_host_f64(x)

    def apply_stiffness_host_f64(self, x: np.ndarray) -> np.ndarray:
        """Float64 numpy twin of :meth:`apply_stiffness` (residual oracle)."""
        return self.K_csr.spmv_host_f64(x)

    def mass_dense(self) -> torch.Tensor:
        """The dense interior mass matrix on the space's device (test oracle
        and small direct solves), as :meth:`fem.space.P1Space.mass_dense`."""
        return to_device(self.M_csr.todense(), self.dtype, self.device)

    def stiffness_dense(self) -> torch.Tensor:
        """The dense interior stiffness matrix on the space's device."""
        return to_device(self.K_csr.todense(), self.dtype, self.device)

    def mass_diag(self) -> np.ndarray:
        return np.diag(self.M_csr.todense()).copy()

    def stiffness_diag(self) -> np.ndarray:
        return np.diag(self.K_csr.todense()).copy()


def make_general_space(
    points: np.ndarray,
    triangles: np.ndarray,
    dtype=torch.float64,
    interior: Optional[np.ndarray] = None,
    device="cuda",
) -> GeneralP1Space:
    """Assemble a :class:`GeneralP1Space` with the native C++ assembler
    (required: there is no fallback) on ``device``, the card unless the
    caller asks for the CPU.

    ``interior``: optional boolean mask of the non-Dirichlet nodes; by
    default topological boundary detection (homogeneous Dirichlet on the
    whole boundary, as in the reference)."""
    from optimal_control_paradiag_torch import native

    dev = resolve_device(device)
    pts = np.ascontiguousarray(points, np.float64)
    tris = np.ascontiguousarray(triangles, np.int32)
    indptr, indices, mass, stiff = native.assemble_p1_triangles(pts, tris)
    if interior is None:
        interior = ~boundary_nodes(pts.shape[0], tris)
    interior = np.asarray(interior, bool)
    M = _interior_csr(indptr, indices, mass, interior, dtype, dev)
    K = _interior_csr(indptr, indices, stiff, interior, dtype, dev)
    return GeneralP1Space(
        points=pts, triangles=tris, dtype=dtype, device=dev, interior=interior, M_csr=M, K_csr=K
    )
