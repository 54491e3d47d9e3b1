"""Sparse matrices: CSR containers and the padded-row (ELL) SpMV (PyTorch).

The counterpart of ``optimal_control_paradiag_tpu/ops/sparse.py``. CSR is
kept on the host for construction and interop; the product runs in ELL
layout on the device: every row padded to the widest one, so ``A @ x`` is
one gather over the last axis, one multiply and one row sum, batched over
any leading axes of ``x`` (real or complex). For P1 matrices the rows hold
at most 3^dim entries, so the padding wastes little.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from optimal_control_paradiag_torch.utils.constants import host_const, np_dtype, resolve_device, to_device


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """Host CSR (numpy) with the ELL apply data on a device."""

    shape: Tuple[int, int]
    indptr: np.ndarray  # (n_rows+1,) int32
    indices: np.ndarray  # (nnz,) int32
    data: np.ndarray  # (nnz,) in the matrix dtype
    ell_cols: np.ndarray  # (n_rows, width) int32, padded with 0
    ell_vals: torch.Tensor  # (n_rows, width) on the device, padded with 0.0
    cols_flat: torch.Tensor  # ell_cols flattened, int64 on the device

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @property
    def width(self) -> int:
        return self.ell_cols.shape[1]

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x over the last axis of ``x`` (batched over leading axes)."""
        gathered = x.index_select(-1, self.cols_flat).reshape(x.shape[:-1] + self.ell_cols.shape)
        return torch.sum(gathered * self.ell_vals, dim=-1)

    @functools.cached_property
    def _ell_vals_f64(self) -> np.ndarray:
        """ELL values from the CSR data in float64 (the data already carry
        the matrix dtype's rounding, as in the JAX package)."""
        widths = np.diff(self.indptr)
        vals = np.zeros((self.shape[0], self.width), np.float64)
        mask = np.arange(self.width)[None, :] < widths[:, None]
        vals[mask] = np.asarray(self.data, np.float64)
        return vals

    def spmv_host_f64(self, x: np.ndarray) -> np.ndarray:
        """A @ x in float64 numpy on the host: the residual-oracle twin of
        :meth:`spmv` (batched over leading axes)."""
        x = np.asarray(x, np.float64)
        gathered = np.take(x, self.ell_cols, axis=-1)
        return np.sum(gathered * self._ell_vals_f64, axis=-1)

    def todense(self) -> np.ndarray:
        """The dense host matrix, in the data's dtype."""
        out = np.zeros(self.shape, self.data.dtype)
        rows = np.repeat(np.arange(self.shape[0]), np.diff(self.indptr))
        np.add.at(out, (rows, self.indices), self.data)
        return out


def csr_from_dense(A: np.ndarray, dtype=np.float64, tol: float = 0.0, device="cuda") -> CSRMatrix:
    """The CSR of the entries of ``A`` with ``|a| > tol``, row by row."""
    A = np.asarray(A)
    rows, cols = np.nonzero(np.abs(A) > tol)
    indptr = np.zeros(A.shape[0] + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    return csr_from_parts(A.shape, np.cumsum(indptr), cols, A[rows, cols], dtype=dtype, device=device)


def csr_from_parts(shape, indptr, indices, data, dtype=None, device="cuda") -> CSRMatrix:
    """A :class:`CSRMatrix` from CSR arrays; ``dtype`` (torch or numpy, the
    data's own by default) is the matrix dtype, ``device`` where its ELL
    data go: the card unless the caller asks for the CPU."""
    indptr = np.asarray(indptr, np.int32)
    indices = np.asarray(indices, np.int32)
    data = host_const(data, dtype if dtype is not None else np.asarray(data).dtype)
    n_rows = shape[0]
    widths = np.diff(indptr)
    width = max(int(widths.max(initial=0)), 1)
    rows = np.repeat(np.arange(n_rows), widths)
    slot = np.arange(len(indices)) - indptr[rows]
    ell_cols = np.zeros((n_rows, width), np.int32)
    ell_vals = np.zeros((n_rows, width), data.dtype)
    ell_cols[rows, slot] = indices
    ell_vals[rows, slot] = data
    dev = resolve_device(device)
    return CSRMatrix(
        shape=tuple(shape),
        indptr=indptr,
        indices=indices,
        data=data,
        ell_cols=ell_cols,
        ell_vals=to_device(ell_vals, np_dtype(data.dtype), dev),
        cols_flat=torch.from_numpy(ell_cols.reshape(-1).astype(np.int64)).to(dev),
    )


def space_matrices_csr(space) -> Tuple[CSRMatrix, CSRMatrix]:
    """(M, K) of a :class:`fem.space.P1Space` as CSR on the space's device:
    the assembled-matrix view of its stencil operators."""
    dense = lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    M = csr_from_dense(dense(space.mass_dense()), dtype=space.dtype, device=space.device)
    K = csr_from_dense(dense(space.stiffness_dense()), dtype=space.dtype, device=space.device)
    return M, K


def spmv_flops(csr: CSRMatrix) -> int:
    """Operations per SpMV: 2 per stored nonzero."""
    return 2 * csr.nnz
