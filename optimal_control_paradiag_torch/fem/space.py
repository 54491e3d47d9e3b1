"""P1 spaces on structured unit-interval / unit-square meshes (PyTorch).

The counterpart of ``optimal_control_paradiag_tpu/fem/space.py``: interior-DoF
arrays, shift-add stencils for the mass and stiffness matrices, and the DST-I
sine transform that diagonalizes both.

1D, ``h = 1/N_x``: mass tridiag(h/6, 4h/6, h/6) (consistent) or h I
(lumped); stiffness tridiag(-1/h, 2/h, -1/h).
2D (Friedrichs-Keller): stiffness the 5-point stencil; consistent mass
h^2/12 {centre 6; E, W, N, S, NE, SW 1}; lumped mass h^2 I.

The sine transform is a dense matmul with the symmetric DST-I matrix in
strict float32 (or float64): the direct solve does not survive a
reduced-precision transform (``config.py`` of the JAX package records a
relative residual of 0.129 with bf16x3 on the DST alone), so the solver
builders call :func:`require_full_fp32_matmul` before they build anything.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from optimal_control_paradiag_torch.utils.constants import host_const, np_dtype, to_device

# Dense DST matrix budget of dst_method='auto' (the JAX package's choice).
_DST_MATMUL_BUDGET_BYTES = 64 * 2**20


def require_full_fp32_matmul() -> None:
    """Raise unless float32 matmuls run in full float32 (no TF32)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is on: the Woodbury direct "
            "solve needs full-float32 sine transforms; set it to False"
        )
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "torch.get_float32_matmul_precision() is "
            f"{torch.get_float32_matmul_precision()!r}: the Woodbury direct "
            "solve needs 'highest' (full float32) sine transforms"
        )


def shift(x: torch.Tensor, s: int, dim: int) -> torch.Tensor:
    """y[..., i, ...] = x[..., i - s, ...] along ``dim``, zero-padded."""
    if s == 0:
        return x
    dim = dim % x.ndim
    size = x.shape[dim]
    k = min(abs(s), size)
    zshape = list(x.shape)
    zshape[dim] = k
    zeros = x.new_zeros(zshape)
    if s > 0:
        return torch.cat([zeros, x.narrow(dim, 0, size - k)], dim)
    return torch.cat([x.narrow(dim, k, size - k), zeros], dim)


def _np_shift(x: np.ndarray, s: int, axis: int) -> np.ndarray:
    """Numpy twin of :func:`shift` (host float64 oracles)."""
    if s == 0:
        return x
    axis = axis % x.ndim
    pad = [(0, 0)] * x.ndim
    idx = [slice(None)] * x.ndim
    if s > 0:
        pad[axis] = (s, 0)
        idx[axis] = slice(None, -s)
    else:
        pad[axis] = (0, -s)
        idx[axis] = slice(-s, None)
    return np.pad(x[tuple(idx)], pad)


@dataclasses.dataclass(frozen=True)
class P1Space:
    """Interior-DoF P1 space with stencil operators and sine-transform data.

    Vector arguments have shape ``(..., n)`` with the flat interior-node axis
    last (2D flattening is row-major over ``(ny, nx)``). ``dtype`` is a real
    torch dtype; ``device`` is where the space's tensors live.
    """

    dim: int
    N_x: int
    mass: str  # 'consistent' | 'lumped'
    dtype: Any
    device: torch.device = torch.device("cpu")
    dst_method: str = "auto"
    dst_precision: str = "highest"

    def __post_init__(self):
        if self.dst_method in ("fft", "mxu4"):
            raise NotImplementedError(
                f"dst_method={self.dst_method!r} is not ported yet (ROADMAP Queue A "
                "item 1, deferred transforms); use 'matmul' or 'auto'"
            )
        if self.dst_precision != "highest":
            raise NotImplementedError(
                "dst_precision='high' is not ported yet (ROADMAP Queue A, deferred "
                "transforms): its meaning is the bf16x3 matmul, and torch's 'high' "
                "float32 matmul precision is TF32, a different algorithm"
            )

    @property
    def h(self) -> float:
        return 1.0 / self.N_x

    @property
    def n1d(self) -> int:
        """Interior nodes per dimension."""
        return self.N_x - 1

    @property
    def grid_shape(self) -> Tuple[int, ...]:
        return (self.n1d,) * self.dim

    @property
    def n(self) -> int:
        """Total interior DoFs."""
        return self.n1d**self.dim

    # ---------------------------------------------------------------- coords

    @functools.cached_property
    def coords(self) -> Tuple[np.ndarray, ...]:
        """Interior node coordinates, each flat of length ``n``: (x,) or (x, y)."""
        pts = (np.arange(1, self.N_x) / self.N_x).astype(np.float64)
        if self.dim == 1:
            return (pts,)
        X, Y = np.meshgrid(pts, pts, indexing="xy")  # rows iy, cols ix
        return (X.ravel(), Y.ravel())

    def interpolate(self, fn: Callable[..., Any]) -> np.ndarray:
        """Nodal interpolation of ``fn(x)`` / ``fn(x, y)`` onto interior
        nodes, as a host numpy array of the working dtype."""
        return host_const(np.asarray(fn(*self.coords), dtype=np.float64), self.dtype)

    # ------------------------------------------------------------- operators

    def apply_mass(self, x: torch.Tensor) -> torch.Tensor:
        """M @ x over the last axis, batched over leading axes."""
        h = self.h  # python float: keeps the tensor's dtype
        if self.mass == "lumped":
            return (h**self.dim) * x
        if self.dim == 1:
            return (h / 6.0) * (4.0 * x + shift(x, 1, -1) + shift(x, -1, -1))
        g = x.reshape(x.shape[:-1] + self.grid_shape)
        acc = 6.0 * g
        for sy, sx in ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (-1, -1)):
            acc = acc + shift(shift(g, sx, -1), sy, -2)
        return ((h * h / 12.0) * acc).reshape(x.shape)

    def apply_stiffness(self, x: torch.Tensor) -> torch.Tensor:
        """K @ x over the last axis, batched over leading axes."""
        h = self.h
        if self.dim == 1:
            return (1.0 / h) * (2.0 * x - shift(x, 1, -1) - shift(x, -1, -1))
        g = x.reshape(x.shape[:-1] + self.grid_shape)
        acc = 4.0 * g
        for sy, sx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            acc = acc - shift(shift(g, sx, -1), sy, -2)
        return acc.reshape(x.shape)

    def apply_stiffness_nested(self, x: torch.Tensor) -> torch.Tensor:
        """K @ x as summed first differences, ``(x_j - x_{j-1}) + (x_j -
        x_{j+1})``: algebraically :meth:`apply_stiffness`, but every
        intermediate stays at the scale of the answer on smooth fields
        (adjacent-value subtraction is exact by Sterbenz), so the float32
        rounding noise drops by ~1/h. The physical-space defect correction
        (``AllAtOnceOperator.matvec_accurate``) measures defects with it."""
        h = self.h
        if self.dim == 1:
            return (1.0 / h) * ((x - shift(x, 1, -1)) + (x - shift(x, -1, -1)))
        g = x.reshape(x.shape[:-1] + self.grid_shape)
        sh = lambda sy, sx: shift(shift(g, sx, -1), sy, -2)
        acc = (g - sh(0, 1)) + (g - sh(0, -1))
        acc = acc + (g - sh(1, 0)) + (g - sh(-1, 0))
        return acc.reshape(x.shape)

    def apply_mass_host_f64(self, x: np.ndarray) -> np.ndarray:
        """Float64 numpy twin of :meth:`apply_mass` (residual oracle)."""
        x = np.asarray(x, np.float64)
        h = self.h
        if self.mass == "lumped":
            return (h**self.dim) * x
        if self.dim == 1:
            return (h / 6.0) * (4.0 * x + _np_shift(x, 1, -1) + _np_shift(x, -1, -1))
        g = x.reshape(x.shape[:-1] + self.grid_shape)
        acc = 6.0 * g
        for sy, sx in ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (-1, -1)):
            acc = acc + _np_shift(_np_shift(g, sx, -1), sy, -2)
        return ((h * h / 12.0) * acc).reshape(x.shape)

    def apply_stiffness_host_f64(self, x: np.ndarray) -> np.ndarray:
        """Float64 numpy twin of :meth:`apply_stiffness` (residual oracle)."""
        x = np.asarray(x, np.float64)
        h = self.h
        if self.dim == 1:
            return (1.0 / h) * (2.0 * x - _np_shift(x, 1, -1) - _np_shift(x, -1, -1))
        g = x.reshape(x.shape[:-1] + self.grid_shape)
        acc = 4.0 * g
        for sy, sx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            acc = acc - _np_shift(_np_shift(g, sx, -1), sy, -2)
        return acc.reshape(x.shape)

    # -------------------------------------------------------- sine transform

    @functools.cached_property
    def dst_matrix(self) -> torch.Tensor:
        """Symmetric DST-I matrix ``V[i,j] = sin((i+1)(j+1)pi/N_x)``,
        ``V @ V = (N_x/2) I``; built in float64 numpy, cast once, and copied
        to the device once."""
        i = np.arange(1, self.N_x)
        V = np.sin(np.pi * np.outer(i, i) / self.N_x)
        return to_device(V, self.dtype, self.device)

    def _check_matmul_dst(self) -> None:
        itemsize = np_dtype(self.dtype).itemsize
        if self.n1d * self.n1d * itemsize > _DST_MATMUL_BUDGET_BYTES:
            raise NotImplementedError(
                f"n1d={self.n1d}: the dense DST matrix exceeds the 64 MB budget "
                "where dst_method='auto' switches to the FFT sine transform, which "
                "is not ported yet (ROADMAP Queue A item 1, deferred transforms)"
            )

    def dst(self, x: torch.Tensor) -> torch.Tensor:
        """Forward sine transform over the (flat) space axis, as matmuls with
        the DST-I matrix (complex inputs: real and imaginary parts apart)."""
        self._check_matmul_dst()
        if x.is_complex():
            return torch.complex(self.dst(x.real), self.dst(x.imag))
        V = self.dst_matrix
        if self.dim == 1:
            return torch.matmul(x, V)
        g = x.reshape(x.shape[:-1] + self.grid_shape)
        g = torch.matmul(g, V)  # over x:  [..., y, j]
        g = torch.matmul(V.T, g)  # over y:  [..., j, x]
        return g.reshape(x.shape)

    def idst(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse sine transform: ``(2/N_x)^dim`` times the forward map."""
        return self.dst(x) * ((2.0 / self.N_x) ** self.dim)

    @functools.cached_property
    def spectrum(self) -> Tuple[Optional[np.ndarray], np.ndarray]:
        """(mass eigenvalues, stiffness eigenvalues) in the sine basis, each a
        flat host array of length ``n`` -- or ``(None, muK)`` for the 2D
        consistent mass, which the sine transform does not diagonalize."""
        j = np.arange(1, self.N_x)
        c = np.cos(np.pi * j / self.N_x)
        if self.dim == 1:
            muK = (2.0 / self.h) * (1.0 - c)
            if self.mass == "lumped":
                muM = np.full_like(muK, self.h)
            else:
                muM = (self.h / 6.0) * (4.0 + 2.0 * c)
            return (host_const(muM, self.dtype), host_const(muK, self.dtype))
        ky = 2.0 * (1.0 - c)[:, None]
        kx = 2.0 * (1.0 - c)[None, :]
        muK = (ky + kx).ravel()
        if self.mass == "lumped":
            muM = np.full_like(muK, self.h * self.h)
            return (host_const(muM, self.dtype), host_const(muK, self.dtype))
        return (None, host_const(muK, self.dtype))

    @property
    def diagonalizable(self) -> bool:
        """True when both M and K are diagonalized by the sine transform."""
        return self.spectrum[0] is not None


def make_space(
    dim: int,
    N_x: int,
    mass: str = "consistent",
    dtype=torch.float64,
    device="cpu",
    dst_method: str = "auto",
    dst_precision: str = "highest",
) -> P1Space:
    return P1Space(
        dim=dim,
        N_x=N_x,
        mass=mass,
        dtype=dtype,
        device=torch.device(device),
        dst_method=dst_method,
        dst_precision=dst_precision,
    )
