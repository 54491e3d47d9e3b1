"""P1 spaces on structured unit-interval / unit-square meshes (PyTorch).

The counterpart of ``optimal_control_paradiag_tpu/fem/space.py``: interior-DoF
arrays, shift-add stencils for the mass and stiffness matrices, and the DST-I
sine transform that diagonalizes both.

1D, ``h = 1/N_x``: mass tridiag(h/6, 4h/6, h/6) (consistent) or h I
(lumped); stiffness tridiag(-1/h, 2/h, -1/h).
2D (Friedrichs-Keller): stiffness the 5-point stencil; consistent mass
h^2/12 {centre 6; E, W, N, S, NE, SW 1}; lumped mass h^2 I.

The sine transform (``dst_method``) is a dense matmul with the symmetric
DST-I matrix, the odd-extension FFT identity, or its four-step matmul
factorization, each in strict float32 (or float64). The matmul alone also
runs in bf16x3 (``dst_precision='high'``, ``ops/bf16x3.py``), the JAX
package's ``Precision.HIGH``: the direct solve does not survive it without
one physical-space polish step, which measures the defect with the
stencil. TF32 is a different algorithm that the port never runs: the
solver builders call :func:`require_full_fp32_matmul` before they build
anything.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from optimal_control_paradiag_torch.ops.bf16x3 import SplitMatrix, bf16x3_matmul, split_matrix
from optimal_control_paradiag_torch.utils.constants import host_const, np_dtype, resolve_device, to_device
from optimal_control_paradiag_torch.utils.timing import span

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
    device: torch.device
    dst_method: str = "auto"
    dst_precision: str = "highest"

    def __post_init__(self):
        if self.dst_precision not in ("highest", "high"):
            raise ValueError(f"dst_precision must be 'highest' or 'high', got {self.dst_precision!r}")

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

    @functools.cached_property
    def dst_matrix_split(self) -> SplitMatrix:
        """The float32 DST-I matrix split to bf16 hi and lo once, on the
        space's device: the constant operand of the bf16x3 sine transform
        (``dst_precision='high'``)."""
        return split_matrix(self.dst_matrix)

    @property
    def _bf16x3(self) -> bool:
        """The matmul sine transform runs in bf16x3: ``dst_precision='high'``
        in float32. In float64 'high' is the float64 matmul, as the JAX
        package computes it on the CPU."""
        return self.dst_precision == "high" and self.dtype == torch.float32

    def _dst_bf16x3_lastaxis(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ V`` over the last axis in bf16x3, the leading axes folded
        into the kernel's rows."""
        out = bf16x3_matmul(x.reshape(-1, self.n1d).contiguous(), self.dst_matrix_split)
        return out.reshape(x.shape)

    @property
    def _use_fft_dst(self) -> bool:
        """``dst_method='fft'``, or ``'auto'`` past the dense matrix budget:
        the JAX package's rule (64 MB for the n1d^2 matrix, so the cutover
        is dtype-aware: float32 n1d > 4096, float64 n1d > 2896)."""
        if self.dst_method == "fft":
            return True
        if self.dst_method == "matmul":
            return False
        return self.n1d * self.n1d * np_dtype(self.dtype).itemsize > _DST_MATMUL_BUDGET_BYTES

    def _dst_fft_lastaxis(self, x: torch.Tensor) -> torch.Tensor:
        """DST-I along the last axis via the odd-extension FFT identity:
        fft([0, x, 0, -reverse(x)])_k = -2i DST(x)_k, length 2 N_x. Real
        inputs take the rfft half spectrum (the bins 1..n1d all sit in it)."""
        z = x.new_zeros(x.shape[:-1] + (1,))
        ext = torch.cat([z, x, z, -torch.flip(x, dims=(-1,))], dim=-1)
        if not x.is_complex():
            F = torch.fft.rfft(ext, dim=-1)
            return (0.5j * F[..., 1 : self.n1d + 1]).real.to(x.dtype)
        F = torch.fft.fft(ext, dim=-1)
        return 0.5j * F[..., 1 : self.n1d + 1]

    @functools.cached_property
    def _dst4_plan(self):
        from optimal_control_paradiag_torch.ops.transforms import DstFourStepPlan

        return DstFourStepPlan(self.N_x, self.dtype, device=self.device)

    def _dst_mm4_lastaxis(self, x: torch.Tensor) -> torch.Tensor:
        from optimal_control_paradiag_torch.ops.transforms import dst1_mm4

        if x.is_complex():
            return torch.complex(dst1_mm4(x.real, self._dst4_plan), dst1_mm4(x.imag, self._dst4_plan))
        return dst1_mm4(x, self._dst4_plan)

    def _dst_2d(self, x: torch.Tensor, lastaxis) -> torch.Tensor:
        """A last-axis DST applied over both grid axes of a flat 2D state
        (the second pass on the last two axes transposed)."""
        g = lastaxis(x.reshape(x.shape[:-1] + self.grid_shape))
        g = lastaxis(torch.swapaxes(g, -1, -2))
        return torch.swapaxes(g, -1, -2).reshape(x.shape)

    def dst(self, x: torch.Tensor) -> torch.Tensor:
        """Forward sine transform over the (flat) space axis, by
        ``dst_method``: 'matmul' (and 'auto' up to the 64 MB budget), the
        dense DST-I matrix in full precision (complex inputs: real and
        imaginary parts apart), and in bf16x3 where ``dst_precision='high'``
        in float32 (2D: the y axis transposed to the last place, the same
        product, and back, since V is symmetric); 'fft', the odd-extension
        identity on ``torch.fft``; 'mxu4', the same identity with the
        length-2N_x FFT factored into two radix-~sqrt(2 N_x) real matmul
        stages (``ops.transforms.dst1_mm4``), O(N_x^1.5) flops per row.
        'fft' and 'mxu4' ignore ``dst_precision``, as in the JAX package.
        One call is one ``transforms/dst`` span."""
        with span("transforms/dst"):
            return self._dst(x)

    def _dst(self, x: torch.Tensor) -> torch.Tensor:
        if self.dst_method == "mxu4":
            return self._dst_mm4_lastaxis(x) if self.dim == 1 else self._dst_2d(x, self._dst_mm4_lastaxis)
        if self._use_fft_dst:
            return self._dst_fft_lastaxis(x) if self.dim == 1 else self._dst_2d(x, self._dst_fft_lastaxis)
        if x.is_complex():
            return torch.complex(self._dst(x.real), self._dst(x.imag))
        if self._bf16x3:
            return self._dst_bf16x3_lastaxis(x) if self.dim == 1 else self._dst_2d(x, self._dst_bf16x3_lastaxis)
        V = self.dst_matrix
        if self.dim == 1:
            return torch.matmul(x, V)
        g = x.reshape(x.shape[:-1] + self.grid_shape)
        g = torch.matmul(g, V)  # over x:  [..., y, j]
        g = torch.matmul(V.T, g)  # over y:  [..., j, x]
        return g.reshape(x.shape)

    def idst(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse sine transform: ``(2/N_x)^dim`` times the forward map, in
        one ``transforms/dst`` span."""
        with span("transforms/dst"):
            return self._dst(x) * ((2.0 / self.N_x) ** self.dim)

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

    @functools.cached_property
    def spectrum_tensor(self) -> np.ndarray:
        """Sine-basis spectrum of the tensor-product part of the mass matrix,
        a flat host array of length ``n``: ``spectrum[0]`` where the sine
        transform diagonalizes M. For the 2D consistent (Friedrichs-Keller)
        mass, ``M = M_t + (h^2/24) S_x (x) S_y`` with
        ``M_t = (h^2/12)(6 I + C_x + C_y + C_x C_y / 2)``, ``C = T+ + T-``
        (sine eigenvalue ``2 cos(pi j / N_x)``) and ``S = T+ - T-``, whose
        tensor product has a zero diagonal in the sine basis: ``M_t`` is the
        optimal sine-diagonal surrogate of M, the spectral preconditioner of
        the COCG inner solves."""
        muM, _ = self.spectrum
        if muM is not None:
            return muM
        c = np.cos(np.pi * np.arange(1, self.N_x) / self.N_x)
        h = self.h
        mt = (h * h / 12.0) * (6.0 + 2.0 * c[:, None] + 2.0 * c[None, :] + 2.0 * np.outer(c, c))
        return host_const(mt.ravel(), self.dtype)

    # --------------------------------------------------------------- dense

    def mass_dense(self) -> torch.Tensor:
        """Dense interior mass matrix (test oracle / small direct solves)."""
        return self._densify(self.apply_mass)

    def stiffness_dense(self) -> torch.Tensor:
        """Dense interior stiffness matrix (test oracle / small direct solves)."""
        return self._densify(self.apply_stiffness)

    def _densify(self, op) -> torch.Tensor:
        eye = torch.eye(self.n, dtype=self.dtype, device=self.device)
        return op(eye).T


def make_space(
    dim: int,
    N_x: int,
    mass: str = "consistent",
    dtype=torch.float64,
    device="cuda",
    dst_method: str = "auto",
    dst_precision: str = "highest",
) -> P1Space:
    """A ``P1Space`` on ``device``: the card by default; without a CUDA card
    this raises unless ``device='cpu'`` is passed."""
    return P1Space(
        dim=dim,
        N_x=N_x,
        mass=mass,
        dtype=dtype,
        device=resolve_device(device),
        dst_method=dst_method,
        dst_precision=dst_precision,
    )
