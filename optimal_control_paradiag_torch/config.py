"""Configuration dataclasses of the PyTorch port.

Field names, defaults and validation follow
``optimal_control_paradiag_tpu/config.py`` one for one, so a config
translates between the two packages field by field (``interop.py``). The one
difference is ``ProblemConfig.dtype``: a torch dtype here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class ProblemConfig:
    """Discretization of the wave-equation optimal-control problem.

    Attributes:
      N_x: spatial elements per dimension (unit interval / unit square).
      N_t: time slices of the all-at-once system.
      T: final time.
      gamma: control regularization coefficient.
      dim: spatial dimension, 1 or 2.
      scaled: sqrt(gamma) rescaling of the state; required by the
        diagonalized solvers.
      mass: 'consistent' P1 mass or 'lumped' (row-sum) mass.
      dtype: real torch dtype of the system (float32 or float64); complex
        work uses the matching complex dtype.
      dst_precision: 'highest' (full float32 matmul DST) or 'high'. In the
        JAX package 'high' is the bf16x3 matmul (valid with polish); torch's
        'high' is TF32, a different algorithm, so the port raises for it.
      dst_method: sine-transform algorithm, 'auto' | 'matmul' | 'fft' |
        'mxu4' ('auto': the matmul up to the 64 MB matrix budget, then the
        FFT, the JAX package's rule).
    """

    N_x: int
    N_t: int
    T: float = 2.0
    gamma: float = 1.0
    dim: int = 1
    scaled: bool = True
    mass: str = "consistent"
    dtype: Any = torch.float64
    dst_precision: str = "highest"
    dst_method: str = "auto"

    def __post_init__(self):
        if self.dim not in (1, 2):
            raise ValueError(f"dim must be 1 or 2, got {self.dim}")
        if self.mass not in ("consistent", "lumped"):
            raise ValueError(f"mass must be 'consistent' or 'lumped', got {self.mass}")
        if self.N_x < 2 or self.N_t < 3:
            raise ValueError("need N_x >= 2 and N_t >= 3")
        if self.dst_precision not in ("highest", "high"):
            raise ValueError(f"dst_precision must be 'highest' or 'high', got {self.dst_precision}")
        if self.dst_method not in ("auto", "matmul", "fft", "mxu4"):
            raise ValueError(
                f"dst_method must be auto/matmul/fft/mxu4, got {self.dst_method}"
            )
        if self.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be torch.float32 or torch.float64, got {self.dtype}")

    @property
    def dt(self) -> float:
        """Time step ``T / N_t``."""
        return self.T / self.N_t


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Solver options; the same fields as the JAX package's ``SolverConfig``.

    Methods:

    - ``method='gmres'`` (the default, the reference's own algorithm):
      restarted GMRES (``restart``, ``rtol``, ``atol``, ``maxiter``,
      ``pc_side``) preconditioned by the ParaDiag preconditioner
      (``pc='paradiag'``; ``pc_variant`` 'fulldiag', 'eig', 'block',
      'blockdense', 'blockline' or 'blockband'; ``inner`` 'auto', 'dst',
      'tridiag_thomas', 'tridiag_pcr', 'cocg' or 'cocg_jacobi', with
      ``inner_tol`` and ``inner_maxiter`` for COCG); ``inner='auto'`` on a
      space the sine transform does not diagonalize picks 'blockline' or
      'block' (2D consistent mass), 'blockdense', 'blockband' or
      Jacobi-COCG (triangle meshes) by their memory;
    - ``method='woodbury'``: the Sherman-Morrison-Woodbury direct solve in
      ParaDiag-diagonalized coordinates, rank 4 for the wave family and
      rank 2 for the heat family, with ``refine`` spectral and ``polish``
      physical-space defect-correction steps; ``use_pallas=True`` routes it
      through the family's fused CUDA kernel (``paradiag/cuda_woodbury.py``,
      ``paradiag/cuda_heat.py``). On the 2D consistent mass it is GMRES
      preconditioned by the exact solve of the tensor-mass surrogate
      (``pc_variant='blockline'``: SMW over block-Thomas); on a triangle
      mesh ``pc_variant='blockband'`` selects SMW over the banded
      factorization;
    - ``method='minres'``: MINRES (``rtol``, ``maxiter``) on the
      block-row-swapped symmetric system, with the SPD absolute-value
      preconditioner unless ``pc=None`` (wave; the heat family always uses
      it, as the JAX package does);
    - ``method='spectral'`` (wave): GMRES in ParaDiag-diagonalized
      coordinates, preconditioned by the circulant block inverse;
    - ``method='direct'``: dense LU of the assembled all-at-once matrix
      (small problems).

    A triangle mesh's ``method='woodbury'`` is the direct solve over its
    generalized eigenbasis (``paradiag/eigbasis.py``); the sharded solves
    of both families take the same configuration (``parallel/solve.py``).
    What the port lacks (``dst_precision='high'``) raises
    ``NotImplementedError`` naming its ROADMAP item.
    """

    method: str = "gmres"
    pc: Optional[str] = "paradiag"
    pc_variant: str = "fulldiag"
    inner: str = "auto"
    pc_side: str = "left"
    use_pallas: bool = False
    restart: int = 300
    rtol: float = 1e-5
    atol: float = 1e-50
    maxiter: int = 1000
    inner_tol: float = 1e-10
    inner_maxiter: int = 50
    refine: int = 1
    polish: int = 0

    def __post_init__(self):
        if self.method not in ("gmres", "minres", "direct", "spectral", "woodbury"):
            raise ValueError(f"unknown method {self.method!r}")
        if self.pc not in (None, "paradiag"):
            raise ValueError(f"unknown pc {self.pc!r}")
        if self.pc_variant not in (
            "fulldiag",
            "eig",
            "block",
            "blockdense",
            "blockline",
            "blockband",
        ):
            raise ValueError(f"unknown pc_variant {self.pc_variant!r}")
        if self.inner not in ("auto", "dst", "tridiag_thomas", "tridiag_pcr", "cocg", "cocg_jacobi"):
            raise ValueError(f"unknown inner solver {self.inner!r}")
        if self.pc_side not in ("left", "right"):
            raise ValueError(f"unknown pc_side {self.pc_side!r}")
        if not isinstance(self.refine, int) or self.refine < 0:
            raise ValueError(f"refine must be a non-negative int, got {self.refine!r}")
        if not isinstance(self.polish, int) or self.polish < 0:
            raise ValueError(f"polish must be a non-negative int, got {self.polish!r}")
        if self.polish and self.method != "woodbury":
            raise ValueError(
                f"polish is a 'woodbury'-method option; method={self.method!r} ignores it"
            )


def reference_1d_default() -> ProblemConfig:
    """The reference's default run: ``N_x=80, N_t=81, T=2, gamma=1, 1D``."""
    return ProblemConfig(N_x=80, N_t=81, T=2.0, gamma=1.0, dim=1)
