"""PyTorch / CUDA port of the ParaDiag wave-control framework.

The second package beside ``optimal_control_paradiag_tpu`` (the JAX
reference, which it never imports). It runs the system's main path on an
NVIDIA Hopper card: the 1D wave-control all-at-once KKT system solved directly
by the rank-4 Sherman-Morrison-Woodbury identity in ParaDiag-diagonalized
coordinates, with the spectral solve as one hand-written CUDA kernel
(``paradiag/cuda_woodbury.py``, ``csrc/woodbury.cu``):

    WaveControlProblem(ProblemConfig(N_x=2048, N_t=1024, dtype=torch.float32)).solve(
        SolverConfig(method="woodbury", use_pallas=True))

Entry points run on the card (``device='cuda'``) unless the caller passes
``device='cpu'``.
"""

from optimal_control_paradiag_torch.config import (
    ProblemConfig,
    SolverConfig,
    reference_1d_default,
)
from optimal_control_paradiag_torch.models.wave import WaveControlProblem

__all__ = [
    "ProblemConfig",
    "SolverConfig",
    "WaveControlProblem",
    "reference_1d_default",
]
