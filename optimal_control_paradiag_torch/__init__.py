"""PyTorch / CUDA port of the ParaDiag wave-control framework.

The second package beside ``optimal_control_paradiag_tpu`` (the JAX
reference, which it never imports). It runs on an NVIDIA Hopper card the
all-at-once KKT systems of both model families, solved directly by the
Sherman-Morrison-Woodbury identity in ParaDiag-diagonalized coordinates, with
the spectral solve as one hand-written CUDA kernel per family:

- wave control, rank 4 (``paradiag/cuda_woodbury.py``, ``csrc/woodbury.cu``);
- heat control, rank 2, 1D or 2D lumped mass (``paradiag/cuda_heat.py``,
  ``csrc/heat_woodbury.cu``).

    WaveControlProblem(ProblemConfig(N_x=2048, N_t=1024, dtype=torch.float32)).solve(
        SolverConfig(method="woodbury", use_pallas=True))
    HeatControlProblem(ProblemConfig(N_x=2048, N_t=1024, dtype=torch.float32)).solve(
        SolverConfig(method="woodbury", use_pallas=True, polish=1))

``polish`` adds physical-space defect correction
(``paradiag.spectral.build_polished_solver``) to either family.

Entry points run on the card (``device='cuda'``) unless the caller passes
``device='cpu'``.
"""

from optimal_control_paradiag_torch.config import (
    ProblemConfig,
    SolverConfig,
    reference_1d_default,
)
from optimal_control_paradiag_torch.models.heat import HeatControlProblem
from optimal_control_paradiag_torch.models.wave import WaveControlProblem

__all__ = [
    "HeatControlProblem",
    "ProblemConfig",
    "SolverConfig",
    "WaveControlProblem",
    "reference_1d_default",
]
