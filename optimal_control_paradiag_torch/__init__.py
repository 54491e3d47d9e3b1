"""PyTorch / CUDA port of the ParaDiag wave-control framework.

The second package beside ``optimal_control_paradiag_tpu`` (the JAX
reference, which it never imports). It runs on an NVIDIA Hopper card the
all-at-once KKT systems of both model families, solved directly by the
Sherman-Morrison-Woodbury identity in ParaDiag-diagonalized coordinates, with
the spectral solve as one hand-written CUDA kernel per family:

- wave control, rank 4 (``paradiag/cuda_woodbury.py``, ``csrc/woodbury.cu``);
- heat control, rank 2, 1D or 2D lumped mass (``paradiag/cuda_heat.py``,
  ``csrc/heat_woodbury.cu``).

Around it, the packed time FFT's split and merge are one hand-written kernel
each way (``ops/time_pack.py``, ``csrc/time_pack.cu``).

    WaveControlProblem(ProblemConfig(N_x=2048, N_t=1024, dtype=torch.float32)).solve(
        SolverConfig(method="woodbury", use_pallas=True))
    HeatControlProblem(ProblemConfig(N_x=2048, N_t=1024, dtype=torch.float32)).solve(
        SolverConfig(method="woodbury", use_pallas=True, polish=1))

``polish`` adds physical-space defect correction
(``paradiag.spectral.build_polished_solver``) to either family.

``method='gmres'`` (the default) runs the reference's own algorithm:
restarted GMRES (``krylov/gmres.py``) preconditioned by the block-circulant
ParaDiag preconditioner (``paradiag/pc.py``: 'fulldiag', or 'eig' with the
inner solvers of ``paradiag/inner.py``; the heat family's
``HeatControlProblem.build_preconditioner``). It launches no hand kernel:

    WaveControlProblem(reference_1d_default()).solve(SolverConfig(rtol=1e-8))

``method='minres'`` runs MINRES (``krylov/minres.py``) on the symmetrized
system (``paradiag/symmetric.py``), ``method='spectral'`` GMRES in
diagonalized coordinates and ``method='direct'`` a dense LU.
``WaveControlProblem.make_batched_solver_fn`` solves a batch ``(B, 2, N_t,
n)`` at once, every layer taking the leading axis; a batched kernel solve is
one launch.

On a triangle mesh (``fem/general.py``) the direct solve runs over the
mesh's generalized eigenbasis (``paradiag/eigbasis.py``; pencil eigensolvers
on the host, on the card by cuSOLVER, or by the blocked spectral
divide-and-conquer of ``paradiag/sdc.py`` over ``ops/blocked.py``). The
reference's prototype derivation, the KKT system as the autodiff gradient of
the discrete Lagrangian, is ``models/wave_lagrangian.py``, and the naive
dense assembly of the all-at-once matrix the test oracle
``ops/dense_oracle.py``.

The sine transform is the dense matmul, the FFT or its four-step matmul
factorization (``ProblemConfig.dst_method``), the time transforms
``torch.fft`` (plain or packed), a DFT matmul or the four-step factorization
(``ops/transforms.py``). The CLI driver is ``python -m
optimal_control_paradiag_torch.run`` (``run.py``; writers in ``io/``, timers,
monitor and checkpoints in ``utils/``, plots in ``viz/``).

The sharded solves (``parallel/``) run either family over a ('time',
'space') grid of processes on ``torch.distributed``, one device each:
``parallel.solve.make_sharded_solver`` and ``make_sharded_heat_solver`` on a
``parallel.make_layout(n_time, n_space)``, and ``--mesh TIME,SPACE`` in the
CLI. ``utils/compilation_cache.py`` names the build directory of the
compiled kernels (``PARADIAG_COMPILE_CACHE``).

Entry points run on the card (``device='cuda'``) unless the caller passes
``device='cpu'`` (the CLI: ``--platform cpu``).
"""

from optimal_control_paradiag_torch.config import (
    ProblemConfig,
    SolverConfig,
    reference_1d_default,
)
from optimal_control_paradiag_torch.models.heat import HeatControlProblem
from optimal_control_paradiag_torch.models.wave import WaveControlProblem
from optimal_control_paradiag_torch.models.wave_lagrangian import LagrangianWaveProblem
from optimal_control_paradiag_torch.paradiag.eigbasis import EigBasisSpace, build_eig_basis

__all__ = [
    "EigBasisSpace",
    "HeatControlProblem",
    "LagrangianWaveProblem",
    "ProblemConfig",
    "SolverConfig",
    "WaveControlProblem",
    "build_eig_basis",
    "reference_1d_default",
]
