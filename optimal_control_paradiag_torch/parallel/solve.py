"""Sharded end-to-end solves: the multi-device entry points.

The counterpart of ``optimal_control_paradiag_tpu/parallel/solve.py``. The
JAX package compiles one program whose collectives XLA places. Here every
rank of the layout's grid runs the same Python: the right-hand side in the
canonical layout, the Krylov loop or direct solve on this rank's blocks, and
every collective issued by the layout itself (``parallel/sharding.py``):
stage moves around the transforms, halo exchanges in the matvecs, and one
``all_reduce`` per inner product or set of phase sums. Every route of the
JAX module is here, for both model families, with the same defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from optimal_control_paradiag_torch.config import SolverConfig
from optimal_control_paradiag_torch.krylov.gmres import gmres
from optimal_control_paradiag_torch.krylov.minres import minres
from optimal_control_paradiag_torch.paradiag.pc import build_preconditioner
from optimal_control_paradiag_torch.paradiag.spectral import (
    _build_woodbury_half,
    _spectral_plan,
    build_woodbury_solver,
)
from optimal_control_paradiag_torch.paradiag.symmetric import build_symmetric_system
from optimal_control_paradiag_torch.parallel.sharding import ParallelLayout


@dataclasses.dataclass(frozen=True)
class CanonicalBlocks:
    """The canonical layout of a ``(2, N_t, n)`` state on a grid that
    divides it (the counterpart of the JAX package's canonical
    ``NamedSharding``): :meth:`shard` cuts this rank's block out of a global
    state, :meth:`gather` puts the blocks together."""

    layout: ParallelLayout
    N_t: int
    n: int

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        return self.layout.scatter(x)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return gather(self.layout, x, self.N_t, self.n)


def gather(layout: ParallelLayout, x: torch.Tensor, N_t: int, n: int) -> torch.Tensor:
    """The global ``(2, N_t, n)`` state, on every rank, from the ranks'
    canonical blocks (one ``all_gather``)."""
    return layout.gather(x, N_t, n)


def _contract(layout: ParallelLayout, N_t: int, n: int, device):
    """``(sharding, to_block)``: the canonical blocks when the grid divides
    ``(N_t, n)``, else None (the JAX contract for uneven shapes), and the
    map that ``run`` applies to its argument: a global state on every rank
    is cut to this rank's block, a block passes as it is."""
    if torch.device(device).type != layout.device.type:
        raise ValueError(f"the problem lives on {device}, the layout's ranks on {layout.device}")
    even = N_t % layout.n_time == 0 and n % layout.n_space == 0
    sharding = CanonicalBlocks(layout, N_t, n) if even else None
    l0, l1, n0, n1 = layout.box("canonical", N_t, n)

    def to_block(b: torch.Tensor) -> torch.Tensor:
        if b.ndim != 3:
            raise ValueError(
                f"sharded solves take one state (2, N_t, n) per call, got shape {tuple(b.shape)}; "
                "the JAX package's sharded solvers take no batch axis either"
            )
        if tuple(b.shape) == (2, N_t, n):
            return layout.scatter(b)
        if tuple(b.shape) != (2, l1 - l0, n1 - n0):
            raise ValueError(
                f"run takes the global state (2, {N_t}, {n}) or this rank's canonical block "
                f"{(2, l1 - l0, n1 - n0)}, got {tuple(b.shape)}"
            )
        return b

    return sharding, to_block


def make_sharded_solver(problem, solver: Optional[SolverConfig], layout: ParallelLayout):
    """``(run, sharding)`` of a wave-family solve sharded over ``layout``'s
    grid. ``run(b) -> (x, result)`` takes this rank's canonical block of the
    right-hand side (``sharding.shard(b)``) or the global ``b`` and returns
    this rank's canonical block of x, with the Krylov record (None on the
    direct routes). ``sharding`` is the :class:`CanonicalBlocks` of an even
    shape, None when ``N_t % n_time`` or ``n % n_space`` is not 0 (the JAX
    contract; ``run`` then takes the global b). :func:`gather` assembles x.

    Routes, as in the JAX package: ``method='woodbury'`` is the half-spectrum
    direct solve on diagonalizable spaces (an ``EigBasisSpace`` included),
    and on the 2D consistent mass GMRES on the physical operator
    preconditioned by the tensor-mass surrogate's solve (float32 on
    ``matvec_accurate``; rtol tightened to 1e-10 / 1e-5 unless below 1e-6);
    ``'minres'`` the symmetrized system; ``'gmres'`` GMRES with the ParaDiag
    preconditioner (``solver.pc_variant``)."""
    solver = solver or SolverConfig()
    op = problem.operator
    N_t, n = op.N_t, op.space.n
    sharding, to_block = _contract(layout, N_t, n, op.space.device)

    if solver.method == "woodbury":
        if op.space.diagonalizable:
            wb = build_woodbury_solver(op, refine=solver.refine, layout=layout)
            return (lambda b: (wb(to_block(b)), None)), sharding

        pl = _spectral_plan(op, mass_surrogate=True)
        W_t = _build_woodbury_half(op, pl, refine=0, time_transform="dft", layout=layout)
        f64 = op.space.dtype == torch.float64
        rtol_t = solver.rtol if solver.rtol < 1e-6 else (1e-10 if f64 else 1e-5)
        # float32: the cancellation-aware matvec, as the unsharded route
        mv_t = op.matvec if f64 else op.matvec_accurate

        def run_tensor(b):
            res = gmres(lambda x: mv_t(x, layout=layout), to_block(b), M=W_t, restart=solver.restart,
                        rtol=rtol_t, atol=solver.atol, maxiter=solver.maxiter, layout=layout)
            return res.x, res

        return run_tensor, sharding

    if solver.method == "minres":
        matvec_sym, pc_spd, swap = build_symmetric_system(op, layout=layout)
        M_spd = pc_spd if solver.pc == "paradiag" else None

        def run_mr(b):
            res = minres(matvec_sym, swap(to_block(b)), M=M_spd, rtol=solver.rtol,
                         maxiter=solver.maxiter, layout=layout)
            return res.x, res

        return run_mr, sharding

    if solver.method != "gmres":
        raise NotImplementedError(f"sharded wave solve: method {solver.method!r}")

    pc_apply = build_preconditioner(op, variant=solver.pc_variant, layout=layout) if solver.pc == "paradiag" else None

    def run(b):
        res = gmres(lambda x: op.matvec(x, layout=layout), to_block(b), M=pc_apply, restart=solver.restart,
                    rtol=solver.rtol, atol=solver.atol, maxiter=solver.maxiter, layout=layout)
        return res.x, res

    return run, sharding


def make_sharded_heat_solver(problem, solver: Optional[SolverConfig], layout: ParallelLayout):
    """Sharded solve of the heat-control family, with the contract of
    :func:`make_sharded_solver`. ``method='woodbury'`` on a diagonalizable
    space is the rank-2 SMW direct solve; ``'minres'`` the symmetrized
    system; otherwise (``'gmres'``, or ``'woodbury'`` on the 2D consistent
    mass with its tightened rtol) GMRES preconditioned by the sharded SMW
    solve, of the tensor-mass surrogate where the exact one does not
    exist."""
    solver = solver or SolverConfig(method="woodbury")
    N_t, n = problem.config.N_t, problem.space.n
    sharding, to_block = _contract(layout, N_t, n, problem.device)
    diag = problem.space.diagonalizable

    if solver.method == "woodbury" and diag:
        wb = problem.build_woodbury_solver(refine=solver.refine, layout=layout)
        return (lambda b: (wb(to_block(b)), None)), sharding

    if solver.method == "minres":
        matvec_sym, pc_spd, swap = problem.build_symmetric_system(layout=layout)
        M_spd = pc_spd if solver.pc == "paradiag" else None

        def run_mr(b):
            res = minres(matvec_sym, swap(to_block(b)), M=M_spd, rtol=solver.rtol,
                         maxiter=solver.maxiter, layout=layout)
            return res.x, res

        return run_mr, sharding

    if solver.method not in ("woodbury", "gmres"):
        raise NotImplementedError(f"sharded heat solve: method {solver.method!r}")

    M = problem.build_woodbury_solver(refine=0, mass_surrogate=not diag, layout=layout)
    if solver.method == "woodbury":
        f64 = problem.config.dtype == torch.float64
        rtol = solver.rtol if solver.rtol < 1e-6 else (1e-10 if f64 else 1e-5)
    else:
        rtol = solver.rtol

    def run(b):
        res = gmres(lambda x: problem.matvec(x, layout=layout), to_block(b), M=M, restart=solver.restart,
                    rtol=rtol, atol=solver.atol, maxiter=solver.maxiter, layout=layout)
        return res.x, res

    return run, sharding
