"""Sharding layer: the process grid, stage layouts and the sharded solves.

The counterpart of ``optimal_control_paradiag_tpu/parallel/``, on
``torch.distributed``: one process per device over a ('time', 'space') grid,
the ParaDiag mode axis as the parallel-in-time dimension and the space axis
row-partitioning each mode's spatial problem. ``sharding.py`` holds the
grid, the stage layouts and their collectives; ``solve.py`` the sharded
entry points of both model families; ``shardmap_ops.py`` the
explicit-collective matvec and preconditioner; ``multihost.py`` the process
group set-up and the CPU launcher."""

from optimal_control_paradiag_torch.parallel.sharding import (
    ParallelLayout,
    make_layout,
    make_mesh,
)

__all__ = ["ParallelLayout", "make_layout", "make_mesh"]
