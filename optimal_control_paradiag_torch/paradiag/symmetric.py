"""Symmetrized ParaDiag: MINRES on the block-row-swapped system (PyTorch).

The counterpart of ``optimal_control_paradiag_tpu/paradiag/symmetric.py``.
Swapping the (u-rows, p-rows) block order of the scaled all-at-once system
makes its matrix exactly real symmetric (indefinite). In ParaDiag-
diagonalized coordinates the swapped circulant part is, per (mode k,
wavenumber j), the traceless Hermitian 2x2 ``[[t, conj(a11)], [a11, -t]]``
(t = theta muM_j) with eigenvalues ``+/- sqrt(det)``, so its absolute value,
the SPD preconditioner of MINRES, is the scalar

    P_spd^{-1} = T^{-1} diag(1 / sqrt(det_kj)) T       (T = DST o ifft_time)

applied to both components alike. On the 2D consistent mass the swap and
the matvec stay exact and the preconditioner uses the tensor-part mass
surrogate spectrum. MINRES iterates in physical coordinates, so the
float32 time-stencil cancellation applies: run it in float64.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from optimal_control_paradiag_torch.fem.space import require_full_fp32_matmul
from optimal_control_paradiag_torch.ops.allatonce import AllAtOnceOperator, join_state, split_state
from optimal_control_paradiag_torch.paradiag.spectral import _make_ops, _spectral_plan
from optimal_control_paradiag_torch.parallel.sharding import resolve_layout
from optimal_control_paradiag_torch.utils.constants import to_device


def _swap(x: torch.Tensor) -> torch.Tensor:
    """Flip the (u, p) block rows of ``(..., 2, N_t, n)``: the symmetrizing
    row permutation."""
    u, p = split_state(x)
    return join_state(p, u)


def build_symmetric_system(
    op: AllAtOnceOperator, *, layout=None, time_transform: str = None
) -> Tuple[Callable, Callable, Callable]:
    """``(matvec_sym, pc_spd, swap_rhs)`` for MINRES:

    - ``matvec_sym(x) = swap(A x)``, exactly symmetric;
    - ``pc_spd``, the scalar absolute-value-circulant SPD preconditioner
      ``T^{-1} det^{-1/2} T`` (module docstring);
    - ``swap_rhs(b) = swap(b)``.

    Solve ``matvec_sym(x) = swap_rhs(b)``; x is in the original unknown
    order. States may carry leading batch axes. ``layout`` (a
    ``parallel.sharding.ParallelLayout``): all three act on this rank's
    canonical blocks (the matvec with its halos, the preconditioner through
    the full-spectrum stage moves, the scalar cut to the rank's modes);
    ``time_transform`` then defaults to 'dft', as in the JAX package."""
    require_full_fp32_matmul()
    lay = resolve_layout(layout)
    if time_transform is None:
        time_transform = "dft" if lay.sharded else "fft"
    pl = _spectral_plan(op, mass_surrogate=True)
    _, _, to_s, from_s = _make_ops(op, pl, time_transform=time_transform, layout=layout)
    inv_sqrt_det = to_device(1.0 / np.sqrt(pl.det_h[lay.rows("mode_local", pl.N_t)]), pl.rdtype, pl.device)

    def matvec_sym(x: torch.Tensor) -> torch.Tensor:
        return _swap(op.matvec(x, layout=layout))

    def pc_spd(r: torch.Tensor) -> torch.Tensor:
        return from_s(to_s(r) * inv_sqrt_det)

    return matvec_sym, pc_spd, _swap
