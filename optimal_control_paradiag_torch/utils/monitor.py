"""Solver health monitoring -- the ``ksp_monitor`` / ``ksp_converged_reason``
analogue (reference options at ``Control_Wave_PC.py:352-355``), plus the
divergence/NaN detection the reference lacks.

The counterpart of ``optimal_control_paradiag_tpu/utils/monitor.py``, on
the port's ``GmresResult``, whose convergence record is CPU tensors."""

from __future__ import annotations

import math

import numpy as np

from optimal_control_paradiag_torch.utils.constants import host_array


def _history(result) -> np.ndarray:
    return host_array(result.residual_history)


def converged_reason(result, rtol: float, maxiter: int) -> str:
    """PETSc-style reason string for a GMRES result."""
    hist = _history(result)
    finite = hist[np.isfinite(hist)]
    if len(finite) and not np.all(np.isfinite(finite)):
        return "DIVERGED_NANORINF"
    if bool(result.converged):
        return "CONVERGED_RTOL"
    if int(result.iterations) >= maxiter:
        return "DIVERGED_ITS"
    if len(finite) >= 2 and finite[-1] > 1e3 * finite[0]:
        return "DIVERGED_DTOL"
    return "DIVERGED_BREAKDOWN"


def format_monitor(result, every: int = 1) -> str:
    """Per-iteration residual lines, PETSc ``ksp_monitor`` style:
    ``  12 KSP Residual norm 1.234567890123e-05``."""
    lines = []
    for i, v in enumerate(_history(result)):
        if not math.isfinite(v):
            break
        if i % every == 0:
            lines.append(f"{i:5d} KSP Residual norm {v:.12e}")
    return "\n".join(lines)


def health_check(result, rtol: float, maxiter: int) -> dict:
    """Structured record for logging/telemetry."""
    hist = _history(result)
    finite = hist[np.isfinite(hist)]
    final = float(result.residual_norm)
    return {
        "reason": converged_reason(result, rtol, maxiter),
        "iterations": int(result.iterations),
        "initial_residual": float(finite[0]) if len(finite) else float("nan"),
        "final_residual": final,
        "reduction": final / float(finite[0]) if len(finite) and finite[0] > 0 else float("nan"),
        "stagnated": bool(
            len(finite) > 10 and finite[-1] > 0.5 * finite[max(0, len(finite) - 10)]
        ),
    }
