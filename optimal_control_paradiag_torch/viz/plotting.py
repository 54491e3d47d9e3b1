"""Convergence and solution plots -- the reference's ``plot.py`` equivalent.

The counterpart of ``optimal_control_paradiag_tpu/viz/plotting.py``. The
reference hardcodes its published convergence table in ``plot.py:5-18`` and
plots it against ``43 N^-2`` (``plot.py:19-22``); that table is embedded
here as :data:`REFERENCE_PUBLISHED_ERRORS` for side-by-side comparison.
Matplotlib is optional and imported only when a plot is drawn: without it
the plotting functions raise a clear ``RuntimeError``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from optimal_control_paradiag_torch.utils.constants import host_f64

# Code/plot.py:5-18 -- the reference's only published numbers.
REFERENCE_PUBLISHED_ERRORS: Dict[int, float] = {
    5: 9.042540594444626878e-01,
    10: 2.194904204578775053e-01,
    15: 2.074143348600335224e-01,
    20: 7.434653270072190401e-02,
    25: 8.447904285618772213e-02,
    30: 4.036253568006076264e-02,
    35: 4.701801862372274182e-02,
    40: 2.620697023860175945e-02,
    45: 3.060449968470332210e-02,
    50: 1.875112255341825768e-02,
    55: 2.184258555898753451e-02,
    60: 1.426449505896217398e-02,
    65: 1.655606546941080018e-02,
    70: 1.131967852152349768e-02,
}


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError as exc:
        raise RuntimeError("matplotlib is not available in this environment") from exc


def plot_convergence(
    Ns: Sequence[int],
    errors: Sequence[float],
    aligned_errors: Optional[Sequence[float]] = None,
    out: str = "convergence.png",
    show_reference: bool = True,
):
    """Log-log convergence plot (the reference's ``plot.py:4-27``): our sweep
    errors, optionally the aligned metric, the published reference table, and
    the ``43 N^-2`` guide line."""
    plt = _plt()
    Ns = np.asarray(list(Ns), dtype=float)
    fig, ax = plt.subplots()
    ax.loglog(Ns, errors, "o-", label=r"$e_u$ (reference write() metric)")
    if aligned_errors is not None:
        ax.loglog(Ns, aligned_errors, "s-", label=r"$e_u$ (aligned metric)")
    if show_reference:
        rN = sorted(REFERENCE_PUBLISHED_ERRORS)
        ax.loglog(
            rN,
            [REFERENCE_PUBLISHED_ERRORS[k] for k in rN],
            "x--",
            label="reference published (plot.py)",
        )
    ax.loglog(Ns, 43.0 * Ns**-2.0, ":", label=r"$43\,N^{-2}$")
    ax.set_xlabel(r"Mesh size $O(h)$ and $O(\tau)$")
    ax.set_ylabel("Error norms")
    ax.set_title("Convergence of the 1D wave-control solve")
    ax.legend()
    fig.savefig(out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out


def plot_time_slice(npz_path: str, node_index: int = 25, out: str = "slice.png"):
    """Solution vs analytic at a fixed node over time (the reference's
    ``x_sol``/``x_ana`` plots, ``plot.py:29-44``)."""
    plt = _plt()
    d = np.load(npz_path)
    times = d["times"]
    fig, ax = plt.subplots()
    ax.plot(times, d["u_out"].reshape(len(times), -1)[:, node_index], label="numerical u")
    ax.plot(times, d["u_ana"].reshape(len(times), -1)[:, node_index], "--", label="analytic u")
    ax.set_xlabel("time t")
    ax.set_ylabel("solution u")
    ax.legend()
    fig.savefig(out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out


def plot_residual_history(history, out: str = "residuals.png"):
    """Outer Krylov residual history (the ``ksp_monitor`` picture); a tensor
    (the GMRES record) or an array."""
    plt = _plt()
    h = host_f64(history)
    h = h[np.isfinite(h)]
    fig, ax = plt.subplots()
    ax.semilogy(np.arange(len(h)), h, "o-")
    ax.set_xlabel("outer iteration")
    ax.set_ylabel("preconditioned residual norm")
    fig.savefig(out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out
