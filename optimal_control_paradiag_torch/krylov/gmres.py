"""Restarted GMRES, left or right preconditioned, real or complex (PyTorch).

The counterpart of ``optimal_control_paradiag_tpu/krylov/gmres.py``, with its
semantics: PETSc-style LEFT preconditioning by default (convergence on the
preconditioned residual norm, relative to the preconditioned initial
residual), ``side='right'`` converging on the true residual, classical
Gram-Schmidt with one re-orthogonalisation (CGS2), restart cycles, and a
residual history of length ``maxiter + 1``.

:func:`gmres_batched` solves B systems in lock-step, the counterpart of the
JAX package's ``jax.vmap`` of its ``gmres``; :func:`gmres`, one system, is
its one-lane case. The JAX package runs the whole solve as two nested
``lax.while_loop``s on the device. Here each Arnoldi step is split in three:

1. on the device (:func:`arnoldi_step`), for every lane at once: the
   operator, two projections onto the active basis rows ``V[:, :k+1]`` and
   two expansions in the working dtype, the new basis rows: on a real CUDA
   basis three split-K passes and a scale of ``csrc/cgs2.cu``
   (``ops/cgs2.py``), else batched matrix products (float32 in full FP32);
2. one copy of the step's B Hessenberg columns (k + 2 numbers each) to the
   host: the step's only host synchronisation;
3. on the host (:func:`givens_update`), per lane, in numpy in the working
   dtype and in the JAX code's order of operations: the Givens rotations,
   the residual estimate and the convergence test.

At the end of a cycle each lane's k x k triangular system is solved on the
host and the updates ``y @ V[:k]`` run on the device. Each cycle adds two
more host synchronisations: the norms of its starting residuals, and the
copy of the ``y`` to the device.

Spans (``utils/timing.py``): each Arnoldi step, with its host part, is a
``krylov/step``; the starting residual and each cycle's solution update
with the next residual are a ``krylov/restart``; each host synchronisation
is a ``host/sync`` (a cycle of k steps: k + 2).
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from optimal_control_paradiag_torch.fem.space import require_full_fp32_matmul
from optimal_control_paradiag_torch.ops import cgs2 as cuda_cgs2
from optimal_control_paradiag_torch.parallel.sharding import resolve_layout
from optimal_control_paradiag_torch.utils.constants import np_dtype
from optimal_control_paradiag_torch.utils.timing import counted_span, span

# Krylov-basis memory budget (bytes) for the restart clamp, the JAX
# package's rule and knob: the basis V is (restart+1, *state), and at the
# headline state (2, 1024, 2047) a restart of 300 would take 5.0 GB in
# float32, 10.1 GB in float64. Override with PARADIAG_GMRES_BASIS_BUDGET.
_BASIS_BUDGET_BYTES = int(float(os.environ.get("PARADIAG_GMRES_BASIS_BUDGET", 4e9)))


def clamp_restart(restart: int, shape, dtype, maxiter: int, rows_max: Optional[int] = None) -> int:
    """Largest restart (<= the requested one, >= 4) whose Krylov basis
    ``(restart+1, *shape)`` fits the budget and, where ``rows_max`` is
    given, at most ``rows_max``: the active rows CGS2's CUDA kernels stage
    (``ops.cgs2.max_rows``; a restart of R runs steps of up to R rows).
    Warns when it clamps."""
    restart = min(restart, maxiter)
    if rows_max is not None and restart > rows_max:
        warnings.warn(
            f"GMRES restart {restart} is more than the {rows_max} basis rows CGS2's CUDA kernels "
            f"stage in {np_dtype(dtype).name}; clamping to {rows_max}",
            stacklevel=3,
        )
        restart = rows_max
    state_bytes = int(np.prod(shape)) * np_dtype(dtype).itemsize
    fit = max(4, _BASIS_BUDGET_BYTES // max(state_bytes, 1) - 1)
    if restart > fit:
        warnings.warn(
            f"GMRES restart {restart} needs a {(restart + 1) * state_bytes / 1e9:.1f} GB "
            f"Krylov basis for state shape {tuple(shape)}; clamping to {fit} "
            f"(budget {_BASIS_BUDGET_BYTES / 1e9:.1f} GB, override with "
            "PARADIAG_GMRES_BASIS_BUDGET)",
            stacklevel=3,
        )
        return int(fit)
    return restart


class GmresResult(NamedTuple):
    """Solution and convergence record. ``x`` lies on the right-hand side's
    device; the record, computed on the host, stays there (CPU tensors)."""

    x: torch.Tensor
    iterations: torch.Tensor  # total Arnoldi steps taken
    converged: torch.Tensor  # bool
    residual_norm: torch.Tensor  # final (preconditioned, for side='left') residual norm
    residual_history: torch.Tensor  # (maxiter+1,), NaN beyond `iterations`


def _givens(a, b):
    """Complex-safe Givens rotation of two numpy scalars: ``(c real, s, r)``
    with ``c*a + s*b = r`` and ``-conj(s)*a + c*b = 0``."""
    abs_a = np.abs(a)
    abs_b = np.abs(b)
    rho = np.sqrt(abs_a * abs_a + abs_b * abs_b)
    if not rho > 0:
        return rho.dtype.type(1), a.dtype.type(0), a.dtype.type(0) * rho
    # a == 0 -> swap rotation (c = 0, s = conj(b)/|b|).
    phase_a = a / abs_a if abs_a > 0 else a.dtype.type(1)
    c = abs_a / rho
    s = phase_a * np.conj(b) / rho
    return c.real, s, phase_a * rho


def _norms(w: torch.Tensor, lay) -> torch.Tensor:
    """Per-lane 2-norms of flat ``(B, m)`` vectors; under a layout, of the
    global vectors whose blocks the ranks hold (one ``all_reduce``).
    Unsharded, ``linalg.norm`` keeps the single-process loop bitwise."""
    if not lay.sharded:
        return torch.linalg.norm(w, dim=1)
    sq = torch.sum(torch.square(w.real) + torch.square(w.imag), dim=1) if w.is_complex() else torch.sum(w * w, dim=1)
    return torch.sqrt(lay.all_reduce(sq))


def cgs2_reference(V: torch.Tensor, w: torch.Tensor, k: int, layout=None) -> torch.Tensor:
    """CGS2 of ``w`` (``(B, m)``) against ``V[:, :k+1]`` in plain PyTorch
    (batched products), ``V[:, k+1] = w / |w|`` (``w`` itself where
    ``|w| = 0``); returns the Hessenberg columns ``(B, k+2)``. The plain
    twin of ``csrc/cgs2.cu``. Under a ``layout`` V and w hold this rank's
    blocks, and each projection and the norm is completed by an
    ``all_reduce`` (three per step)."""
    lay = resolve_layout(layout)
    Vk = V[:, : k + 1]
    Vh = Vk.conj() if V.is_complex() else Vk
    h1 = lay.all_reduce(torch.bmm(Vh, w[:, :, None])[:, :, 0])
    w = w - torch.bmm(h1[:, None, :], Vk)[:, 0]
    h2 = lay.all_reduce(torch.bmm(Vh, w[:, :, None])[:, :, 0])
    w = w - torch.bmm(h2[:, None, :], Vk)[:, 0]
    hk1 = _norms(w, lay)
    V[:, k + 1] = w / torch.where(hk1 > 0, hk1, torch.ones_like(hk1))[:, None]
    return torch.cat([h1 + h2, hk1.to(V.dtype)[:, None]], dim=1)


def takes_cgs2_kernels(V: torch.Tensor, layout=None) -> bool:
    """Whether Arnoldi steps on a basis of ``V``'s dtype and device run
    ``csrc/cgs2.cu``: a real basis on a CUDA device with no sharded layout.
    The CPU, complex bases and sharded layouts run :func:`cgs2_reference`."""
    return V.device.type == "cuda" and not V.is_complex() and not resolve_layout(layout).sharded


def arnoldi_step(op: Callable, V: torch.Tensor, k: int, shape, layout=None) -> torch.Tensor:
    """The device part of Arnoldi step ``k`` for B lanes: ``w = op(V[:, k])``,
    made orthogonal to ``V[:, :k+1]`` by CGS2, and ``V[:, k+1] = w / |w|``
    (``w`` itself where ``|w| = 0``). ``V`` is the flat basis ``(B,
    restart+1, m)``, ``op`` maps states ``(B, *shape)``. Returns the B
    Hessenberg columns ``[h_0, ..., h_k, |w|]``, ``(B, k+2)``, on the
    device. Where :func:`takes_cgs2_kernels` the step runs the CUDA kernels
    (``ops.cgs2.cgs2``; a step they do not take raises), else the batched
    products (:func:`cgs2_reference`); under a ``layout``
    (``parallel.sharding``) V holds this rank's block of each basis vector,
    and each projection and the norm is completed by an ``all_reduce``
    (three per step)."""
    B = V.shape[0]
    w = op(V[:, k].reshape((B,) + tuple(shape))).reshape(B, -1)
    if takes_cgs2_kernels(V, layout):
        return cuda_cgs2.cgs2(V, w, k)
    return cgs2_reference(V, w, k, layout)


def givens_update(hcol: np.ndarray, k: int, R: np.ndarray, cs: np.ndarray, sn: np.ndarray, g: np.ndarray):
    """The host part of Arnoldi step ``k``: apply the stored rotations
    0..k-1 to the new column ``hcol`` (numpy, working dtype), make and store
    the rotation that eliminates its subdiagonal, and update ``R[:, k]`` and
    the rotated right-hand side ``g``. Returns the residual estimate
    ``|g[k+1]|``."""
    for j in range(k):
        a, bb = hcol[j], hcol[j + 1]
        hcol[j] = cs[j] * a + sn[j] * bb
        hcol[j + 1] = -np.conj(sn[j]) * a + cs[j] * bb
    ck, sk, rk = _givens(hcol[k], hcol[k + 1])
    cs[k] = ck
    sn[k] = sk
    R[: k + 1, k] = hcol[: k + 1]
    R[k, k] = rk
    gk = g[k]
    g[k] = ck * gk
    g[k + 1] = -np.conj(sk) * gk
    return np.abs(g[k + 1])


def gmres_batched(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    *,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    x0: Optional[torch.Tensor] = None,
    restart: int = 30,
    rtol: float = 1e-5,
    atol: float = 0.0,
    maxiter: int = 1000,
    side: str = "left",
    layout=None,
) -> GmresResult:
    """Solve ``A x = b`` for B systems ``b (B, *shape)`` at once, with
    preconditioner ``M ~= A^{-1}`` and the semantics of the JAX package's
    ``jax.vmap(gmres)``: each lane has its own
    tolerance, residual history, iteration count and stopping test, and the
    batch runs in lock-step. Restart cycles start together; within one,
    every lane still running is at the same step, and a lane that has
    converged or reached ``maxiter`` keeps its x, history and count while
    the others go on. ``matvec`` and ``M`` map ``(B, *shape)`` states; like
    ``vmap`` they run on every lane, and the steps of stopped lanes are
    discarded. The result's fields all have a leading B axis.

    The restart is clamped on the per-lane shape, as the JAX package's clamp
    sees it under ``vmap``, so the iteration counts match; the Krylov basis
    ``(B, restart+1, *shape)`` therefore takes B times the budget's
    memory. Where the steps run CGS2's CUDA kernels it is also capped at
    the rows they stage (``ops.cgs2.max_rows``: 853 in float64).

    ``layout`` (a ``parallel.sharding.ParallelLayout``): the states are this
    rank's canonical blocks of global states, ``matvec`` and ``M`` map blocks
    to blocks, and every inner product and norm is reduced over the grid.
    Every rank then reads the same Hessenberg columns and runs the same host
    Givens updates and stopping tests, so all ranks take the same branches;
    the restart clamp sees the global state size. ``None`` (the default)
    leaves the single-process loop exactly as it is."""
    if side not in ("left", "right"):
        raise ValueError(f"unknown side {side!r}")
    require_full_fp32_matmul()
    if M is None:
        M = lambda v: v
    B, shape = b.shape[0], tuple(b.shape[1:])
    np_t = np_dtype(b.dtype)
    np_r = np.empty((), np_t).real.dtype
    x = torch.zeros_like(b) if x0 is None else x0
    lay = resolve_layout(layout)
    clamp_shape = shape
    if lay.sharded:
        size = torch.tensor([float(b[0].numel())], dtype=torch.float64, device=b.device)
        with counted_span("host/sync"):
            clamp_shape = (int(lay.all_reduce(size).item()),)
    rows_max = cuda_cgs2.max_rows(b.element_size()) if takes_cgs2_kernels(b, lay) else None
    restart = clamp_restart(restart, clamp_shape, b.dtype, maxiter, rows_max)
    op = (lambda v: M(matvec(v))) if side == "left" else (lambda v: matvec(M(v)))

    def residual(x):
        r = b - matvec(x)
        r = M(r) if side == "left" else r
        beta_t = _norms(r.reshape(B, -1), lay)
        with counted_span("host/sync"):
            return r, beta_t, beta_t.cpu().numpy().astype(np_r)

    V = torch.empty((B, restart + 1, b[0].numel()), dtype=b.dtype, device=b.device)
    it = np.zeros(B, np.int64)
    hist = np.full((B, maxiter + 1), np.nan, np_r)
    with span("krylov/restart"):
        r, beta_t, beta = residual(x)
    tol = np.maximum(np_r.type(rtol) * beta, np_r.type(atol))
    hist[:, 0] = beta
    res = beta.copy()
    running = (res > tol) & (it < maxiter)
    while running.any():
        scale = torch.where(beta_t > 0, beta_t, torch.ones_like(beta_t))
        V[:, 0] = (r / scale.reshape((B,) + (1,) * len(shape))).reshape(B, -1)
        R = np.zeros((B, restart, restart), np_t)
        cs = np.zeros((B, restart), np_r)
        sn = np.zeros((B, restart), np_t)
        g = np.zeros((B, restart + 1), np_t)
        g[:, 0] = beta
        steps = np.zeros(B, np.int64)
        res = np.where(running, beta, res)
        active = running & (res > tol)
        k = 0
        while active.any():
            with counted_span("krylov/step"):
                hcol = arnoldi_step(op, V, k, shape, lay)
                with counted_span("host/sync"):  # the step's one sync
                    hcol = hcol.cpu().numpy()
                for i in np.flatnonzero(active):
                    res[i] = givens_update(hcol[i], k, R[i], cs[i], sn[i], g[i])
                    hist[i, it[i] + k + 1] = res[i]
                    steps[i] = k + 1
                k += 1
                active &= (k < restart) & (res > tol) & (it + k < maxiter)
        with span("krylov/restart"):
            if steps.any():
                Y = np.zeros((B, k), np_t)
                for i in np.flatnonzero(steps):
                    ki = steps[i]
                    Y[i, :ki] = torch.linalg.solve_triangular(
                        torch.from_numpy(R[i, :ki, :ki].copy()), torch.from_numpy(g[i, :ki].copy())[:, None],
                        upper=True,
                    )[:, 0].numpy()
                with counted_span("host/sync"):  # a pageable host-to-device copy
                    Yd = torch.from_numpy(Y).to(b.device)
                dx = torch.zeros_like(b)
                for i in np.flatnonzero(steps):
                    dx[i] = (Yd[i, : steps[i]] @ V[i, : steps[i]]).view(shape)
                x = x + (dx if side == "left" else M(dx))  # dx = 0 on lanes that took no step
            it += steps
            running = (res > tol) & (it < maxiter)
            if running.any():
                r, beta_t, beta = residual(x)

    return GmresResult(
        x=x,
        iterations=torch.from_numpy(it),
        converged=torch.from_numpy(res <= tol),
        residual_norm=torch.from_numpy(res),
        residual_history=torch.from_numpy(hist),
    )


def gmres(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    *,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    x0: Optional[torch.Tensor] = None,
    **kwargs,
) -> GmresResult:
    """Solve ``A x = b`` with preconditioner ``M ~= A^{-1}``: the one-lane
    case of :func:`gmres_batched` (same keywords), fields without the batch
    axis.

    ``matvec`` and ``M`` map states to states of ``b``'s shape and dtype
    (real or complex), on ``b``'s device. ``side``: 'left' (PETSc's default;
    convergence on the preconditioned residual norm, the reference's
    monitored counts) or 'right' (convergence on the true residual norm).
    """
    lane = lambda f: None if f is None else (lambda v: f(v[0])[None])
    res = gmres_batched(lane(matvec), b[None], M=lane(M), x0=None if x0 is None else x0[None], **kwargs)
    return GmresResult(*(field[0] for field in res))
