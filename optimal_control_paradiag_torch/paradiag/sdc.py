"""Blocked spectral divide-and-conquer symmetric eigensolver (PyTorch).

The counterpart of ``optimal_control_paradiag_tpu/paradiag/sdc.py``: the
pencil eigendecomposition ``K V = M V diag(lam)`` of the generalized-
eigenbasis solve (``paradiag/eigbasis.py``) built from large matmuls and
small factorizations only. The JAX package needs it because its TPU's
monolithic ``eigh`` and large-triangle solves do not compile at n ~ 2e4;
on a CUDA card cuSOLVER's ``eigh`` has no such wall (``eigbasis.py``'s
``'auto'`` picks ``'device'`` there), and this module is the ``'sdc'``
option. Classic spectral divide-and-conquer (Nakatsukasa & Higham, SIAM Rev.
2013):

1. congruence to standard form: blocked Cholesky of M and blocked
   triangular solves (``ops/blocked.py``), ``S = L^{-1} K L^{-T}``;
2. shift: sigma ~ the median of the block's diagonal, moved by
   inertia-count bisection when it splits too unevenly;
3. sign function ``U = sign(S - sigma I)`` by scaled Newton-Schulz
   (``X <- 1.5 X - 0.5 X^3``): matmuls only; the loop reads its defect on
   the host once per iteration (two n^3 GEMMs each, so the read costs
   nothing);
4. spectral projectors ``(I -/+ U)/2`` with ``k = (p - tr U)/2``; a
   randomized range finder and shifted CholeskyQR per projector, then one
   step of subspace iteration (the port's addition, see :func:`_range`);
5. the congruence ``Q^T S Q`` decouples S into two blocks, the split is
   verified by its off-diagonal norm against ``||S||_F`` (recorded in
   ``sdc_eigh.last_stats``); recurse down to ``base_size``, where a host
   float64 LAPACK ``eigh`` finishes the leaf;
6. unwind: ``V = [Q1 W1, Q2 W2]``.

The range finder draws from a ``torch.Generator`` on the block's device
seeded as the JAX package seeds ``jax.random.PRNGKey``: a different stream,
so V differs from JAX's by rotations inside each split subspace while the
eigenvalues, residuals and M-orthonormality agree. Matmuls must be full
float32 (``fem.space.require_full_fp32_matmul``): the split checks depend
on it.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from optimal_control_paradiag_torch.fem.space import require_full_fp32_matmul
from optimal_control_paradiag_torch.ops.blocked import blocked_cholesky, cholqr2, tri_solve_lower
from optimal_control_paradiag_torch.utils.constants import to_device
from optimal_control_paradiag_torch.utils.timing import StageTimer

# Inner triangle size of the blocked kernels, the JAX package's choice.
_BLOCK = 1024


def _diag_stats(S: torch.Tensor) -> Tuple[float, float, float]:
    """(median of the diagonal, max absolute row sum, ||S||_F) on the host;
    the median of an even count averages the two middle values."""
    d = torch.sort(torch.diagonal(S)).values
    p = d.shape[0]
    med = 0.5 * (d[(p - 1) // 2] + d[p // 2])
    stats = torch.stack([med, torch.max(torch.sum(torch.abs(S), dim=1)), torch.linalg.norm(S)])
    return tuple(float(v) for v in stats.cpu())


def _sign_ns(S: torch.Tensor, sigma: float, maxiter: int = 110, polish: int = 3):
    """``U ~ sign(S - sigma I)`` by scaled Newton-Schulz; returns ``(U, tr U,
    ||U^2 - I||_F / sqrt(p), iterations)``, the last three on the host.

    The scale alpha is a provable upper bound on ``||A||_2``, ``min(max row
    sum, ||A||_F)``: Newton-Schulz diverges past sqrt(3), so an
    underestimate is fatal, while an overestimate costs log1.5 of the slack
    in iterations. The loop stops when the defect of the iterate it squared
    reaches ``10 eps sqrt(p)``, as the JAX package's ``while_loop`` does,
    then runs ``polish`` more steps."""
    p = S.shape[0]
    A = S - sigma * torch.eye(p, dtype=S.dtype, device=S.device)
    alpha = torch.clamp(torch.minimum(torch.max(torch.sum(torch.abs(A), dim=1)), torch.linalg.norm(A)), min=1e-30)
    X = A.div_(alpha)
    tol = 10.0 * torch.finfo(S.dtype).eps * p**0.5
    err, it = np.inf, 0
    while err > tol and it < maxiter:
        X2 = X @ X
        X = torch.addmm(X, X, X2, beta=1.5, alpha=-0.5)
        X2.diagonal().sub_(1.0)
        err = float(torch.linalg.norm(X2)) / p**0.5  # the iteration's one host read
        it += 1
        del X2
    for _ in range(polish):
        X = torch.addmm(X, X, X @ X, beta=1.5, alpha=-0.5)
    X = 0.5 * (X + X.mT)
    X2 = X @ X
    X2.diagonal().sub_(1.0)
    tr_defect = torch.stack([torch.trace(X), torch.linalg.norm(X2) / p**0.5]).cpu()
    return X, float(tr_defect[0]), float(tr_defect[1]), it


def _range(U: torch.Tensor, k: int, lo: bool, seed: int) -> torch.Tensor:
    """An orthonormal basis of the range of the spectral projector ``(I -/+
    U)/2``: the randomized range finder ``Y = G -/+ U G`` with ``G ~ N(0,
    1)`` p x k, orthonormalized (:func:`ops.blocked.cholqr2`), then one step
    of subspace iteration, ``Q <- cholqr2(Q -/+ U Q)``.

    The step is the port's addition. The rounding of ``U G`` puts a
    component of size ~eps in the complementary subspace, and the first
    orthonormalization divides it by the smallest singular value of the
    projected Gaussian block, which is small for some draws: at p = 257 the
    relative eigen-residual of the finished basis spreads over 8.6e-6 to
    3.2e-4 across seeds 0-9 without the step, and stays at 2.7e-6 with it
    (``PYTHONPATH=. python tests/test_torch_sdc.py``, on a CPU). The step
    removes that component again from a block of singular values ~1."""
    gen = torch.Generator(device=U.device)
    gen.manual_seed(int(seed))
    G = torch.randn((U.shape[0], k), generator=gen, dtype=U.dtype, device=U.device)
    sign = -1.0 if lo else 1.0
    Q = cholqr2(torch.addmm(G, U, G, alpha=sign), block=_BLOCK)
    del G
    return cholqr2(torch.addmm(Q, U, Q, alpha=sign), block=_BLOCK)


def _project(S: torch.Tensor, Q: torch.Tensor):
    """``(Q^T S Q symmetrized, S Q)`` for a p x k orthonormal block."""
    SQ = S @ Q
    Ssub = Q.mT @ SQ
    return 0.5 * (Ssub + Ssub.mT), SQ


def _eigh_base(S: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Direct eigh of a leaf block on the HOST in float64 LAPACK, as the JAX
    package does it: LAPACK's tridiagonal divide-and-conquer handles the
    near-degenerate clusters of a FEM pencil's top spectrum in guaranteed
    O(p^3), and the leaf bases come out at float64 accuracy. Returns
    ``(lam, V)`` in S's dtype on S's device."""
    Sh = S.detach().cpu().numpy().astype(np.float64)
    Sh = 0.5 * (Sh + Sh.T)
    lam, V = np.linalg.eigh(Sh)
    return to_device(lam, S.dtype, S.device), to_device(V, S.dtype, S.device)


def _combine(Q1, Q2, W1, W2) -> torch.Tensor:
    """``V = [Q1 W1, Q2 W2]``: the unwind rotation, two rectangular
    matmuls."""
    return torch.cat([Q1 @ W1, Q2 @ W2], dim=1)


def _bisection_bracket(med: float, rbound: float) -> Tuple[float, float]:
    """The shift bisection's bracket: ``[min(med, 0) - rbound, max(med, 0) +
    rbound]``, which holds the Gershgorin interval ``[-rbound, rbound]`` of
    the whole spectrum and the JAX package's ``[med - rbound, med +
    rbound]``. The JAX window is centred on the diagonal's median, which
    need not bracket the spectral median (ROADMAP Queue C); a first probe
    that splits evenly runs no bisection, so the two agree there."""
    return min(med, 0.0) - rbound, max(med, 0.0) + rbound


def _new_stats() -> dict:
    return {
        "splits": 0, "bisect_probes": 0, "max_off": 0.0, "max_defect": 0.0,
        "ns_iters": [], "phase_s": {"sign": 0.0, "split": 0.0, "leaf": 0.0, "combine": 0.0},
    }


def sdc_eigh(
    S: torch.Tensor,
    *,
    base_size: int = 2048,
    seed: int = 0,
    min_frac: float = 0.08,
    max_bisect: int = 8,
    _depth: int = 0,
    _stats: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition ``(lam ascending, V)`` of a symmetric matrix ``S``
    by host-driven spectral divide-and-conquer (module docstring), on S's
    device and dtype.

    ``base_size``: blocks at or below it go to the host float64 ``eigh``.
    ``min_frac``: the least acceptable split balance; a degenerate shift is
    re-chosen by inertia-count bisection, each probe one sign function.
    ``sdc_eigh.last_stats`` holds the run's ``splits``, ``bisect_probes``,
    ``max_off`` (largest relative off-diagonal of an accepted split),
    ``max_defect`` (largest sign defect), ``ns_iters`` and ``phase_s``
    (seconds of sign, split, leaf and combine; the pencil form adds
    congruence and back_transform). ``SDC_VERBOSE=1`` prints each step."""
    require_full_fp32_matmul()
    p = int(S.shape[0])
    stats = _stats if _stats is not None else _new_stats()
    if _stats is None:
        sdc_eigh.last_stats = stats
    timer = StageTimer(stats["phase_s"])
    verbose = bool(int(os.environ.get("SDC_VERBOSE", "0")))
    if p <= base_size:
        if verbose:
            print(f"[sdc] base eigh p={p}", flush=True)
        with timer.stage("leaf") as out:
            lam, V = _eigh_base(S)
            out["fence"] = V
        return lam, V

    med, rbound, froS = _diag_stats(S)

    def find_sign(sigma0):
        """(U, k, sigma) at a balance-acceptable shift, by inertia-count
        bisection from ``sigma0`` inside :func:`_bisection_bracket`."""
        blo, bhi = _bisection_bracket(med, rbound)
        sigma = sigma0
        U = k = sig = None
        for probe in range(max_bisect + 1):
            with timer.stage("sign"):  # it ends with a host read
                U_c, trU, defect, ns_it = _sign_ns(S, sigma)
            if verbose:
                print(f"[sdc] sign p={p} depth={_depth} probe={probe} sigma={sigma:.4g} "
                      f"defect={defect:.2e} ns_iters={ns_it} trU={trU:.2f}", flush=True)
            if not np.isfinite(trU) or not defect < 1e-2:
                raise RuntimeError(
                    f"sdc_eigh: sign iteration failed at block p={p} (sigma={sigma:.6g}, "
                    f"defect={defect:.3e}, iters={ns_it}) -- an eigenvalue may sit at machine "
                    f"distance from sigma; this guard stops NaNs propagating silently into the basis"
                )
            # Parity-corrected count: tr U = #above - #below has the parity
            # of p; rounding the trace to the nearest integer of that parity
            # removes the +-0.5 ambiguity of half-converged eigenvalues.
            t_int = int(round(trU))
            if (p - t_int) % 2:
                t_int += 1 if trU > t_int else -1
            kk = max(0, min(p, (p - t_int) // 2))
            stats["bisect_probes"] += 1 if probe else 0
            stats["max_defect"] = max(stats["max_defect"], defect)
            stats["ns_iters"].append(ns_it)
            if kk < p * min_frac:  # almost everything above sigma: raise it
                if 0 < kk < p:
                    U, k, sig = U_c, kk, sigma  # best non-trivial so far
                blo = sigma
                sigma = 0.5 * (sigma + bhi)
            elif kk > p * (1 - min_frac):
                if 0 < kk < p:
                    U, k, sig = U_c, kk, sigma
                bhi = sigma
                sigma = 0.5 * (blo + sigma)
            else:
                return U_c, kk, sigma
        if U is None:
            raise RuntimeError(
                f"sdc_eigh: could not find a splitting shift for block of size {p} (spectrum "
                f"may be a single numerical cluster); lower base_size or use a direct eigh"
            )
        return U, k, sig

    # Verified split. Two float32 failure modes show in the off-diagonal
    # norm of the decoupled congruence: (a) the float32 trace miscounts k by
    # one (retried with k +- 1); (b) an eigenvalue so close to sigma that
    # the sign leaves it half-converged, its eigenvector in both subspaces
    # whatever k and seed (retried by jittering sigma).
    sd = int(seed + 7919 * _depth + p)
    tol_rel, best = 3e-3, None
    sigma_sel = None
    for jitter in range(4):
        U, k, sigma_sel = find_sign(med + jitter * 0.0037 * rbound)
        for attempt, dk in enumerate((0, 1, -1)):
            kk = k + dk
            if not 0 < kk < p:
                continue
            with timer.stage("split"):  # it ends with a host read
                Q1 = _range(U, kk, True, sd + 2 * attempt)
                Q2 = _range(U, p - kk, False, sd + 2 * attempt + 1)
                S1, SQ1 = _project(S, Q1)
                S2, _ = _project(S, Q2)
                off_rel = float(torch.linalg.norm(Q2.mT @ SQ1)) / max(froS, 1e-30)
            del SQ1
            if verbose:
                print(f"[sdc] split p={p} depth={_depth} k={kk} (dk={dk}, jitter={jitter}) "
                      f"off_rel={off_rel:.2e}", flush=True)
            if best is None or off_rel < best[0]:
                best = (off_rel, kk, Q1, Q2, S1, S2)
            if off_rel <= tol_rel:
                break
            stats["split_retries"] = stats.get("split_retries", 0) + 1
            if attempt == 0 and off_rel > 30 * tol_rel:
                # k-independent failure (mode b): straight to the jitter
                break
        del U
        if best[0] <= tol_rel:
            break
    off_rel, k, Q1, Q2, S1, S2 = best
    del best
    if off_rel > 30 * tol_rel:
        raise RuntimeError(
            f"sdc_eigh: no acceptable split at block p={p} (best relative off-diagonal "
            f"{off_rel:.3e} over {jitter + 1} shifts around sigma={sigma_sel:.6g}); the "
            f"spectrum may be pathologically clustered"
        )
    stats["splits"] += 1
    stats["max_off"] = max(stats["max_off"], off_rel)
    del S  # the caller's reference keeps the parent block alive; ours goes
    kw = dict(base_size=base_size, seed=seed, min_frac=min_frac, max_bisect=max_bisect,
              _depth=_depth + 1, _stats=stats)
    lam1, W1 = sdc_eigh(S1, **kw)
    del S1
    lam2, W2 = sdc_eigh(S2, **kw)
    del S2
    with timer.stage("combine") as out:
        out["fence"] = V = _combine(Q1, Q2, W1, W2)
    return torch.cat([lam1, lam2]), V  # the below-sigma block first: ascending


sdc_eigh.last_stats = _new_stats()


def pencil_eig_sdc(
    M, K, dtype, *, base_size: int = 2048, seed: int = 0, device="cuda"
) -> Tuple[np.ndarray, torch.Tensor]:
    """``(lam, V)`` of ``K V = M V diag(lam)`` with ``V^T M V = I``: the
    pencil form of :func:`sdc_eigh` (blocked Cholesky congruence, divide and
    conquer on the standard form, blocked triangular back-substitution).
    ``M``, ``K``: host arrays (cast through float64 to ``dtype``, as the JAX
    package casts them) or tensors, moved to ``device``. ``lam`` returns as
    float64 numpy for the host capacity math; ``V`` is a tensor of ``dtype``
    on ``device``. ``sdc_eigh.last_stats['phase_s']`` gains the
    ``congruence`` and ``back_transform`` seconds."""
    dev = torch.device(device)
    timer = StageTimer()
    with timer.stage("congruence") as out:
        Md = _as_tensor(M, dtype, dev)
        Kd = _as_tensor(K, dtype, dev)
        L = blocked_cholesky(Md, block=_BLOCK)
        del Md
        X = tri_solve_lower(L, Kd, block=_BLOCK)  # L^{-1} K
        del Kd
        S = tri_solve_lower(L, X.mT, block=_BLOCK).mT  # L^{-1} K L^{-T}
        del X
        out["fence"] = S = 0.5 * (S + S.mT)
    lam, Q = sdc_eigh(S, base_size=base_size, seed=seed)
    del S
    with timer.stage("back_transform") as out:
        out["fence"] = V = tri_solve_lower(L, Q, block=_BLOCK, transpose=True)
    sdc_eigh.last_stats["phase_s"].update(timer.records)
    return lam.cpu().numpy().astype(np.float64), V


def _as_tensor(A, dtype, device) -> torch.Tensor:
    """``A`` as a ``dtype`` tensor on ``device``; host arrays go through
    float64 first (the JAX package's ``to_device(np.asarray(A, float64))``)."""
    if isinstance(A, torch.Tensor):
        return A.to(device=device, dtype=dtype)
    return to_device(np.asarray(A, np.float64), dtype, device)
