"""Banded block-Thomas direct inner solve for UNSTRUCTURED meshes (PyTorch).

The counterpart of ``optimal_control_paradiag_tpu/paradiag/blockband.py``:
the blockline recipe (``paradiag/blockline.py``) carried from structured
grid lines to RCM-banded level blocks.

1. Reverse Cuthill-McKee reorders the interior-DoF adjacency graph (the
   native ``rcm_order``, a sparse direct solver's fill-reducing ordering),
   and the reordered matrix has bandwidth ``b``.
2. The reordered unknowns fall into ``L = ceil(n / m)`` consecutive levels
   of ``m = b``: a matrix of bandwidth <= m is block-tridiagonal over such
   levels, so M and K split exactly into per-level diagonal, sub and super
   m x m blocks (level-dependent here, unlike the grid's identical lines).
3. Per Fourier mode k of the Hermitian half spectrum the coupled operator
   ``P_k`` (see ``paradiag/blockline.py``) is block-tridiagonal over levels
   with 2m x 2m blocks; block-Thomas stores ``G_j = (A_j - B_j G_{j-1}
   C_{j-1})^{-1}``, built once on the host in complex128 (level by level,
   each factor sent to the device as it is made).
4. The apply is two sweeps over levels whose step is a mode-batched complex
   product; the off-diagonal blocks act matrix-free from the REAL level
   blocks of M and K (shared by all modes) and the per-mode scalars, so only
   G is stored per mode: ``(N_t//2 + 1) * L * (2m)^2`` complex entries. An
   off-diagonal apply is two products: the stacked real ``[M_b; K_b]`` on
   the u and p halves, then the per-mode 2x4 coefficients of the coupled
   operator on the four results.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from optimal_control_paradiag_torch.fem.space import require_full_fp32_matmul
from optimal_control_paradiag_torch.paradiag.blockline import coupled_blocks, hermitian_mirror, lanes_first
from optimal_control_paradiag_torch.paradiag.eigs import circulant_eigs
from optimal_control_paradiag_torch.utils.constants import complex_dtype, to_device


def _csr_coo(csr) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    rows = np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr))
    return rows, np.asarray(csr.indices, np.int64), np.asarray(csr.data, np.float64)


def band_profile(space) -> Tuple[np.ndarray, int]:
    """(RCM permutation over interior DoFs, bandwidth after reordering)."""
    from optimal_control_paradiag_torch import native

    csr = space.M_csr
    perm = native.rcm_permutation(np.asarray(csr.indptr, np.int64), np.asarray(csr.indices, np.int32))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=perm.dtype)
    rows, cols, _ = _csr_coo(csr)
    bw = int(np.abs(inv[rows].astype(np.int64) - inv[cols].astype(np.int64)).max())
    return perm, max(bw, 1)


def blockband_entries(N_t: int, n: int, m: int) -> int:
    """Stored complex entries of the half-spectrum level-Thomas factors."""
    L = -(-n // m)
    return (N_t // 2 + 1) * L * (2 * m) ** 2


def _level_blocks(csr, inv: np.ndarray, m: int, L: int, pad_diag: float):
    """(diag, sub, super) level blocks, each (L, m, m) float64, of the
    RCM-permuted matrix (``inv`` maps old index -> new). ``pad_diag`` fills
    the padded tail's diagonal (1 for M so pad rows stay invertible, 0 for K)."""
    n = csr.shape[0]
    rows, cols, vals = _csr_coo(csr)
    r, c = inv[rows], inv[cols]
    br, bc = r // m, c // m
    D = np.zeros((L, m, m))
    S = np.zeros((L, m, m))  # S[j] = block (j, j-1)
    U = np.zeros((L, m, m))  # U[j] = block (j, j+1)
    if np.abs(br - bc).max(initial=0) > 1:
        raise ValueError("bandwidth exceeds level size; enlarge m")
    for out, sel in ((D, br == bc), (S, br == bc + 1), (U, br + 1 == bc)):
        np.add.at(out, (br[sel], r[sel] % m, c[sel] % m), vals[sel])
    for i in range(n, L * m):
        D[i // m, i % m, i % m] = pad_diag
    return D, S, U


def build_blockband_solver(op) -> Callable[[torch.Tensor], torch.Tensor]:
    """Factorize P_k for modes 0..N_t//2 on the RCM-banded level structure
    and return the half-spectrum solver ``solve(rhat) -> w`` on ``(..., 2,
    N_t, n)`` mode arrays (full spectrum in and out, leading axes a batch;
    ``rhat`` must carry real-residual mode symmetry, as for
    :func:`paradiag.blockline.build_blockline_solver`)."""
    sp = op.space
    if sp.diagonalizable:
        raise ValueError("blockband is the unstructured direct path; "
                         "diagonalizable spaces have exact spectral solves")
    require_full_fp32_matmul()
    rdtype, dev = sp.dtype, sp.device
    cdtype = complex_dtype(rdtype)
    n = sp.n
    N_t = op.N_t
    hk = N_t // 2 + 1
    c = 0.5 * op.dt * op.dt
    theta = op.dt * op.dt / (op.gamma**0.5)
    e = circulant_eigs(N_t, op.dt, op.gamma)
    L1 = np.asarray(e.Lambda1, np.complex128)[:hk]
    L2 = np.asarray(e.Lambda2, np.complex128)[:hk]

    perm, m = band_profile(sp)
    L = -(-n // m)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=perm.dtype)
    Md, Ms, Mu = _level_blocks(sp.M_csr, inv, m, L, pad_diag=1.0)
    Kd, Ks, Ku = _level_blocks(sp.K_csr, inv, m, L, pad_diag=0.0)
    blocks = lambda Mb, Kb: coupled_blocks(L1, L2, c, theta, Mb, Kb)

    # Level-Thomas forward recursion, batched over modes, each level's
    # blocks and factor made in turn (B[j] acts on level j-1, C[j] on j+1).
    G = torch.empty((L, hk, 2 * m, 2 * m), dtype=cdtype, device=dev)
    Gj = np.linalg.inv(blocks(Md[0], Kd[0]))
    G[0].copy_(torch.from_numpy(Gj))
    for j in range(1, L):
        Gj = np.linalg.inv(blocks(Md[j], Kd[j]) - blocks(Ms[j], Ks[j]) @ Gj @ blocks(Mu[j - 1], Ku[j - 1]))
        G[j].copy_(torch.from_numpy(Gj))
    # real level blocks (shared across modes) for the matrix-free off-block
    # apply, M over K: (L, 2m, m); the coupled operator's per-mode
    # coefficients on (u M, u K, p M, p K): (hk, 2, 4)
    sub = to_device(np.concatenate([Ms, Ks], axis=1), rdtype, dev)
    sup = to_device(np.concatenate([Mu, Ku], axis=1), rdtype, dev)
    coef = np.zeros((hk, 2, 4), np.complex128)
    coef[:, 0] = np.stack([L1, c * L2, np.full(hk, -theta), np.zeros(hk)], axis=1)
    coef[:, 1] = np.stack([np.full(hk, theta), np.zeros(hk), np.conj(L1), c * np.conj(L2)], axis=1)
    coef = to_device(coef, cdtype, dev)
    perm_d = torch.from_numpy(perm.astype(np.int64)).to(dev)
    inv_d = torch.from_numpy(inv.astype(np.int64)).to(dev)
    n_pad = L * m

    def _blocks_of(MK, y):
        """The real level blocks ``MK = [M_b; K_b]`` (2m, m) on the u and p
        halves of complex level vectors y (hk, 2m, nb), as one real
        product: (hk, 4, m nb), rows (u M, u K, p M, p K)."""
        nb = y.shape[-1]
        Y = torch.view_as_real(y.view(hk, 2, m, nb)).reshape(hk, 2, m, 2 * nb)
        Z = torch.view_as_complex(torch.matmul(MK, Y).view(hk, 2, 2 * m, nb, 2))
        return Z.view(hk, 4, m * nb)

    def solve(rhat: torch.Tensor) -> torch.Tensor:
        lead = rhat.shape[:-3]
        rh = lanes_first(rhat[..., :hk, :], lead).to(cdtype)  # (nb, 2, hk, n)
        nb = rh.shape[0]
        # RCM order + pad, then level vectors (L, hk, 2m, nb)
        rperm = rh.index_select(-1, perm_d)
        rperm = torch.cat([rperm, rperm.new_zeros((nb, 2, hk, n_pad - n))], dim=-1)
        r = rperm.reshape(nb, 2, hk, L, m).permute(3, 2, 1, 4, 0).reshape(L, hk, 2 * m, nb)
        flat = lambda v: v.view(hk, 2, m * nb)  # (hk, 2m, nb) as (hk, 2, m nb)
        ys = [torch.bmm(G[0], r[0])]
        for j in range(1, L):
            t = torch.baddbmm(flat(r[j]), coef, _blocks_of(sub[j], ys[-1]), alpha=-1)
            ys.append(torch.bmm(G[j], t.view(hk, 2 * m, nb)))
        xs = torch.empty_like(r)
        xs[L - 1] = x = ys[L - 1]
        for j in range(L - 2, -1, -1):
            off = torch.bmm(coef, _blocks_of(sup[j], x)).view(hk, 2 * m, nb)
            xs[j] = x = torch.baddbmm(ys[j], G[j], off, alpha=-1)
        w = xs.reshape(L, hk, 2, m, nb).permute(4, 2, 1, 0, 3).reshape(nb, 2, hk, n_pad)[..., :n]
        w = w.index_select(-1, inv_d)  # undo the RCM permutation
        return hermitian_mirror(w.reshape(lead + (2, hk, n)), N_t)

    return solve
