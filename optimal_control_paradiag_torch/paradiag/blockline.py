"""Block-line (block-Thomas) direct inner solve for the 2D consistent mass
(PyTorch).

The counterpart of ``optimal_control_paradiag_tpu/paradiag/blockline.py``:
the MUMPS-parity factorization past ``blockdense``'s memory wall. Per Fourier
mode k the coupled 2x2-block operator

    P_k = [[ L1 M + c L2 K,            -theta M ],
           [ theta M,  conj(L1) M + c conj(L2) K ]],   c = dt^2/2,

on the (n1d, n1d) interior grid is block-tridiagonal over grid lines: the
Friedrichs-Keller consistent mass (stencil {C 6; E, W, N, S 1; NE, SW 1} x
h^2/12) and the 5-point stiffness couple a line only to its two neighbours,
and Dirichlet elimination makes every line alike, so the line blocks are
mode-dependent but line-independent:

    diag block  A_k = blocks(M_d, K_d),  M_d = (h^2/12)(6 I + C_x), K_d = 4I - C_x
    sub block   B_k = blocks(M_s-, -I),  M_s- = (h^2/12)(I + T^-)   (S + SW)
    super block C_k = blocks(M_s+, -I),  M_s+ = (h^2/12)(I + T^+)   (N + NE)

The block-Thomas factorization stores the line Schur-complement inverses
``G_j = (A - B G_{j-1} C)^{-1}``, n1d dense (2 n1d)^2 matrices per stored
mode. Only the Hermitian half spectrum (modes 0..N_t//2) is factorized and
solved: ``P_{N_t-k} = conj(P_k)`` and a real residual's spectrum has
``rhat_{N_t-k} = conj(rhat_k)``, so the other modes are conjugates.

The factors are built once on the host in complex128, as the JAX package
builds them, and each line's factor goes to the device as soon as it is
made, so the host never holds more than two lines. The apply is two sweeps
over the lines, each step a product batched over the modes (complex
matrices, ``torch.bmm``), with the lanes of a batch as the product's
columns; the line-independent B_k and C_k are kept as dense mode-batched
matrices, so a step is two products.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from optimal_control_paradiag_torch.fem.space import require_full_fp32_matmul
from optimal_control_paradiag_torch.paradiag.eigs import circulant_eigs
from optimal_control_paradiag_torch.utils.constants import complex_dtype, to_device


def blockline_entries(N_t: int, n1d: int) -> int:
    """Stored complex entries of the half-spectrum block-Thomas factors."""
    return (N_t // 2 + 1) * n1d * (2 * n1d) ** 2


def coupled_blocks(L1: np.ndarray, L2: np.ndarray, c: float, theta: float, Mb: np.ndarray, Kb: np.ndarray):
    """Per-mode 2x2-block matrices ``(..., hk, 2m, 2m)`` complex128 of the
    coupled operator from real (m, m) mass and stiffness blocks (leading
    axes of ``Mb``/``Kb`` are kept, the modes ``L1``/``L2`` go after them)."""
    m = Mb.shape[-1]
    hk = L1.shape[0]
    Mb, Kb = Mb[..., None, :, :], Kb[..., None, :, :]
    lead = np.broadcast_shapes(Mb.shape[:-3], Kb.shape[:-3])
    Z = np.zeros(lead + (hk, 2 * m, 2 * m), np.complex128)
    Z[..., :m, :m] = L1[:, None, None] * Mb + c * L2[:, None, None] * Kb
    Z[..., :m, m:] = -theta * Mb
    Z[..., m:, :m] = theta * Mb
    Z[..., m:, m:] = np.conj(L1)[:, None, None] * Mb + c * np.conj(L2)[:, None, None] * Kb
    return Z


def lanes_first(v: torch.Tensor, lead) -> torch.Tensor:
    """``(..., *tail)`` as ``(B, *tail)``, B the product of ``lead``."""
    return v.reshape((int(np.prod(lead, dtype=np.int64)),) + tuple(v.shape[len(lead):]))


def hermitian_mirror(w_half: torch.Tensor, N_t: int) -> torch.Tensor:
    """The full spectrum ``(..., N_t, n)`` of the half one ``(..., hk, n)``:
    modes hk..N_t-1 are the conjugates of modes N_t-k (physical conjugates,
    not torch's lazy conjugate views)."""
    hk = w_half.shape[-2]
    mirror = torch.conj_physical(torch.flip(w_half[..., 1 : N_t - hk + 1, :], dims=(-2,)))
    return torch.cat([w_half, mirror], dim=-2)


def build_blockline_solver(op, modes=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """Factorize P_k for modes 0..N_t//2 and return the half-spectrum
    solver ``solve(rhat) -> w`` on ``(..., 2, N_t, n)`` mode arrays (full
    spectrum in and out, leading axes a batch; the Hermitian mirror happens
    inside). ``rhat`` must carry Hermitian mode symmetry, as the time
    spectrum of any real residual does. ``modes=(lo, hi)`` factors modes
    ``lo..hi-1`` of the full spectrum instead, and the solver maps those
    modes, no mirror (a sharded rank's block of the modes)."""
    sp = op.space
    if sp.dim != 2 or not hasattr(sp, "n1d"):
        raise ValueError("blockline is the 2D structured-grid direct solver; "
                         "1D spaces have exact tridiagonal/spectral paths and "
                         "unstructured meshes use blockdense/cocg_jacobi")
    require_full_fp32_matmul()
    cdtype, dev = complex_dtype(sp.dtype), sp.device
    m = sp.n1d
    N_t = op.N_t
    lo, hi = (0, N_t // 2 + 1) if modes is None else modes
    hk = hi - lo
    c = 0.5 * op.dt * op.dt
    theta = op.dt * op.dt / (op.gamma**0.5)
    e = circulant_eigs(N_t, op.dt, op.gamma)
    L1 = np.asarray(e.Lambda1, np.complex128)[lo:hi]
    L2 = np.asarray(e.Lambda2, np.complex128)[lo:hi]

    hh12 = sp.h * sp.h / 12.0
    eye = np.eye(m)
    t_dn = np.eye(m, k=-1)  # (T^- v)_i = v_{i-1}
    t_up = np.eye(m, k=+1)  # (T^+ v)_i = v_{i+1}
    blocks = lambda Mb, Kb: coupled_blocks(L1, L2, c, theta, Mb, Kb)
    A = blocks(hh12 * (6.0 * eye + t_dn + t_up), 4.0 * eye - t_dn - t_up)
    B = blocks(hh12 * (eye + t_dn), -eye)
    C = blocks(hh12 * (eye + t_up), -eye)

    # Block-Thomas forward recursion, batched over modes, sequential in
    # lines: G_0 = A^{-1}, G_j = (A - B G_{j-1} C)^{-1}; each line's factor
    # goes to the device as it is made.
    G = torch.empty((m, hk, 2 * m, 2 * m), dtype=cdtype, device=dev)
    Gj = np.linalg.inv(A)
    G[0].copy_(torch.from_numpy(Gj))
    for j in range(1, m):
        Gj = np.linalg.inv(A - B @ Gj @ C)
        G[j].copy_(torch.from_numpy(Gj))
    Bd, Cd = to_device(B, cdtype, dev), to_device(C, cdtype, dev)

    def solve(rhat: torch.Tensor) -> torch.Tensor:
        lead = rhat.shape[:-3]
        rh = lanes_first(rhat[..., :hk, :] if modes is None else rhat, lead).to(cdtype)  # (nb, 2, hk, n)
        nb = rh.shape[0]
        # line vectors (lines, hk, 2m, nb): [u within the line | p within]
        r = rh.reshape(nb, 2, hk, m, m).permute(3, 2, 1, 4, 0).reshape(m, hk, 2 * m, nb)
        ys = [torch.bmm(G[0], r[0])]
        for j in range(1, m):
            ys.append(torch.bmm(G[j], torch.baddbmm(r[j], Bd, ys[-1], alpha=-1)))
        xs = torch.empty_like(r)
        xs[m - 1] = x = ys[m - 1]
        for j in range(m - 2, -1, -1):
            xs[j] = x = torch.baddbmm(ys[j], G[j], torch.bmm(Cd, x), alpha=-1)
        w = xs.reshape(m, hk, 2, m, nb).permute(4, 2, 1, 0, 3).reshape(lead + (2, hk, m * m))
        return hermitian_mirror(w, N_t) if modes is None else w

    return solve
