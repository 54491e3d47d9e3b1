"""The ParaDiag preconditioner apply (PyTorch).

The counterpart of ``optimal_control_paradiag_tpu/paradiag/pc.py``. Both
variants apply the same operator P^{-1}, where P is the block-circulant
analogue of the all-at-once matrix (time stencils replaced by circulants):

'fulldiag': after an FFT over time and a DST over space the whole system is
  diagonal 2x2 blocks per (mode k, wavenumber j),

    P_k = [[ L1 muM + c L2 muK,     -dt^2/sqrt(g) muM       ],
           [ dt^2/sqrt(g) muM,  conj(L1) muM + c conj(L2) muK ]],  c = dt^2/2,

  solved by Cramer's rule with ``det = |a11|^2 + (dt^2/sqrt(g) muM)^2 > 0``,
  robust where Lambda_2(k) ~ 0 (N_t divisible by 4). The transforms are a
  full-spectrum time transform and the space's DST (``dst_method``).

'eig': the reference's 7-step apply: ifft over time, S^{-1} 2x2 mix,
  per-mode complex-shifted spatial solves ``(Sigma_i M + c K)``, S mix,
  division by (Lambda_2, conj Lambda_2), fft back. The spatial solves are
  the sine-spectral inverse unless an ``inner_solver`` is given
  (``paradiag/inner.py``).

The spaces the sine transform does not diagonalize (2D consistent mass,
unstructured meshes) solve the coupled per-mode system P_k w = r directly:

'block': batched COCG on the p-row-negated (complex symmetric) P_k,
  preconditioned by the tensor-part mass sine-spectral 2x2 Cramer inverse
  (structured grids; memory-free, but COCG can stall at indefinite-Helmholtz
  resonant modes);
'blockdense': per-mode dense inverses of P_k, made once on the host (the
  analogue of the reference's cached MUMPS factorization), N_t (2n)^2
  stored entries;
'blockline': block-Thomas over grid lines on the half spectrum
  (``paradiag/blockline.py``, structured grids);
'blockband': block-Thomas over RCM-banded levels on the half spectrum
  (``paradiag/blockband.py``, unstructured meshes).

The time transform is ``torch.fft`` or, with ``time_transform='dft'``, the
real-matmul DFT of ``ops/transforms.py``. The sharded ``layout`` is not
ported yet and raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from optimal_control_paradiag_torch.fem.space import require_full_fp32_matmul
from optimal_control_paradiag_torch.krylov.cocg import cocg
from optimal_control_paradiag_torch.ops import transforms
from optimal_control_paradiag_torch.ops.allatonce import AllAtOnceOperator, join_state, split_state
from optimal_control_paradiag_torch.paradiag.blockband import build_blockband_solver
from optimal_control_paradiag_torch.paradiag.blockline import build_blockline_solver
from optimal_control_paradiag_torch.paradiag.eigs import circulant_eigs
from optimal_control_paradiag_torch.paradiag.inner import make_dst_inner_solver
from optimal_control_paradiag_torch.utils.constants import complex_dtype, host_f64, to_device

_VARIANTS = ("fulldiag", "eig", "block", "blockdense", "blockline", "blockband")


def build_preconditioner(
    op: AllAtOnceOperator,
    variant: str = "fulldiag",
    inner_solver: Optional[Callable] = None,
    layout=None,
    time_transform: Optional[str] = None,
    inner_tol: float = 1e-10,
    inner_maxiter: int = 50,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Return ``apply(r) -> y ~= P^{-1} r`` on ``(..., 2, N_t, n)`` states
    (leading axes are a batch; time is dim -2).

    ``inner_solver(sigma, rhs)``, if given, overrides the per-mode spatial
    solve of the 'eig' variant: it receives per-mode complex shifts ``sigma``
    (N_t, 1) and right-hand sides (N_t, n) and returns the solutions of
    ``(sigma_k M + dt^2/2 K) w_k = rhs_k``. ``time_transform``: 'fft'
    (``torch.fft``, the default) or 'dft' (real-matmul DFT from
    :mod:`ops.transforms`). ``inner_tol`` and ``inner_maxiter`` bound the
    'block' variant's COCG.
    """
    if layout is not None:
        raise NotImplementedError(
            "the sharded preconditioner (layout) is not ported yet: ROADMAP Queue A item 14"
        )
    time_transform = "fft" if time_transform is None else time_transform
    if time_transform not in ("fft", "dft"):
        raise ValueError(f"unknown time_transform {time_transform!r}")
    if not op.scaled:
        raise ValueError(
            "The ParaDiag preconditioner requires the sqrt(gamma)-scaled "
            "system (reference 'pc' mode)."
        )
    if variant not in _VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    require_full_fp32_matmul()
    sp = op.space
    rdtype, dev = sp.dtype, sp.device
    cdtype = complex_dtype(rdtype)
    e = circulant_eigs(op.N_t, op.dt, op.gamma)
    c = 0.5 * op.dt * op.dt

    if time_transform == "dft":
        Cm, Sm = transforms.dft_matrices(op.N_t, rdtype, dev)

        def ifft_t(r):  # real input
            return transforms.time_ifft_real_mm(r, Cm, Sm)

        def fft_t_real(y):  # complex input -> real(fft(y))
            return transforms.time_fft_real_part_mm(y, Cm, Sm)

    else:

        def ifft_t(r):
            return torch.fft.ifft(r.to(cdtype), dim=-2)

        def fft_t_real(y):
            return torch.fft.fft(y, dim=-2).real

    if variant == "fulldiag":
        muM, muK = sp.spectrum
        if muM is None:
            raise ValueError(
                "fulldiag requires a sine-diagonalizable mass matrix "
                "(1D, or 2D with mass='lumped'); use variant='eig' with an "
                "iterative inner_solver for 2D consistent mass."
            )
        # Host float64 constants, cast once and copied to the device once.
        muM_h = np.asarray(muM, np.float64)[None, :]
        a11_h = e.Lambda1[:, None] * muM_h + c * e.Lambda2[:, None] * np.asarray(muK, np.float64)[None, :]
        coup_h = (op.dt * op.dt / (op.gamma**0.5)) * muM_h  # (1, n) real
        det_h = np.abs(a11_h) ** 2 + coup_h * coup_h
        a11 = to_device(a11_h, cdtype, dev)
        a22 = to_device(np.conj(a11_h), cdtype, dev)
        coup = to_device(coup_h, rdtype, dev)
        det = to_device(det_h, rdtype, dev)

        def apply_fulldiag(r: torch.Tensor) -> torch.Tensor:
            ru, rp = split_state(sp.dst(ifft_t(r)))
            yu = (a22 * ru + coup * rp) / det  # -a12 = +coup
            yp = (a11 * rp - coup * ru) / det  # a21 = +coup
            return fft_t_real(sp.idst(join_state(yu, yp)))

        return apply_fulldiag

    if variant == "block":
        return _block(op, sp, e, c, ifft_t, fft_t_real, inner_tol, inner_maxiter)
    if variant == "blockdense":
        return _blockdense(op, sp, e, c, ifft_t, fft_t_real)
    if variant in ("blockline", "blockband"):
        build = build_blockline_solver if variant == "blockline" else build_blockband_solver
        inner_solve = build(op)

        def apply_banded(r: torch.Tensor) -> torch.Tensor:
            return fft_t_real(inner_solve(ifft_t(r)))

        return apply_banded

    col = lambda v: to_device(np.asarray(v)[:, None], cdtype, dev)
    S1, S2, Sig1, Sig2 = col(e.S1), col(e.S2), col(e.Sigma1), col(e.Sigma2)
    L2, L2c = col(e.Lambda2), col(np.conj(e.Lambda2))

    if inner_solver is None:
        if not sp.diagonalizable:
            raise ValueError(
                "2D consistent mass needs an iterative inner_solver "
                "(see paradiag.inner.make_cocg_inner_solver)."
            )
        inner_solver = make_dst_inner_solver(sp, op.dt)

    def apply_eig(r: torch.Tensor) -> torch.Tensor:
        ru, rp = split_state(ifft_t(r))
        # S^{-1} mix (det S = 2)
        wu = 0.5 * (ru - S2 * rp)
        wp = 0.5 * (rp - S1 * ru)
        # per-mode complex-shifted spatial solves
        wu = inner_solver(Sig1, wu)
        wp = inner_solver(Sig2, wp)
        # S mix, then the deferred Lambda_2 row scaling
        yu = (wu + S2 * wp) / L2
        yp = (S1 * wu + wp) / L2c
        return fft_t_real(join_state(yu, yp))

    return apply_eig


def _block(op, sp, e, c, ifft_t, fft_t_real, inner_tol, inner_maxiter):
    """The 'block' variant: the coupled per-mode system solved by batched
    COCG. Negating the p-row makes it complex SYMMETRIC,

        [[L1 M + c L2 K,  -theta M], [-theta M, -(conj(L1) M + c conj(L2) K)]],

    with no S-eig decoupling, hence no division by Lambda_2 (stable for any
    N_t). The preconditioner is the 2x2 Cramer inverse with the tensor-part
    mass spectrum (``P1Space.spectrum_tensor``, the optimal sine-diagonal
    surrogate of M). Each lane of a batch keeps its own COCG stopping test."""
    theta = op.dt * op.dt / (op.gamma**0.5)
    _, muK = sp.spectrum
    if muK is None:
        raise ValueError(
            "variant='block' needs a structured-grid space (sine-"
            "diagonalizable stiffness); use 'blockdense' or "
            "inner='cocg_jacobi' on unstructured meshes"
        )
    rdtype, dev = sp.dtype, sp.device
    cdtype = complex_dtype(rdtype)
    muK_h = np.asarray(muK, np.float64)[None, :]
    muMt_h = np.asarray(sp.spectrum_tensor, np.float64)[None, :]
    L1h = np.asarray(e.Lambda1)[:, None]
    L2h = np.asarray(e.Lambda2)[:, None]
    b11_h = L1h * muMt_h + c * L2h * muK_h
    pdet_h = -(np.abs(b11_h) ** 2) - (theta * muMt_h) ** 2  # real, < 0
    L1, L2 = to_device(L1h, cdtype, dev), to_device(L2h, cdtype, dev)
    L1c, L2c = to_device(np.conj(L1h), cdtype, dev), to_device(np.conj(L2h), cdtype, dev)
    b11, b11c = to_device(b11_h, cdtype, dev), to_device(np.conj(b11_h), cdtype, dev)
    bcoup = to_device(theta * muMt_h, rdtype, dev)
    pdet = to_device(pdet_h, rdtype, dev)

    def block_A(w):
        wu, wp = split_state(w)
        mu_, mp_ = sp.apply_mass(wu), sp.apply_mass(wp)
        ku_, kp_ = sp.apply_stiffness(wu), sp.apply_stiffness(wp)
        return join_state(L1 * mu_ + c * L2 * ku_ - theta * mp_, -theta * mu_ - (L1c * mp_ + c * L2c * kp_))

    def block_pinv(r):
        ru, rp = split_state(sp.dst(r))
        return sp.idst(join_state((-b11c * ru + bcoup * rp) / pdet, (bcoup * ru + b11 * rp) / pdet))

    def apply_block(r: torch.Tensor) -> torch.Tensor:
        ru, rp = split_state(ifft_t(r))
        w, _ = cocg(block_A, join_state(ru, -rp), M=block_pinv, dot_axes=(-3, -1),
                    tol=inner_tol, maxiter=inner_maxiter, batch_dims=r.ndim - 3)
        return fft_t_real(w)

    return apply_block


def _blockdense(op, sp, e, c, ifft_t, fft_t_real):
    """The 'blockdense' variant: per-mode dense inverses of the coupled
    2x2-block systems P_k, made once on the host (numpy, complex128; the
    analogue of the reference's cached MUMPS factorization) and applied as
    one mode-batched complex product. Exact for every mode, the
    indefinite-Helmholtz ones and the Lambda_2 ~ 0 ones (N_t % 4 == 0)
    included. Memory: N_t (2n)^2 complex entries, refused past 3e8."""
    n = sp.n
    entries = op.N_t * (2 * n) ** 2
    if entries > 3e8:
        raise ValueError(
            f"blockdense would need {entries:.1e} stored entries; use "
            "variant='eig' with an iterative inner_solver for this size"
        )
    theta = op.dt * op.dt / (op.gamma**0.5)
    M_h = host_f64(sp.mass_dense())
    K_h = host_f64(sp.stiffness_dense())
    W = np.empty((op.N_t, 2 * n, 2 * n), np.complex128)
    for k in range(op.N_t):
        A = np.zeros((2 * n, 2 * n), np.complex128)
        A[:n, :n] = e.Lambda1[k] * M_h + c * e.Lambda2[k] * K_h
        A[:n, n:] = -theta * M_h
        A[n:, :n] = theta * M_h
        A[n:, n:] = np.conj(e.Lambda1[k]) * M_h + c * np.conj(e.Lambda2[k]) * K_h
        W[k] = np.linalg.inv(A)
    Wd = to_device(W, complex_dtype(sp.dtype), sp.device)

    def apply_blockdense(r: torch.Tensor) -> torch.Tensor:
        ru, rp = split_state(ifft_t(r))
        lead = r.shape[:-3]
        rvec = torch.cat([ru, rp], dim=-1).reshape((-1, op.N_t, 2 * n))  # (nb, N_t, 2n)
        w = torch.bmm(Wd, rvec.permute(1, 2, 0)).permute(2, 0, 1).reshape(lead + (op.N_t, 2 * n))
        return fft_t_real(join_state(w[..., :n], w[..., n:]))

    return apply_blockdense
