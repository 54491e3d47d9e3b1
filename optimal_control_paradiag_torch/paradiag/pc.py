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

The time transform is ``torch.fft`` or, with ``time_transform='dft'``, the
real-matmul DFT of ``ops/transforms.py``. The JAX package's other variants
('block', 'blockdense', 'blockline', 'blockband') and its sharded ``layout``
are not ported yet and raise ``NotImplementedError`` naming their ROADMAP
item.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from optimal_control_paradiag_torch.fem.space import require_full_fp32_matmul
from optimal_control_paradiag_torch.ops import transforms
from optimal_control_paradiag_torch.ops.allatonce import AllAtOnceOperator, join_state, split_state
from optimal_control_paradiag_torch.paradiag.eigs import circulant_eigs
from optimal_control_paradiag_torch.paradiag.inner import make_dst_inner_solver
from optimal_control_paradiag_torch.utils.constants import to_device

_NOT_PORTED_VARIANTS = {
    "block": "item 9 (2D consistent mass)",
    "blockline": "item 9 (2D consistent mass)",
    "blockdense": "items 9 and 10 (2D consistent mass, unstructured meshes)",
    "blockband": "item 10 (unstructured meshes)",
}


def complex_dtype(rdtype) -> torch.dtype:
    """The complex dtype that matches a real one."""
    return torch.complex64 if rdtype == torch.float32 else torch.complex128


def build_preconditioner(
    op: AllAtOnceOperator,
    variant: str = "fulldiag",
    inner_solver: Optional[Callable] = None,
    layout=None,
    time_transform: Optional[str] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Return ``apply(r) -> y ~= P^{-1} r`` on ``(..., 2, N_t, n)`` states
    (leading axes are a batch; time is dim -2).

    ``inner_solver(sigma, rhs)``, if given, overrides the per-mode spatial
    solve of the 'eig' variant: it receives per-mode complex shifts ``sigma``
    (N_t, 1) and right-hand sides (N_t, n) and returns the solutions of
    ``(sigma_k M + dt^2/2 K) w_k = rhs_k``. ``time_transform``: 'fft'
    (``torch.fft``, the default) or 'dft' (real-matmul DFT from
    :mod:`ops.transforms`). The JAX package's ``inner_tol`` and
    ``inner_maxiter`` belong to its 'block' variant, which is not ported.
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
    if variant in _NOT_PORTED_VARIANTS:
        raise NotImplementedError(
            f"pc_variant={variant!r} is not ported yet: ROADMAP Queue A {_NOT_PORTED_VARIANTS[variant]}"
        )
    if variant not in ("fulldiag", "eig"):
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
