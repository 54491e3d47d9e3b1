"""Spectral-space solvers in ParaDiag-diagonalized coordinates (PyTorch):
GMRES there (:func:`build_spectral_system`), the rank-4 Woodbury DIRECT
solve, and the host float64 residual oracle.

The counterpart of ``optimal_control_paradiag_tpu/paradiag/spectral.py``
(unsharded). With T = DST(space) o ifft(time) the all-at-once
operator becomes ``A_hat = D + B_hat``: D the exact per-(mode k, wavenumber j)
2x2 circulant block, B_hat a correction that reads four time slices
(u_{N-1}, u_{N-2}, p_0, p_1) and writes four time rows, with spatially
diagonal coefficients. Per wavenumber j the correction has rank 4, so

  A_hat_j^{-1} = D_j^{-1} - D_j^{-1} Psi G_j Phi* D_j^{-1},
  G_j = (I_4 + C_j W_j)^{-1} C_j,   W_j = Phi* D_j^{-1} Psi,

with the capacity matrices G_j computed in float64 on the host. The solve is
two transforms plus O(1) elementwise passes; ``refine`` defect-correction
steps (one exact A_hat apply plus one Woodbury apply each) polish the
working-precision rounding; :func:`build_polished_solver` adds
physical-space defect correction on top of any such solve.

The real state has a Hermitian time spectrum, so the default Woodbury solve
runs on the ``K = N_t//2 + 1`` rfft bins: extractions pair conjugate bins
(weight 2, 1 on the self-conjugate ones), which makes G_j real. The
full-spectrum solve (``half_spectrum=False``) and spectral GMRES work on all
N_t bins with complex states.

Every solve and transform takes states with leading batch axes,
``(..., 2, N_t, n)``: time is dim -2 and the (u, p) blocks dim -3.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from optimal_control_paradiag_torch.fem.space import require_full_fp32_matmul
from optimal_control_paradiag_torch.krylov.gmres import gmres
from optimal_control_paradiag_torch.ops import time_pack
from optimal_control_paradiag_torch.ops.allatonce import AllAtOnceOperator, join_state, split_state
from optimal_control_paradiag_torch.ops.transforms import (
    FourStepPlan,
    dft_matrices,
    time_fft_real_part_mm,
    time_ifft_real_mm,
    time_irfft_conj_mm4,
    time_irfft_conj_packed,
    time_rfft_conj_mm4,
    time_rfft_conj_packed,
)
from optimal_control_paradiag_torch.paradiag.eigs import circulant_eigs
from optimal_control_paradiag_torch.parallel.sharding import resolve_layout
from optimal_control_paradiag_torch.utils.constants import host_const, to_device
from optimal_control_paradiag_torch.utils.timing import span, spanned


@dataclasses.dataclass(frozen=True)
class _SpectralPlan:
    """Constants of the diagonalized system: float64 host originals, and the
    working-dtype casts (1D factors on the plan's device, phases on the
    host)."""

    N_t: int
    n: int
    rdtype: torch.dtype
    np_c: np.dtype  # complex numpy dtype matching rdtype
    device: torch.device
    c: float  # dt^2 / 2
    theta: float  # dt^2 / sqrt(gamma)
    # float64 originals (Woodbury capacity math):
    a11_h: np.ndarray  # (N_t, n) complex128
    det_h: np.ndarray  # (N_t, n) float64
    muM64: np.ndarray  # (n,)
    muK64: np.ndarray  # (n,)
    # working dtype
    L1c: np.ndarray  # Lambda1(k), (N_t,) complex
    L2c: np.ndarray  # Lambda2(k), (N_t,) complex
    m1: torch.Tensor  # muM, (n,)
    kap1: torch.Tensor  # c * muK, (n,)
    tm1: torch.Tensor  # theta * muM, (n,)
    mk1: torch.Tensor  # muM + c muK, (n,)

    def mode_diag(self, K: Optional[int] = None, rows: slice = slice(None)):
        """Per-mode diagonal ``(a11, a22, tm, inv_det)`` of the circulant
        block system on the plan's device, each broadcastable to
        ``(K or N_t, n)``, formed in working precision from the 1D factors:

            a11 = Lambda1 (x) muM + Lambda2 (x) (c muK),   a22 = conj(a11),
            tm  = theta * muM,   det = |a11|^2 + tm^2.

        ``rows`` picks modes out of those K (a sharded rank's block).
        """
        L1 = torch.from_numpy(self.L1c[:K][rows]).to(self.device)
        L2 = torch.from_numpy(self.L2c[:K][rows]).to(self.device)
        a11 = L1[:, None] * self.m1[None, :] + L2[:, None] * self.kap1[None, :]
        a22 = a11.conj()
        tm = self.tm1[None, :]
        inv_det = 1.0 / (torch.square(a11.real) + torch.square(a11.imag) + torch.square(tm))
        return a11, a22, tm, inv_det


def _spectral_plan(op: AllAtOnceOperator, mass_surrogate: bool = False) -> _SpectralPlan:
    """``mass_surrogate=True``: on spaces the sine transform does not
    diagonalize (2D consistent mass) use the tensor-part mass eigenvalues
    (``P1Space.spectrum_tensor``); the plan then describes an approximation
    of the operator, fit for building a preconditioner
    (``paradiag/symmetric.py``), never for the exact solves."""
    sp = op.space
    if not sp.diagonalizable and not mass_surrogate:
        raise ValueError("spectral solver needs a sine-diagonalizable space")
    if not op.scaled:
        raise ValueError("spectral solver operates on the scaled system")
    rdtype = sp.dtype
    np_c = np.dtype(np.complex64 if rdtype == torch.float32 else np.complex128)
    N_t, n = op.N_t, sp.n
    c = 0.5 * op.dt * op.dt
    theta = op.dt * op.dt / math.sqrt(op.gamma)

    e = circulant_eigs(N_t, op.dt, op.gamma)
    muM_raw, muK = sp.spectrum
    if muM_raw is None:
        muM_raw = sp.spectrum_tensor
    muM, muK = np.asarray(muM_raw, np.float64), np.asarray(muK, np.float64)
    L1 = np.asarray(e.Lambda1)[:, None]
    L2 = np.asarray(e.Lambda2)[:, None]
    a11_h = L1 * muM[None, :] + c * L2 * muK[None, :]  # (N_t, n)
    det_h = np.abs(a11_h) ** 2 + (theta * muM[None, :]) ** 2

    dev = sp.device

    return _SpectralPlan(
        N_t=N_t,
        n=n,
        rdtype=rdtype,
        np_c=np_c,
        device=dev,
        c=c,
        theta=theta,
        a11_h=a11_h,
        det_h=det_h,
        muM64=muM,
        muK64=muK,
        L1c=host_const(np.asarray(e.Lambda1), np_c),
        L2c=host_const(np.asarray(e.Lambda2), np_c),
        m1=to_device(muM, rdtype, dev),
        kap1=to_device(c * muK, rdtype, dev),
        tm1=to_device(theta * muM, rdtype, dev),
        mk1=to_device(muM + c * muK, rdtype, dev),
    )


# --------------------------------------------------------------------------
# Woodbury direct solve
# --------------------------------------------------------------------------


def _capacity_matrices(pl: _SpectralPlan) -> np.ndarray:
    """G_j = (I_4 + C_j W_j)^{-1} C_j per wavenumber j, complex128 host.

    Ordering of the rank-4 factors:
      extraction rows a (Phi*): 0 = u slice N-1, 1 = u slice N-2,
                                2 = p slice 0,   3 = p slice 1;
      injection cols  b (Psi):  0 = u row 0,     1 = u row 1,
                                2 = p row N-1,   3 = p row N-2.
    """
    C, W = _capacity_CW(pl)
    I4 = np.eye(4)[None]
    return np.linalg.solve(I4 + C @ W, C.astype(np.complex128))


def _real_capacity_matrices(pl: _SpectralPlan) -> np.ndarray:
    """The float64 real part of :func:`_capacity_matrices`, (n, 4, 4); the
    half-spectrum pairing makes G_j real, and this raises if it is not."""
    G_h = _capacity_matrices(pl)
    if not float(np.abs(G_h.imag).max()) < 1e-10 * max(float(np.abs(G_h.real).max()), 1.0):
        raise ArithmeticError("half-spectrum capacity matrices are not real")
    return G_h.real


def _capacity_CW(pl: _SpectralPlan):
    """Per-wavenumber capacity ingredients: C_j (the real 4x4 boundary-row
    coefficients) and W_j = Phi* D_j^{-1} Psi (the slice-of-inverse 4x4)."""
    N_t, n = pl.N_t, pl.n
    k = np.arange(N_t)
    phiE = lambda i: np.exp(-2j * np.pi * i * k / N_t)  # extraction
    psiI = lambda i: np.exp(2j * np.pi * i * k / N_t) / N_t  # injection

    # D^{-1} component blocks, complex128, (N_t, n).
    tm64 = pl.theta * pl.muM64[None, :]
    iuu = np.conj(pl.a11_h) / pl.det_h
    iup = tm64 / pl.det_h + 0j
    ipu = -tm64 / pl.det_h + 0j
    ipp = pl.a11_h / pl.det_h
    E = {("u", "u"): iuu, ("u", "p"): iup, ("p", "u"): ipu, ("p", "p"): ipp}

    rows = [("u", phiE(N_t - 1)), ("u", phiE(N_t - 2)), ("p", phiE(0)), ("p", phiE(1))]
    cols = [("u", psiI(0)), ("u", psiI(1)), ("p", psiI(N_t - 1)), ("p", psiI(N_t - 2))]

    W = np.zeros((n, 4, 4), np.complex128)
    for a, (ca, pa) in enumerate(rows):
        for b, (cb, pb) in enumerate(cols):
            W[:, a, b] = np.einsum("k,kn,k->n", pa, E[(ca, cb)], pb)

    # C_j: outputs (u0, u1, pN-1, pN-2) from inputs (uN-1, uN-2, p0, p1).
    m = pl.muM64
    kap = pl.c * pl.muK64
    t2 = pl.theta * pl.muM64
    C = np.zeros((n, 4, 4), np.float64)
    C[:, 0, 0] = 2.0 * m
    C[:, 0, 1] = -(m + kap)
    C[:, 0, 2] = 0.5 * t2
    C[:, 1, 0] = -(m + kap)
    C[:, 2, 0] = -0.5 * t2
    C[:, 2, 2] = 2.0 * m
    C[:, 2, 3] = -(m + kap)
    C[:, 3, 2] = -(m + kap)
    return C, W


def pairing_weights(N_t: int) -> np.ndarray:
    """Hermitian pairing weight of each rfft bin: 2 on bins paired with a
    conjugate, 1 on the self-conjugate ones (k = 0, and N_t/2 if N_t is
    even)."""
    K = N_t // 2 + 1
    wgt = np.full(K, 2.0)
    wgt[0] = 1.0
    if N_t % 2 == 0:
        wgt[K - 1] = 1.0
    return wgt


def make_halfspectrum_transforms(
    space,
    N_t: int,
    rdtype,
    layout=None,
    time_transform: str = "fft",
) -> Tuple[Callable, Callable]:
    """``(to_spectral, from_spectral)`` of the half-spectrum pipeline, on
    states with leading batch axes (time is dim -2):

        xi = conj(rfft(dst(x), axis=-2)) / N_t       (..., 2, K, n) complex
        x  = idst(irfft(conj(xi)) * N_t)             (..., 2, N_t, n) real

    ``time_transform``: 'fft' (two real rffts), 'fft2' (one packed complex
    FFT, ``ops.transforms.time_rfft_conj_packed``; on the card the kernels
    of ``ops/time_pack.py`` are all that runs around cuFFT), 'dft' (the rfft/irfft
    as split-real matmuls with K x N_t cos/sin matrices, the pairing weights
    folded into the inverse's) or 'mxu' (the four-step factorization,
    ``ops.transforms.FourStepPlan``; a prime N_t has no radix split and
    falls back to 'fft', as in the JAX package). The DST runs first, on the
    real state. Unknown names raise ``ValueError`` (the JAX package falls
    back to 'fft'; ROADMAP Queue C). The time half of each direction is a
    ``transforms/time_fwd`` or ``transforms/time_inv`` span.

    ``layout`` (a ``parallel.sharding.ParallelLayout``) needs 'dft', as in
    the JAX package. x is then a canonical block and xi a ``mode_local``
    block of the K bins; each direction is three stage moves (one
    ``all_to_all_single`` each): the DST with the time axis split (space
    local), the K x N_t matmuls with space split (time local), and the bins
    split for the elementwise solve."""
    sp = space
    dev = sp.device
    lay = resolve_layout(layout)
    if lay.sharded and time_transform != "dft":
        raise ValueError("sharded half-spectrum transforms require time_transform='dft'")
    n = sp.n
    if time_transform == "dft":
        K = N_t // 2 + 1
        wgt = pairing_weights(N_t)
        ang = 2.0 * np.pi * np.outer(np.arange(K), np.arange(N_t)) / N_t
        Cf = to_device(np.cos(ang) / N_t, rdtype, dev)
        Sf = to_device(np.sin(ang) / N_t, rdtype, dev)
        Ci = to_device(wgt[None, :] * np.cos(ang).T, rdtype, dev)
        Si = to_device(wgt[None, :] * np.sin(ang).T, rdtype, dev)

        def to_spectral(x):
            s = sp.dst(lay.move(x, "canonical", "mode_local", N_t, n))
            s = lay.move(s, "mode_local", "time_local", N_t, n)
            with span("transforms/time_fwd"):
                xi = torch.complex(torch.einsum("kt,...tn->...kn", Cf, s), torch.einsum("kt,...tn->...kn", Sf, s))
            return lay.move(xi, "time_local", "mode_local", K, n)

        def from_spectral(xi):
            xi = lay.move(xi, "mode_local", "time_local", K, n)
            with span("transforms/time_inv"):
                t = torch.einsum("tk,...kn->...tn", Ci, xi.real) + torch.einsum("tk,...kn->...tn", Si, xi.imag)
            t = lay.move(t, "time_local", "mode_local", N_t, n)
            return lay.move(sp.idst(t).to(rdtype), "mode_local", "canonical", N_t, n)

    elif time_transform == "mxu":
        try:
            plan4 = FourStepPlan(N_t, rdtype, device=dev)
        except ValueError:
            # prime N_t has no radix split: the rfft path is the fallback
            return make_halfspectrum_transforms(sp, N_t, rdtype, time_transform="fft")

        def to_spectral(x):
            s = sp.dst(x)
            with span("transforms/time_fwd"):
                return time_rfft_conj_mm4(s, plan4)

        def from_spectral(xi):
            with span("transforms/time_inv"):
                t = time_irfft_conj_mm4(xi, plan4)
            return sp.idst(t).to(rdtype)

    elif time_transform == "fft2":
        if dev.type == "cuda":
            time_pack.kernel_library()  # the time_pack kernels build here, at set-up

        def to_spectral(x):
            s = sp.dst(x)
            with span("transforms/time_fwd"):
                return time_rfft_conj_packed(s, N_t)

        def from_spectral(xi):
            with span("transforms/time_inv"):
                t = time_irfft_conj_packed(xi, N_t)
            return sp.idst(t).to(rdtype)

    elif time_transform == "fft":

        def to_spectral(x):
            s = sp.dst(x)
            # contiguous, as the packed transform returns it: the fused
            # kernels read b_hat in that layout (cuFFT's rfft over the time
            # axis returns a strided result)
            with span("transforms/time_fwd"):
                return (torch.fft.rfft(s, dim=-2).conj() * (1.0 / N_t)).contiguous()

        def from_spectral(xi):
            with span("transforms/time_inv"):
                t = torch.fft.irfft(xi.conj(), n=N_t, dim=-2) * float(N_t)
            return sp.idst(t).to(rdtype)

    else:
        raise ValueError(f"unknown time_transform {time_transform!r}")
    return to_spectral, from_spectral


def d_inv(a11, a22, tm, inv_det):
    """r -> D^{-1} r, the per-(k, j) 2x2 Cramer inverse of the circulant
    block, on states ``(..., 2, K, n)``."""

    def D_inv(r):
        ru, rp = split_state(r)
        return join_state((a22 * ru + tm * rp) * inv_det, (a11 * rp - tm * ru) * inv_det)

    return D_inv


def _reduce4(lay, z):
    """Four partial phase sums completed over a sharded bin axis: one
    ``all_reduce`` of the stacked sums (the identity unsharded)."""
    if not lay.sharded:
        return z
    return tuple(lay.all_reduce(torch.stack(z)).unbind(0))


def _extract4(phis, yu, yp):
    """The four boundary time slices (u N-1, u N-2, p 0, p 1), each
    ``(..., n)``: phase sums over the time (bin) axis, dim -2."""
    phi_uNm1, phi_uNm2, phi_p0, phi_p1 = phis
    return (
        torch.sum(phi_uNm1[:, None] * yu, dim=-2),
        torch.sum(phi_uNm2[:, None] * yu, dim=-2),
        torch.sum(phi_p0[:, None] * yp, dim=-2),
        torch.sum(phi_p1[:, None] * yp, dim=-2),
    )


def _inject4(psis, w):
    """The rank-1 injections of the four row values ``w`` (each ``(..., n)``)
    into u rows 0, 1 and p rows N-1, N-2: a state ``(..., 2, K, n)``."""
    psi_u0, psi_u1, psi_pNm1, psi_pNm2 = psis
    col = lambda v: v[..., None, :]
    return join_state(
        psi_u0[:, None] * col(w[0]) + psi_u1[:, None] * col(w[1]),
        psi_pNm1[:, None] * col(w[2]) + psi_pNm2[:, None] * col(w[3]),
    )


def _a_hat(a11, a22, tm, pl: _SpectralPlan, extract, psis):
    """xi -> (D + B_hat) xi: the circulant block plus the rank-4 boundary
    rows, read through ``extract`` and written through ``psis``."""
    m1, kap1, tm1, mk1 = pl.m1, pl.kap1, pl.tm1, pl.mk1

    def A_hat(xi):
        xu, xp = split_state(xi)
        uNm1, uNm2, p0, p1 = extract(xu, xp)
        rows = (
            m1 * (2.0 * uNm1 - uNm2) - kap1 * uNm2 + 0.5 * tm1 * p0,
            -mk1 * uNm1,
            m1 * (2.0 * p0 - p1) - kap1 * p1 - 0.5 * tm1 * uNm1,
            -mk1 * p0,
        )
        psi_u0, psi_u1, psi_pNm1, psi_pNm2 = psis
        col = lambda v: v[..., None, :]
        du = a11 * xu - tm * xp
        dp = tm * xu + a22 * xp
        du = du + psi_u0[:, None] * col(rows[0]) + psi_u1[:, None] * col(rows[1])
        dp = dp + psi_pNm1[:, None] * col(rows[2]) + psi_pNm2[:, None] * col(rows[3])
        return join_state(du, dp)

    return A_hat


def _full_phases(pl: _SpectralPlan):
    """Extraction phases ``phi_i[k] = exp(-2 pi i i k / N_t)`` of slices
    (N-1, N-2, 0, 1) and injection phases ``psi_i[k] = exp(2 pi i i k /
    N_t) / N_t`` of rows (0, 1, N-1, N-2), all N_t bins, on the plan's
    device."""
    N_t = pl.N_t
    k = np.arange(N_t)
    phi = lambda i: to_device(np.exp(-2j * np.pi * i * k / N_t), pl.np_c, pl.device)
    psi = lambda i: to_device(np.exp(2j * np.pi * i * k / N_t) / N_t, pl.np_c, pl.device)
    return (
        tuple(phi(i) for i in (N_t - 1, N_t - 2, 0, 1)),
        tuple(psi(i) for i in (0, 1, N_t - 1, N_t - 2)),
    )


def _make_ops(op: AllAtOnceOperator, pl: _SpectralPlan, time_transform: str = "fft", layout=None):
    """``(A_hat, D_inv, to_spectral, from_spectral)`` of the full-spectrum
    system from a prepared plan, on states ``(..., 2, N_t, n)``:

        to_spectral(x)    = dst(ifft(x, axis=-2))      complex
        from_spectral(xi) = real(fft(idst(xi), axis=-2))

    ``time_transform='dft'`` runs the time transforms as real matmuls
    (``ops.transforms``); any other name, as in the JAX package, the FFT.
    ``layout`` (a ``parallel.sharding.ParallelLayout``): x is a canonical
    block and xi a ``mode_local`` block of the N_t modes; the time transform
    runs time-local, the DST and the elementwise work mode-local (two stage
    moves each way), and A_hat's four phase sums end in one
    ``all_reduce``."""
    sp = op.space
    rdtype = pl.rdtype
    cdtype = torch.complex64 if rdtype == torch.float32 else torch.complex128
    lay = resolve_layout(layout)
    N_t, n = pl.N_t, pl.n
    rows = lay.rows("mode_local", N_t)
    a11, a22, tm, inv_det = pl.mode_diag(rows=rows)
    phis, psis = (tuple(v[rows] for v in vs) for vs in _full_phases(pl))
    extract = lambda xu, xp: _reduce4(lay, _extract4(phis, xu, xp))
    A_hat = _a_hat(a11, a22, tm, pl, extract, psis)
    D_inv = d_inv(a11, a22, tm, inv_det)
    if time_transform == "dft":
        C_t, S_t = dft_matrices(pl.N_t, rdtype, pl.device)
        ifft_t = lambda x: time_ifft_real_mm(x.to(rdtype), C_t, S_t)
        fft_t_real = lambda y: time_fft_real_part_mm(y, C_t, S_t)
    else:
        ifft_t = lambda x: torch.fft.ifft(x.to(cdtype), dim=-2)
        fft_t_real = lambda y: torch.fft.fft(y, dim=-2).real
    ifft_t = spanned("transforms/time_fwd", ifft_t)
    fft_t_real = spanned("transforms/time_inv", fft_t_real)

    def to_spectral(x):
        xh = ifft_t(lay.move(x, "canonical", "time_local", N_t, n))
        return sp.dst(lay.move(xh, "time_local", "mode_local", N_t, n))

    def from_spectral(xi):
        y = lay.move(sp.idst(xi), "mode_local", "time_local", N_t, n)
        return lay.move(fft_t_real(y).to(rdtype), "time_local", "canonical", N_t, n)

    return A_hat, D_inv, to_spectral, from_spectral


def build_spectral_system(op: AllAtOnceOperator):
    """``(A_hat, D_inv, to_spectral, from_spectral)`` of the scaled
    all-at-once system in ParaDiag-diagonalized coordinates: GMRES on
    ``A_hat xi = to_spectral(b)`` with ``D_inv`` as preconditioner, then
    ``x = from_spectral(xi)``."""
    require_full_fp32_matmul()
    return _make_ops(op, _spectral_plan(op))


def solve_spectral(
    op: AllAtOnceOperator,
    b: torch.Tensor,
    *,
    restart: int = 40,
    rtol: float = 1e-5,
    maxiter: int = 200,
):
    """The full spectral-space solve; returns ``(x, GmresResult)``."""
    A_hat, D_inv, to_spectral, from_spectral = build_spectral_system(op)
    res = gmres(A_hat, to_spectral(b), M=D_inv, restart=restart, rtol=rtol, maxiter=maxiter)
    return from_spectral(res.x), res


def _build_woodbury_full(op: AllAtOnceOperator, pl: _SpectralPlan, refine: int, time_transform: str, layout=None):
    """Full-spectrum Woodbury solve: all N_t bins of the complex spectral
    state, complex capacity matrices (the pairing that makes them real
    needs the half spectrum)."""
    lay = resolve_layout(layout)
    A_hat, D_inv, to_spectral, from_spectral = _make_ops(op, pl, time_transform=time_transform, layout=layout)
    G_h = _capacity_matrices(pl)
    G = [[to_device(G_h[:, a, b], pl.np_c, pl.device) for b in range(4)] for a in range(4)]
    rows = lay.rows("mode_local", pl.N_t)
    phis, psis = (tuple(v[rows] for v in vs) for vs in _full_phases(pl))

    def wb_apply(r):
        y = D_inv(r)
        z = _reduce4(lay, _extract4(phis, *split_state(y)))
        w = [sum(G[a][b] * z[b] for b in range(4)) for a in range(4)]
        return y - D_inv(_inject4(psis, w))

    def solve(b):
        b_hat = to_spectral(b)
        x = wb_apply(b_hat)
        for _ in range(refine):
            x = x + wb_apply(b_hat - A_hat(x))
        return from_spectral(x)

    return solve


def _build_woodbury_half(
    op: AllAtOnceOperator,
    pl: _SpectralPlan,
    refine: int,
    time_transform: str = "fft",
    layout=None,
):
    """Half-spectrum Woodbury solve ``b -> x`` on the ``K = N_t//2 + 1``
    rfft bins (module docstring). ``layout`` (a
    ``parallel.sharding.ParallelLayout``): b and x are canonical blocks, the
    elementwise work runs on this rank's ``mode_local`` block of the bins,
    and each set of four phase sums is this rank's partial sums (working
    dtype, as unsharded) completed by one ``all_reduce``."""
    sp = op.space
    N_t = pl.N_t
    K = N_t // 2 + 1
    rdtype, np_c, dev = pl.rdtype, pl.np_c, pl.device
    lay = resolve_layout(layout)
    to_spectral, from_spectral = make_halfspectrum_transforms(
        sp, N_t, rdtype, layout=layout, time_transform=time_transform
    )
    rows = lay.rows("mode_local", K)

    k = np.arange(K)[rows]
    wgt = pairing_weights(N_t)[rows]
    # Extraction phases carry the pairing weight; injections use plain bins.
    phiw = lambda i: to_device(wgt * np.exp(-2j * np.pi * i * k / N_t), np_c, dev)
    psi = lambda i: to_device(np.exp(2j * np.pi * i * k / N_t) / N_t, np_c, dev)
    phi_uNm1, phi_uNm2, phi_p0, phi_p1 = (phiw(i) for i in (N_t - 1, N_t - 2, 0, 1))
    psi_u0, psi_u1, psi_pNm1, psi_pNm2 = (psi(i) for i in (0, 1, N_t - 1, N_t - 2))

    G_h = _real_capacity_matrices(pl)
    G = [[to_device(G_h[:, a, b], rdtype, dev) for b in range(4)] for a in range(4)]
    a11, a22, tm, inv_det = pl.mode_diag(K, rows=rows)

    D_inv = d_inv(a11, a22, tm, inv_det)

    def extract(yu, yp):
        return _reduce4(lay, tuple(e.real for e in _extract4((phi_uNm1, phi_uNm2, phi_p0, phi_p1), yu, yp)))

    psis = (psi_u0, psi_u1, psi_pNm1, psi_pNm2)
    A_hat = _a_hat(a11, a22, tm, pl, extract, psis)

    def wb_apply(r):
        y = D_inv(r)
        z = extract(*split_state(y))
        w = [sum(G[a][b] * z[b] for b in range(4)) for a in range(4)]
        return y - D_inv(_inject4(psis, w))

    def solve(b):
        b_hat = to_spectral(b)
        x = wb_apply(b_hat)
        for _ in range(refine):
            x = x + wb_apply(b_hat - A_hat(x))
        return from_spectral(x)

    return solve


def build_woodbury_solver(
    op: AllAtOnceOperator,
    *,
    refine: int = 1,
    layout=None,
    time_transform: Optional[str] = None,
    half_spectrum: Optional[bool] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Direct all-at-once solver ``b -> x`` via the rank-4 Woodbury identity
    in ParaDiag-diagonalized coordinates, on the half spectrum, in plain
    PyTorch, on states ``(..., 2, N_t, n)``. ``time_transform`` ('fft',
    'fft2', 'dft' or 'mxu'; see :func:`make_halfspectrum_transforms`)
    defaults to the packed FFT ('fft2'). ``half_spectrum=False`` solves on
    all N_t bins instead (:func:`_build_woodbury_full`; 'dft', or the FFT
    for 'fft'/'fft2', as in the JAX package).

    ``layout`` (a ``parallel.sharding.ParallelLayout``): the sharded solve of
    one state, b and x canonical blocks (:func:`_build_woodbury_half`); the
    time transform defaults to 'dft' and 'mxu' is refused, as in the JAX
    package."""
    require_full_fp32_matmul()
    sharded = resolve_layout(layout).sharded
    if time_transform is None:
        time_transform = "dft" if sharded else "fft2"
    if time_transform == "mxu" and sharded:
        raise ValueError("time_transform='mxu' is the single-device fast path; sharded runs use 'dft'")
    if half_spectrum is False:
        if time_transform == "mxu":
            raise ValueError("time_transform='mxu' is implemented for the half-spectrum pipeline (the default)")
        return _build_woodbury_full(op, _spectral_plan(op), refine, time_transform, layout=layout)
    return _build_woodbury_half(op, _spectral_plan(op), refine, time_transform=time_transform, layout=layout)


# --------------------------------------------------------------------------
# Physical-space polish
# --------------------------------------------------------------------------


def _two_sum(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Knuth two-sum: ``s + e == a + b`` exactly, ``s = fl(a + b)``, any
    magnitudes. Eager PyTorch evaluates each operation as written, so no
    barrier is needed; do not put this under ``torch.compile``, whose
    algebraic simplification may cancel the error terms (their purpose)."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def build_polished_solver(
    op,
    *,
    refine: int = 1,
    polish: int = 1,
    dword: bool = False,
    time_transform: Optional[str] = None,
    half_spectrum: Optional[bool] = None,
    base_solver: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Callable[[torch.Tensor], object]:
    """Woodbury direct solve + PHYSICAL-space defect correction: the float32
    accuracy path past the spectral ``refine`` ladder, which cannot see the
    rounding of the inverse transforms and of the float32 solution itself.

    ``op`` is any object with ``matvec`` and ``matvec_accurate`` (an
    :class:`AllAtOnceOperator`, or a heat problem). Each ``polish`` step
    measures the defect with the cancellation-aware ``matvec_accurate`` and
    keeps the solution as an unevaluated two-float pair ``(x, e)``:

        r = (b - A_acc x) - A e
        d = W r + e
        x, e = two_sum(x, d)

    ``dword=False`` returns ``x`` (its true residual on the float32
    representation floor); ``dword=True`` returns ``(x, e)``, whose float64
    sum carries the residual below that floor. In float64 polish is a no-op
    to rounding.

    ``base_solver`` substitutes a prebuilt direct solve ``b -> x`` for ``W``
    (the fused CUDA kernel, or a heat solve); ``refine``, ``time_transform``
    and ``half_spectrum`` configure the default-built ``W`` only, so
    combining them with ``base_solver`` is an error."""
    if base_solver is not None and (
        refine != 1 or time_transform is not None or half_spectrum is not None
    ):
        raise ValueError(
            "base_solver carries its own refine/time_transform/half_spectrum; "
            "do not combine it with those arguments"
        )
    W = base_solver or build_woodbury_solver(
        op, refine=refine, time_transform=time_transform, half_spectrum=half_spectrum
    )

    def solve(b: torch.Tensor):
        x = W(b)
        e = torch.zeros_like(x)
        for _ in range(polish):
            r = (b - op.matvec_accurate(x)) - op.matvec(e)
            d = W(r) + e
            x, e = _two_sum(x, d)
        return (x, e) if dword else x

    return solve


# --------------------------------------------------------------------------
# Host-side float64 residual (accuracy oracle for float32 device solves)
# --------------------------------------------------------------------------


def _np_dst_axis(g: np.ndarray, ax: int) -> np.ndarray:
    """DST-I along ``ax`` via the odd-extension FFT identity (numpy, host)."""
    g = np.moveaxis(g, ax, -1)
    n = g.shape[-1]
    z = np.zeros(g.shape[:-1] + (1,), g.dtype)
    ext = np.concatenate([z, g, z, -g[..., ::-1]], axis=-1)
    out = 0.5j * np.fft.fft(ext, axis=-1)[..., 1 : n + 1]
    if not np.iscomplexobj(g):
        out = out.real
    return np.moveaxis(out, -1, ax)


def spectral_relative_residual(op: AllAtOnceOperator, x, b) -> float:
    """``||A x - b|| / ||b||`` evaluated in float64 numpy on the host, in
    spectral coordinates (the combined transform is a scalar multiple of a
    unitary, so the ratio equals the physical one to rounding). It sees the
    true residual of a float32 solution, below the float32 matvec's own
    cancellation noise: the accuracy gate of float32 solves."""
    pl = _spectral_plan(op)
    dim = op.space.dim
    N_t = pl.N_t

    def to_spec(v):
        v = np.fft.ifft(np.asarray(v, np.float64), axis=1)
        g = v.reshape(v.shape[:-1] + op.space.grid_shape)
        for ax in range(-dim, 0):
            g = _np_dst_axis(g, ax)
        return g.reshape(v.shape)

    xh, bh = to_spec(x), to_spec(b)
    a11 = pl.a11_h
    a22 = np.conj(a11)
    tm = pl.theta * pl.muM64[None, :]
    m1, kap1 = pl.muM64, pl.c * pl.muK64
    tm1, mk1 = pl.theta * pl.muM64, pl.muM64 + pl.c * pl.muK64
    k = np.arange(N_t)
    phi = lambda i: np.exp(-2j * np.pi * i * k / N_t)
    psi = lambda i: np.exp(2j * np.pi * i * k / N_t) / N_t

    xu, xp = xh[0], xh[1]
    du = a11 * xu - tm * xp
    dp = tm * xu + a22 * xp
    uNm1 = phi(N_t - 1) @ xu
    uNm2 = phi(N_t - 2) @ xu
    p0 = phi(0) @ xp
    p1 = phi(1) @ xp
    du = du + np.outer(psi(0), m1 * (2.0 * uNm1 - uNm2) - kap1 * uNm2 + 0.5 * tm1 * p0)
    du = du + np.outer(psi(1), -mk1 * uNm1)
    dp = dp + np.outer(psi(N_t - 1), m1 * (2.0 * p0 - p1) - kap1 * p1 - 0.5 * tm1 * uNm1)
    dp = dp + np.outer(psi(N_t - 2), -mk1 * p0)
    r = np.stack([du, dp]) - bh
    return float(np.linalg.norm(r.ravel()) / np.linalg.norm(bh.ravel()))
