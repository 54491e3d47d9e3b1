"""Generalized-eigenbasis ParaDiag: the direct solve of triangle meshes
(PyTorch).

The counterpart of ``optimal_control_paradiag_tpu/paradiag/eigbasis.py``.
No fast transform diagonalizes the mass and stiffness of a general mesh, and
every iterative route through the block-circulant part inherits the
outliers of the non-commuting (M, K) (the JAX package measures 119 / 187 /
284 GMRES iterations at n = 529 / 961 / 2209 with the blockband
preconditioner at N_t = 64). Instead, compute the generalized
eigendecomposition of the pencil once,

    K V = M V diag(lam),     V^T M V = I,

and the exact spectral machinery (``paradiag/spectral.py``: per-mode 2x2
Cramer, rank-4 Woodbury with 4x4 capacities) applies verbatim with ``(muM,
muK) = (1, lam)``: a direct solve. The residual-side transform is ``V^T``
and the solution-side transform ``V`` (inverse to each other only through
M); both are dense GEMMs.

A float32 basis is the exact eigenbasis of a ~1e-5-perturbed pencil, so its
Woodbury apply is the exact inverse of a nearby operator: used as the left
preconditioner of GMRES on the true operator (the cancellation-aware
matvec) it converges in a handful of mesh-independent iterations
(:func:`build_eig_gmres_solver`), or as fixed-step Richardson defect
correction (:func:`build_eig_direct_solver`, :func:`build_eig_direct_fn`).

The pencil eigensolvers are host float64 numpy (``'host'``), torch's CPU
LAPACK (``'torch'``), cuSOLVER on the space's device (``'device'``) and the
blocked spectral divide-and-conquer of ``paradiag/sdc.py`` (``'sdc'``).
Every solver takes states with leading batch axes ``(..., 2, N_t, n)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from optimal_control_paradiag_torch.ops.allatonce import AllAtOnceOperator
from optimal_control_paradiag_torch.paradiag.spectral import build_woodbury_solver
from optimal_control_paradiag_torch.paradiag.woodbury2d import solve_lanes
from optimal_control_paradiag_torch.utils.constants import host_const, to_device
from optimal_control_paradiag_torch.utils.timing import StageTimer

# The basis size up to which 'auto' takes the host float64 LAPACK basis,
# and above which the wave model's default mesh route switches from eig
# GMRES to the Richardson solve (the JAX package's thresholds).
AUTO_HOST_MAX_N = 1500
RICHARDSON_MIN_N = 2000


def pencil_eig_host(M: np.ndarray, K: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(lam, V) of ``K V = M V diag(lam)`` with ``V^T M V = I``, float64
    numpy on the host via the Cholesky congruence (the small/test path)."""
    M = np.asarray(M, np.float64)
    K = np.asarray(K, np.float64)
    L = np.linalg.cholesky(M)
    X = np.linalg.solve(L, K)
    S = np.linalg.solve(L, X.T).T
    S = 0.5 * (S + S.T)
    lam, Q = np.linalg.eigh(S)
    V = np.linalg.solve(L.T, Q)
    return lam, V


def pencil_eig_torch(M: np.ndarray, K: np.ndarray, f32: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """(lam, V) via torch's multithreaded LAPACK on the host, in float32
    (``f32``) or float64: the JAX package's ``pencil_eig_torch`` verbatim."""
    npd = np.float32 if f32 else np.float64
    Mt = torch.from_numpy(np.ascontiguousarray(M, npd))
    Kt = torch.from_numpy(np.ascontiguousarray(K, npd))
    L = torch.linalg.cholesky(Mt)
    X = torch.linalg.solve_triangular(L, Kt, upper=False)
    S = torch.linalg.solve_triangular(L, X.T, upper=False).T
    S = 0.5 * (S + S.T)
    lam, Q = torch.linalg.eigh(S)
    V = torch.linalg.solve_triangular(L.T, Q, upper=True)
    return lam.numpy().astype(np.float64), V.numpy()


def pencil_eig_device(M: torch.Tensor, K: torch.Tensor, timings: Optional[dict] = None) -> Tuple[np.ndarray, torch.Tensor]:
    """(lam, V) on the tensors' device in their dtype: ``torch.linalg``'s
    Cholesky, triangular congruence and ``eigh`` (cuSOLVER on a CUDA card).
    Returns ``lam`` as float64 numpy (the host capacity math) and ``V`` on
    the device. ``timings``: a dict that receives the seconds of the
    ``congruence`` (Cholesky and both triangular solves), ``eigh`` and
    ``back_transform``, each fenced on the device."""
    timer = StageTimer(timings)
    with timer.stage("congruence") as out:
        L = torch.linalg.cholesky(M)
        X = torch.linalg.solve_triangular(L, K, upper=False)
        S = torch.linalg.solve_triangular(L, X.mT, upper=False).mT
        del X
        out["fence"] = S = 0.5 * (S + S.mT)
    with timer.stage("eigh") as out:
        lam, Q = _eigh(S)
        out["fence"] = Q
    del S
    with timer.stage("back_transform") as out:
        out["fence"] = V = torch.linalg.solve_triangular(L.mT, Q, upper=True)
    return lam.cpu().numpy().astype(np.float64), V


# Up to this size torch sends a float32 CUDA eigh to cuSOLVER's Jacobi
# solver (syevj), which leaves a FEM pencil's standard form far less
# accurate than the divide-and-conquer syevd it uses above: ||S Q - Q lam|| /
# ||S|| 1.6e-4 and ||Q^T Q - I|| 3.5e-3 at n = 400, against 8.7e-7 and
# 5.0e-5 at n = 961 (chip_smoke phase 32, ``eigh_jacobi_range``; NVIDIA H100
# 80GB HBM3, 700.00 W). Such blocks are solved in float64 on the card.
_CUDA_F32_JACOBI_MAX_N = 512


def _eigh(S: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``torch.linalg.eigh(S)`` in S's dtype, except a float32 CUDA block of
    at most ``_CUDA_F32_JACOBI_MAX_N`` rows, which is solved in float64 on
    its device (see above) and cast back."""
    if S.is_cuda and S.dtype == torch.float32 and S.shape[-1] <= _CUDA_F32_JACOBI_MAX_N:
        lam, Q = torch.linalg.eigh(S.double())
        return lam.float(), Q.float()
    return torch.linalg.eigh(S)


@dataclasses.dataclass(frozen=True)
class EigBasisSpace:
    """A diagonalizable 'space' over a general mesh: it delegates the
    physical operators to the underlying space and supplies the eigenbasis
    transforms and spectrum that the spectral/Woodbury machinery reads
    (``paradiag.spectral._spectral_plan``: ``spectrum, dst, idst, dtype,
    device``)."""

    base: Any  # a fem.general.GeneralP1Space (any space with the applies)
    lam: np.ndarray  # (n,) float64 generalized eigenvalues
    V: torch.Tensor  # (n, n) on the base space's device, columns M-orthonormal
    # Provenance, for the Richardson step count (default_richardson_steps):
    # 'f64' host LAPACK, direct at 0 steps; 'f32' LAPACK-grade, floors in
    # 2; 'f32_sdc' divide-and-conquer, contracts ~0.18 per step, floors in
    # 8 (the JAX package's measured ladder at n = 20449).
    quality: str = "f32"

    diagonalizable: bool = True

    @property
    def dim(self) -> int:
        return self.base.dim

    @property
    def n(self) -> int:
        return self.base.n

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def spectrum(self):
        """(muM, muK) = (1, lam), cast to the working dtype as the JAX
        package casts them."""
        return (host_const(np.ones(self.base.n), self.dtype), host_const(self.lam, self.dtype))

    # the physical-side operators delegate to the true space
    def apply_mass(self, x):
        return self.base.apply_mass(x)

    def apply_stiffness(self, x):
        return self.base.apply_stiffness(x)

    def apply_stiffness_nested(self, x):
        return self.base.apply_stiffness_nested(x)

    def apply_mass_host_f64(self, x):
        return self.base.apply_mass_host_f64(x)

    def apply_stiffness_host_f64(self, x):
        return self.base.apply_stiffness_host_f64(x)

    def interpolate(self, fn):
        return self.base.interpolate(fn)

    @property
    def coords(self):
        return self.base.coords

    def _mm(self, x: torch.Tensor, transpose: bool) -> torch.Tensor:
        """``V^T x`` (``transpose``) or ``V x`` over the last axis: one GEMM,
        a complex input as its two real planes stacked into one GEMM. The
        sharded Woodbury solve calls it on ``mode_local`` blocks (every
        spatial unknown local, the time rows or bins split over the ranks),
        so each rank multiplies its rows by the whole V and nothing is
        gathered."""
        Vm = self.V if transpose else self.V.mT
        if x.is_complex():
            y = torch.stack([x.real, x.imag]) @ Vm
            return torch.complex(y[0], y[1])
        return x @ Vm

    def dst(self, x: torch.Tensor) -> torch.Tensor:
        """Residual-side transform ``V^T x`` (the eigenbasis analogue of the
        sine transform on the dual side)."""
        return self._mm(x, transpose=True)

    def idst(self, x: torch.Tensor) -> torch.Tensor:
        """Solution-side transform ``V x``."""
        return self._mm(x, transpose=False)


def dense_pencil(space, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense (M, K) of a general space, built on ``device`` (the space's
    by default) in the space's dtype from its CSR data: the same entries as
    the JAX package's ``to_device(np.asarray(M_csr.todense(), float64),
    dtype)``, without the host float64 copies."""
    dev = space.device if device is None else torch.device(device)

    def dense(csr):
        n = csr.shape[0]
        rows = torch.from_numpy(np.repeat(np.arange(n), np.diff(csr.indptr))).to(dev)
        cols = torch.from_numpy(csr.indices.astype(np.int64)).to(dev)
        vals = to_device(np.asarray(csr.data, np.float64), space.dtype, dev)
        out = torch.zeros((n, n), dtype=space.dtype, device=dev)
        return out.index_put_((rows, cols), vals, accumulate=True)

    return dense(space.M_csr), dense(space.K_csr)


def resolve_eig_method(space, method: str = "auto") -> str:
    """The pencil eigensolver of ``method`` for ``space``: 'auto' is 'host'
    up to n = 1500; above, 'device' (cuSOLVER) on a CUDA space and 'torch'
    (CPU LAPACK) otherwise. The JAX package's 'auto' picks 'sdc' on a TPU,
    whose monolithic eigh does not compile at scale; cuSOLVER's does, so the
    card takes 'device'."""
    if method != "auto":
        return method
    if space.n <= AUTO_HOST_MAX_N:
        return "host"
    return "device" if torch.device(space.device).type == "cuda" else "torch"


def build_eig_basis(space, method: str = "auto", timings: Optional[dict] = None, **sdc_kwargs) -> EigBasisSpace:
    """The pencil eigenbasis of a general space (:func:`resolve_eig_method`):

    - 'host': float64 numpy (exact to rounding; quality 'f64' on a float64
      space, 'f32' on a float32 one, whose V is rounded);
    - 'torch': torch's CPU LAPACK in the space's precision (quality 'f32');
    - 'device': ``torch.linalg`` on the space's device (cuSOLVER on the
      card; quality 'f32'). It raises where it fails: there is no fallback;
    - 'sdc': ``paradiag/sdc.py`` on the space's device (quality 'f32_sdc';
      ``sdc_kwargs``: ``base_size``, ``seed``).

    Every method starts from the CSR entries of the space's dtype, cast to
    float64 on the host methods, as the JAX package does. ``timings``: a
    dict that receives the seconds of ``dense`` (building M and K),
    ``congruence`` (the card's methods), ``eigh`` (for 'sdc': the whole
    divide and conquer) and ``back_transform`` (ending with V on the
    space's device), each fenced on the device."""
    method = resolve_eig_method(space, method)
    if method not in ("host", "torch", "device", "sdc"):
        raise ValueError(f"unknown eig method {method!r}")
    dtype, dev = space.dtype, space.device
    timer = StageTimer(timings)
    if method in ("host", "torch"):
        with timer.stage("dense"):
            M, K = space.M_csr.todense(), space.K_csr.todense()
        with timer.stage("eigh"):
            if method == "host":
                lam, V = pencil_eig_host(M, K)
                quality = "f64" if dtype == torch.float64 else "f32"
            else:
                lam, V = pencil_eig_torch(M, K, f32=dtype == torch.float32)
                quality = "f32"
        with timer.stage("back_transform") as out:
            out["fence"] = Vd = to_device(V, dtype, dev)
        return EigBasisSpace(base=space, lam=lam, V=Vd, quality=quality)
    with timer.stage("dense") as out:
        M, K = dense_pencil(space)
        out["fence"] = K
    if method == "device":
        lam, Vd = pencil_eig_device(M, K, timings=timer.records)
        return EigBasisSpace(base=space, lam=lam, V=Vd, quality="f32")
    from optimal_control_paradiag_torch.paradiag.sdc import pencil_eig_sdc, sdc_eigh

    lam, Vd = pencil_eig_sdc(M, K, dtype, device=dev, **sdc_kwargs)
    ph = sdc_eigh.last_stats["phase_s"]
    timer.records.update(congruence=ph["congruence"], back_transform=ph["back_transform"],
                         eigh=sum(ph[k] for k in ("sign", "split", "leaf", "combine")))
    return EigBasisSpace(base=space, lam=lam, V=Vd, quality="f32_sdc")


def default_richardson_steps(basis: EigBasisSpace) -> int:
    """Step count that reaches each basis grade's accuracy floor (see
    :attr:`EigBasisSpace.quality`)."""
    return {"f64": 0, "f32": 2}.get(getattr(basis, "quality", "f32_sdc"), 8)


def save_eig_basis(path: str, basis: EigBasisSpace) -> str:
    """Persist the pencil eigenbasis (the expensive setup artifact):
    :func:`load_eig_basis` restores it for any number of later solves on the
    same mesh. The file holds ``lam``, ``V`` and ``quality``; the JAX
    package's files lack ``quality`` (ROADMAP Queue C)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    np.savez_compressed(path, lam=basis.lam, V=basis.V.detach().cpu().numpy(), quality=np.asarray(basis.quality))
    return path


def load_eig_basis(path: str, space) -> EigBasisSpace:
    """Restore a basis saved by :func:`save_eig_basis` (or by the JAX
    package's, which loads as quality 'f32', its default) onto ``space``,
    which must be the same mesh (checked by shape), in its dtype and on its
    device."""
    from optimal_control_paradiag_torch.interop import eig_basis_from_arrays

    z = np.load(path)
    quality = str(z["quality"]) if "quality" in z.files else "f32"
    return eig_basis_from_arrays(space, z["lam"], z["V"], quality)


def build_eig_woodbury_solver(
    op: AllAtOnceOperator,
    basis: Optional[EigBasisSpace] = None,
    *,
    refine: int = 1,
    eig_method: str = "auto",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Direct solver ``b -> x`` of the all-at-once system on a general mesh:
    the rank-4 half-spectrum Woodbury solve (``paradiag/spectral.py``) over
    the pencil eigenbasis. Exact to the quality of the eigendecomposition
    (float64 host basis: direct to rounding; float32 basis: the exact
    inverse of a ~1e-5-perturbed operator, see
    :func:`build_eig_gmres_solver`)."""
    sp = op.space
    if sp.diagonalizable:
        raise ValueError("sine-diagonalizable space: use the spectral Woodbury directly")
    if basis is None:
        basis = build_eig_basis(sp, method=eig_method)
    return build_woodbury_solver(dataclasses.replace(op, space=basis), refine=refine)


def build_eig_direct_solver(
    op: AllAtOnceOperator,
    basis: Optional[EigBasisSpace] = None,
    *,
    steps: int = 2,
    eig_method: str = "auto",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Richardson form of the direct solve: ``x = W b`` plus ``steps``
    defect corrections ``x += W (b - A_acc x)`` with the cancellation-aware
    matvec. A float32 LAPACK basis floors in 2 steps; a float64 basis is
    exact at 0."""
    W = build_eig_woodbury_solver(op, basis, refine=0, eig_method=eig_method)

    def solve(b: torch.Tensor) -> torch.Tensor:
        x = W(b)
        for _ in range(steps):
            x = x + W(b - op.matvec_accurate(x))
        return x

    return solve


def build_eig_direct_fn(
    op: AllAtOnceOperator,
    basis: EigBasisSpace,
    *,
    steps: int = 2,
    with_residual: bool = False,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Argument-form Richardson solve ``fn(b, V) -> x``, the basis matrix an
    explicit argument: the JAX package's API (there it keeps a multi-GB V
    out of the compiled program's constants). Here it is a plain function;
    the Woodbury solve over ``V`` is built on the first call and kept while
    later calls pass the same tensor.

    ``with_residual``: also return the a-posteriori relative residual
    ``||b - A_acc x|| / ||b||`` per system (one more accurate matvec; a
    batch gives B values), on the device, the certificate of the
    fixed-step solve (it is not adaptive: rtol/maxiter do not apply)."""
    built = {}

    def fn(b: torch.Tensor, V: torch.Tensor):
        if built.get("V") is not V:
            W = build_woodbury_solver(dataclasses.replace(op, space=dataclasses.replace(basis, V=V)), refine=0)
            built.update(V=V, W=W)
        W = built["W"]
        x = W(b)
        for _ in range(steps):
            x = x + W(b - op.matvec_accurate(x))
        if with_residual:
            lead = b.shape[:-3]
            r = b - op.matvec_accurate(x)
            rel = torch.linalg.norm(r.reshape(lead + (-1,)), dim=-1) / torch.linalg.norm(b.reshape(lead + (-1,)), dim=-1)
            return x, rel
        return x

    return fn


def build_eig_gmres_solver(
    op: AllAtOnceOperator,
    basis: Optional[EigBasisSpace] = None,
    *,
    rtol: float = 1e-10,
    maxiter: int = 40,
    eig_method: str = "auto",
    with_result: bool = False,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Mesh-independent solve of a general mesh: GMRES on the true operator
    (the cancellation-aware matvec in float32) left-preconditioned by the
    exact eig-Woodbury solve. A float64 host basis makes the preconditioner
    the exact inverse (1 iteration); a float32 basis gives a mesh-
    independent handful. ``solve(b)`` returns x, or ``(x, GmresResult)``
    with ``with_result``; a batch ``(B, 2, N_t, n)`` gets per-lane
    records."""
    W = build_eig_woodbury_solver(op, basis, refine=0, eig_method=eig_method)
    mv = op.matvec_accurate if op.space.dtype == torch.float32 else op.matvec

    def solve(b: torch.Tensor):
        res = solve_lanes(mv, b, 3, M=W, restart=maxiter, rtol=rtol, maxiter=maxiter)
        return (res.x, res) if with_result else res.x

    return solve
