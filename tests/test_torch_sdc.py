"""Blocked spectral divide-and-conquer eigensolver of the PyTorch port
(``paradiag/sdc.py``) vs the JAX package's, on the CPU: the five cases of
tests/test_sdc.py run on the port with their gates, small ``base_size`` so
the recursion splits.

The range finder draws from a torch generator, not JAX's PRNG, so V differs
from JAX's by rotations inside split subspaces: the tests compare
eigenvalues (both packages within 1e-4 of max|lam| of each other),
residuals, orthonormality and the solves a basis drives, never V itself.
The host float64 leaf equals JAX's to 1e-12 on the same block."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_control_paradiag_torch import ProblemConfig, WaveControlProblem, native
from optimal_control_paradiag_torch.fem.general import boundary_nodes, make_general_space
from optimal_control_paradiag_torch.models.wave import WaveSolution
from optimal_control_paradiag_torch.paradiag import sdc as t_sdc
from optimal_control_paradiag_torch.paradiag.eigbasis import EigBasisSpace, build_eig_basis, build_eig_direct_fn
from optimal_control_paradiag_torch.paradiag.sdc import pencil_eig_sdc, sdc_eigh
from optimal_control_paradiag_tpu.paradiag import sdc as j_sdc

torch.set_num_threads(1)

needs_native = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is missing: no native host runtime")


def _random_sym(n, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)).astype(np.float32)
    return (A + A.T) / 2


def _perturbed_space(N, dtype, amp=0.18, seed=0):
    """tests/test_sdc.py:60-67's mesh, from the port's own mesh code."""
    pts, tris = native.unit_square_mesh(N, diagonal="left")
    bnd = boundary_nodes(pts.shape[0], tris)
    rng = np.random.default_rng(seed)
    pts = pts.copy()
    pts[~bnd] += rng.uniform(-amp / N, amp / N, size=pts[~bnd].shape)
    return make_general_space(pts, tris, dtype=dtype, device="cpu")


def test_sdc_matches_lapack_eigenvalues():
    """tests/test_sdc.py:22, and the port's eigenvalues within 1e-4 of
    max|lam| of JAX's SDC on the same matrix; ``last_stats`` carries the
    JAX package's keys."""
    S = _random_sym(300)
    lam, V = sdc_eigh(torch.from_numpy(S), base_size=64)
    lam = lam.double().numpy()
    lam_ref = np.linalg.eigvalsh(S.astype(np.float64))
    st = sdc_eigh.last_stats
    assert st["splits"] >= 3
    assert {"splits", "bisect_probes", "max_off", "max_defect", "phase_s"} <= set(st)
    assert {"sign", "split", "leaf", "combine"} <= set(st["phase_s"])
    assert np.all(np.diff(lam) >= -1e-3)
    assert np.max(np.abs(np.sort(lam) - lam_ref)) <= 1e-4 * np.max(np.abs(lam_ref))
    j_lam, _ = j_sdc.sdc_eigh(jnp.asarray(S), base_size=64)
    j_lam = np.asarray(j_lam, np.float64)
    assert np.max(np.abs(j_lam - lam)) <= 1e-4 * np.max(np.abs(j_lam))
    assert st["splits"] == j_sdc.sdc_eigh.last_stats["splits"]


def test_sdc_residual_and_orthogonality():
    """tests/test_sdc.py:32: odd size, uneven splits."""
    S = _random_sym(257, seed=3)
    lam, V = sdc_eigh(torch.from_numpy(S), base_size=48)
    lam, V = lam.double().numpy(), V.double().numpy()
    R = S.astype(np.float64) @ V - V * lam[None, :]
    assert np.linalg.norm(R) / np.linalg.norm(S) <= 5e-5
    assert np.linalg.norm(V.T @ V - np.eye(V.shape[0])) <= 5e-4


@pytest.mark.parametrize("seed", range(5))
def test_sdc_residual_holds_for_every_seed(seed):
    """The gates of tests/test_sdc.py:32 for five range-finder seeds: the
    port's subspace-iteration step (``sdc._range``) keeps the residual at
    rounding size whatever the draw (without it, 8.6e-6 to 3.2e-4 across
    seeds 0-9 at this size: this file's ``__main__``)."""
    S = _random_sym(257, seed=3)
    lam, V = sdc_eigh(torch.from_numpy(S), base_size=48, seed=seed)
    lam, V = lam.double().numpy(), V.double().numpy()
    R = S.astype(np.float64) @ V - V * lam[None, :]
    assert np.linalg.norm(R) / np.linalg.norm(S) <= 5e-5
    assert np.linalg.norm(V.T @ V - np.eye(V.shape[0])) <= 5e-4
    assert sdc_eigh.last_stats["max_off"] <= 1e-5


def test_sdc_base_case_is_direct():
    """tests/test_sdc.py:42: at or below base_size the leaf eigh runs
    directly (against torch's eigh, as JAX's test holds it to its own)."""
    S = _random_sym(50)
    lam, _ = sdc_eigh(torch.from_numpy(S), base_size=64)
    lam_d, _ = torch.linalg.eigh(torch.from_numpy(S))
    np.testing.assert_allclose(lam.numpy(), lam_d.numpy(), rtol=0, atol=1e-5)
    assert sdc_eigh.last_stats["splits"] == 0


@pytest.mark.parametrize("med", [-0.9, 0.0, 0.9])
def test_bisection_bracket_holds_the_spectrum(med):
    """The shift bisection's bracket holds the Gershgorin interval
    [-rbound, rbound] of the spectrum and JAX's window [med - rbound, med +
    rbound]. JAX's window alone misses part of [-rbound, rbound] when the
    diagonal's median is off zero (ADVICE.md, sdc.py:283): the port widens
    it, the divergence this test states."""
    lo, hi = t_sdc._bisection_bracket(med, 1.0)
    assert lo <= min(-1.0, med - 1.0) and hi >= max(1.0, med + 1.0)
    assert (med - 1.0 <= -1.0 and med + 1.0 >= 1.0) == (med == 0.0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_eigh_base_equals_jax(dtype):
    """The host float64 LAPACK leaf on the same block as JAX's, to 1e-12
    (relative max-abs; eigenvectors up to sign)."""
    S = _random_sym(40, seed=5).astype(dtype)
    lam, V = t_sdc._eigh_base(torch.from_numpy(S))
    j_lam, j_V = j_sdc._eigh_base(jnp.asarray(S), 40, 64)
    j_lam, j_V = np.asarray(j_lam, np.float64), np.asarray(j_V, np.float64)
    lam, V = lam.double().numpy(), V.double().numpy()
    assert lam.dtype == j_lam.dtype and V.shape == j_V.shape
    assert np.abs(lam - j_lam).max() <= 1e-12 * np.abs(j_lam).max()
    V = V * np.sign(np.sum(V * j_V, axis=0))[None, :]
    assert np.abs(V - j_V).max() <= 1e-12 * np.abs(j_V).max()


@needs_native
def test_pencil_sdc_matches_host_pencil():
    """tests/test_sdc.py:51: the SDC basis diagonalizes the FEM pencil to
    float32 grade and is M-orthonormal; its eigenvalues within 1e-3 of the
    float64 ones."""
    N = 20
    sp = _perturbed_space(N, torch.float32)
    M, K = sp.M_csr.todense(), sp.K_csr.todense()
    lam, V = pencil_eig_sdc(M, K, torch.float32, base_size=96, device="cpu")
    V = V.double().numpy()
    M64, K64 = M.astype(np.float64), K.astype(np.float64)
    R = K64 @ V - (M64 @ V) * lam[None, :]
    assert np.linalg.norm(R) / np.linalg.norm(K64) <= 5e-3
    assert np.linalg.norm(V.T @ M64 @ V - np.eye(sp.n)) <= 5e-3
    Lc = np.linalg.cholesky(M64)
    lam_ref = np.linalg.eigvalsh(np.linalg.solve(Lc, K64) @ np.linalg.inv(Lc).T)
    assert np.max(np.abs(np.sort(lam) - lam_ref)) <= 1e-3 * lam_ref.max()
    assert sdc_eigh.last_stats["splits"] >= 2
    assert {"congruence", "back_transform"} <= set(sdc_eigh.last_stats["phase_s"])
    j_lam, _ = j_sdc.pencil_eig_sdc(M, K, jnp.float32, base_size=96)
    assert np.max(np.abs(j_lam - lam)) <= 1e-4 * np.abs(j_lam).max()


@needs_native
def test_sdc_basis_drives_richardson_to_floor():
    """tests/test_sdc.py:82: an SDC float32 basis through the 2-step
    Richardson solve reaches the float64-oracle residual floor of a float64
    LAPACK basis (rel <= max(3 x the host basis's, 1e-5))."""
    N, N_t = 16, 16
    sp = _perturbed_space(N, torch.float32)
    prob = WaveControlProblem(ProblemConfig(N_x=N, N_t=N_t, dim=2, dtype=torch.float32), device="cpu", space=sp)
    b = prob.rhs
    lam, V = pencil_eig_sdc(sp.M_csr.todense(), sp.K_csr.todense(), torch.float32, base_size=64, device="cpu")
    basis = EigBasisSpace(base=sp, lam=lam, V=V)
    x, _ = build_eig_direct_fn(prob.operator, basis, steps=2, with_residual=True)(b, basis.V)
    rel = prob.relative_residual_f64(WaveSolution(u=x[0], p=x[1], result=None))
    basis_h = build_eig_basis(sp, method="host")
    xh, _ = build_eig_direct_fn(prob.operator, basis_h, steps=2, with_residual=True)(b, basis_h.V)
    rel_h = prob.relative_residual_f64(WaveSolution(u=xh[0], p=xh[1], result=None))
    assert rel <= max(3.0 * rel_h, 1e-5), (rel, rel_h)


if __name__ == "__main__":
    # CPU measurement of the range finder's subspace-iteration step: the
    # relative eigen-residual of sdc_eigh's basis at p = 257 (base_size 48)
    # for range-finder seeds 0-9, with the step (the port) and with the
    # single CholeskyQR pass of the JAX package, and JAX's own at seed 0.
    #     PYTHONPATH=. python tests/test_torch_sdc.py
    import unittest.mock

    from optimal_control_paradiag_torch.ops.blocked import cholqr2

    S = _random_sym(257, seed=3)

    def single_pass(U, k, lo, seed):
        gen = torch.Generator().manual_seed(int(seed))
        G = torch.randn((U.shape[0], k), generator=gen, dtype=U.dtype)
        return cholqr2(torch.addmm(G, U, G, alpha=-1.0 if lo else 1.0), block=t_sdc._BLOCK)

    def residual(lam, V):
        lam, V = np.asarray(lam, np.float64), np.asarray(V, np.float64)
        return np.linalg.norm(S.astype(np.float64) @ V - V * lam[None, :]) / np.linalg.norm(S)

    for label, patch in (("port (with the step)", None), ("single pass", single_pass)):
        with unittest.mock.patch.object(t_sdc, "_range", patch or t_sdc._range):
            res = [residual(*(t.numpy() for t in sdc_eigh(torch.from_numpy(S), base_size=48, seed=sd)))
                   for sd in range(10)]
        print(f"{label}: residual min {min(res):.2e} median {np.median(res):.2e} max {max(res):.2e}")
    print(f"JAX package, seed 0: residual {residual(*j_sdc.sdc_eigh(jnp.asarray(S), base_size=48)):.2e}")
