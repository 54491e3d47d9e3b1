"""The generalized-eigenbasis solve of triangle meshes on the card against
the CPU. These tests need a CUDA card; they skip without one. The file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda_eigbasis.py -q

Gates: the card's 'device' (cuSOLVER) and 'sdc' bases against the host
float64 basis at n = 400 as tests/test_sdc.py:51-79 holds a float32 basis
(||K V - M V lam|| / ||K|| <= 5e-3, ||V^T M V - I|| <= 5e-3, eigenvalues
within 1e-3 of lam_max); the Richardson and eig GMRES solves on the card
against the same solves on the CPU on the same basis: the same step or
iteration count, x 1e-5 apart (float32, relative max-abs: cuBLAS and the
CPU's BLAS order the sums differently) and 1e-10 apart (float64)."""

import numpy as np
import pytest
import torch

from optimal_control_paradiag_torch import LagrangianWaveProblem, ProblemConfig, SolverConfig, WaveControlProblem, native
from optimal_control_paradiag_torch.fem.general import boundary_nodes, make_general_space
from optimal_control_paradiag_torch.interop import eig_basis_from_arrays
from optimal_control_paradiag_torch.paradiag.eigbasis import (
    build_eig_basis,
    build_eig_direct_fn,
    build_eig_gmres_solver,
    resolve_eig_method,
)
from optimal_control_paradiag_torch.paradiag.sdc import sdc_eigh

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _mesh(N, seed=0, amp=0.18):
    pts, tris = native.unit_square_mesh(N, diagonal="left")
    bnd = boundary_nodes(pts.shape[0], tris)
    pts = pts.copy()
    pts[~bnd] += np.random.default_rng(seed).uniform(-amp / N, amp / N, size=pts[~bnd].shape)
    return pts, tris


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("method,kw", [("device", {}), ("sdc", {"base_size": 128})], ids=["device", "sdc"])
def test_card_basis_against_host(cuda, method, kw):
    """n = 400: the card's basis diagonalizes the pencil to float32 grade
    and is M-orthonormal; its eigenvalues match the host float64 ones."""
    pts, tris = _mesh(21)
    sp = make_general_space(pts, tris, dtype=torch.float32, device=cuda)
    assert sp.n == 400
    basis = build_eig_basis(sp, method=method, **kw)
    assert basis.V.device.type == "cuda" and basis.V.dtype == torch.float32
    assert basis.quality == ("f32_sdc" if method == "sdc" else "f32")
    if method == "sdc":
        assert sdc_eigh.last_stats["splits"] >= 2
    host = build_eig_basis(make_general_space(pts, tris, dtype=torch.float64, device="cpu"), method="host")
    M = sp.M_csr.todense().astype(np.float64)
    K = sp.K_csr.todense().astype(np.float64)
    V = basis.V.double().cpu().numpy()
    assert np.linalg.norm(K @ V - (M @ V) * basis.lam[None, :]) / np.linalg.norm(K) <= 5e-3
    assert np.linalg.norm(V.T @ M @ V - np.eye(sp.n)) <= 5e-3
    assert np.abs(basis.lam - host.lam).max() <= 1e-3 * host.lam.max()


@pytest.mark.cuda
def test_auto_takes_cusolver_on_the_card(cuda):
    """'auto' is 'host' up to n = 1500 and 'device' above on a card space;
    'torch' on a CPU space."""
    small = make_general_space(*_mesh(8), dtype=torch.float32, device=cuda)
    big = make_general_space(*_mesh(40), dtype=torch.float32, device=cuda)
    big_cpu = make_general_space(*_mesh(40), dtype=torch.float32, device="cpu")
    assert resolve_eig_method(small) == "host"
    assert resolve_eig_method(big) == "device"
    assert resolve_eig_method(big_cpu) == "torch"


def _pair(N, N_t, dtype, cuda):
    pts, tris = _mesh(N)
    return [WaveControlProblem(ProblemConfig(N_x=N, N_t=N_t, dim=2, dtype=dtype), device=dev,
                               space=make_general_space(pts, tris, dtype=dtype, device=dev))
            for dev in (cuda, "cpu")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_richardson_and_eig_gmres_on_card_match_cpu(cuda, dtype):
    """The Richardson solve and eig GMRES on one (host float64) basis,
    card against CPU: the same counts, x as the module docstring says."""
    gp, cp = _pair(16, 16, dtype, cuda)
    host = build_eig_basis(cp.space, method="host")
    tol = 1e-5 if dtype == torch.float32 else 1e-10
    out = {}
    for p in (gp, cp):
        b = eig_basis_from_arrays(p.space, host.lam, host.V.numpy(), "f32")
        x, rel = build_eig_direct_fn(p.operator, b, steps=2, with_residual=True)(p.rhs, b.V)
        xg, res = build_eig_gmres_solver(p.operator, b, rtol=1e-5 if dtype == torch.float32 else 1e-10,
                                         with_result=True)(p.rhs)
        out[p.device.type] = (x, float(rel), xg, int(res.iterations))
    (x_g, rel_g, xg_g, it_g), (x_c, rel_c, xg_c, it_c) = out["cuda"], out["cpu"]
    assert x_g.device.type == "cuda"
    assert _rel(x_g, x_c) <= tol and _rel(xg_g, xg_c) <= tol
    assert it_g == it_c
    assert rel_g <= 5e-4 and rel_c <= 5e-4


@pytest.mark.cuda
def test_entry_point_richardson_route_on_card(cuda):
    """``method='woodbury'`` on a float32 mesh above n = 2000 on the card:
    the 'device' basis built once, 2 steps, converged, the float64 oracle
    residual <= 5e-4, and the batched solve on the same basis."""
    pts, tris = _mesh(47)
    p = WaveControlProblem(ProblemConfig(N_x=47, N_t=8, dim=2, dtype=torch.float32), device=cuda,
                           space=make_general_space(pts, tris, dtype=torch.float32, device=cuda))
    sol = p.solve(SolverConfig(method="woodbury"))
    assert p._eig_basis.quality == "f32" and p._eig_basis.V.device.type == "cuda"
    assert int(sol.result.iterations) == 2 and bool(sol.result.converged)
    assert p.relative_residual_f64(sol) <= 5e-4
    assert {"dense", "congruence", "eigh", "back_transform"} <= set(p.eig_setup_s)
    xs, res = p.make_batched_solver_fn(SolverConfig(method="woodbury"))(torch.stack([p.rhs, -p.rhs]))
    assert res.iterations.tolist() == [2, 2] and bool(res.converged.all())
    assert _rel(xs[1], -xs[0]) <= 1e-6


@pytest.mark.cuda
def test_lagrangian_on_card_matches_cpu(cuda):
    """The autodiff-Lagrangian 'direct' solve (float64) on the card and on
    the CPU: u 1e-10 apart, the same error."""
    sols = [LagrangianWaveProblem(ProblemConfig(N_x=8, N_t=8, scaled=False), device=dev) for dev in (cuda, "cpu")]
    (sg, sc) = (p.solve() for p in sols)
    assert _rel(sg.u, sc.u) <= 1e-10
    assert abs(sols[0].error_vs_analytic(sg) - sols[1].error_vs_analytic(sc)) <= 1e-10
