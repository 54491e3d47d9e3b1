"""The generalized-eigenbasis solve of the PyTorch port
(``paradiag/eigbasis.py``, and the triangle-mesh route of
``WaveControlProblem``'s ``method='woodbury'``) vs the JAX package's, on
the CPU, on one perturbed mesh per case and the same data: the cases of
tests/test_eigbasis.py, each run in both packages, and the mesh's entry
point just above the Richardson threshold (n = 2116).

Tolerances (relative max-abs, ``|a - b|.max() <= tol * |a|.max()``): the
host pencil basis 1e-12 against JAX's; the float64 eig Woodbury solve
1e-11 against JAX's on the same basis and 1e-9 absolute against the dense
LU; eig GMRES JAX's iteration count, x 1e-10 (float64); float32 solves
JAX's iteration and step counts, x 1e-5 against JAX's on the same basis
(XLA and torch order the float32 FFT and GEMM sums differently; measured
at most 2e-6)."""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optimal_control_paradiag_tpu as J
from optimal_control_paradiag_torch import SolverConfig, native
from optimal_control_paradiag_torch.fem.general import boundary_nodes, make_general_space
from optimal_control_paradiag_torch.interop import eig_basis_from_arrays, problem_from_jax
from optimal_control_paradiag_torch.models.wave import WaveSolution
from optimal_control_paradiag_torch.paradiag.eigbasis import (
    build_eig_basis,
    build_eig_direct_fn,
    build_eig_direct_solver,
    build_eig_gmres_solver,
    build_eig_woodbury_solver,
    default_richardson_steps,
    dense_pencil,
    load_eig_basis,
    pencil_eig_host,
    resolve_eig_method,
    save_eig_basis,
)
from optimal_control_paradiag_torch.paradiag.spectral import build_polished_solver
from optimal_control_paradiag_tpu.fem.general import make_general_space as j_make_general_space
from optimal_control_paradiag_tpu.paradiag import eigbasis as j_eig

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is missing: no native host runtime")


def _close(ref, got, tol):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert ref.shape == got.shape
    assert np.abs(ref - got).max() <= tol * np.abs(ref).max()


def _mesh(N, seed=0, amp=0.18):
    """tests/test_eigbasis.py:26's perturbed square, from the port's mesh
    code."""
    pts, tris = native.unit_square_mesh(N, diagonal="left")
    bnd = boundary_nodes(pts.shape[0], tris)
    rng = np.random.default_rng(seed)
    pts = pts.copy()
    pts[~bnd] += rng.uniform(-amp / N, amp / N, size=pts[~bnd].shape)
    return pts, tris


def _pair(N, N_t, f32=False, seed=0):
    """(JAX problem, port problem on the CPU) on one perturbed mesh with
    the same data; the port's space comes through the interop's mesh."""
    pts, tris = _mesh(N, seed)
    jdt = jnp.float32 if f32 else jnp.float64
    jcfg = J.ProblemConfig(N_x=N, N_t=N_t, dim=2, dtype=jdt)
    jp = J.WaveControlProblem(jcfg, space=j_make_general_space(pts, tris, dtype=jdt))
    tp = problem_from_jax(dataclasses.asdict(jcfg), {k: np.asarray(v) for k, v in jp._data.items()},
                          device="cpu", mesh={"points": pts, "triangles": tris})
    return jp, tp


def _shared_basis(jp, tp, method="host"):
    """JAX's basis of the mesh, and the same arrays carried into the port
    (the interop's ``eig_basis_from_arrays``)."""
    jb = j_eig.build_eig_basis(jp.space, method=method)
    return jb, eig_basis_from_arrays(tp.space, jb.lam, np.asarray(jb.V), jb.quality)


def _x(sol):
    return np.stack([np.asarray(sol.u, np.float64), np.asarray(sol.p, np.float64)])


def test_pencil_eig_host_matches_jax():
    """tests/test_eigbasis.py:35, and the basis equal to JAX's to 1e-12."""
    jp, tp = _pair(8, 4)
    M, K = tp.space.M_csr.todense(), tp.space.K_csr.todense()
    lam, V = pencil_eig_host(M, K)
    np.testing.assert_allclose(V.T @ M @ V, np.eye(tp.space.n), atol=1e-12)
    np.testing.assert_allclose(V.T @ K @ V, np.diag(lam), atol=1e-11)
    assert lam.min() > 0
    j_lam, j_V = j_eig.pencil_eig_host(jp.space.mass_dense(), jp.space.stiffness_dense())
    _close(j_lam, lam, 1e-12)
    _close(j_V, V, 1e-12)
    basis = build_eig_basis(tp.space, method="host")
    assert basis.quality == "f64" and basis.V.device.type == "cpu"
    _close(j_V, basis.V, 1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dense_pencil_equals_csr(dtype):
    """The dense (M, K) the card's methods build from the CSR entries,
    equal to the host ``todense`` the host methods use (JAX's pencil
    input)."""
    sp = make_general_space(*_mesh(7), dtype=dtype, device="cpu")
    M, K = dense_pencil(sp)
    assert M.dtype == dtype and K.dtype == dtype
    np.testing.assert_array_equal(M.numpy(), sp.M_csr.todense())
    np.testing.assert_array_equal(K.numpy(), sp.K_csr.todense())


def test_adapter_transforms():
    """tests/test_eigbasis.py:44: dst = V^T (residual side), idst = V
    (solution side): ``V diag(shift + lam)^-1 V^T`` is ``(shift M + K)^-1``;
    complex inputs through the stacked planes."""
    _, tp = _pair(7, 4)
    sp = tp.space
    basis = build_eig_basis(sp, method="host")
    r = torch.from_numpy(np.random.default_rng(1).standard_normal((3, sp.n)))
    lam = torch.from_numpy(basis.lam)
    y = basis.idst(basis.dst(r) / (0.3 + lam))
    A = 0.3 * sp.M_csr.todense() + sp.K_csr.todense()
    np.testing.assert_allclose(y.numpy(), np.linalg.solve(A, r.numpy().T).T, atol=1e-10)
    z = torch.complex(r, 2.0 * r)
    np.testing.assert_allclose(basis.dst(z).imag.numpy(), 2.0 * basis.dst(r).numpy(), atol=1e-12)
    np.testing.assert_allclose(basis.idst(z).real.numpy(), basis.idst(r).numpy(), atol=1e-12)
    assert basis.device == sp.device and basis.dtype == sp.dtype and basis.diagonalizable


def test_eig_woodbury_direct_f64():
    """tests/test_eigbasis.py:59: the eig Woodbury is a direct solve on a
    general mesh; against JAX's on the same basis (1e-11) and the dense LU
    (1e-9)."""
    jp, tp = _pair(9, 10)
    jb, tb = _shared_basis(jp, tp)
    x = build_eig_woodbury_solver(tp.operator, tb, refine=1)(tp.rhs)
    rel = tp.relative_residual_f64(WaveSolution(u=x[0], p=x[1], result=None))
    assert rel < 1e-11, rel
    jx = jax.jit(j_eig.build_eig_woodbury_solver(jp.operator, jb, refine=1))(jp.rhs)
    _close(jx, x, 1e-11)
    A = tp.operator.dense().numpy()
    x_lu = np.linalg.solve(A, tp.rhs.numpy().reshape(-1)).reshape(x.shape)
    np.testing.assert_allclose(x.numpy(), x_lu, atol=1e-9)
    # the port's own basis gives the same solve
    x2 = build_eig_woodbury_solver(tp.operator, refine=1, eig_method="host")(tp.rhs)
    _close(x, x2, 1e-11)


def test_eig_gmres_one_iteration_f64():
    """tests/test_eigbasis.py:73: JAX's iteration count, x 1e-10."""
    jp, tp = _pair(16, 32)
    jb, tb = _shared_basis(jp, tp)
    x, res = build_eig_gmres_solver(tp.operator, tb, rtol=1e-10, with_result=True)(tp.rhs)
    jx, jres = jax.jit(j_eig.build_eig_gmres_solver(jp.operator, jb, rtol=1e-10, with_result=True))(jp.rhs)
    assert int(res.iterations) == int(jres.iterations) <= 2
    assert tp.relative_residual_f64(WaveSolution(u=x[0], p=x[1], result=res)) < 1e-10
    _close(jx, x, 1e-10)


def test_eig_gmres_batched_lanes():
    """A batch (B, 2, N_t, n) through eig GMRES: per-lane records, each
    lane the single solve's count and x."""
    _, tp = _pair(8, 8, f32=True)
    solve = build_eig_gmres_solver(tp.operator, rtol=1e-5, eig_method="host", with_result=True)
    bs = torch.stack([tp.rhs, -0.5 * tp.rhs, tp.rhs.flip(-1)])
    xs, res = solve(bs)
    assert res.iterations.shape == (3,)
    for i in range(3):
        x, r = solve(bs[i])
        assert int(res.iterations[i]) == int(r.iterations)
        _close(x, xs[i], 1e-6)


def test_dispatch_unstructured_woodbury_f32():
    """tests/test_eigbasis.py:84: ``method='woodbury'`` on a float32 mesh
    routes to eig GMRES (n <= 2000); the residual at the float32 working
    level, x against JAX's route, and the route's GMRES count equal to
    JAX's (both at the route's tolerance, 1e-5, on the same basis)."""
    jp, tp = _pair(16, 32, f32=True)
    sol = tp.solve(SolverConfig(method="woodbury"))
    assert tp.relative_residual_f64(sol) < 5e-4
    jsol = jp.solve(J.SolverConfig(method="woodbury"))
    _close(_x(jsol), _x(sol), 1e-5)
    assert tp.space.n <= 1500 and resolve_eig_method(tp.space) == "host"  # as JAX's 'auto'
    jb, tb = _shared_basis(jp, tp)
    _, res = build_eig_gmres_solver(tp.operator, tb, rtol=1e-5, with_result=True)(tp.rhs)
    _, jres = jax.jit(j_eig.build_eig_gmres_solver(jp.operator, jb, rtol=1e-5, with_result=True))(jp.rhs)
    assert int(res.iterations) == int(jres.iterations)


def test_polish_ladder_unstructured_f32():
    """tests/test_eigbasis.py:98: the polish/dword ladder on a general mesh
    drops the float64-oracle residual below the plain float32 solve's
    (gate 5e-6), as in the JAX package on the same basis."""
    jp, tp = _pair(16, 32, f32=True)
    jb, tb = _shared_basis(jp, tp)
    base = build_eig_gmres_solver(tp.operator, tb, rtol=1e-5)
    x, e = build_polished_solver(tp.operator, polish=1, dword=True, base_solver=base)(tp.rhs)
    xs = x.double().numpy() + e.double().numpy()
    b = tp.rhs.double().numpy()

    def rel(v):
        r = tp.operator.matvec_host_f64(v) - b
        return float(np.linalg.norm(r.ravel()) / np.linalg.norm(b.ravel()))

    rel_plain, rel_dword = rel(base(tp.rhs).double().numpy()), rel(xs)
    assert rel_dword < 5e-6, (rel_plain, rel_dword)
    assert rel_dword < rel_plain, (rel_plain, rel_dword)
    jbase = j_eig.build_eig_gmres_solver(jp.operator, jb, rtol=1e-5)
    jx = np.asarray(jax.jit(jbase)(jp.rhs), np.float64)
    _close(jx, base(tp.rhs), 1e-5)


def test_basis_save_load_roundtrip(tmp_path):
    """tests/test_eigbasis.py:134: the basis persists and restores, in both
    directions across the packages. The port's file keeps ``quality`` (an
    SDC basis reloads as 'f32_sdc', 8 Richardson steps); JAX's file has
    none and loads as 'f32', JAX's default, as JAX reloads its own files
    (ROADMAP Queue C: the reference drops the grade)."""
    jp, tp = _pair(9, 8)
    basis = build_eig_basis(tp.space, method="host")
    path = save_eig_basis(str(tmp_path / "basis"), basis)
    restored = load_eig_basis(path, tp.space)
    np.testing.assert_allclose(restored.lam, basis.lam)
    np.testing.assert_allclose(restored.V.numpy(), basis.V.numpy())
    assert restored.quality == "f64"
    x = build_eig_woodbury_solver(tp.operator, restored, refine=1)(tp.rhs)
    assert tp.relative_residual_f64(WaveSolution(u=x[0], p=x[1], result=None)) < 1e-11
    with pytest.raises(ValueError, match="does not match"):
        load_eig_basis(path, _pair(7, 4)[1].space)
    # an SDC-grade basis keeps its grade through the port's file; JAX's drops it
    sdc_grade = dataclasses.replace(basis, quality="f32_sdc")
    p2 = save_eig_basis(str(tmp_path / "sdc"), sdc_grade)
    assert default_richardson_steps(load_eig_basis(p2, tp.space)) == 8
    assert j_eig.load_eig_basis(p2, jp.space).quality == "f32"
    # a JAX-written file: loads through the interop as 'f32', solves as JAX's
    jb = j_eig.build_eig_basis(jp.space, method="host")
    jpath = j_eig.save_eig_basis(str(tmp_path / "jax_basis"), jb)
    from_jax = load_eig_basis(jpath, tp.space)
    assert from_jax.quality == "f32" and "quality" not in np.load(jpath).files
    np.testing.assert_array_equal(from_jax.V.numpy(), np.asarray(jb.V))
    jx = jax.jit(j_eig.build_eig_woodbury_solver(jp.operator, jb, refine=1))(jp.rhs)
    _close(jx, build_eig_woodbury_solver(tp.operator, from_jax, refine=1)(tp.rhs), 1e-11)


def test_direct_fn_equals_closure_solver():
    """tests/test_eigbasis.py:157: the argument form ``fn(b, V)`` and the
    closure form are the same solve (bitwise), and both match JAX's."""
    jp, tp = _pair(12, 16, f32=True)
    jb, tb = _shared_basis(jp, tp)
    fn = build_eig_direct_fn(tp.operator, tb, steps=2)
    x_args = fn(tp.rhs, tb.V)
    x_clos = build_eig_direct_solver(tp.operator, tb, steps=2)(tp.rhs)
    np.testing.assert_array_equal(x_args.numpy(), x_clos.numpy())
    assert tp.relative_residual_f64(WaveSolution(u=x_args[0], p=x_args[1], result=None)) < 1e-4
    x_res, rel = build_eig_direct_fn(tp.operator, tb, steps=2, with_residual=True)(tp.rhs, tb.V)
    np.testing.assert_array_equal(x_res.numpy(), x_args.numpy())
    jx, jrel = jax.jit(j_eig.build_eig_direct_fn(jp.operator, jb, steps=2, with_residual=True))(jp.rhs, jb.V)
    _close(jx, x_args, 1e-5)
    assert abs(float(rel) - float(jrel)) <= 0.05 * float(jrel)


def test_entry_point_richardson_route_matches_jax():
    """The mesh's default ``method='woodbury'`` just above the Richardson
    threshold: N = 47 (n = 2116), N_t = 8, float32, the 'torch' basis in
    both packages ('auto' on the CPU): 2 steps, converged, x against JAX's
    (float32 tolerance, module docstring); the basis is built once per
    problem, and the batched solver takes the same route."""
    jp, tp = _pair(47, 8, f32=True)
    assert tp.space.n == 2116 and resolve_eig_method(tp.space) == "torch"
    sol = tp.solve(SolverConfig(method="woodbury"))
    jsol = jp.solve(J.SolverConfig(method="woodbury"))
    assert int(sol.result.iterations) == int(jsol.result.iterations) == 2
    assert bool(sol.result.converged) and bool(jsol.result.converged)
    assert tp._eig_basis.quality == jp._eig_basis.quality == "f32"
    np.testing.assert_array_equal(tp._eig_basis.V.numpy(), np.asarray(jp._eig_basis.V))
    _close(_x(jsol), _x(sol), 1e-5)
    rel, jrel = (float(r.result.residual_norm) for r in (sol, jsol))
    assert abs(rel - jrel) <= 0.1 * jrel  # the measured a-posteriori residual, float32
    assert set(tp.eig_setup_s) == {"dense", "eigh", "back_transform"}
    basis = tp._eig_basis
    sol2 = tp.solve(SolverConfig(method="woodbury", polish=1))
    assert tp._eig_basis is basis and int(sol2.result.iterations) == 3
    xs, res = tp.make_batched_solver_fn(SolverConfig(method="woodbury"))(torch.stack([tp.rhs, 2.0 * tp.rhs]))
    assert tp._eig_basis is basis
    assert res.iterations.tolist() == [2, 2] and bool(res.converged.all())
    x1, _ = tp.make_solver_fn(SolverConfig(method="woodbury"))(tp.rhs)
    _close(x1, xs[0], 1e-6)
    _close(2.0 * x1, xs[1], 1e-6)
