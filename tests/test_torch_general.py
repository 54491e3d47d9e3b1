"""The unstructured-mesh path of the PyTorch port vs the JAX package, in
float64 on the CPU, on seeded numpy inputs: the sparse layer
(``ops/sparse.py``), the native host runtime's bindings (``native/``), the
triangle-mesh space (``fem/general.py``), the RCM-banded factorization
(``paradiag/blockband.py``), Jacobi-COCG and the GMRES and SMW routes of
unstructured meshes; the fast tests of tests/test_sparse.py,
test_native.py, test_general.py and test_blockband.py, each run in both
packages. Tests that build the native library skip without ``g++``.

Tolerances (relative max-abs, ``|a - b|.max() <= tol * |a|.max()``):
assembly, spaces, products and applies 1e-12 against JAX (integer arrays
equal); the SMW direct solves 1e-11; GMRES solves 1e-10 with the same
iteration counts (batched: the same per-lane counts as JAX's ``vmap``);
blockband against blockdense 1e-9 and the dense direct solve 1e-7
absolute, as the JAX tests hold them."""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optimal_control_paradiag_tpu as J
from optimal_control_paradiag_torch import ProblemConfig, SolverConfig, WaveControlProblem, native
from optimal_control_paradiag_torch.fem.general import boundary_nodes, make_general_space
from optimal_control_paradiag_torch.fem.space import make_space
from optimal_control_paradiag_torch.interop import problem_from_jax, space_from_mesh
from optimal_control_paradiag_torch.ops.allatonce import operator_nnz
from optimal_control_paradiag_torch.ops.sparse import csr_from_dense, csr_from_parts, space_matrices_csr, spmv_flops
from optimal_control_paradiag_torch.paradiag.blockband import band_profile, blockband_entries, build_blockband_solver
from optimal_control_paradiag_torch.paradiag.inner import make_jacobi_cocg_inner_solver
from optimal_control_paradiag_torch.paradiag.pc import build_preconditioner
from optimal_control_paradiag_torch.paradiag.woodbury2d import build_woodbury2d_solver
from optimal_control_paradiag_tpu import native as j_native
from optimal_control_paradiag_tpu.fem.general import make_general_space as j_make_general_space
from optimal_control_paradiag_tpu.fem.space import make_space as j_make_space
from optimal_control_paradiag_tpu.ops import sparse as j_sparse

torch.set_num_threads(1)

needs_native = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is missing: no native host runtime")


def _close(ref, got, tol):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape
    assert np.abs(ref - got).max() <= tol * np.abs(ref).max()


def _perturbed_square(N: int, amp: float = 0.18, seed: int = 0):
    """Unit-square triangulation with interior nodes moved by up to ``amp *
    h`` (tests/test_general.py:23), from the port's own mesh code."""
    pts, tris = native.unit_square_mesh(N, diagonal="left")
    bnd = boundary_nodes(pts.shape[0], tris)
    rng = np.random.default_rng(seed)
    pts = pts.copy()
    pts[~bnd] += rng.uniform(-amp / N, amp / N, size=pts[~bnd].shape)
    return pts, tris


def _pair(N: int, N_t: int, seed: int = 0, amp: float = 0.18, interior=None):
    """(JAX problem, port problem on the CPU) on one perturbed mesh and the
    same data; the port's space comes through the interop's mesh."""
    pts, tris = _perturbed_square(N, amp, seed)
    jcfg = J.ProblemConfig(N_x=N, N_t=N_t, dim=2)
    jp = J.WaveControlProblem(jcfg, space=j_make_general_space(pts, tris, interior=interior))
    mesh = {"points": pts, "triangles": tris, **({} if interior is None else {"interior": interior})}
    tp = problem_from_jax(dataclasses.asdict(jcfg), {k: np.asarray(v) for k, v in jp._data.items()},
                          device="cpu", mesh=mesh)
    return jp, tp


# --------------------------------------------------------------- sparse layer


def test_csr_roundtrip_and_spmv():
    """tests/test_sparse.py:13, and the CSR arrays equal JAX's."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((12, 9))
    A[np.abs(A) < 1.0] = 0.0
    csr = csr_from_dense(A, device="cpu")
    jcsr = j_sparse.csr_from_dense(A)
    np.testing.assert_allclose(csr.todense(), A)
    for name in ("indptr", "indices", "data", "ell_cols"):
        np.testing.assert_array_equal(getattr(csr, name), getattr(jcsr, name))
    x = rng.standard_normal(9)
    np.testing.assert_allclose(csr.spmv(torch.from_numpy(x)).numpy(), A @ x, atol=1e-12)
    _close(jcsr.spmv(jnp.asarray(x)), csr.spmv(torch.from_numpy(x)), 1e-12)
    assert spmv_flops(csr) == j_sparse.spmv_flops(jcsr) == 2 * csr.nnz


def test_spmv_batched_and_complex():
    """tests/test_sparse.py:24: leading axes are a batch; complex vectors
    too (the COCG inner solves), against JAX's."""
    rng = np.random.default_rng(1)
    A = np.triu(rng.standard_normal((8, 8)))
    csr = csr_from_dense(A, device="cpu")
    X = rng.standard_normal((3, 5, 8))
    np.testing.assert_allclose(csr.spmv(torch.from_numpy(X)).numpy(), X @ A.T, atol=1e-12)
    Z = X + 1j * rng.standard_normal(X.shape)
    _close(j_sparse.csr_from_dense(A).spmv(jnp.asarray(Z)), csr.spmv(torch.from_numpy(Z)), 1e-12)
    np.testing.assert_allclose(csr.spmv_host_f64(X), X @ A.T, atol=1e-12)


@pytest.mark.parametrize("dim", [1, 2])
def test_space_matrices_csr_match_stencils(dim):
    """tests/test_sparse.py:33."""
    sp = make_space(dim, 6, device="cpu")
    M, K = space_matrices_csr(sp)
    jM, jK = j_sparse.space_matrices_csr(j_make_space(dim, 6))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(sp.n))
    np.testing.assert_allclose(M.spmv(x).numpy(), sp.apply_mass(x).numpy(), atol=1e-12)
    np.testing.assert_allclose(K.spmv(x).numpy(), sp.apply_stiffness(x).numpy(), atol=1e-12)
    assert M.width <= 3**dim
    np.testing.assert_array_equal(M.indices, jM.indices)
    _close(jK.data, K.data, 1e-12)


def test_empty_rows():
    A = np.zeros((4, 4))
    A[1, 2] = 3.0
    csr = csr_from_dense(A, device="cpu")
    np.testing.assert_allclose(csr.spmv(torch.ones(4, dtype=torch.float64)).numpy(), A @ np.ones(4))


# -------------------------------------------------------------------- native


@needs_native
def test_native_assembly_matches_jax():
    """Both bindings load the same C++ source: the triangle and interval
    CSR arrays are equal, the RCM permutation and partition too."""
    pts, tris = _perturbed_square(7, seed=4)
    for got, ref in zip(native.assemble_p1_triangles(pts, tris), j_native.assemble_p1_triangles(pts, tris)):
        np.testing.assert_array_equal(got, ref)
    for got, ref in zip(native.assemble_p1_interval(13), j_native.assemble_p1_interval(13)):
        np.testing.assert_array_equal(got, ref)
    indptr, indices, _, _ = native.assemble_p1_triangles(pts, tris)
    np.testing.assert_array_equal(native.rcm_permutation(indptr, indices), j_native.rcm_permutation(indptr, indices))
    np.testing.assert_array_equal(native.partition_rows(10, 3), j_native.partition_rows(10, 3))
    assert native.partition_rows(10, 3).tolist() == [0, 0, 0, 0, 1, 1, 1, 2, 2, 2]
    for a, b in zip(native.unit_square_mesh(5, "right"), j_native.unit_square_mesh(5, "right")):
        np.testing.assert_array_equal(a, b)


@needs_native
def test_native_triangle_assembly_matches_structured_space():
    """tests/test_native.py:37: the CSR over all nodes, restricted to the
    interior, is the structured 2D space's mass and stiffness."""
    N = 7
    pts, tris = native.unit_square_mesh(N, diagonal="left")
    indptr, indices, mass, stiff = native.assemble_p1_triangles(pts, tris)
    n_all = len(indptr) - 1
    keep = np.arange(n_all).reshape(N + 1, N + 1)[1:-1, 1:-1].ravel()
    csr = lambda data: csr_from_parts((n_all, n_all), indptr, indices, data, device="cpu").todense()[np.ix_(keep, keep)]
    sp = make_space(2, N, device="cpu")
    np.testing.assert_allclose(csr(mass), sp.mass_dense().numpy(), atol=1e-13)
    np.testing.assert_allclose(csr(stiff), sp.stiffness_dense().numpy(), atol=1e-12)


@needs_native
def test_rcm_reduces_bandwidth():
    """tests/test_native.py:59: RCM of a shuffled grid graph restores a
    small band."""
    N = 12
    pts, tris = native.unit_square_mesh(N)
    indptr, indices, _, _ = native.assemble_p1_triangles(pts, tris)
    n = len(indptr) - 1
    shuf = np.random.default_rng(1).permutation(n)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    A = np.zeros((n, n), bool)
    A[shuf[rows], shuf[indices]] = True
    r2, c2 = np.nonzero(A)
    indptr2 = np.concatenate([[0], np.cumsum(np.bincount(r2, minlength=n))]).astype(np.int64)
    perm = native.rcm_permutation(indptr2, c2.astype(np.int32))
    assert sorted(perm.tolist()) == list(range(n))
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    assert np.abs(inv[r2] - inv[c2]).max() < np.abs(r2 - c2).max() / 2


# ------------------------------------------------------------ general space


@needs_native
@pytest.mark.parametrize("interior", [False, True], ids=["detected", "given"])
def test_general_space_matches_jax(interior):
    """The space a JAX ``GeneralP1Space`` problem becomes in the port
    (``interop.space_from_mesh``): the same mass, stiffness, diagonals and
    coordinates to 1e-12, the element-form nested stiffness and the host
    float64 applies too."""
    pts, tris = _perturbed_square(8, seed=2)
    mask = None
    if interior:  # Dirichlet on three sides only: the top row stays free
        mask = ~boundary_nodes(pts.shape[0], tris) | (pts[:, 1] == 1.0)
        mask &= (pts[:, 0] > 0.0) & (pts[:, 0] < 1.0)
    jsp = j_make_general_space(pts, tris, interior=mask)
    sp = space_from_mesh({"points": pts, "triangles": tris, **({} if mask is None else {"interior": mask})},
                         "float64", device="cpu")
    assert sp.n == jsp.n and sp.diagonalizable is False and sp.spectrum == (None, None)
    _close(jsp.mass_dense(), sp.mass_dense(), 1e-12)
    _close(jsp.stiffness_dense(), sp.stiffness_dense(), 1e-12)
    _close(jsp.mass_diag(), sp.mass_diag(), 1e-12)
    _close(jsp.stiffness_diag(), sp.stiffness_diag(), 1e-12)
    for a, b in zip(jsp.coords, sp.coords):
        np.testing.assert_array_equal(a, b)
    x = np.random.default_rng(3).standard_normal((3, sp.n))
    _close(jsp.apply_stiffness_nested(jnp.asarray(x)), sp.apply_stiffness_nested(torch.from_numpy(x)), 1e-12)
    _close(jsp.apply_mass_host_f64(x), sp.apply_mass_host_f64(x), 1e-12)
    _close(jsp.apply_stiffness_host_f64(x), sp.apply_stiffness_host_f64(x), 1e-12)


@needs_native
def test_general_space_matches_structured_on_unperturbed_mesh():
    """tests/test_general.py:36."""
    N = 7
    pts, tris = native.unit_square_mesh(N, diagonal="left")
    gsp = make_general_space(pts, tris, device="cpu")
    ssp = make_space(2, N, device="cpu")
    assert gsp.n == ssp.n
    np.testing.assert_allclose(gsp.mass_dense().numpy(), ssp.mass_dense().numpy(), atol=1e-13)
    np.testing.assert_allclose(gsp.stiffness_dense().numpy(), ssp.stiffness_dense().numpy(), atol=1e-12)
    np.testing.assert_allclose(gsp.coords[0], ssp.coords[0], atol=0)
    np.testing.assert_allclose(gsp.coords[1], ssp.coords[1], atol=0)


def test_boundary_detection_unit_square():
    pts, tris = native.unit_square_mesh(5)
    on_edge = (pts[:, 0] == 0.0) | (pts[:, 0] == 1.0) | (pts[:, 1] == 0.0) | (pts[:, 1] == 1.0)
    np.testing.assert_array_equal(boundary_nodes(pts.shape[0], tris), on_edge)


@needs_native
def test_element_form_nested_stiffness():
    """tests/test_general.py:125: the element form is the CSR apply to
    1e-12, and its float32 noise on a smooth field is no worse than the CSR
    form's."""
    pts, tris = _perturbed_square(12, amp=0.15, seed=2)
    sp = make_general_space(pts, tris, device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((3, sp.n)))
    _close(sp.apply_stiffness(x), sp.apply_stiffness_nested(x), 1e-12)
    sp32 = make_general_space(pts, tris, dtype=torch.float32, device="cpu")
    xs, ys = sp.coords
    smooth = np.sin(np.pi * xs) * np.sin(np.pi * ys)
    ref = sp.apply_stiffness_host_f64(smooth)
    s32 = torch.from_numpy(smooth.astype(np.float32))
    n_csr = np.abs(sp32.apply_stiffness(s32).double().numpy() - ref).max()
    n_nst = np.abs(sp32.apply_stiffness_nested(s32).double().numpy() - ref).max()
    assert n_nst <= 1.5 * n_csr, (n_nst, n_csr)


@needs_native
def test_unstructured_end_to_end_matches_jax_and_direct():
    """tests/test_general.py:61: GMRES with ``inner='auto'`` (blockdense)
    on a perturbed mesh takes JAX's iteration count, equals JAX's solution
    and the dense direct solve; ``operator_nnz`` and the float64 oracle
    agree with JAX's."""
    jp, tp = _pair(6, 8)
    _close(jp.rhs, tp.rhs, 1e-12)
    sol = tp.solve(SolverConfig(rtol=1e-10))
    js = jp.solve(J.SolverConfig(rtol=1e-10))
    assert bool(sol.result.converged)
    assert int(sol.result.iterations) == int(js.result.iterations)
    _close(js.u, sol.u, 1e-10)
    lu = tp.solve(SolverConfig(method="direct"))
    np.testing.assert_allclose(sol.u.numpy(), lu.u.numpy(), atol=1e-7)
    np.testing.assert_allclose(sol.p.numpy(), lu.p.numpy(), atol=1e-7)
    from optimal_control_paradiag_tpu.ops.allatonce import operator_nnz as j_operator_nnz

    assert operator_nnz(tp.operator) == j_operator_nnz(jp.operator)
    assert abs(tp.relative_residual_f64(sol) - jp.relative_residual_f64(js)) <= 1e-12


@needs_native
def test_unstructured_host_f64_oracle():
    """tests/test_general.py:74."""
    jp, tp = _pair(5, 6, seed=1)
    x = np.random.default_rng(2).standard_normal(tp.operator.shape)
    np.testing.assert_allclose(tp.operator.matvec_host_f64(x), tp.operator.matvec(torch.from_numpy(x)).numpy(),
                               atol=1e-12)
    _close(jp.operator.matvec_host_f64(x), tp.operator.matvec_host_f64(x), 1e-12)
    assert tp.relative_residual_f64(tp.solve(SolverConfig(method="direct"))) < 1e-10


@needs_native
def test_jacobi_cocg_inner_matches_jax():
    """The Jacobi-COCG inner solve itself (JAX's trip count and solution)
    and, tests/test_general.py:90, GMRES with it against blockdense."""
    jp, tp = _pair(5, 6, seed=3)
    from optimal_control_paradiag_tpu.paradiag.inner import make_jacobi_cocg_inner_solver as j_make

    rng = np.random.default_rng(6)
    sigma = (rng.standard_normal((6, 1)) + 1j * rng.standard_normal((6, 1))) * 30.0
    rhs = rng.standard_normal((6, tp.space.n)) + 1j * rng.standard_normal((6, tp.space.n))
    got = make_jacobi_cocg_inner_solver(tp.space, 0.25, 1e-12, 400)(torch.from_numpy(sigma), torch.from_numpy(rhs))
    _close(j_make(jp.space, 0.25, 1e-12, 400)(jnp.asarray(sigma), jnp.asarray(rhs)), got, 1e-10)
    bd = tp.solve(SolverConfig(rtol=1e-10, pc_variant="blockdense"))
    cj = tp.solve(SolverConfig(rtol=1e-10, inner="cocg_jacobi", inner_tol=1e-12, inner_maxiter=400))
    jcj = jp.solve(J.SolverConfig(rtol=1e-10, inner="cocg_jacobi", inner_tol=1e-12, inner_maxiter=400))
    assert bool(bd.result.converged) and bool(cj.result.converged)
    np.testing.assert_allclose(cj.u.numpy(), bd.u.numpy(), atol=1e-7)
    assert int(cj.result.iterations) == int(jcj.result.iterations)
    _close(jcj.u, cj.u, 1e-10)


def test_jacobi_cocg_needs_diagonals():
    with pytest.raises(ValueError, match="cocg_jacobi"):
        make_jacobi_cocg_inner_solver(make_space(2, 6, device="cpu"), 0.1)


@needs_native
def test_unstructured_manufactured_convergence():
    """tests/test_general.py:102: the aligned error falls under mesh
    refinement on perturbed meshes."""
    errs = []
    for N in (6, 12):
        pts, tris = _perturbed_square(N, amp=0.15, seed=1)
        prob = WaveControlProblem(ProblemConfig(N_x=N, N_t=2 * N, dim=2), device="cpu",
                                  space=make_general_space(pts, tris, device="cpu"))
        sol = prob.solve(SolverConfig(rtol=1e-10))
        assert bool(sol.result.converged)
        errs.append(prob.error_aligned(sol) / np.sqrt(prob.space.n))
    assert errs[1] < 0.45 * errs[0], errs


@needs_native
def test_structured_only_paths_refuse_unstructured():
    """tests/test_general.py:117; and the default unstructured Woodbury (the
    eigenbasis solve, eig GMRES at this size) solves as JAX's, 1e-10."""
    jp, tp = _pair(5, 6)
    with pytest.raises(ValueError, match="structured"):
        tp.solve(SolverConfig(pc_variant="blockline"))
    with pytest.raises(ValueError, match="structured"):
        tp.solve(SolverConfig(pc_variant="block"))
    sol, jsol = tp.solve(SolverConfig(method="woodbury")), jp.solve(J.SolverConfig(method="woodbury"))
    _close(jsol.u, sol.u, 1e-10)
    _close(jsol.p, sol.p, 1e-10)
    with pytest.raises(ValueError, match="lies on"):
        WaveControlProblem(ProblemConfig(N_x=5, N_t=6, dim=2), device="cpu",
                           space=dataclasses.replace(tp.space, device=torch.device("meta")))


@needs_native
def test_unstructured_writers(tmp_path):
    """tests/test_general.py:151: the npz carries the mesh, and the VTK
    series is an UNSTRUCTURED_GRID of triangles."""
    from optimal_control_paradiag_torch.io.writers import write_solution

    pts, tris = _perturbed_square(8, amp=0.12, seed=3)
    prob = WaveControlProblem(ProblemConfig(N_x=8, N_t=8, dim=2), device="cpu",
                              space=make_general_space(pts, tris, device="cpu"))
    sol = prob.solve(SolverConfig(method="woodbury", pc_variant="blockband"))
    npz = write_solution(prob, sol, str(tmp_path / "unstr"), vtk=True)
    z = np.load(npz)
    assert z["u_out"].shape == (9, pts.shape[0])
    assert z["triangles"].shape == tris.shape
    assert "UNSTRUCTURED_GRID" in (tmp_path / "unstr_0000.vtk").read_text().splitlines()[3]
    assert sum(1 for p in tmp_path.iterdir() if p.suffix == ".vtk") == 9


# ----------------------------------------------------------------- blockband


@needs_native
def test_band_profile_matches_jax():
    """tests/test_blockband.py:34: RCM on the perturbed square gives a
    bandwidth well under n, JAX's permutation and bandwidth."""
    from optimal_control_paradiag_tpu.paradiag.blockband import band_profile as j_band_profile

    jp, tp = _pair(16, 16)
    perm, m = band_profile(tp.space)
    jperm, jm = j_band_profile(jp.space)
    assert sorted(perm) == list(range(tp.space.n))
    np.testing.assert_array_equal(perm, jperm)
    assert m == jm < tp.space.n // 3
    assert blockband_entries(16, tp.space.n, m) < 16 * (2 * tp.space.n) ** 2


@needs_native
@pytest.mark.parametrize("N_t", [12, 9], ids=["even", "odd"])
def test_blockband_matches_blockdense_and_jax(N_t):
    """tests/test_blockband.py:44: the banded factorization applies the same
    circulant inverse as the dense one; each equals JAX's apply."""
    from optimal_control_paradiag_tpu.paradiag.pc import build_preconditioner as j_bp

    jp, tp = _pair(9, N_t, seed=3)
    r = np.random.default_rng(0).standard_normal((2, N_t, tp.space.n))
    y_band = build_preconditioner(tp.operator, variant="blockband")(torch.from_numpy(r)).numpy()
    y_dense = build_preconditioner(tp.operator, variant="blockdense")(torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(y_band, y_dense, atol=1e-9 * np.abs(y_dense).max())
    _close(jax.jit(j_bp(jp.operator, variant="blockband"))(jnp.asarray(r)), y_band, 1e-12)
    _close(jax.jit(j_bp(jp.operator, variant="blockdense"))(jnp.asarray(r)), y_dense, 1e-12)


@needs_native
def test_blockband_solver_inverts_circulant_modes():
    """tests/test_blockband.py:60: P_k w_k = r_k per mode, against dense
    per-mode matrices built independently."""
    _, tp = _pair(7, 8, seed=1)
    op, sp = tp.operator, tp.space
    n, N_t = sp.n, op.N_t
    rhat = np.fft.ifft(np.random.default_rng(2).standard_normal((2, N_t, n)), axis=1)
    w = build_blockband_solver(op)(torch.from_numpy(rhat)).numpy()
    from optimal_control_paradiag_torch.paradiag.eigs import circulant_eigs

    e = circulant_eigs(N_t, op.dt, op.gamma)
    c = 0.5 * op.dt * op.dt
    theta = op.dt * op.dt / np.sqrt(op.gamma)
    M, K = sp.mass_dense().numpy(), sp.stiffness_dense().numpy()
    for k in (0, 1, N_t // 2, N_t - 1):
        P = np.block([[e.Lambda1[k] * M + c * e.Lambda2[k] * K, -theta * M],
                      [theta * M, np.conj(e.Lambda1[k]) * M + c * np.conj(e.Lambda2[k]) * K]])
        want = np.linalg.solve(P, np.concatenate([rhat[0, k], rhat[1, k]]))
        np.testing.assert_allclose(np.concatenate([w[0, k], w[1, k]]), want, atol=1e-9 * np.abs(want).max())


@needs_native
def test_unstructured_smw_direct_midsize():
    """tests/test_blockband.py:79: the SMW solve over blockband (capacity
    GMRES unpreconditioned) with one refine pass reaches direct accuracy,
    and equals JAX's to 1e-11; ``method='woodbury', pc_variant='blockband'``
    is that solve."""
    from optimal_control_paradiag_tpu.paradiag.woodbury2d import build_woodbury2d_solver as j_build

    jp, tp = _pair(20, 16, seed=5)
    x = build_woodbury2d_solver(tp.operator, cap_maxiter=80, refine=1)(tp.rhs)
    rel = float(torch.linalg.norm((tp.operator.matvec(x) - tp.rhs).reshape(-1)) / torch.linalg.norm(tp.rhs.reshape(-1)))
    assert rel < 1e-8, rel
    _close(jax.jit(j_build(jp.operator, cap_maxiter=80, refine=1))(jp.rhs), x, 1e-11)


@needs_native
def test_blockband_rejects_diagonalizable():
    prob = WaveControlProblem(ProblemConfig(N_x=8, N_t=6, dim=2, mass="lumped"), device="cpu")
    with pytest.raises(ValueError, match="diagonalizable"):
        build_blockband_solver(prob.operator)


@needs_native
@pytest.mark.parametrize("sc", [dict(rtol=1e-10), dict(rtol=1e-10, pc_variant="blockband"),
                                dict(method="woodbury", pc_variant="blockband")],
                         ids=["auto-blockdense", "blockband", "smw"])
def test_batched_unstructured_matches_jax_vmap(sc):
    """A batch of three (the problem's rhs and two seeded lanes) through
    ``make_batched_solver_fn`` on a perturbed mesh: JAX's vmapped per-lane
    counts and solutions."""
    jp, tp = _pair(6, 8)
    rng = np.random.default_rng(11)
    rhs = tp.rhs.numpy()
    bs = np.stack([rhs] + [rhs * (1.0 + 0.5 * rng.standard_normal(rhs.shape)) for _ in range(2)])
    xs, res = tp.make_batched_solver_fn(SolverConfig(**sc))(torch.from_numpy(bs))
    jxs, jres = jp.make_batched_solver_fn(J.SolverConfig(**sc))(jnp.asarray(bs))
    if res is not None:
        assert res.iterations.tolist() == np.asarray(jres.iterations).tolist()
    _close(jxs, xs, 1e-10)


@needs_native
def test_unstructured_float32_gmres_iterates_on_the_accurate_matvec():
    """Float32 GMRES on a triangle mesh uses ``matvec_accurate``, as the JAX
    package does: it converges with JAX's iteration count to a float64
    oracle residual near rtol."""
    pts, tris = _perturbed_square(8)
    jcfg = J.ProblemConfig(N_x=8, N_t=8, dim=2, dtype=jnp.float32)
    jp = J.WaveControlProblem(jcfg, space=j_make_general_space(pts, tris, dtype=jnp.float32))
    tp = problem_from_jax(dataclasses.asdict(jcfg), {k: np.asarray(v) for k, v in jp._data.items()},
                          device="cpu", mesh={"points": pts, "triangles": tris})
    sc = dict(rtol=1e-5, pc_variant="blockband")
    sol = tp.solve(SolverConfig(**sc))
    js = jp.solve(J.SolverConfig(**sc))
    assert sol.u.dtype == torch.float32 and bool(sol.result.converged)
    assert int(sol.result.iterations) == int(js.result.iterations)
    assert tp.relative_residual_f64(sol) < 1e-4
