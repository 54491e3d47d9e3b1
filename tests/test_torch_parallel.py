"""The port's sharded layer (``optimal_control_paradiag_torch/parallel/``)
against its unsharded solves and the JAX package's sharded ones.

Every case of ``tests/test_parallel.py`` (meshes (8,1), (4,2), (2,2), (2,4),
(1,8), at its sizes and tolerances) runs in ONE gloo group of 8 CPU
processes (``tests/torch_parallel_ranks.py``, started once for this file
by ``parallel.multihost.launch_cpu_group``; it imports no JAX). The ranks
compare each sharded solve with the port's single-process solve on the same
inputs; the tests here assert on their pickled results, and for each route
(wave Woodbury, wave GMRES, MINRES, heat Woodbury, the eigenbasis Woodbury,
the explicit-collective matvec and preconditioner) also compare with the
JAX package's sharded solve on the conftest's 8 virtual devices.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from optimal_control_paradiag_torch.parallel.multihost import launch_cpu_group
from optimal_control_paradiag_tpu import native as j_native
from optimal_control_paradiag_tpu.config import ProblemConfig as JProblemConfig
from optimal_control_paradiag_tpu.config import SolverConfig as JSolverConfig
from optimal_control_paradiag_tpu.fem.general import boundary_nodes as j_boundary_nodes
from optimal_control_paradiag_tpu.fem.general import make_general_space as j_make_general_space
from optimal_control_paradiag_tpu.models.heat import HeatControlProblem as JHeat
from optimal_control_paradiag_tpu.models.wave import WaveControlProblem as JWave
from optimal_control_paradiag_tpu.paradiag.eigbasis import build_eig_basis as j_build_eig_basis
from optimal_control_paradiag_tpu.parallel.sharding import make_layout as j_make_layout
from optimal_control_paradiag_tpu.parallel.solve import make_sharded_heat_solver as j_sharded_heat
from optimal_control_paradiag_tpu.parallel.solve import make_sharded_solver as j_sharded
from optimal_control_paradiag_tpu.utils import checkpoint as j_ckpt

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))


def _perturbed_mesh(N):
    """The JAX tests' perturbed unit-square mesh (default_rng(0), +-0.18/N)."""
    rng = np.random.default_rng(0)
    pts, tris = j_native.unit_square_mesh(N, diagonal="left")
    bnd = j_boundary_nodes(pts.shape[0], tris)
    pts = pts.copy()
    pts[~bnd] += rng.uniform(-0.18 / N, 0.18 / N, size=pts[~bnd].shape)
    return pts, tris


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Inputs for the ranks (meshes, the JAX package's float32 host
    eigenbasis of the N = 17 mesh, a state and its JAX sharded checkpoint),
    one launch of the 8-rank group, and its results."""
    if not j_native.available():
        pytest.skip("native toolchain unavailable")
    out = tmp_path_factory.mktemp("ranks")
    eig_pts, eig_tris = _perturbed_mesh(17)
    basis = j_build_eig_basis(j_make_general_space(eig_pts, eig_tris, dtype=jnp.float32), method="host")
    band_pts, band_tris = _perturbed_mesh(9)
    state = np.random.default_rng(5).standard_normal((2, 16, 16))
    np.savez(out / "inputs.npz", eig_points=eig_pts, eig_triangles=eig_tris, eig_lam=np.asarray(basis.lam),
             eig_V=np.asarray(basis.V), band_points=band_pts, band_triangles=band_tris, ckpt_state=state)
    layout = j_make_layout(4, 2)
    j_ckpt.save_sharded(str(out / "jax_ckpt"), jax.device_put(jnp.asarray(state), layout.sharding(P(None, "time", "space"))))
    launch_cpu_group([os.path.join(HERE, "torch_parallel_ranks.py"), str(out)], 8, timeout_s=600)
    with open(out / "results.pkl", "rb") as f:
        results = pickle.load(f)
    return out, results, basis, state


def _get(ranks, name):
    res = ranks[1][name]
    assert "exception" not in res, res.get("exception")
    return res


def _jax_solve(prob, solver, grid, family="wave"):
    run, sh = (j_sharded if family == "wave" else j_sharded_heat)(prob, solver, j_make_layout(*grid))
    x, res = run(jax.device_put(prob.rhs, sh) if sh is not None else prob.rhs)
    return np.asarray(x), res


# ------------------------------------------------- tests/test_parallel.py


@pytest.mark.parametrize("grid", ["8x1", "4x2", "2x2"])
def test_sharded_solve_matches_single_device(ranks, grid):
    r = _get(ranks, f"solve_gmres_{grid}")
    assert r["even"]
    np.testing.assert_allclose(r["x"][0], r["ref"][0], atol=1e-8)
    np.testing.assert_allclose(r["x"][1], r["ref"][1], atol=1e-8)
    assert r["iterations"] == r["ref_iterations"]


@pytest.mark.parametrize("grid", ["8x1", "4x2", "2x2"])
def test_sharded_woodbury_matches_single_device(ranks, grid):
    r = _get(ranks, f"woodbury_{grid}")
    assert r["iterations"] is None
    np.testing.assert_allclose(r["x"], r["ref"], atol=1e-11)


@pytest.mark.parametrize("grid", ["8x1", "4x2"])
def test_sharded_solve_uneven_shards(ranks, grid):
    """N_t = 12 over 8 time ranks, n = 19 over 2 space ranks: blocks of
    np.array_split sizes, ``sharding`` None (the JAX contract), the
    single-process answer and iteration count."""
    r = _get(ranks, f"uneven_{grid}")
    assert not r["even"]
    assert r["iterations"] == r["ref_iterations"]
    np.testing.assert_allclose(r["x"], r["ref"], atol=1e-8)


def test_sharded_solve_float32_iteration_parity(ranks):
    r = _get(ranks, "f32_parity")
    assert r["iterations"] == r["ref_iterations"]
    np.testing.assert_allclose(r["x"], r["ref"], atol=5e-5)


@pytest.mark.parametrize("dtype,atol", [("float64", 1e-11), ("float32", 2e-4)])
def test_sharded_2d_lumped_woodbury_matches_single_device(ranks, dtype, atol):
    r = _get(ranks, f"lumped2d_woodbury_{dtype}")
    assert r["iterations"] is None
    np.testing.assert_allclose(r["x"], r["ref"], atol=atol)


def test_sharded_2d_lumped_gmres_matches_single_device(ranks):
    r = _get(ranks, "lumped2d_gmres")
    assert r["iterations"] == r["ref_iterations"]
    np.testing.assert_allclose(r["x"], r["ref"], atol=1e-8)


def test_sharded_woodbury_half_spectrum_parity_f32(ranks):
    r = _get(ranks, "half_f32")
    np.testing.assert_allclose(r["x"], r["ref"], atol=2e-4)


def test_shardmap_rejects_uneven_shards(ranks):
    assert "need nt" in _get(ranks, "shardmap_reject")["error"]


def test_mesh_construction(ranks):
    r = _get(ranks, "mesh_construction")
    assert r["axis_names"] == ("time", "space") and r["shape"] == (4, 2)
    assert "need 32 devices, have 8" in r["error"]


def test_graft_entry_single_and_multichip(ranks):
    """The port's counterpart of the JAX graft entry: one preconditioned
    residual step at the reference shape, and the JAX dry run's routes over
    the (4, 2) grid (the uneven heat GMRES returns ``sharding=None``)."""
    r = _get(ranks, "graft")
    assert r["step_shape"] == (2, 81, 79) and r["step_finite"]
    for name, (got, want, uneven) in r["shapes"].items():
        assert got == want, name
        assert uneven == (name == "heat_uneven"), name


@pytest.mark.parametrize("grid", ["8x1", "4x2", "2x4", "1x8"])
def test_shardmap_matvec_matches_local(ranks, grid):
    """Values, and the layout path's halos: one ``batch_isend_irecv`` per
    split axis (a one-rank chain posts none)."""
    r = _get(ranks, f"shardmap_matvec_{grid}")
    np.testing.assert_allclose(r["got"], r["want"], atol=1e-11)
    nt, ns = (int(v) for v in grid.split("x"))
    assert r["counts"] == {"send_recv": (nt > 1) + (ns > 1)}


@pytest.mark.parametrize("grid", ["8x1", "4x2", "2x4"])
def test_shardmap_pc_matches_local(ranks, grid):
    r = _get(ranks, f"shardmap_pc_{grid}")
    np.testing.assert_allclose(r["got"], r["want"], atol=1e-10)
    assert r["counts"] == {"reduce_scatter": 4}


def test_shardmap_end_to_end_gmres(ranks):
    r = _get(ranks, "shardmap_e2e")
    assert r["iterations"] == r["ref_iterations"]
    np.testing.assert_allclose(r["x"][0], r["ref"][0], atol=1e-8)


def test_multihost_helpers_single_process(ranks):
    """In this process no group is up: ``initialize`` is a no-op and the
    summary counts one process; on the 8 ranks ``pod_layout`` spans them
    all and refuses a space axis that does not divide them."""
    from optimal_control_paradiag_torch.parallel import multihost

    assert multihost.initialize(device="cpu") is False
    assert multihost.process_summary()["process_count"] == 1
    r = _get(ranks, "multihost")
    assert r["summary"]["process_count"] == 8 and r["summary"]["backend"] == "gloo"
    assert r["pod_size"] == 8
    assert "must divide device count 8" in r["error"]


def test_sharded_heat_woodbury_matches_single_device(ranks):
    r = _get(ranks, "heat_woodbury")
    assert r["iterations"] is None
    np.testing.assert_allclose(r["x"], r["ref"], atol=1e-11)


def test_sharded_heat_2d_consistent_tensor_pc_matches_single_device(ranks):
    r = _get(ranks, "heat_2d_consistent")
    assert r["converged"] and r["iterations"] <= 8
    np.testing.assert_allclose(r["x"], r["ref"], atol=1e-8)


def test_sharded_heat_gmres_f32_converges(ranks):
    r = _get(ranks, "heat_gmres_f32")
    assert r["converged"] and r["iterations"] <= 3
    assert r["relative_residual"] < 1e-4


@pytest.mark.parametrize("grid", ["8x1", "4x2"])
def test_sharded_minres_matches_single_device(ranks, grid):
    r = _get(ranks, f"minres_{grid}")
    assert r["converged"]
    np.testing.assert_allclose(r["x"], r["ref"], atol=1e-8)
    assert abs(r["iterations"] - r["ref_iterations"]) <= 1


def test_sharded_heat_minres_matches_single_device(ranks):
    r = _get(ranks, "heat_minres")
    assert r["converged"]
    np.testing.assert_allclose(r["x"], r["ref"], atol=1e-9)


def test_sharded_wave_2d_consistent_tensor_pc_matches_single_device(ranks):
    r = _get(ranks, "wave_2d_consistent")
    assert r["converged"] and r["iterations"] <= 12
    np.testing.assert_allclose(r["x"], r["ref"], atol=1e-7)


def test_sharded_unstructured_eig_woodbury_matches_single_device(ranks):
    """A problem over the JAX package's eigenbasis of a perturbed mesh rides
    the diagonalizable sharded Woodbury route: the V products run
    mode-local, the phase sums are all-reduces, and the layout's counter
    records ZERO all-gathers in the solve (the port's reading of the JAX
    test's compiled-program check)."""
    r = _get(ranks, "eig_woodbury")
    assert r["rel"] <= 1e-4
    np.testing.assert_allclose(r["x"], r["x0"], rtol=0, atol=1e-5)
    assert r["counts"].get("all_gather", 0) == 0
    assert r["counts"] == {"all_to_all": 6, "all_reduce": 3}


# ------------------------------------------------- against the JAX package


@pytest.mark.parametrize("route", ["woodbury", "gmres", "minres", "heat_woodbury", "eig_woodbury"])
def test_sharded_solves_match_jax_sharded(ranks, route):
    """Each sharded route against the JAX package's sharded solve of the
    same problem on the (4, 2) mesh, at the tolerances above (float32 for
    the eigenbasis problem, on the same basis)."""
    if route == "eig_woodbury":
        prob = JWave(JProblemConfig(N_x=17, N_t=16, dim=2, dtype=jnp.float32), space=ranks[2])
        x, _ = _jax_solve(prob, JSolverConfig(method="woodbury"), (4, 2))
        np.testing.assert_allclose(_get(ranks, "eig_woodbury")["x"], x, atol=1e-5)
        return
    name, prob, solver, fam, atol = {
        "woodbury": ("woodbury_4x2", JWave(JProblemConfig(N_x=17, N_t=16)), JSolverConfig(method="woodbury"), "wave", 1e-11),
        "gmres": ("solve_gmres_4x2", JWave(JProblemConfig(N_x=17, N_t=16)), JSolverConfig(rtol=1e-10), "wave", 1e-8),
        "minres": ("minres_4x2", JWave(JProblemConfig(N_x=17, N_t=16)),
                   JSolverConfig(method="minres", rtol=1e-10, maxiter=200), "wave", 1e-8),
        "heat_woodbury": ("heat_woodbury", JHeat(JProblemConfig(N_x=17, N_t=16)),
                          JSolverConfig(method="woodbury"), "heat", 1e-11),
    }[route]
    x, res = _jax_solve(prob, solver, (4, 2), fam)
    r = _get(ranks, name)
    np.testing.assert_allclose(r["x"], x, atol=atol)
    if route == "gmres":
        assert r["iterations"] == int(res.iterations)
    if route == "minres":
        assert abs(r["iterations"] - int(res.iterations)) <= 1


@pytest.mark.parametrize("which", ["matvec", "pc"])
def test_shardmap_ops_match_jax(ranks, which):
    from optimal_control_paradiag_tpu.parallel.shardmap_ops import (
        build_shardmap_matvec as j_matvec,
        build_shardmap_preconditioner as j_pc,
    )

    layout = j_make_layout(4, 2)
    prob = JWave(JProblemConfig(N_x=17, N_t=16))
    r = _get(ranks, f"shardmap_{which}_4x2")
    build, arg, tol = (j_matvec, r["x"], 1e-11) if which == "matvec" else (j_pc, r["r"], 1e-10)
    fn = jax.jit(build(prob.operator, layout))
    got = np.asarray(fn(jax.device_put(jnp.asarray(arg), layout.sharding(layout.canonical_spec))))
    np.testing.assert_allclose(r["got"], got, atol=tol)


# ------------------------------------------------- the port's own layer


@pytest.mark.parametrize("variant", ["fulldiag", "eig", "block", "blockdense", "blockline", "blockband"])
def test_sharded_preconditioner_variants(ranks, variant):
    """``build_preconditioner(layout=)`` for every variant the JAX builder
    pins its stages for, against the single-process apply (the 'dft' time
    transform against 'fft'; the banded solvers factor each rank's modes)."""
    r = _get(ranks, f"pc_{variant}")
    scale = np.abs(r["want"]).max()
    np.testing.assert_allclose(r["got"], r["want"], atol=(1e-8 if variant == "block" else 1e-12) * scale)
    assert r["counts"]["all_to_all"] == 4 and "all_gather" not in r["counts"]


def test_collective_counts(ranks):
    """What each route issues, from the layout's counter: the direct solve
    six stage moves and one all_reduce per set of phase sums (refine = 1:
    three); GMRES three all_reduces per Arnoldi step; no route
    all-gathers."""
    wb = _get(ranks, "woodbury_4x2")["counts"]
    assert wb == {"all_to_all": 6, "all_reduce": 3}
    assert _get(ranks, "heat_woodbury")["counts"] == {"all_to_all": 6, "all_reduce": 3}
    g = _get(ranks, "solve_gmres_4x2")
    assert g["counts"]["all_reduce"] == 3 * g["iterations"] + 2
    assert g["counts"]["all_to_all"] == 4 * (g["iterations"] + 1)
    for name, r in ranks[1].items():
        if "counts" in r and "x" in r:
            assert r["counts"].get("all_gather", 0) == 0, name


def test_batch_axis_refused(ranks):
    assert "one state" in _get(ranks, "batch_refused")["error"]


def test_cli_mesh_in_group(ranks):
    """``run.main(['--mesh', '4,2', ...])`` inside a group that is already
    up: both families, the JAX CLI's record fields."""
    r = _get(ranks, "cli_in_group")
    for model in ("wave", "heat"):
        rec = r[model]
        assert rec["mesh"] == {"time": 4, "space": 2, "devices": 8} and rec["model"] == model
        assert set(rec["timings_ms"]) == {"solve (compile + run)", "solve (cached)"}
    assert r["wave"]["iterations"] == 5 and r["wave"]["residual"] < 1e-8
    assert r["heat"]["iterations"] is None and r["heat"]["residual"] < 1e-12


def test_sharded_checkpoints_cross_package(ranks):
    """The JAX package's sharded checkpoint loads rank by rank in the port,
    the port's per-rank files load under another layout and in the JAX
    package, and a set of files that does not cover the array raises in
    both."""
    out, results, _, state = ranks
    r = _get(ranks, "checkpoint")
    assert r["ok_jax"] and r["ok_other"]
    from optimal_control_paradiag_torch.utils import checkpoint as t_ckpt

    np.testing.assert_array_equal(j_ckpt.load_sharded(str(out / "port_ckpt")), state)
    np.testing.assert_array_equal(t_ckpt.load_sharded(str(out / "port_ckpt")), state)
    np.testing.assert_array_equal(t_ckpt.load_sharded(str(out / "jax_ckpt")), state)
    partial = out / "partial"
    partial.mkdir()
    os.link(out / "port_ckpt_p000.npz", partial / "ck_p000.npz")
    for load in (j_ckpt.load_sharded, t_ckpt.load_sharded):
        with pytest.raises(ValueError, match="does not cover"):
            load(str(partial / "ck"))
