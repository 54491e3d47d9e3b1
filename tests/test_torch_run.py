"""The driver and observability layer of the PyTorch port (``run.py``,
``io/writers.py``, ``utils/{timing,monitor,checkpoint}.py``,
``viz/plotting.py``) vs the JAX package's, in float64 on the CPU.

Tolerances: the CLI records' error metrics 1e-10 absolute and the
``solution.npz`` arrays 1e-10 relative max-abs; residual histories to rtol
1e-8 with an absolute floor of 1e-13 of the initial residual (a restart
starts from the true residual, whose cancellation amplifies last-bit
differences; tests/test_torch_gmres.py), 1e-8 for MINRES
(tests/test_torch_batched.py); checkpoints and the unstructured
VTK writer exact; the structured VTK files' numbers 1e-10 relative to the
field's largest value, their other lines equal."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import optimal_control_paradiag_tpu as J
from optimal_control_paradiag_torch import ProblemConfig, SolverConfig, WaveControlProblem
from optimal_control_paradiag_torch import run as t_run
from optimal_control_paradiag_torch.interop import problem_from_jax
from optimal_control_paradiag_torch.io import writers as t_writers
from optimal_control_paradiag_torch.utils import checkpoint as t_ckpt
from optimal_control_paradiag_torch.utils import monitor as t_mon
from optimal_control_paradiag_torch.utils.timing import StageTimer, profile_trace
from optimal_control_paradiag_torch.viz import plotting as t_plot
from optimal_control_paradiag_tpu import run as j_run
from optimal_control_paradiag_tpu.io import writers as j_writers
from optimal_control_paradiag_tpu.utils import checkpoint as j_ckpt
from optimal_control_paradiag_tpu.utils import monitor as j_mon
from optimal_control_paradiag_tpu.viz import plotting as j_plot

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_jax_compile_cache(monkeypatch):
    """The JAX CLI would otherwise point jax at a persistent cache."""
    monkeypatch.setenv("PARADIAG_COMPILE_CACHE", "off")


def _close(ref, got, tol):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape
    assert np.abs(ref - got).max() <= tol * np.abs(ref).max()


def _same_history(hj, ht, floor=1e-13):
    hj, ht = np.asarray(hj, np.float64), np.asarray(ht, np.float64)
    assert hj.shape == ht.shape
    np.testing.assert_allclose(ht, hj, rtol=1e-8, atol=floor * hj[0])


def _both_cli(tmp_path, argv):
    """(JAX record, port record, JAX out dir, port out dir) of one argv."""
    dj, dt = tmp_path / "jax", tmp_path / "torch"
    rj = j_run.main(argv + ["--out", str(dj)])
    rt = t_run.main(argv + ["--platform", "cpu", "--out", str(dt)])
    return rj, rt, dj, dt


def test_cli_default_run_matches_jax(tmp_path):
    rj, rt, dj, dt = _both_cli(tmp_path, ["--nx", "10", "--nt", "11", "--rtol", "1e-8"])
    assert set(rt) == set(rj)
    assert set(rt["config"]) == set(rj["config"])
    assert rt["config"]["platform"] == "cpu"
    assert rt["iterations"] == rj["iterations"] <= 10 and rt["converged"] and rj["converged"]
    assert abs(rt["error_reference_metric"] - rj["error_reference_metric"]) <= 1e-10
    assert abs(rt["error_aligned_metric"] - rj["error_aligned_metric"]) <= 1e-10
    assert rt["residual_norm_true"] < 1e-8 and rj["residual_norm_true"] < 1e-8
    assert set(rt["timings_ms"]) == set(rj["timings_ms"]) == {"setup", "solve (compile + run)", "solve (cached)"}
    zj, zt = np.load(dj / "solution.npz"), np.load(dt / "solution.npz")
    assert set(zt.files) == set(zj.files)
    np.testing.assert_array_equal(zt["times"], zj["times"])
    np.testing.assert_array_equal(zt["coords"], zj["coords"])
    for k in ("u_out", "p_out", "u_ana", "p_ana"):
        _close(zj[k], zt[k], 1e-10)
    assert set(json.loads(str(zt["config"]))) == set(json.loads(str(zj["config"])))
    _same_history(np.loadtxt(dj / "residuals.out"), np.loadtxt(dt / "residuals.out"))


def test_cli_heat_matches_jax(tmp_path):
    argv = ["--model", "heat", "--nx", "16", "--nt", "8", "--method", "woodbury"]
    rj, rt, dj, dt = _both_cli(tmp_path, argv)
    assert set(rt) == set(rj) and set(rt["config"]) == set(rj["config"])
    assert rt["iterations"] is None and rj["iterations"] is None
    assert rt["relative_residual"] < 1e-10 and rj["relative_residual"] < 1e-10
    assert abs(rt["error_vs_analytic"] - rj["error_vs_analytic"]) <= 1e-10
    zj, zt = np.load(dj / "heat_solution.npz"), np.load(dt / "heat_solution.npz")
    for k in ("u", "p"):
        assert zt[k].dtype == np.float64
        _close(zj[k], zt[k], 1e-11)


@pytest.mark.parametrize(
    "argv",
    [
        ["--method", "minres", "--rtol", "1e-10"],
        ["--method", "spectral", "--rtol", "1e-10"],
        ["--method", "direct"],
        ["--model", "heat", "--method", "minres", "--rtol", "1e-10"],
        ["--model", "heat", "--method", "direct"],
    ],
    ids=["minres", "spectral", "direct", "heat-minres", "heat-direct"],
)
def test_cli_methods_match_jax(tmp_path, argv):
    """--method minres / spectral / direct through both CLIs: the same
    record keys, iterations and error metrics, and the same files."""
    rj, rt, dj, dt = _both_cli(tmp_path, argv + ["--nx", "10", "--nt", "11"])
    assert set(rt) == set(rj) and set(rt["config"]) == set(rj["config"])
    assert rt["iterations"] == rj["iterations"]
    assert (rt["iterations"] is None) == (argv[-1] == "direct")
    if "heat" in argv:
        assert rt["relative_residual"] < 1e-9 and rj["relative_residual"] < 1e-9
        assert abs(rt["error_vs_analytic"] - rj["error_vs_analytic"]) <= 1e-10
        zj, zt = np.load(dj / "heat_solution.npz"), np.load(dt / "heat_solution.npz")
        _close(zj["u"], zt["u"], 1e-9)
        return
    assert rt["converged"] and rj["converged"]
    assert rt["residual_norm_true"] < 1e-8 and rj["residual_norm_true"] < 1e-8
    assert abs(rt["error_aligned_metric"] - rj["error_aligned_metric"]) <= 1e-10
    assert abs(rt["error_reference_metric"] - rj["error_reference_metric"]) <= 1e-10
    zj, zt = np.load(dj / "solution.npz"), np.load(dt / "solution.npz")
    _close(zj["u_out"], zt["u_out"], 1e-10)
    assert (dt / "residuals.out").exists() == (dj / "residuals.out").exists() == (rt["iterations"] is not None)
    if rt["iterations"] is not None:
        # MINRES: the floor of tests/test_torch_batched.py (MINRES_HISTORY_FLOOR)
        floor = 1e-8 if "minres" in argv else 1e-13
        _same_history(np.loadtxt(dj / "residuals.out"), np.loadtxt(dt / "residuals.out"), floor)


def test_cli_heat_gmres_and_float32(tmp_path):
    rt = t_run.main(["--model", "heat", "--nx", "16", "--nt", "8", "--rtol", "1e-10",
                     "--platform", "cpu", "--out", str(tmp_path)])
    assert rt["iterations"] <= 5 and rt["relative_residual"] < 1e-8
    rt = t_run.main(["--model", "heat", "--nx", "16", "--nt", "8", "--method", "woodbury",
                     "--dtype", "float32", "--platform", "cpu", "--out", str(tmp_path)])
    assert np.load(tmp_path / "heat_solution.npz")["u"].dtype == np.float32


def test_cli_heat_sweep_nx_default(tmp_path):
    """The heat tau-sweep defaults N_x to 128 only when --nx is not given,
    as in the JAX CLI; its error.out matches the JAX problems'."""
    for argv in (["--model", "heat", "--sweep", "--nx", "80"], ["--model", "heat", "--sweep"]):
        aj, at = j_run.build_parser().parse_args(argv), t_run.build_parser().parse_args(argv)
        assert at.nx == aj.nx
    args = t_run.build_parser().parse_args(["--model", "heat", "--sweep", "--nx", "12", "--method", "woodbury",
                                             "--out", str(tmp_path)])
    rec = t_run.run_heat(args, torch.float64, SolverConfig(method="woodbury"), "cpu")
    assert rec["N_t"] == [8, 16, 32, 64, 128]
    errs = np.loadtxt(tmp_path / "error.out")
    from optimal_control_paradiag_tpu.models.heat import HeatControlProblem as JHeat

    for i, N_t in enumerate((8, 16)):
        jp = JHeat(J.ProblemConfig(N_x=12, N_t=N_t))
        assert abs(errs[i] - jp.error_vs_analytic(jp.solve(J.SolverConfig(method="woodbury")))) <= 1e-10
    assert json.load(open(tmp_path / "sweep.json"))["N_t"] == rec["N_t"]


def test_cli_sweep_writes_error_out(tmp_path):
    """The wave sweep (N = 5..70) through the port's ``run_sweep``; its
    error.out at N = 5 and 10 against the JAX package's
    ``error_vs_analytic`` (tests/test_tools.py's check)."""
    args = t_run.build_parser().parse_args(["--rtol", "1e-8", "--out", str(tmp_path)])
    rec = t_run.run_sweep(args, torch.float64, SolverConfig(rtol=1e-8), "cpu")
    assert rec["N"] == list(range(5, 71, 5))
    loaded = np.loadtxt(tmp_path / "error.out")
    assert loaded.shape == (14,)
    for i, N in enumerate((5, 10)):
        jp = J.WaveControlProblem(J.ProblemConfig(N_x=N, N_t=N))
        assert abs(loaded[i] - jp.error_vs_analytic(jp.solve(J.SolverConfig(rtol=1e-8)))) <= 1e-10
    sweep = json.load(open(tmp_path / "sweep.json"))
    assert set(sweep) == {"N", "error_reference_metric", "error_aligned_metric", "iterations"}
    assert max(sweep["iterations"]) <= 10


def test_cli_platform_x64_and_profile_flags():
    p, pj = t_run.build_parser(), j_run.build_parser()
    acts = {a.dest: a for a in p._actions}
    jacts = {a.dest: a for a in pj._actions}
    assert set(acts) == set(jacts)
    for dest, a in acts.items():
        assert a.default == jacts[dest].default, dest
        if dest != "platform":
            assert a.choices == jacts[dest].choices, dest
    assert acts["platform"].choices == ("auto", "cpu", "cuda")
    assert "no effect" in acts["x64"].help
    assert "torch.profiler" in acts["profile"].help


@pytest.mark.parametrize(
    "argv,match",
    [
        (["--mesh", "2,1", "--sweep"], "cannot be combined"),
        (["--mesh", "2,1"], "item 14"),
        (["--mesh-file", "m.npz", "--mesh", "2,1"], "item 14"),
        (["--mesh-file", "m.npz", "--model", "heat"], "wave model only"),
        (["--model", "heat", "--method", "spectral", "--platform", "cpu"], "heat supports"),
    ],
    ids=["mesh-sweep", "mesh", "mesh-file", "mesh-file-heat", "heat-spectral"],
)
def test_cli_refusals(argv, match, tmp_path):
    with pytest.raises(SystemExit, match=match):
        t_run.main(argv + ["--out", str(tmp_path)])


def test_cli_methods_not_ported_raise(tmp_path):
    """--mesh-file with --method woodbury: the default direct solve of a
    triangle mesh, the eigenbasis solve (eig GMRES at this size), runs as
    the JAX CLI runs it (the same record and solution); with --mesh (the
    sharded solve) it still exits naming ROADMAP Queue A item 14."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: no native host runtime")
    from optimal_control_paradiag_torch import native

    pts, tris = native.unit_square_mesh(4)
    np.savez(tmp_path / "m.npz", points=pts, triangles=tris)
    argv = ["--mesh-file", str(tmp_path / "m.npz"), "--method", "woodbury", "--nt", "6"]
    rj, rt, dj, dt = _both_cli(tmp_path, argv)
    assert set(rt) == set(rj) and rt["iterations"] is None is rj["iterations"] and rt["converged"]
    assert abs(rt["error_aligned_metric"] - rj["error_aligned_metric"]) <= 1e-10
    _close(np.load(dj / "solution.npz")["u_out"], np.load(dt / "solution.npz")["u_out"], 1e-10)
    with pytest.raises(SystemExit, match="item 14"):
        t_run.main(argv + ["--mesh", "2,1", "--platform", "cpu", "--out", str(tmp_path)])


def _wall_mesh_space(N, dtype):
    """The JAX package's --rebuild-eig-cache mesh at N (run.py:302-306 of
    the JAX package): its GeneralP1Space in the JAX dtype."""
    from optimal_control_paradiag_torch import native
    from optimal_control_paradiag_torch.fem.general import boundary_nodes
    from optimal_control_paradiag_tpu.fem.general import make_general_space as j_make_general_space

    pts, tris = native.unit_square_mesh(N, diagonal="left")
    bnd = boundary_nodes(pts.shape[0], tris)
    pts = pts.copy()
    pts[~bnd] += np.random.default_rng(0).uniform(-0.18 / N, 0.18 / N, size=pts[~bnd].shape)
    return j_make_general_space(pts, tris, dtype=dtype), pts, tris


@pytest.mark.parametrize("method", ["auto", "host", "torch", "device", "sdc"])
def test_cli_rebuild_eig_cache(tmp_path, monkeypatch, method):
    """--rebuild-eig-cache --eig-method M on the CPU at N = 8 (n = 49): the
    file lands in the (monkeypatched) cache directory, carries the basis
    grade, loads in both packages, and its eigenvalues match JAX's float64
    host basis of the same mesh (float32 basis: 1e-5 of lam_max). 'auto' on
    the CPU is 'torch'."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: no native host runtime")
    import jax.numpy as jnp

    from optimal_control_paradiag_torch.interop import space_from_mesh
    from optimal_control_paradiag_torch.paradiag.eigbasis import load_eig_basis
    from optimal_control_paradiag_tpu.paradiag import eigbasis as j_eig

    monkeypatch.setattr(t_run, "EIG_CACHE_DIR", str(tmp_path / "cache"))
    rec = t_run.main(["--rebuild-eig-cache", "--nx", "8", "--eig-method", method, "--platform", "cpu",
                      "--out", str(tmp_path / "out")])
    path = tmp_path / "cache" / "eig_basis_N8.npz"
    assert rec["path"] == str(path) and path.exists() and rec["n"] == 49
    assert rec["method"] == ("torch" if method == "auto" else method)
    assert rec["quality"] == ("f32_sdc" if method == "sdc" else "f32")
    assert set(rec["phases_s"]) >= {"dense", "eigh", "back_transform"}
    jsp, pts, tris = _wall_mesh_space(8, jnp.float32)
    basis = load_eig_basis(str(path), space_from_mesh({"points": pts, "triangles": tris}, "float32", "cpu"))
    assert basis.quality == rec["quality"] and basis.V.dtype == torch.float32
    jb = j_eig.load_eig_basis(str(path), jsp)
    np.testing.assert_array_equal(np.asarray(jb.V), basis.V.numpy())
    j_lam = j_eig.build_eig_basis(_wall_mesh_space(8, jnp.float64)[0], method="host").lam
    assert np.abs(basis.lam - j_lam).max() <= 1e-5 * j_lam.max()


def test_cli_eig_method_is_accepted(tmp_path):
    """--eig-method outside --rebuild-eig-cache: accepted, and used only by
    the sharded --mesh-file solve, as in the JAX CLI (a structured run is
    the same run)."""
    rj, rt, _, _ = _both_cli(tmp_path, ["--eig-method", "sdc", "--nx", "6", "--nt", "7", "--rtol", "1e-8"])
    assert rt["config"]["eig_method"] == rj["config"]["eig_method"] == "sdc"
    assert rt["iterations"] == rj["iterations"] and rt["converged"]
    assert abs(rt["error_aligned_metric"] - rj["error_aligned_metric"]) <= 1e-10


@pytest.mark.parametrize(
    "argv",
    [
        ["--dim", "2", "--nx", "6", "--nt", "8", "--rtol", "1e-10"],
        ["--dim", "2", "--nx", "8", "--nt", "8", "--method", "woodbury"],
        ["--dim", "2", "--nx", "8", "--nt", "8", "--method", "woodbury", "--pc-variant", "blockline"],
        ["--model", "heat", "--dim", "2", "--nx", "8", "--nt", "8", "--method", "woodbury"],
    ],
    ids=["gmres-blockline", "tensor-gmres", "smw", "heat-tensor-gmres"],
)
def test_cli_2d_consistent_matches_jax(tmp_path, argv):
    """The CLI on the 2D consistent mass (its default mass at --dim 2):
    the same record keys, iterations and error metrics as the JAX CLI's,
    and the same solution file."""
    rj, rt, dj, dt = _both_cli(tmp_path, argv)
    assert set(rt) == set(rj) and set(rt["config"]) == set(rj["config"])
    assert rt["iterations"] == rj["iterations"]
    if "heat" in argv:
        assert abs(rt["error_vs_analytic"] - rj["error_vs_analytic"]) <= 1e-10
        _close(np.load(dj / "heat_solution.npz")["u"], np.load(dt / "heat_solution.npz")["u"], 1e-10)
        return
    assert rt["converged"] and rj["converged"]
    assert abs(rt["error_aligned_metric"] - rj["error_aligned_metric"]) <= 1e-10
    zj, zt = np.load(dj / "solution.npz"), np.load(dt / "solution.npz")
    for k in ("u_out", "p_out"):
        _close(zj[k], zt[k], 1e-10)


@pytest.mark.parametrize("interior", [False, True], ids=["detected", "given"])
def test_cli_mesh_file_matches_jax(tmp_path, interior):
    """--mesh-file on a perturbed triangle mesh (an .npz of points,
    triangles and, optionally, the interior mask): the GMRES auto route
    (blockdense) through both CLIs, the same iterations, error metrics and
    files, the mesh in the npz."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: no native host runtime")
    from optimal_control_paradiag_torch import native
    from optimal_control_paradiag_torch.fem.general import boundary_nodes

    pts, tris = native.unit_square_mesh(6)
    bnd = boundary_nodes(pts.shape[0], tris)
    pts[~bnd] += np.random.default_rng(0).uniform(-0.03, 0.03, size=pts[~bnd].shape)
    extra = {"interior": ~bnd} if interior else {}
    np.savez(tmp_path / "mesh.npz", points=pts, triangles=tris, **extra)
    rj, rt, dj, dt = _both_cli(tmp_path, ["--mesh-file", str(tmp_path / "mesh.npz"), "--nt", "8", "--rtol", "1e-10"])
    assert set(rt) == set(rj) and set(rt["config"]) == set(rj["config"])
    assert rt["config"]["dim"] == rj["config"]["dim"] == "2"
    assert rt["iterations"] == rj["iterations"] and rt["converged"] and rj["converged"]
    assert abs(rt["error_aligned_metric"] - rj["error_aligned_metric"]) <= 1e-10
    zj, zt = np.load(dj / "solution.npz"), np.load(dt / "solution.npz")
    assert set(zt.files) == set(zj.files)
    np.testing.assert_array_equal(zt["triangles"], zj["triangles"])
    for k in ("u_out", "p_out"):
        _close(zj[k], zt[k], 1e-10)


def test_cli_platform_auto_needs_the_card(tmp_path):
    """Without a card, --platform auto (and cuda) exit before any work: the
    CLI never moves to the CPU on its own, in either dtype."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: --platform auto runs there")
    for argv in ([], ["--dtype", "float32"], ["--platform", "cuda"]):
        out = tmp_path / "x"
        with pytest.raises(SystemExit, match="no CUDA device"):
            t_run.main(argv + ["--nx", "8", "--nt", "9", "--out", str(out)])
        assert not out.exists()


# ------------------------------------------------------------------ writers


def _solved_pair(kw, tmp=None):
    jcfg = J.ProblemConfig(**kw)
    jp = J.WaveControlProblem(jcfg)
    tp = problem_from_jax(dataclasses.asdict(jcfg), {k: np.asarray(v) for k, v in jp._data.items()}, device="cpu")
    return jp, tp, jp.solve(J.SolverConfig(method="woodbury")), tp.solve(SolverConfig(method="woodbury"))


def _vtk_lines_match(fj, ft):
    lj, lt = open(fj).read().splitlines(), open(ft).read().splitlines()
    assert len(lj) == len(lt)
    scale = max(abs(float(x)) for line in lj if line[:1] in "-0123456789" for x in line.split())
    for a, b in zip(lj, lt):
        if a[:1] in "-0123456789":
            np.testing.assert_allclose(np.array(b.split(), float), np.array(a.split(), float), rtol=0,
                                       atol=1e-10 * scale)
        else:
            assert a == b


@pytest.mark.parametrize("kw", [dict(N_x=8, N_t=9), dict(N_x=5, N_t=4, dim=2, mass="lumped")], ids=["1d", "2d-lumped"])
def test_write_solution_matches_jax(kw, tmp_path):
    jp, tp, js, ts = _solved_pair(kw)
    nj = j_writers.write_solution(jp, js, str(tmp_path / "jax" / "sol"), vtk=True)
    nt = t_writers.write_solution(tp, ts, str(tmp_path / "torch" / "sol"), vtk=True)
    assert os.path.basename(nt) == os.path.basename(nj) == "sol.npz"
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))
    zj, zt = np.load(nj), np.load(nt)
    assert set(zt.files) == set(zj.files)
    for k in ("u_out", "p_out", "u_ana", "p_ana", "times", "coords"):
        _close(zj[k], zt[k], 1e-10)
    assert set(json.loads(str(zt["config"]))) == set(json.loads(str(zj["config"])))
    assert json.load(open(tmp_path / "torch" / "sol.vtk.series")) == json.load(open(tmp_path / "jax" / "sol.vtk.series"))
    for name in ("sol_0000.vtk", f"sol_{kw['N_t']:04d}.vtk"):
        _vtk_lines_match(tmp_path / "jax" / name, tmp_path / "torch" / name)


class _StubMesh:
    """The attributes the writers read of an unstructured space: a 3x3-node
    square mesh of 8 triangles with one interior node."""

    points = np.array([[x, y] for y in (0.0, 0.5, 1.0) for x in (0.0, 0.5, 1.0)])
    triangles = np.array([[0, 1, 4], [0, 4, 3], [1, 2, 5], [1, 5, 4], [3, 4, 7], [3, 7, 6], [4, 5, 8], [4, 8, 7]])
    interior = np.array([False] * 4 + [True] + [False] * 4)


def test_unstructured_vtk_writer_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    times = np.arange(4) * 0.5
    fields = [rng.standard_normal((4, 1)) for _ in range(4)]
    sp = _StubMesh()
    _close(j_writers._with_boundary(sp, fields[0]), t_writers._with_boundary(sp, torch.from_numpy(fields[0])), 0)
    os.makedirs(tmp_path / "jax")
    os.makedirs(tmp_path / "torch")
    j_writers._write_vtk_unstructured_series(sp, str(tmp_path / "jax" / "m"), times, *fields)
    t_writers._write_vtk_unstructured_series(sp, str(tmp_path / "torch" / "m"), times, *fields)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch")) and len(names) == 5
    for name in names:
        assert open(tmp_path / "torch" / name).read() == open(tmp_path / "jax" / name).read()


# -------------------------------------------------------------- checkpoints


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_checkpoints_load_across_packages(writer, tmp_path):
    jp, tp, js, ts = _solved_pair(dict(N_x=8, N_t=9, gamma=0.5))
    js, ts = jp.solve(J.SolverConfig(rtol=1e-8)), tp.solve(SolverConfig(rtol=1e-8))
    path = str(tmp_path / "ckpt.npz")
    if writer == "torch":
        assert t_ckpt.save_solution(path, tp, ts, extra={"note": "t"}) == path
        u = ts.u.numpy()
    else:
        j_ckpt.save_solution(path, jp, js, extra={"note": "t"})
        u = np.asarray(js.u)
    dj, dt = j_ckpt.load_solution(path), t_ckpt.load_solution(path)
    assert set(dt) == set(dj) == {"u", "p", "config", "iterations", "residual_history", "extra"}
    np.testing.assert_array_equal(dt["u"], u)
    assert dt["u"].dtype == np.float64 and dt["extra"] == {"note": "t"} and dt["config"]["N_x"] == 8
    x0_t = t_ckpt.warm_start(tp, path)
    assert x0_t.shape == (2, 9, 7) and x0_t.dtype == torch.float64 and x0_t.device.type == "cpu"
    np.testing.assert_array_equal(x0_t.numpy(), np.asarray(j_ckpt.warm_start(jp, path)))
    r = tp.operator.matvec(x0_t) - tp.rhs
    assert float(torch.linalg.norm(r.reshape(-1))) < 1e-4


def test_checkpoint_keeps_the_working_dtype(tmp_path):
    tp = WaveControlProblem(ProblemConfig(N_x=8, N_t=9, dtype=torch.float32), device="cpu")
    sol = tp.solve(SolverConfig(method="woodbury"))
    path = t_ckpt.save_solution(str(tmp_path / "c32"), tp, sol)
    assert path.endswith("c32.npz")
    d = t_ckpt.load_solution(path)
    assert d["u"].dtype == np.float32 and "iterations" not in d
    assert t_ckpt.warm_start(tp, path).dtype == torch.float32


def test_warm_start_resumes_with_fewer_iterations(tmp_path):
    """tests/test_checkpoint.py:70-88 on the port: loose solve, checkpoint,
    warm-started resume to a tight absolute target in fewer iterations than
    the cold solve."""
    prob = WaveControlProblem(ProblemConfig(N_x=40, N_t=40), device="cpu")
    atarget = 1e-10 * float(torch.linalg.norm(prob.rhs.reshape(-1)))
    cold = prob.solve(SolverConfig(rtol=0.0, atol=atarget))
    assert bool(cold.result.converged)
    loose = prob.solve(SolverConfig(rtol=1e-3))
    path = t_ckpt.save_solution(str(tmp_path / "loose.npz"), prob, loose)
    resumed = prob.solve(SolverConfig(rtol=0.0, atol=atarget), x0=t_ckpt.warm_start(prob, path))
    assert bool(resumed.result.converged)
    assert int(resumed.result.iterations) < int(cold.result.iterations)
    np.testing.assert_allclose(resumed.u.numpy(), cold.u.numpy(), atol=1e-7)


def test_sharded_checkpoints_name_their_item():
    for fn, args in ((t_ckpt.save_sharded, ("p", None)), (t_ckpt.load_sharded, ("p",))):
        with pytest.raises(NotImplementedError, match="item 14"):
            fn(*args)


# ------------------------------------------------------------------ monitor


@pytest.mark.parametrize("solver", [dict(rtol=1e-8), dict(rtol=1e-30, maxiter=5, restart=5)],
                         ids=["converged", "diverged-its"])
def test_monitor_matches_jax(solver):
    # 10 x 11, the CLI test's problem: at 8 x 9 the last step's estimate is
    # rounding noise of an exhausted Krylov space (1e-10 of the initial
    # residual), which the two packages' last bits move by 2e-11 of it
    jp, tp, _, _ = _solved_pair(dict(N_x=10, N_t=11))
    js, ts = jp.solve(J.SolverConfig(**solver)), tp.solve(SolverConfig(**solver))
    rtol, maxiter = solver["rtol"], solver.get("maxiter", 1000)
    reason = t_mon.converged_reason(ts.result, rtol, maxiter)
    assert reason == j_mon.converged_reason(js.result, rtol, maxiter)
    assert reason == ("CONVERGED_RTOL" if "maxiter" not in solver else "DIVERGED_ITS")
    hj, ht = j_mon.health_check(js.result, rtol, maxiter), t_mon.health_check(ts.result, rtol, maxiter)
    assert set(ht) == set(hj)
    for k in ("reason", "iterations", "stagnated"):
        assert ht[k] == hj[k], k
    for k in ("initial_residual", "final_residual", "reduction"):
        assert abs(ht[k] - hj[k]) <= 1e-8 * abs(hj[k]) + 1e-13 * hj["initial_residual"], k
    mj, mt = j_mon.format_monitor(js.result).splitlines(), t_mon.format_monitor(ts.result).splitlines()
    assert len(mt) == len(mj) == int(js.result.iterations) + 1
    assert [m.split()[:4] for m in mt] == [m.split()[:4] for m in mj]
    _same_history([float(m.split()[-1]) for m in mj], [float(m.split()[-1]) for m in mt])
    assert t_mon.format_monitor(ts.result, every=2).count("\n") == (len(mt) - 1) // 2


# ---------------------------------------------------------- timing and plots


def test_stage_timer():
    t = StageTimer()
    with t.stage("a"):
        pass
    with t.stage("b", fence=torch.zeros(3)) as out:
        out["fence"] = torch.ones(2)
    with t.stage("a"):
        pass
    assert list(t.records) == ["a", "b"] and all(v >= 0 for v in t.records.values())
    assert "a" in t.report() and "ms" in t.report()


def test_profile_trace_on_the_cpu(tmp_path):
    x = torch.ones(64, 64, dtype=torch.float64)
    with profile_trace(None):
        x @ x
    assert not os.listdir(tmp_path)
    with profile_trace(str(tmp_path / "prof")):
        (x @ x).sum()
    events = json.load(open(tmp_path / "prof" / "trace.json"))["traceEvents"]
    cats = {e.get("cat") for e in events}
    assert "cpu_op" in cats and "kernel" not in cats
    assert any(e.get("name") == "aten::mm" for e in events)


def test_cli_profile_writes_a_trace(tmp_path):
    t_run.main(["--nx", "8", "--nt", "9", "--rtol", "1e-8", "--platform", "cpu", "--out", str(tmp_path),
                "--profile", str(tmp_path / "prof")])
    events = json.load(open(tmp_path / "prof" / "trace.json"))["traceEvents"]
    assert sum(e.get("cat") == "cpu_op" for e in events) > 10


def test_reference_errors_and_plots(tmp_path, monkeypatch):
    assert t_plot.REFERENCE_PUBLISHED_ERRORS == j_plot.REFERENCE_PUBLISHED_ERRORS
    with monkeypatch.context() as m:  # as on a machine without matplotlib
        m.setitem(sys.modules, "matplotlib", None)
        with pytest.raises(RuntimeError, match="matplotlib is not available"):
            t_plot.plot_convergence([5, 10], [0.9, 0.2], out=str(tmp_path / "c.png"))
    pytest.importorskip("matplotlib")
    out = t_plot.plot_convergence([5, 10, 20], [0.9, 0.2, 0.07], [0.5, 0.1, 0.03], out=str(tmp_path / "c.png"))
    assert os.path.getsize(out) > 0
    # plot_time_slice reads node 25, as the JAX package's does: N_x > 25
    rec = t_run.main(["--nx", "30", "--nt", "9", "--rtol", "1e-8", "--platform", "cpu", "--plot",
                      "--out", str(tmp_path / "cli")])
    assert rec["converged"]
    for name in ("slice.png", "residuals.png"):
        assert os.path.getsize(tmp_path / "cli" / name) > 0
    assert os.path.getsize(t_plot.plot_residual_history(np.array([1.0, 0.1, np.nan]),
                                                        out=str(tmp_path / "r.png"))) > 0


def test_cli_module_runs_as_a_script(tmp_path):
    """``python -m optimal_control_paradiag_torch.run`` on the CPU, without
    JAX in the process."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "optimal_control_paradiag_torch.run", "--platform", "cpu",
                          "--nx", "8", "--nt", "9", "--rtol", "1e-8", "--out", str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert '"converged": true' in out.stdout and os.path.exists(tmp_path / "residuals.out")
