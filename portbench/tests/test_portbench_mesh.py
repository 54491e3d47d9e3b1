"""Triangle meshes in the benchmark, on the CPU: the perturbed unit-square
mesh against the port's own triangulation and boundary, the reference's
element operator against the grid's stencils and the port's assembly, the
float64 control against a dense solve, whole runs of a tiny mesh cell with
the program, the control, the surrogate and broken timed paths in its
place, ``control.py --config``, a heat configuration that may not take a
mesh, and the five cells' pools and right-hand sides pinned bit for bit."""

import hashlib
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import cell as cellmod, manifest, mesh as meshes, traffic as gen
from portbench.reference import model as ref, solve as rs
from portbench_helpers import CELLS, mesh_cell, mesh_config, tiny

import test_portbench_faults

torch.set_num_threads(1)

SEED = 2**31 + 2701


def _mesh(N, jitter=0.18):
    return meshes.build(meshes.spec(mesh_config(N, 8, jitter)))


def _elements(m):
    return ref.Elements(m.points, m.triangles, m.interior)


def _dense(apply, n):
    return apply(torch.eye(n, dtype=torch.float64)).T  # column j is apply(e_j)


# ---------------------------------------------------------------------- the mesh


def test_the_mesh_is_the_ports_triangulation_moved_as_the_jax_bench_moves_it():
    """Points and triangles as ``native.unit_square_mesh`` gives them, the
    interior moved as ``bench.py`` moves it; the interior by grid index is
    the complement of the port's topological boundary."""
    from optimal_control_paradiag_torch import native
    from optimal_control_paradiag_torch.fem.general import boundary_nodes

    N = 12
    pts, tris = native.unit_square_mesh(N, diagonal="left")
    bnd = boundary_nodes(pts.shape[0], tris)
    pts = pts.copy()
    pts[~bnd] += np.random.default_rng(0).uniform(-0.18 / N, 0.18 / N, size=pts[~bnd].shape)
    m = _mesh(N)
    assert np.array_equal(m.points, pts) and np.array_equal(m.triangles, tris) and m.triangles.dtype == np.int32
    assert np.array_equal(m.interior, ~bnd) and m.interior.sum() == (N - 1) ** 2
    x, y = m.coords
    assert np.array_equal(x, pts[~bnd, 0]) and np.array_equal(y, pts[~bnd, 1])
    assert 0 < np.abs(m.points - _mesh(N, 0.0).points).max() <= 0.18 / N
    assert meshes.build(meshes.spec(mesh_config(N, 8))) is m  # built once
    assert meshes.spec(mesh_config(N, 8))["N"] == N  # N is N_x
    with pytest.raises(ValueError):
        m.points[0, 0] = 1.0  # shared, so read only


# ---------------------------------------------------------- the element operator


def test_an_unmoved_mesh_gives_the_grids_stencils():
    """Jitter 0: the mesh's mass and stiffness are the 2D consistent mass
    and the 5-point stiffness of ``model.py``; the 'left' diagonal is the
    stencil's (1, 1) neighbour pair, not (-1, 1); jittered, the mesh's
    operator is not the grid's."""
    N = 8
    pc = mesh_config(N, 8)["problem_config"]
    n = (N - 1) ** 2
    grid_m = _dense(lambda x: ref.mass(pc, x), n)
    grid_k = _dense(lambda x: ref.stiffness(pc, x), n)
    E = _elements(_mesh(N, 0.0))
    mesh_m, mesh_k = _dense(lambda x: ref.mass(pc, x, E), n), _dense(lambda x: ref.stiffness(pc, x, E), n)
    assert float((mesh_m - grid_m).abs().max() / grid_m.abs().max()) < 1e-14
    assert float((mesh_k - grid_k).abs().max() / grid_k.abs().max()) < 1e-14
    c = 3 * (N - 1) + 3  # an interior node (3, 3); +(1, 1) is N places on, +(-1, 1) is N - 2
    assert mesh_m[c, c + N] > 0 and mesh_m[c, c + N - 2] == 0
    moved = _elements(_mesh(N))
    assert float((_dense(lambda x: ref.mass(pc, x, moved), n) - grid_m).abs().max() / grid_m.abs().max()) > 1e-2


def test_the_mesh_operator_is_the_ports_assembly():
    """On a jittered N = 12 mesh, the reference's element-by-element mass
    and stiffness equal the port's CSR matrices (native assembly, boundary
    rows and columns dropped), float64."""
    from optimal_control_paradiag_torch.fem.general import make_general_space

    m = _mesh(12)
    sp = make_general_space(m.points, m.triangles, torch.float64, device="cpu")
    E = _elements(m)
    pc = mesh_config(12, 8)["problem_config"]
    for apply, csr in ((ref.mass, sp.M_csr), (ref.stiffness, sp.K_csr)):
        port = torch.as_tensor(np.asarray(csr.todense()), dtype=torch.float64)
        mine = _dense(lambda x: apply(pc, x, E), E.n)
        assert float((mine - port).abs().max() / port.abs().max()) < 1e-13
        assert float((mine - mine.T).abs().max()) == 0.0  # symmetric to the bit: each entry summed in one order


def test_the_all_at_once_mesh_operator_and_rhs_are_the_ports():
    """The reference's all-at-once matvec and right-hand side on the mesh
    equal the port's on its assembled space (float64, N = 8, N_t = 8)."""
    from optimal_control_paradiag_torch import ProblemConfig, WaveControlProblem

    cell = mesh_cell("gmres_f64", 8, 8)
    pc = cell.config["problem_config"]
    data = cellmod.member(cell, SEED, 3)
    prob = WaveControlProblem(ProblemConfig(**pc, dtype=torch.float64), device="cpu", data=data,
                              space=cellmod.mesh_space(cell, torch.device("cpu")))
    E = cellmod.reference_mesh(cell, "cpu")
    b = ref.rhs("wave", pc, {k: torch.from_numpy(v) for k, v in data.items()}, E)
    np.testing.assert_allclose(b.numpy(), prob.rhs.numpy(), rtol=1e-13, atol=1e-13 * float(b.abs().max()))
    x = torch.randn((2, 8, E.n), dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(ref.matvec("wave", pc, x, E).numpy(), prob.operator.matvec(x).numpy(), atol=1e-13)


# ------------------------------------------------------------------ the control


def test_the_float64_control_on_a_mesh_is_a_dense_solve():
    """GMRES on the mesh's matvec, preconditioned by the unmoved grid's
    surrogate, equals a dense solve of the assembled all-at-once matrix;
    the surrogate alone does not."""
    cell = mesh_cell("direct", 8, 8)
    pc = cell.config["problem_config"]
    E = cellmod.reference_mesh(cell, "cpu")
    data = {k: torch.from_numpy(v) for k, v in cellmod.member(cell, SEED, 2).items()}
    b = ref.rhs("wave", pc, data, E)
    A = _dense(lambda x: ref.matvec("wave", pc, x.reshape((-1,) + b.shape), E).reshape(x.shape[0], -1), b.numel())
    x = torch.linalg.solve(A, b.reshape(-1)).reshape(b.shape)
    steps = []
    xs = rs.solve("wave", pc, b, "float64", steps, E)
    assert float((xs - x).abs().max() / x.abs().max()) < 1e-10
    assert ref.rel_residual("wave", pc, data, xs, E) <= rs.F64_TOL and 1 <= steps[0] <= rs.RESTART
    assert not rs.diagonalizable(pc)
    assert float((rs.surrogate_solve("wave", pc, b) - x).abs().max() / x.abs().max()) > 1e-2


def test_the_control_precisions_on_a_mesh_in_order():
    """float64 < float32 < tf32 / 10 < bf16 on the mesh; TF32 rounds the
    element values too."""
    cell = mesh_cell("direct", 8, 8)
    pc = cell.config["problem_config"]
    E = cellmod.reference_mesh(cell, "cpu")
    data = {k: torch.from_numpy(v) for k, v in cellmod.member(cell, SEED, 1).items()}
    b = ref.rhs("wave", pc, data, E)
    rel = {p: ref.rel_residual("wave", pc, data, rs.solve("wave", pc, b, p, None, E), E)
           for p in ("float64", "float32", "tf32", "bf16")}
    assert rel["float64"] < 1e-11 < rel["float32"] < rel["tf32"] / 10 < rel["bf16"]
    low = E.to(torch.float32, lambda a: rs.round_mantissa(a, 10))
    assert low.mass.dtype == torch.float32 and E.mass.dtype == torch.float64
    assert torch.equal(rs.round_mantissa(low.stiffness, 10), low.stiffness)
    assert not torch.equal(low.stiffness.double(), E.stiffness)


# ------------------------------------------------------------- whole runs, CPU


LIMIT = 1e-4  # program 2.0e-6, TF32 control 2.9e-3, surrogate 0.57 (N = 8, N_t = 8, the CPU)


def _in_place(solve):
    return lambda fn: (lambda b: (solve(b), None))


@pytest.mark.parametrize("traffic", ["direct", "batch8"])
def test_a_tiny_mesh_cell_is_correct_and_its_control_and_surrogate_are_not(traffic):
    cell = mesh_cell(traffic, 8, 8, limit=LIMIT)
    pc = cell.config["problem_config"]
    E = cellmod.reference_mesh(cell, "cpu")
    precision = rs.control_precision(cell.traffic)
    program = cellmod.run_cell(cell, SEED, 0.1, False, device="cpu")
    control = cellmod.run_cell(cell, SEED, 0.1, False, device="cpu",
                               wrap=_in_place(lambda b: rs.solve("wave", pc, b.to(torch.float64), precision, None, E)))
    surrogate = cellmod.run_cell(cell, SEED, 0.1, False, device="cpu",
                                 wrap=_in_place(lambda b: rs.surrogate_solve("wave", pc, b)))
    read = {k: v["check"]["rel_residual"]["value"] for k, v in
            (("program", program), ("control", control), ("surrogate", surrogate))}
    assert program["correct"] and program["failed"] == 0
    assert program["check"]["answered"]["value"] == int(cell.traffic["batch"]) * int(cell.traffic["pool"])
    assert read["program"] < LIMIT / 10 and not control["correct"] and not surrogate["correct"]
    assert read["control"] > 10 * LIMIT and read["surrogate"] > 1000 * LIMIT


@pytest.mark.parametrize("fault", [test_portbench_faults.unchanged, test_portbench_faults.slice_lost,
                                   test_portbench_faults.stale], ids=lambda f: f.__name__)
def test_a_broken_timed_path_on_a_mesh_is_not_correct(fault):
    out = cellmod.run_cell(mesh_cell("direct", 8, 8, limit=LIMIT), SEED, 0.1, False, device="cpu", wrap=fault)
    assert not out["correct"] and out["failed"] > 0 and out["check"]["rel_residual"]["value"] > LIMIT


def test_the_mesh_data_is_the_manufactured_family_at_the_moved_nodes():
    """Member 0 is the port's own manufactured data on the mesh's space;
    member i is mode 1 + i % 8 at the moved nodes, scaled by the seed."""
    from optimal_control_paradiag_torch import ProblemConfig, WaveControlProblem

    cell = mesh_cell("gmres_f64", 8, 8)
    pc, spec = cell.config["problem_config"], meshes.spec(cell.config)
    prob = WaveControlProblem(ProblemConfig(**pc, dtype=torch.float64), device="cpu",
                              space=cellmod.mesh_space(cell, torch.device("cpu")))
    for k, v in cellmod.member(cell, SEED, 0).items():
        np.testing.assert_allclose(v, prob._data[k].numpy(), rtol=1e-13, atol=1e-13)
    x, y = meshes.build(spec).coords
    for i in (1, 5, 11):
        u0 = gen.member("wave", pc, "float64", SEED, i, spec)["u0"]
        k = gen.mode(i)
        shape = np.sin(k * math.pi * x) * np.sin(k * math.pi * y)
        ratio = u0 @ shape / (shape @ shape)
        assert 0.5 <= ratio <= 2.0 and np.allclose(u0, ratio * shape, rtol=0, atol=1e-13)
    grid = gen.member("wave", pc, "float64", SEED, 1)["u0"]
    assert grid.shape == u0.shape and not np.array_equal(grid, gen.member("wave", pc, "float64", SEED, 1, spec)["u0"])


# ------------------------------------------------------ control.py --config


def test_control_py_takes_a_configuration_no_cell_names(tmp_path):
    """``--config`` and ``--traffic``: a program, a control and a surrogate
    line a seed, with the control's GMRES steps and no limit read."""
    path = tmp_path / "mesh_small.json"
    path.write_text(json.dumps(mesh_config(8, 8)))
    env = dict(os.environ, PYTHONPATH=manifest.ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "portbench/control.py", "--config", str(path), "--traffic", "batch8",
                          "--seeds", "7", "--control-seeds", "8", "--device", "cpu"], cwd=manifest.ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    program, control, surrogate = [json.loads(line) for line in out.stdout.splitlines()]
    assert [program["side"], control["side"], surrogate["side"]] == ["program", "control", "surrogate"]
    assert program["cell"] == "mesh_n49.batch8" and program["peak_bytes"] is None  # no card
    assert control["precision"] == "tf32" and len(control["iterations"]) == 32
    assert all(1 <= s <= rs.LOW_STEPS for s in control["iterations"])
    assert program["answered"] == control["answered"] == surrogate["answered"] == 32
    assert program["rel_residual"] < LIMIT / 10 < LIMIT * 10 < min(control["rel_residual"], surrogate["rel_residual"])
    bad = subprocess.run([sys.executable, "portbench/control.py", "--config", str(path), "--seeds", "7",
                          "--device", "cpu"], cwd=manifest.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert bad.returncode != 0 and "--traffic" in bad.stderr


# ----------------------------------------------------- which configurations


def test_a_heat_configuration_with_a_mesh_raises():
    config = mesh_config(8, 8, problem="heat")
    cell = manifest.Cell(name="heat_mesh.batch8", chips=1, config=config,
                         traffic=manifest.load_json(os.path.join(manifest.HERE, "traffic", "batch8.json")),
                         limits={"rel_residual": 1.0}, metrics=[])
    with pytest.raises(ValueError, match="takes no mesh"):
        cellmod.run_cell(cell, SEED, 0.1, False, device="cpu")
    with pytest.raises(ValueError, match="takes no mesh"):
        cellmod.member(cell, SEED, 0)


@pytest.mark.parametrize("change", [{"dim": 1}, {"mass": "lumped"}])
def test_a_mesh_whose_problem_config_disagrees_raises(change):
    config = mesh_config(8, 8)
    config["problem_config"].update(change)
    with pytest.raises(ValueError, match="problem_config"):
        meshes.spec(config)
    assert meshes.spec(mesh_config(8, 8)) is not None and meshes.spec(tiny(CELLS[0]).config) is None


@pytest.mark.parametrize("change", [{"N": 8}, {"diagonal": "left"}, {"kind": "square"}, {"seed": None}],
                         ids=["N", "diagonal", "kind", "no_seed"])
def test_a_mesh_entry_holds_its_own_fields_only(change):
    """kind, jitter and seed, each once: N is problem_config's N_x and the
    cut is the kind's own, so a stale field raises rather than being read
    past; a kind the harness does not build raises."""
    config = mesh_config(8, 8)
    config["mesh"].update(change)
    config["mesh"] = {k: v for k, v in config["mesh"].items() if v is not None}
    with pytest.raises(ValueError, match="mesh"):
        meshes.spec(config)


def test_a_mesh_cells_problem_takes_the_space_it_was_given():
    """One way to hand the port a mesh: ``mesh_space`` once, passed on; a
    mesh cell's problem without it raises rather than solving the grid."""
    cell = mesh_cell("direct", 8, 8)
    data = cellmod.member(cell, SEED, 0)
    with pytest.raises(ValueError, match="mesh_space"):
        cellmod.problem(cell, torch.device("cpu"), data)
    with pytest.raises(ValueError, match="mesh_space"):
        cellmod.entry(cell, torch.device("cpu"))
    space = cellmod.mesh_space(cell, torch.device("cpu"))
    assert cellmod.problem(cell, torch.device("cpu"), data, space).space is space


# ------------------------------------------------- the five cells, bit for bit


PINNED = {  # sha256 of the pool's data and of the reference's b, seed 2**31 + 4321, as the grid-only harness gave them
    "wave1d_headline.direct": ("f3a35ace40d74993eea4f50ef2bf2ea344a2702015462f58226fdb2235c51719",
                               "cb401b103258a33980f09a16cf7ae6653774848503e37e83481e2bf2e23e1452"),
    "heat1d_headline.batch8": ("d18caed60ce98ad5be052921a85084a90e23a07127ba0b3c43bf91106b14fc8f",
                               "26dea489e81665e38128d2f07659509b6d5ee8db9e0b8d38494239ea3c16602d"),
    "wave1d_headline.gmres_f64": ("14250820628ee1acec17b3353c0b6fb6168170bd153b1beed0f734ac0ed21e67",
                                  "930f328076b5f9ed82eb6e387bfab3abfc114319798b97b28857c188cc814b12"),
    "heat2d_lumped.batch8": ("9fca7985533cac947bc98da7876b7e6d066fc9316b6b149a48578b8e07965d2f",
                             "4e188f53893bf12579c8e1205eac1de8392ef97961b9291ecfbb7ee138615f96"),
    "wave2d_consistent.batch8_f64": ("03f9c66ca68975369296f5fae41c4a93355aedebbc5b2b23ace5e27b0855a0bb",
                                     "920e88488861db40bc4f336b0e675945a85078145be838b442b3bdd60a765d03"),
}


@pytest.mark.parametrize("name", CELLS)
def test_the_cells_pools_and_right_hand_sides_are_unchanged(name):
    """Each cell at a tiny grid (32 x 8 in 1D, 16 x 8 in 2D): every data set
    of the pool and the reference's b of each, hashed."""
    assert set(PINNED) == set(CELLS)
    cell = tiny(name, 16, 8) if "2d" in name else tiny(name, 32, 8)
    problem, pc = cell.config["problem"], cell.config["problem_config"]
    data_hash, b_hash = hashlib.sha256(), hashlib.sha256()
    for i in range(int(cell.traffic["batch"]) * int(cell.traffic["pool"])):
        m = cellmod.member(cell, 2**31 + 4321, i)
        for k in sorted(m):
            data_hash.update(k.encode())
            data_hash.update(m[k].tobytes())
        b_hash.update(ref.rhs(problem, pc, {k: torch.from_numpy(v) for k, v in m.items()}).numpy().tobytes())
    assert (data_hash.hexdigest(), b_hash.hexdigest()) == PINNED[name]
    assert cellmod.mesh_space(cell, torch.device("cpu")) is None and cellmod.reference_mesh(cell, "cpu") is None
