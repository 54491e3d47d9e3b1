"""The port's 2D consistent-mass wave solve (``method='woodbury'``: GMRES
preconditioned by the exact solve of the tensor-mass surrogate) against
the benchmark's plain float64 reference (``portbench/reference``), on the
CPU, with the surrogate's solve on B1's route (``use_pallas=True``: B1's
plain twin between the packed 'fft2' time transforms here) and on the
eager composition (``use_pallas=False``).

The reference is written from the stencils and imports nothing of the
port. Its solve on this space is GMRES preconditioned by the surrogate's
sine solve to 1e-13; ``surrogate_solve`` is that sine solve alone, the
answer of a program that skipped the correction. No JAX is imported.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from optimal_control_paradiag_torch import ProblemConfig, SolverConfig, WaveControlProblem
from optimal_control_paradiag_torch.fem.space import make_space
from optimal_control_paradiag_torch.ops.allatonce import build_operator
from optimal_control_paradiag_torch.paradiag import cuda_woodbury as cw
from optimal_control_paradiag_torch.paradiag.spectral import _build_woodbury_half, _spectral_plan
from optimal_control_paradiag_torch.paradiag.woodbury2d import build_tensor_gmres_solver
from optimal_control_paradiag_torch.utils import timing
from portbench import traffic
from portbench.reference import model as ref, solve as rs

torch.set_num_threads(1)

SEED = 2**31 + 24  # past 32 signed bits, as the benchmark's seeds are
GRIDS = [(12, 8), (12, 16), (16, 8), (16, 16)]  # (N_x, N_t); N_t even, as the cell's 128

# Float64 relative residual of the port's answer by the reference: GMRES
# stops at rtol 1e-10 on the preconditioned residual, and the true one
# read 7.6e-12 to 1.6e-10 on these grids, data and random b; 1e-9 leaves
# 6x, and the surrogate's answer alone reads 7.7e-4 or more.
RESIDUAL = 1e-9
# The port's answer against the reference's solve (GMRES to 1e-13): two
# solves of one system whose errors follow their residuals (9.2e-11 read
# at most); 1e-9 leaves 10x.
AGREE = 1e-9
# B1's surrogate solve against the eager composition over the same plan:
# two exact float64 solves of one sine-diagonal system, in another order
# of sums ('fft2' against torch's rfft, the twin's elementwise order):
# 9e-16 read; 1e-12 leaves room for ~N_t and ~N_x term sums.
SURROGATE_AGREE = 1e-12
# A lane of a batch against its own solve: lock-step GMRES takes the same
# steps with the batch's products, which round otherwise (1e-14 read).
LANE_AGREE = 1e-12

ROUTE = SolverConfig(method="woodbury", use_pallas=True)
EAGER = SolverConfig(method="woodbury", use_pallas=False)


def _pc(N_x, N_t):
    return dict(N_x=N_x, N_t=N_t, T=2.0, gamma=1.0, dim=2, scaled=True, mass="consistent")


def _problem(pc, data=None):
    return WaveControlProblem(ProblemConfig(**pc, dtype=torch.float64), device="cpu", data=data)


def _rel(a, b):
    return float(torch.linalg.norm((a - b).reshape(-1)) / torch.linalg.norm(b.reshape(-1)))


def _torch(data):
    return {k: torch.from_numpy(v) for k, v in data.items()}


def _moved(before):
    return {k: timing.counters[k] - before.get(k, 0) for k in timing.counters if timing.counters[k] != before.get(k, 0)}


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("lanes", [1, 2])
def test_benchmark_data_solved_to_the_reference(grid, lanes):
    """The benchmark's data sets (``traffic.member``: member 0 the
    manufactured data, member 1 mode 2 scaled by the seed), each b built by
    the port from ``data=``, through the route one at a time or stacked:
    every answer's residual by the reference, and the reference's solve."""
    pc = _pc(*grid)
    datas = [traffic.member("wave", pc, "float64", SEED, i) for i in range(lanes)]
    probs = [_problem(pc, d) for d in datas]
    if lanes == 1:
        xs = [probs[0].make_solver_fn(ROUTE)(probs[0].rhs)[0]]
    else:
        xb, res = probs[0].make_batched_solver_fn(ROUTE)(torch.stack([p.rhs for p in probs]))
        assert res is None and xb.shape == (lanes, 2, pc["N_t"], (pc["N_x"] - 1) ** 2)
        xs = list(xb)
        for p, x in zip(probs, xs):
            assert _rel(x, p.make_solver_fn(ROUTE)(p.rhs)[0]) <= LANE_AGREE
    for data, x in zip(datas, xs):
        assert ref.rel_residual("wave", pc, _torch(data), x) <= RESIDUAL
        assert _rel(x, rs.solve("wave", pc, ref.rhs("wave", pc, _torch(data)), "float64")) <= AGREE


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("lanes", [1, 2])
def test_random_right_hand_sides_solved_to_the_reference(grid, lanes):
    """Seeded random b (every sine mode and time slice excited): each
    lane's residual by the reference's operator, and its solve."""
    pc = _pc(*grid)
    rng = np.random.default_rng([SEED, lanes, pc["N_x"], pc["N_t"]])
    b = torch.from_numpy(rng.standard_normal((lanes, 2, pc["N_t"], (pc["N_x"] - 1) ** 2)))
    prob = _problem(pc)
    x = prob.make_solver_fn(ROUTE)(b[0])[0][None] if lanes == 1 else prob.make_batched_solver_fn(ROUTE)(b)[0]
    for lane in range(lanes):
        assert _rel(ref.matvec("wave", pc, x[lane]), b[lane]) <= RESIDUAL
    assert _rel(x, rs.solve("wave", pc, b, "float64")) <= AGREE


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("data", ["members", "random"])
def test_the_surrogate_alone_fails_the_bound(grid, data):
    """The surrogate's sine solve with no correction reads far above the
    bound the route is held to, on the benchmark's data and on random b."""
    pc = _pc(*grid)
    if data == "members":
        b = torch.stack([ref.rhs("wave", pc, _torch(traffic.member("wave", pc, "float64", SEED, i))) for i in range(2)])
    else:
        b = torch.from_numpy(np.random.default_rng([SEED, pc["N_x"]]).standard_normal((2, 2, pc["N_t"], (pc["N_x"] - 1) ** 2)))
    x = rs.surrogate_solve("wave", pc, b)
    for lane in range(2):
        assert _rel(ref.matvec("wave", pc, x[lane]), b[lane]) > 100 * RESIDUAL


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("lanes", [1, 3])
def test_b1_surrogate_solve_is_the_eager_composition(grid, lanes):
    """The surrogate solve the route hands GMRES (B1's twin between the
    'fft2' transforms, constants packed from the surrogate plan) equals
    ``_build_woodbury_half`` over that plan at refine 0."""
    op = _problem(_pc(*grid)).operator
    eager = _build_woodbury_half(op, _spectral_plan(op, mass_surrogate=True), refine=0)
    b1 = cw.build_cuda_woodbury_solver(op, refine=0, mass_surrogate=True)
    rng = np.random.default_rng([SEED, lanes, grid[0]])
    r = torch.from_numpy(rng.standard_normal((lanes, 2, op.N_t, op.space.n)))
    r = r[0] if lanes == 1 else r
    assert _rel(b1(r), eager(r)) <= SURROGATE_AGREE


def test_use_pallas_false_is_the_eager_route_bitwise():
    """``use_pallas=False`` runs today's composition: bitwise the tensor
    GMRES built without a surrogate solve; ``use_pallas=True`` agrees with
    it to rounding."""
    prob = _problem(_pc(12, 8))
    x_eager = prob.make_solver_fn(EAGER)(prob.rhs)[0]
    assert torch.equal(x_eager, build_tensor_gmres_solver(prob.operator, rtol=1e-10)(prob.rhs))
    assert _rel(prob.make_solver_fn(ROUTE)(prob.rhs)[0], x_eager) <= AGREE


@pytest.mark.parametrize("solver", [ROUTE, EAGER], ids=["b1", "eager"])
@pytest.mark.parametrize("lanes", [1, 3])
def test_counters_move_as_stated(solver, lanes):
    """Each call: ``solve.tensor_gmres`` once; ``pc.tensor_mass.applies``
    once per lock-step Arnoldi step (``krylov/step``) plus the left
    preconditioner's first apply; ``b1.launches`` not at all on the CPU."""
    prob = _problem(_pc(12, 8))
    b = prob.rhs if lanes == 1 else torch.stack([prob.rhs * (1.0 + 0.5 * i) for i in range(lanes)])
    fn = prob.make_solver_fn(solver) if lanes == 1 else prob.make_batched_solver_fn(solver)
    fn(b)  # built outside the counts
    for _ in range(2):
        before = dict(timing.counters)
        fn(b)
        moved = _moved(before)
        assert moved["solve.tensor_gmres"] == 1
        assert moved["krylov/step"] >= 1
        assert moved["pc.tensor_mass.applies"] == moved["krylov/step"] + 1
        assert "b1.launches" not in moved


def test_applies_are_the_slowest_lanes_steps_plus_one():
    """With the record: the applies of a batched call are its slowest lane's
    iterations plus one (no restart at rtol 1e-10 in 60 steps)."""
    op = _problem(_pc(16, 16)).operator
    solve = build_tensor_gmres_solver(op, with_result=True,
                                      surrogate_solve=cw.build_cuda_woodbury_solver(op, refine=0, mass_surrogate=True))
    rng = np.random.default_rng([SEED, 3])
    b = torch.from_numpy(rng.standard_normal((3, 2, op.N_t, op.space.n)))
    before = dict(timing.counters)
    _, res = solve(b)
    moved = _moved(before)
    assert bool(res.converged.all())
    assert moved["pc.tensor_mass.applies"] == int(res.iterations.max()) + 1
    assert moved["solve.tensor_gmres"] == 1


def _spans(tmp_path, run):
    """The program spans ``run()`` leaves under a CPU profiler, each with
    the name of the innermost span around it (``parent``)."""
    path = os.path.join(str(tmp_path), "trace.json")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                on_trace_ready=lambda p: p.export_chrome_trace(path)):
        run()
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("cat") == "user_annotation" and "/" in e["name"]]
    for e in events:
        around = [p for p in events if p is not e and p["tid"] == e["tid"]
                  and p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"]]
        e["parent"] = min(around, key=lambda p: p["dur"])["name"] if around else None
    return events


@pytest.mark.parametrize("solver", [ROUTE, EAGER], ids=["b1", "eager"])
def test_each_apply_is_a_pc_apply_span(tmp_path, solver):
    """One ``pc/apply`` span an apply, inside the call's
    ``entry/wave.woodbury``; on the route each holds one ``fused/b1`` and
    the 'fft2' time halves; the eager route has no ``fused/b1``."""
    prob = _problem(_pc(12, 8))
    fn = prob.make_solver_fn(solver)
    fn(prob.rhs)
    before = dict(timing.counters)
    events = _spans(tmp_path, lambda: fn(prob.rhs))
    applies = _moved(before)["pc.tensor_mass.applies"]
    names = [e["name"] for e in events]
    assert names.count("entry/wave.woodbury") == 1
    assert names.count("pc/apply") == applies
    assert {e["parent"] for e in events if e["name"] == "pc/apply"} <= {"krylov/step", "krylov/restart"}
    assert names.count("fused/b1") == (applies if solver.use_pallas else 0)
    assert {e["parent"] for e in events if e["name"] == "fused/b1"} <= {"pc/apply"}


# ------------------------------------------------------- packed constants

# sha256 (first 32 hex digits) of a11r, a11i, invdet, colc, gc and phases,
# in that order, as the packing without the ``mass_surrogate`` keyword
# gave them: the sine-diagonalizable spaces' constants do not move.
DIGESTS = {
    (1, "consistent", 32, 16, "float64"): "9a990c34dd0135013471797d3546af16",
    (1, "consistent", 32, 16, "float32"): "dc6e1611db04fdf920c63d194f62a576",
    (2, "lumped", 12, 8, "float64"): "43730b253c82833f4ab4cbf754bd4cf0",
    (1, "lumped", 17, 9, "float32"): "62fa274704796a56139e50acb0a36ba6",
}
FIELDS = ("a11r", "a11i", "invdet", "colc", "gc", "phases")


def _diag_op(dim, mass, N_x, N_t, dtype):
    sp = make_space(dim, N_x, mass=mass, dtype=getattr(torch, dtype), device="cpu")
    return build_operator(sp, N_t, 2.0 / N_t, 1.0, scaled=True)


@pytest.mark.parametrize("key", list(DIGESTS), ids=lambda k: "-".join(map(str, k)))
def test_pack_constants_of_a_diagonalizable_space_are_unchanged(key):
    op = _diag_op(*key)
    c = cw.pack_constants(op)
    h = hashlib.sha256()
    for f in FIELDS:
        h.update(getattr(c, f).contiguous().numpy().tobytes())
    assert h.hexdigest()[:32] == DIGESTS[key]
    # where the sine transform diagonalizes the space the surrogate is the space
    s = cw.pack_constants(op, mass_surrogate=True)
    assert all(torch.equal(getattr(c, f), getattr(s, f)) for f in FIELDS)


def test_pack_constants_of_the_consistent_mass_need_the_keyword():
    op = _problem(_pc(12, 8)).operator
    with pytest.raises(ValueError, match="sine-diagonalizable"):
        cw.pack_constants(op)
    c = cw.pack_constants(op, mass_surrogate=True)
    plan = _spectral_plan(op, mass_surrogate=True)
    K = op.N_t // 2 + 1
    assert torch.equal(c.a11r, torch.from_numpy(plan.a11_h[:K].real))
    assert torch.equal(c.invdet, torch.from_numpy(1.0 / plan.det_h[:K]))
