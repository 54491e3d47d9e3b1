"""The port's 2D heat tracking-control solve (lumped mass, the sine
transform over both grid axes) against the benchmark's plain float64
reference (``portbench/reference``), on the CPU, and the 2D sine
transform's per-axis spans and counters.

The reference is written from the stencils and imports nothing of the
port, so these tests hold the port's right-hand side, operator and
Woodbury direct solve (``use_pallas=True``: B2's plain twin on the CPU)
to an independent statement of the same system: on the benchmark's own
data sets (``portbench.traffic.member``) and on seeded random right-hand
sides, one at a time and in a batch of three. No JAX is imported.
"""

import json
import os

import numpy as np
import pytest
import torch

from optimal_control_paradiag_torch import HeatControlProblem, ProblemConfig, SolverConfig
from optimal_control_paradiag_torch.fem.space import make_space
from optimal_control_paradiag_torch.utils import timing
from portbench import traffic
from portbench.reference import model as ref, solve as rs

torch.set_num_threads(1)

SEED = 2**31 + 18  # past 32 signed bits, as the benchmark's seeds are
GRIDS = [(12, 6), (16, 8)]
DTYPES = ["float64", "float32"]

# Float64 relative residual of the port's answer by the reference: the
# direct solve is exact but for rounding (2.4e-15 read), so 1e-12 leaves
# room for the sine transform's and the FFT's sums of ~N_x and ~N_t terms.
RESIDUAL_F64 = 1e-12
# The same with float32 transforms: 1.7e-6 read on the benchmark's data
# (member 0, the smooth manufactured mode, the largest), near 30 float32
# ulps; 1e-5 leaves 6x, and a wrong operator or constant reads O(1).
RESIDUAL_F32 = 1e-5
# Port against the reference's block-tridiagonal direct solve, float64:
# two exact solves of one well-conditioned system (2.4e-16 read).
AGREE_F64 = 1e-12
# The right-hand side and the operator: the same stencils, summed in
# another order, differ by a few ulps of the largest entry (1.5e-16 read).
STENCIL_F64 = 1e-13


def _pc(N_x, N_t):
    return dict(N_x=N_x, N_t=N_t, T=2.0, gamma=1.0, dim=2, scaled=True, mass="lumped")


def _problem(pc, dtype, data=None):
    return HeatControlProblem(ProblemConfig(**pc, dtype=getattr(torch, dtype)), device="cpu", data=data)


def _solver(prob):
    return prob._make_solver(SolverConfig(method="woodbury", use_pallas=True, refine=1))


def _rel(a, b):
    return float(torch.linalg.norm((a - b).reshape(-1)) / torch.linalg.norm(b.reshape(-1)))


def _members(pc, dtype, count):
    """The benchmark's data sets 0 .. count - 1 of SEED: member 0 the
    manufactured data, the others at modes 2, 3 with seeded scales."""
    return [traffic.member("heat", pc, dtype, SEED, i) for i in range(count)]


def _torch(data):
    return {k: torch.from_numpy(v) for k, v in data.items()}


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lanes", [1, 3])
def test_benchmark_data_solved_to_the_reference(grid, dtype, lanes):
    """The benchmark's data sets, each b built by the port from ``data=``,
    solved one at a time or stacked: every answer's float64 residual by the
    reference, and in float64 the reference's own direct solve."""
    pc = _pc(*grid)
    datas = _members(pc, dtype, lanes)
    probs = [_problem(pc, dtype, d) for d in datas]
    fn = _solver(probs[0])
    if lanes == 1:
        xs = [fn(probs[0].rhs)[0]]
    else:
        xb, _ = fn(torch.stack([p.rhs for p in probs]))
        assert xb.shape == (lanes, 2, pc["N_t"], (pc["N_x"] - 1) ** 2)
        xs = list(xb)
    limit = RESIDUAL_F64 if dtype == "float64" else RESIDUAL_F32
    for data, x in zip(datas, xs):
        assert ref.rel_residual("heat", pc, _torch(data), x) <= limit
        if dtype == "float64":
            b = ref.rhs("heat", pc, _torch(data))
            assert _rel(x, rs.solve("heat", pc, b, "float64")) <= AGREE_F64


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lanes", [1, 3])
def test_random_right_hand_sides_solved_to_the_reference(grid, dtype, lanes):
    """Seeded random b (every sine mode and time slice excited), in the
    port's dtype: the float64 residual of each lane by the reference's
    operator, and in float64 the reference's direct solve."""
    pc = _pc(*grid)
    n = (pc["N_x"] - 1) ** 2
    rng = np.random.default_rng([SEED, lanes, pc["N_x"]])
    b = torch.from_numpy(rng.standard_normal((lanes, 2, pc["N_t"], n))).to(getattr(torch, dtype))
    fn = _solver(_problem(pc, dtype))
    x = fn(b[0])[0][None] if lanes == 1 else fn(b)[0]
    b64 = b.to(torch.float64)
    limit = RESIDUAL_F64 if dtype == "float64" else RESIDUAL_F32
    for lane in range(lanes):
        assert _rel(ref.matvec("heat", pc, x[lane].to(torch.float64)), b64[lane]) <= limit
    if dtype == "float64":
        assert _rel(x, rs.solve("heat", pc, b64, "float64")) <= AGREE_F64


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_rhs_and_operator_match_the_reference(grid):
    """Float64: the port's b from the benchmark's data and its matvec on a
    seeded random state (and a batch of three) equal the reference's."""
    pc = _pc(*grid)
    data = _members(pc, "float64", 2)[1]
    prob = _problem(pc, "float64", data)
    want = ref.rhs("heat", pc, _torch(data))
    assert float((prob.rhs - want).abs().max() / want.abs().max()) <= STENCIL_F64
    rng = np.random.default_rng([SEED, pc["N_x"]])
    x = torch.from_numpy(rng.standard_normal((3, 2, pc["N_t"], (pc["N_x"] - 1) ** 2)))
    want = ref.matvec("heat", pc, x)
    assert float((prob.matvec(x) - want).abs().max() / want.abs().max()) <= STENCIL_F64
    want = ref.matvec("heat", pc, x[0])
    assert float((prob.matvec(x[0]) - want).abs().max() / want.abs().max()) <= STENCIL_F64


# ----------------------------------------------------------- per-axis spans

AXES = ("transforms/dst.x", "transforms/dst.y")


def _spans(tmp_path, run):
    """The program spans ``run()`` leaves under a CPU profiler, each with
    the name of the innermost span around it (``parent``)."""
    path = os.path.join(str(tmp_path), "trace.json")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                on_trace_ready=lambda p: p.export_chrome_trace(path)):
        out = run()
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("cat") == "user_annotation" and "/" in e["name"]]
    for e in events:
        around = [p for p in events if p is not e and p["tid"] == e["tid"]
                  and p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"]]
        e["parent"] = min(around, key=lambda p: p["dur"])["name"] if around else None
    return events, out


def _axis_counts():
    return tuple(timing.counters[a] for a in AXES)


# (dst_method, dst_precision, dtype): each route of P1Space._dst to a 2D pass
ROUTES = [("matmul", "highest", torch.float64), ("matmul", "highest", torch.float32),
          ("matmul", "high", torch.float32), ("fft", "highest", torch.float64), ("mxu4", "highest", torch.float64)]


@pytest.mark.parametrize("route", ROUTES, ids=lambda r: f"{r[0]}-{r[1]}-{str(r[2])[6:]}")
@pytest.mark.parametrize("inverse", [False, True], ids=["dst", "idst"])
def test_2d_transform_opens_one_span_per_axis(tmp_path, route, inverse):
    """One 2D sine transform call: one ``transforms/dst.x`` and one
    ``transforms/dst.y`` span, both directly inside ``transforms/dst``, each
    counted once (the bf16x3 route's ``fused/b3`` call inside each); the
    answer is bitwise the one computed untraced."""
    method, precision, dtype = route
    sp = make_space(2, 16, mass="lumped", dtype=dtype, device="cpu", dst_method=method, dst_precision=precision)
    x = torch.from_numpy(np.random.default_rng(SEED).standard_normal((2, 3, sp.n))).to(dtype)
    fn = sp.idst if inverse else sp.dst
    untraced = fn(x)
    before = _axis_counts()
    events, traced = _spans(tmp_path, lambda: fn(x))
    names = [e["name"] for e in events]
    b3 = ["fused/b3"] * 2 if precision == "high" else []
    assert sorted(names) == sorted(["transforms/dst", *AXES, *b3])
    assert all(e["parent"] == "transforms/dst" for e in events if e["name"] in AXES)
    assert sorted(e["parent"] for e in events if e["name"] == "fused/b3") == sorted(AXES[:len(b3)])
    assert [a - b for a, b in zip(_axis_counts(), before)] == [1, 1]
    assert torch.equal(traced, untraced)


@pytest.mark.parametrize("method", ["matmul", "fft", "mxu4"])
def test_1d_transform_opens_no_axis_span(tmp_path, method):
    sp = make_space(1, 16, mass="lumped", dtype=torch.float64, device="cpu", dst_method=method)
    x = torch.from_numpy(np.random.default_rng(SEED).standard_normal((2, 3, sp.n)))
    before = _axis_counts()
    events, _ = _spans(tmp_path, lambda: sp.idst(sp.dst(x)))
    assert [e["name"] for e in events] == ["transforms/dst", "transforms/dst"]
    assert _axis_counts() == before


@pytest.mark.parametrize("dim", [1, 2])
def test_woodbury_solve_axis_spans(tmp_path, dim):
    """A heat Woodbury solve: in 2D, two of each axis span (the forward and
    the inverse transform), counted, each inside ``transforms/dst``; in 1D
    none."""
    prob = HeatControlProblem(ProblemConfig(N_x=16, N_t=8, dim=dim, mass="lumped"), device="cpu")
    fn = _solver(prob)
    fn(prob.rhs)  # built outside the trace
    before = _axis_counts()
    events, _ = _spans(tmp_path, lambda: fn(prob.rhs))
    names = [e["name"] for e in events]
    per_axis = 2 if dim == 2 else 0
    assert [names.count(a) for a in AXES] == [per_axis, per_axis]
    assert [a - b for a, b in zip(_axis_counts(), before)] == [per_axis, per_axis]
    assert {e["parent"] for e in events if e["name"] in AXES} <= {"transforms/dst"}
    assert names.count("transforms/dst") == 2
