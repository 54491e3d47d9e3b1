"""The ranks of ``tests/test_torch_parallel.py``: one gloo group of 8 CPU
processes runs every case of the port's sharded layer and rank 0 pickles
the results for the parent test process to assert on.

Run by ``parallel.multihost.launch_cpu_group`` as ``python
tests/torch_parallel_ranks.py OUT_DIR``; ``OUT_DIR`` holds the parent's
inputs (``inputs.npz``: the triangle meshes, the JAX package's eigenbasis
of one, a state) and the JAX package's sharded checkpoint
(``jax_ckpt_p000.npz``), and receives ``results.pkl``. Imports no JAX: each
case compares the port's sharded solve with the port's unsharded one, and
the parent compares with the JAX package's sharded solve.
"""

import math
import os
import pickle
import sys
import traceback

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402

from optimal_control_paradiag_torch import HeatControlProblem, ProblemConfig, SolverConfig, WaveControlProblem  # noqa: E402
from optimal_control_paradiag_torch import run as t_run  # noqa: E402
from optimal_control_paradiag_torch.fem.general import make_general_space  # noqa: E402
from optimal_control_paradiag_torch.interop import eig_basis_from_arrays  # noqa: E402
from optimal_control_paradiag_torch.krylov.gmres import gmres  # noqa: E402
from optimal_control_paradiag_torch.paradiag.pc import build_preconditioner  # noqa: E402
from optimal_control_paradiag_torch.paradiag.spectral import build_woodbury_solver  # noqa: E402
from optimal_control_paradiag_torch.parallel import multihost  # noqa: E402
from optimal_control_paradiag_torch.parallel.sharding import make_layout, make_mesh  # noqa: E402
from optimal_control_paradiag_torch.parallel.shardmap_ops import (  # noqa: E402
    build_shardmap_matvec,
    build_shardmap_preconditioner,
)
from optimal_control_paradiag_torch.parallel.solve import gather, make_sharded_heat_solver, make_sharded_solver  # noqa: E402
from optimal_control_paradiag_torch.utils import checkpoint as t_ckpt  # noqa: E402

OUT = sys.argv[1]
CASES = []


def case(name, grid):
    def deco(fn):
        CASES.append((name, grid, fn))
        return fn

    return deco


def wave(**kw):
    return WaveControlProblem(ProblemConfig(**kw), device="cpu")


def heat(**kw):
    return HeatControlProblem(ProblemConfig(**kw), device="cpu")


def scaled(prob, sol):
    s = math.sqrt(prob.config.gamma)
    return torch.stack([sol.u * s, sol.p]).numpy()


def sharded(prob, solver, layout, family="wave"):
    """The sharded solve of the problem's own right-hand side, gathered,
    its record and collective counts, and (on grid position 0) the port's
    unsharded solve."""
    make = make_sharded_solver if family == "wave" else make_sharded_heat_solver
    run, sh = make(prob, solver, layout)
    b = sh.shard(prob.rhs) if sh is not None else prob.rhs
    layout.counts.clear()
    x, res = run(b)
    counts = dict(layout.counts)
    N_t, n = prob.rhs.shape[-2:]
    out = dict(x=gather(layout, x, N_t, n).numpy(), even=sh is not None, counts=counts,
               iterations=None if res is None else int(res.iterations),
               converged=None if res is None else bool(res.converged))
    if layout.index == 0:
        ref = prob.solve(solver)
        out.update(ref=scaled(prob, ref), ref_iterations=None if ref.result is None else int(ref.result.iterations))
    return out


def seeded(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape))


GRIDS = {"8x1": (8, 1), "4x2": (4, 2), "2x2": (2, 2), "2x4": (2, 4), "1x8": (1, 8)}

for g in ("8x1", "4x2", "2x2"):
    case(f"solve_gmres_{g}", GRIDS[g])(lambda lay: sharded(wave(N_x=17, N_t=16), SolverConfig(rtol=1e-10), lay))
    case(f"woodbury_{g}", GRIDS[g])(lambda lay: sharded(wave(N_x=17, N_t=16), SolverConfig(method="woodbury"), lay))
for g in ("8x1", "4x2"):
    case(f"uneven_{g}", GRIDS[g])(lambda lay: sharded(wave(N_x=20, N_t=12), SolverConfig(rtol=1e-10), lay))
    case(f"minres_{g}", GRIDS[g])(
        lambda lay: sharded(wave(N_x=17, N_t=16), SolverConfig(method="minres", rtol=1e-10, maxiter=200), lay))

case("f32_parity", (4, 2))(
    lambda lay: sharded(wave(N_x=17, N_t=16, dtype=torch.float32), SolverConfig(rtol=1e-4), lay))
for dt in ("float64", "float32"):
    case(f"lumped2d_woodbury_{dt}", (4, 2))(
        lambda lay, dt=dt: sharded(wave(N_x=9, N_t=16, dim=2, mass="lumped", dtype=getattr(torch, dt)),
                                   SolverConfig(method="woodbury"), lay))
case("lumped2d_gmres", (4, 2))(
    lambda lay: sharded(wave(N_x=9, N_t=16, dim=2, mass="lumped"), SolverConfig(rtol=1e-10), lay))
case("half_f32", (8, 1))(
    lambda lay: sharded(wave(N_x=17, N_t=16, dtype=torch.float32), SolverConfig(method="woodbury"), lay))
case("heat_woodbury", (4, 2))(lambda lay: sharded(heat(N_x=17, N_t=16), SolverConfig(method="woodbury"), lay, "heat"))
case("heat_2d_consistent", (4, 2))(
    lambda lay: sharded(heat(N_x=9, N_t=16, dim=2, mass="consistent"), SolverConfig(method="woodbury"), lay, "heat"))
case("heat_minres", (4, 2))(
    lambda lay: sharded(heat(N_x=17, N_t=16), SolverConfig(method="minres", rtol=1e-10, maxiter=200), lay, "heat"))
case("wave_2d_consistent", (4, 2))(
    lambda lay: sharded(wave(N_x=9, N_t=16, dim=2, mass="consistent"), SolverConfig(method="woodbury"), lay))


@case("heat_gmres_f32", (8, 1))
def _heat_gmres_f32(lay):
    prob = heat(N_x=17, N_t=16, dtype=torch.float32)
    out = sharded(prob, SolverConfig(method="gmres", rtol=1e-4), lay, "heat")
    from optimal_control_paradiag_torch.models.heat import HeatSolution

    s = math.sqrt(prob.config.gamma)
    x = torch.from_numpy(out["x"])
    out["relative_residual"] = prob.relative_residual(HeatSolution(u=x[0] / s, p=x[1], result=None))
    return out


@case("shardmap_reject", (8, 1))
def _shardmap_reject(lay):
    try:
        build_shardmap_matvec(wave(N_x=21, N_t=12).operator, lay)
    except ValueError as exc:
        return dict(error=str(exc))
    return dict(error=None)


@case("mesh_construction", (4, 2))
def _mesh_construction(lay):
    mesh = make_mesh(4, 2)
    out = dict(axis_names=mesh.axis_names, shape=(mesh.n_time, mesh.n_space))
    try:
        make_mesh(16, 2)
    except ValueError as exc:
        out["error"] = str(exc)
    return out


for g in ("8x1", "4x2", "2x4", "1x8"):
    @case(f"shardmap_matvec_{g}", GRIDS[g])
    def _sm_matvec(lay):
        op = wave(N_x=17, N_t=16).operator
        x = seeded(0, (2, 16, 16))
        mv = build_shardmap_matvec(op, lay)
        lay.counts.clear()
        y = mv(lay.scatter(x))
        counts = dict(lay.counts)
        return dict(x=x.numpy(), got=lay.gather(y, 16, 16).numpy(), want=op.matvec(x).numpy(), counts=counts)

for g in ("8x1", "4x2", "2x4"):
    @case(f"shardmap_pc_{g}", GRIDS[g])
    def _sm_pc(lay):
        op = wave(N_x=17, N_t=16).operator
        r = seeded(1, (2, 16, 16))
        pc = build_shardmap_preconditioner(op, lay)
        lay.counts.clear()
        y = pc(lay.scatter(r))
        counts = dict(lay.counts)
        return dict(r=r.numpy(), got=lay.gather(y, 16, 16).numpy(), want=build_preconditioner(op)(r).numpy(),
                    counts=counts)


@case("shardmap_e2e", (4, 2))
def _sm_e2e(lay):
    prob = wave(N_x=17, N_t=16)
    op = prob.operator
    res = gmres(build_shardmap_matvec(op, lay), lay.scatter(prob.rhs), M=build_shardmap_preconditioner(op, lay),
                restart=50, rtol=1e-10, maxiter=100, layout=lay)
    ref = prob.solve(SolverConfig(rtol=1e-10))
    return dict(x=gather(lay, res.x, 16, 16).numpy(), iterations=int(res.iterations),
                ref=scaled(prob, ref), ref_iterations=int(ref.result.iterations))


@case("multihost", (8, 1))
def _multihost(lay):
    out = dict(summary=multihost.process_summary(), pod_size=multihost.pod_layout(n_space=2).size)
    try:
        multihost.pod_layout(n_space=3)
    except ValueError as exc:
        out["error"] = str(exc)
    return out


@case("graft", (4, 2))
def _graft(lay):
    """The JAX package's graft entry: one preconditioned residual step at
    the reference shape (float32), then its multi-device dry run's routes
    on tiny shapes over the (4, 2) grid."""
    prob = wave(N_x=80, N_t=81, dtype=torch.float32)
    pc = build_preconditioner(prob.operator)
    x0 = torch.zeros(prob.operator.shape, dtype=torch.float32)
    step = pc(prob.rhs - prob.operator.matvec(x0))
    shapes = {}
    N_t, N_x = 32, 17
    p1 = wave(N_x=N_x, N_t=N_t, dtype=torch.float32)
    p2 = wave(N_x=9, N_t=16, dim=2, mass="lumped", dtype=torch.float32)
    p2c = wave(N_x=9, N_t=16, dim=2, mass="consistent", dtype=torch.float32)
    ph = heat(N_x=N_x, N_t=N_t, dtype=torch.float32)
    phu = heat(N_x=N_x, N_t=N_t + 2, dtype=torch.float32)
    routes = {
        "gmres": (p1, SolverConfig(rtol=1e-4, restart=10, maxiter=20), "wave"),
        "woodbury": (p1, SolverConfig(method="woodbury"), "wave"),
        "lumped2d": (p2, SolverConfig(method="woodbury"), "wave"),
        "heat": (ph, SolverConfig(method="woodbury"), "heat"),
        "minres": (p1, SolverConfig(method="minres", rtol=1e-4, maxiter=40), "wave"),
        "consistent2d": (p2c, SolverConfig(method="woodbury", maxiter=20), "wave"),
        "heat_uneven": (phu, SolverConfig(method="gmres", rtol=1e-3, maxiter=20), "heat"),
    }
    for name, (prob_r, solver, fam) in routes.items():
        run, sh = (make_sharded_solver if fam == "wave" else make_sharded_heat_solver)(prob_r, solver, lay)
        x, _ = run(sh.shard(prob_r.rhs) if sh is not None else prob_r.rhs)
        shapes[name] = (tuple(gather(lay, x, *prob_r.rhs.shape[-2:]).shape), tuple(prob_r.rhs.shape), sh is None)
    return dict(step_shape=tuple(step.shape), step_finite=bool(torch.isfinite(step).all()), shapes=shapes)


def _mesh_space(key, dtype):
    z = np.load(os.path.join(OUT, "inputs.npz"))
    return make_general_space(z[f"{key}_points"], z[f"{key}_triangles"], dtype=dtype, device="cpu"), z


@case("eig_woodbury", (4, 2))
def _eig_woodbury(lay):
    gsp, z = _mesh_space("eig", torch.float32)
    basis = eig_basis_from_arrays(gsp, z["eig_lam"], z["eig_V"])
    prob = WaveControlProblem(ProblemConfig(N_x=17, N_t=16, dim=2, dtype=torch.float32), device="cpu", space=basis)
    run, sh = make_sharded_solver(prob, SolverConfig(method="woodbury"), lay)
    b = sh.shard(prob.rhs) if sh is not None else prob.rhs
    lay.counts.clear()
    x, _ = run(b)
    counts = dict(lay.counts)
    xg = gather(lay, x, 16, gsp.n)
    from optimal_control_paradiag_torch.models.wave import WaveSolution

    rel = prob.relative_residual_f64(WaveSolution(u=xg[0], p=xg[1], result=None))
    x0 = build_woodbury_solver(prob.operator, refine=1)(prob.rhs)
    return dict(x=xg.numpy(), x0=x0.numpy(), rel=rel, counts=counts, even=sh is not None)


def _pc_case(prob, variant, lay):
    op = prob.operator
    r = seeded(2, op.shape)
    pc = build_preconditioner(op, variant=variant, layout=lay)
    lay.counts.clear()
    y = pc(lay.scatter(r))
    counts = dict(lay.counts)
    got = lay.gather(y, op.N_t, op.space.n)
    return dict(got=got.numpy(), want=build_preconditioner(op, variant=variant)(r).numpy(), counts=counts)


for v in ("fulldiag", "eig"):
    case(f"pc_{v}", (4, 2))(lambda lay, v=v: _pc_case(wave(N_x=17, N_t=16), v, lay))
for v in ("block", "blockdense", "blockline"):
    case(f"pc_{v}", (4, 2))(lambda lay, v=v: _pc_case(wave(N_x=7, N_t=12, dim=2), v, lay))


@case("pc_blockband", (4, 2))
def _pc_blockband(lay):
    gsp, _ = _mesh_space("band", torch.float64)
    prob = WaveControlProblem(ProblemConfig(N_x=9, N_t=12, dim=2), device="cpu", space=gsp)
    return _pc_case(prob, "blockband", lay)


@case("batch_refused", (4, 2))
def _batch_refused(lay):
    prob = wave(N_x=17, N_t=16)
    run, _ = make_sharded_solver(prob, SolverConfig(method="woodbury"), lay)
    try:
        run(prob.rhs[None])
    except ValueError as exc:
        return dict(error=str(exc))
    return dict(error=None)


@case("cli_in_group", (4, 2))
def _cli(lay):
    out = {}
    for model, extra in (("wave", []), ("heat", ["--method", "woodbury", "--nx", "17", "--nt", "16"])):
        rec = t_run.main(["--mesh", "4,2", "--platform", "cpu", "--model", model, *extra,
                          "--out", os.path.join(OUT, f"cli_{model}")])
        out[model] = rec
    return out


@case("checkpoint", (4, 2))
def _checkpoint(lay):
    z = np.load(os.path.join(OUT, "inputs.npz"))
    state = torch.from_numpy(z["ckpt_state"])
    shape = tuple(state.shape)
    # the JAX package's file, served block by block under this layout
    from_jax = t_ckpt.load_sharded(os.path.join(OUT, "jax_ckpt"), layout=lay)
    ok_jax = bool(torch.equal(from_jax, lay.scatter(state)))
    # this package's per-rank files, read back under another layout
    t_ckpt.save_sharded(os.path.join(OUT, "port_ckpt"), lay.scatter(state), layout=lay, shape=shape)
    dist.barrier(group=lay.mesh.group)
    other = make_layout(8, 1)
    back = t_ckpt.load_sharded(os.path.join(OUT, "port_ckpt"), layout=other, stage="mode_local")
    ok_other = bool(torch.equal(back, other.scatter(state, "mode_local")))
    return dict(ok_jax=ok_jax, ok_other=ok_other)


def main():
    multihost.initialize(device="cpu", timeout_s=120)
    rank = dist.get_rank()
    results = {}
    for name, grid, fn in CASES:
        layout = make_layout(*grid)  # collective over all 8 ranks
        if layout is None:
            continue
        try:
            out = fn(layout)
        except Exception:  # a case that raises on every rank fails its test, not the rest
            out = dict(exception=traceback.format_exc())
        if rank == 0:
            results[name] = out
    if rank == 0:
        with open(os.path.join(OUT, "results.pkl"), "wb") as f:
            pickle.dump(results, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
