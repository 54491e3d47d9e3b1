"""CLI driver of the PyTorch port -- the reference's L5 experiment layer.

The counterpart of ``optimal_control_paradiag_tpu/run.py``, which replaces
the module-level script at ``Control_Wave_PC.py:334-372, 562-631`` (config
constants, pc/complex dispatch, wall-clock prints, convergence sweep writing
``error.out``), with the same flags, records and files:

  python -m optimal_control_paradiag_torch.run                 # default run, on the card
  python -m optimal_control_paradiag_torch.run --platform cpu  # the same on the CPU
  python -m optimal_control_paradiag_torch.run --nx 128 --nt 129 --rtol 1e-8
  python -m optimal_control_paradiag_torch.run --sweep          # N = 5..70 sweep
  python -m optimal_control_paradiag_torch.run --dim 2 --mass lumped
  python -m optimal_control_paradiag_torch.run --model heat --method woodbury
  python -m optimal_control_paradiag_torch.run --model heat --sweep  # tau-order
  python -m optimal_control_paradiag_torch.run --dim 2                # 2D consistent mass
  python -m optimal_control_paradiag_torch.run --mesh-file mesh.npz   # a triangle mesh
  python -m optimal_control_paradiag_torch.run --rebuild-eig-cache    # the N = 144 mesh's eigenbasis
  python -m optimal_control_paradiag_torch.run --mesh 4,2 --platform cpu         # sharded, 8 CPU ranks
  torchrun --nproc-per-node 4 -m optimal_control_paradiag_torch.run --mesh 4,1   # sharded, 4 cards

It runs on the CUDA card unless ``--platform cpu`` is given, in both dtypes
(the JAX CLI picks the CPU for float64, which its TPU lacks). ``--mesh
TIME,SPACE`` runs the solve sharded over a grid of processes
(``parallel/solve.py``), one per device: on the CPU the CLI starts the gloo
group itself when no launcher did; on the cards each rank comes from
``torchrun`` (one card per rank), and a grid larger than the visible cards
is an error. At start-up the CLI enables the build cache of the compiled
kernels (``utils/compilation_cache.py``), where the JAX CLI enables its
persistent compilation cache.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

# Where --rebuild-eig-cache writes eig_basis_N{N}.npz (git-ignored).
EIG_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "artifacts", "cache")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument(
        "--model",
        default="wave",
        choices=("wave", "heat"),
        help="model family: the reference's wave control problem, or the "
        "backward-Euler heat control problem (models/heat.py)",
    )
    p.add_argument(
        "--nx",
        type=int,
        default=None,
        help="spatial elements (default 80, the reference's; the heat tau-sweep "
        "defaults to 128 so the spatial error stays subdominant)",
    )
    p.add_argument("--nt", type=int, default=81, help="time slices (ref default 81)")
    p.add_argument("--T", type=float, default=2.0)
    p.add_argument("--gamma", type=float, default=1.0)
    p.add_argument("--dim", type=int, default=1, choices=(1, 2))
    p.add_argument("--mass", default="consistent", choices=("consistent", "lumped"))
    p.add_argument("--dtype", default="float64", choices=("float32", "float64"))
    p.add_argument(
        "--method",
        default="gmres",
        choices=("gmres", "minres", "direct", "spectral", "woodbury"),
    )
    p.add_argument("--pc", default="paradiag", choices=("paradiag", "none"))
    p.add_argument(
        "--pc-variant",
        default="fulldiag",
        choices=("fulldiag", "eig", "block", "blockdense", "blockline", "blockband"),
    )
    p.add_argument(
        "--inner",
        default="auto",
        choices=("auto", "dst", "tridiag_thomas", "tridiag_pcr", "cocg", "cocg_jacobi"),
    )
    p.add_argument("--rtol", type=float, default=1e-5)
    p.add_argument("--restart", type=int, default=300)
    p.add_argument("--maxiter", type=int, default=1000)
    p.add_argument(
        "--mesh",
        default=None,
        metavar="TIME,SPACE",
        help="run the solve sharded over a ('time','space') grid of processes, "
        "e.g. '4,2': on the CPU a gloo group the CLI starts itself, on the "
        "cards one torchrun rank per card",
    )
    p.add_argument(
        "--mesh-file",
        default=None,
        metavar="NPZ",
        help="solve on an arbitrary triangle mesh: an .npz with 'points' (n,2) "
        "float and 'triangles' (m,3) int, optional boolean 'interior' "
        "(the wave model; with --mesh the sharded eigenbasis solve)",
    )
    p.add_argument("--sweep", action="store_true", help="run the N=5..70 convergence sweep (ref :583-631)")
    p.add_argument(
        "--rebuild-eig-cache",
        action="store_true",
        help="(re)build the cached generalized eigenbasis of the wall-size "
        "unstructured bench mesh (artifacts/cache/eig_basis_N144.npz; n=20449 "
        "interior DoFs, float32) and exit. --eig-method picks the backend; "
        "--nx overrides the mesh size (N interior nodes per side = nx-1)",
    )
    p.add_argument(
        "--eig-method",
        default="auto",
        choices=("auto", "sdc", "torch", "host", "device"),
        help="pencil-eigendecomposition backend of --rebuild-eig-cache and of the "
        "sharded --mesh-file solve: 'device' = torch.linalg on the card (cuSOLVER), "
        "'sdc' = blocked spectral divide-and-conquer on the card, 'torch'/'host' = "
        "host LAPACK in float32/float64; 'auto' = device on the card, else torch",
    )
    p.add_argument("--out", default="out", help="output directory")
    p.add_argument("--write-vtk", action="store_true")
    p.add_argument("--plot", action="store_true", help="write pngs (needs matplotlib)")
    p.add_argument(
        "--profile",
        default=None,
        help="torch.profiler trace directory: the solves' trace goes to <dir>/trace.json",
    )
    p.add_argument(
        "--x64",
        action="store_true",
        help="accepted for the JAX CLI's sake and has no effect: --dtype decides",
    )
    p.add_argument(
        "--platform",
        default="auto",
        choices=("auto", "cpu", "cuda"),
        help="'auto' and 'cuda': the CUDA card, in either dtype (raises without "
        "one); 'cpu': the CPU",
    )
    return p


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if args.mesh and args.sweep:
        raise SystemExit(
            "--mesh and --sweep cannot be combined (the sweep runs many "
            "problem sizes that would each need their own sharded program); "
            "run the sweep unsharded, or single sizes with --mesh"
        )
    if args.mesh_file and args.model == "heat":
        raise SystemExit(
            "--mesh-file applies to the wave model only (the heat family "
            "builds structured spaces); the user mesh would otherwise be "
            "silently dropped"
        )
    if args.mesh_file and args.sweep:
        raise SystemExit(
            "--mesh-file with --sweep is not supported: the sweep rebuilds "
            "structured N_x=N_t=N problems, which would silently drop the "
            "user mesh"
        )
    from optimal_control_paradiag_torch.utils.compilation_cache import enable_persistent_cache

    enable_persistent_cache()
    if args.rebuild_eig_cache:
        return rebuild_eig_cache(args)
    # --nx default resolution: None means "not given" so per-mode defaults
    # (wave: 80, heat sweep: 128) never collide with an explicit value.
    if args.nx is None and not (args.model == "heat" and args.sweep):
        args.nx = 80
    if args.mesh:
        return run_mesh(args, argv)
    import torch

    from optimal_control_paradiag_torch import ProblemConfig, SolverConfig, WaveControlProblem
    from optimal_control_paradiag_torch.io.writers import write_solution
    from optimal_control_paradiag_torch.utils.constants import resolve_device
    from optimal_control_paradiag_torch.utils.timing import StageTimer, profile_trace

    try:
        device = resolve_device("cpu" if args.platform == "cpu" else "cuda")
    except RuntimeError as exc:
        raise SystemExit(f"--platform {args.platform}: {exc} (--platform cpu)") from exc
    dtype = torch.float64 if args.dtype == "float64" else torch.float32
    solver = SolverConfig(
        method=args.method,
        pc=None if args.pc == "none" else args.pc,
        pc_variant=args.pc_variant,
        inner=args.inner,
        rtol=args.rtol,
        restart=args.restart,
        maxiter=args.maxiter,
    )
    os.makedirs(args.out, exist_ok=True)

    if args.model == "heat":
        return run_heat(args, dtype, solver, device)
    if args.sweep:
        return run_sweep(args, dtype, solver, device)

    space = None
    if args.mesh_file:
        import numpy as np

        from optimal_control_paradiag_torch.fem.general import make_general_space

        z = np.load(args.mesh_file)
        space = make_general_space(
            z["points"],
            z["triangles"],
            dtype=dtype,
            interior=z["interior"] if "interior" in z.files else None,
            device=device,
        )
        args.dim = 2
    cfg = ProblemConfig(
        N_x=args.nx, N_t=args.nt, T=args.T, gamma=args.gamma,
        dim=args.dim, mass=args.mass, dtype=dtype,
    )
    timer = StageTimer()
    with timer.stage("setup") as out:
        prob = WaveControlProblem(cfg, device=device, space=space)
        out["fence"] = prob.rhs
    with profile_trace(args.profile):
        with timer.stage("solve (compile + run)") as out:
            sol = prob.solve(solver)
            out["fence"] = sol.u
        with timer.stage("solve (cached)") as out:
            sol = prob.solve(solver)
            out["fence"] = sol.u
    record = {
        "config": {k: str(v) for k, v in vars(args).items()},
        "iterations": int(sol.result.iterations) if sol.result is not None else None,
        "converged": bool(sol.result.converged) if sol.result is not None else True,
        "residual_norm_true": float(prob.residual_norm(sol)),
        "error_reference_metric": prob.error_vs_analytic(sol),
        "error_aligned_metric": prob.error_aligned(sol),
        "timings_ms": {k: v * 1000 for k, v in timer.records.items()},
    }
    print(json.dumps(record, indent=2))
    npz = write_solution(prob, sol, os.path.join(args.out, "solution"), vtk=args.write_vtk)
    print(f"wrote {npz}")
    if sol.result is not None:
        import numpy as np

        from optimal_control_paradiag_torch.utils.constants import host_array

        hist = host_array(sol.result.residual_history)
        np.savetxt(os.path.join(args.out, "residuals.out"), hist[np.isfinite(hist)])
    if args.plot:
        from optimal_control_paradiag_torch.viz.plotting import plot_residual_history, plot_time_slice

        plot_time_slice(npz, out=os.path.join(args.out, "slice.png"))
        if sol.result is not None:
            plot_residual_history(
                sol.result.residual_history, out=os.path.join(args.out, "residuals.png")
            )
    return record


def _grid(args):
    try:
        n_time, n_space = (int(v) for v in args.mesh.split(","))
    except ValueError:
        raise SystemExit(f"--mesh expects 'TIME,SPACE' integers, got {args.mesh!r}") from None
    if n_time < 1 or n_space < 1:
        raise SystemExit(f"--mesh needs positive axes, got {args.mesh!r}")
    return n_time, n_space


# rank 0 of a CPU group the CLI started writes its record here
_RECORD_ENV = "PARADIAG_RUN_RECORD"


def run_mesh(args, argv):
    """``--mesh``: the sharded solve. Joins the process group this run
    belongs to, or starts one: with ``--platform cpu`` and no launcher, a
    gloo group of ``TIME*SPACE`` ranks running this command
    (``parallel.multihost.launch_cpu_group``), whose rank-0 record is
    returned; on the cards, one rank per card from ``torchrun`` (a 1x1 grid
    runs in this process). Never puts a rank on the CPU unless asked."""
    import torch
    import torch.distributed as dist

    from optimal_control_paradiag_torch.parallel import multihost

    n_time, n_space = _grid(args)
    need = n_time * n_space
    if args.model == "heat" and args.method not in ("woodbury", "gmres", "minres"):
        raise SystemExit(f"--model heat with --mesh supports woodbury/gmres/minres, not {args.method!r}")
    if args.mesh_file and args.method != "woodbury":
        raise SystemExit(
            "--mesh-file with --mesh supports --method woodbury (the eigenbasis "
            "direct solve); other methods dispatch on structured spaces"
        )
    launched = dist.is_initialized() or multihost.INIT_ENV in os.environ or "WORLD_SIZE" in os.environ
    if args.platform == "cpu":
        if not launched:
            with tempfile.TemporaryDirectory(prefix="paradiag_mesh_") as tmp:
                rec_path = os.path.join(tmp, "record.json")
                pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
                env = dict(os.environ, **{_RECORD_ENV: rec_path})
                env["PYTHONPATH"] = os.pathsep.join(p for p in (pkg_root, env.get("PYTHONPATH")) if p)
                done = multihost.launch_cpu_group(["-m", "optimal_control_paradiag_torch.run", *argv], need, env=env)
                sys.stdout.write(done[0].stdout)
                with open(rec_path) as f:
                    return json.load(f)
        multihost.initialize(device="cpu")
        device = torch.device("cpu")
    elif launched:  # one rank per card, from torchrun
        multihost.initialize(device="cuda")
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if need > count:
            raise SystemExit(
                f"--mesh {args.mesh} needs {need} ranks, one per card, and {count} CUDA card(s) are "
                "visible; use fewer ranks, or --platform cpu for a CPU group"
            )
        if need > 1:
            raise SystemExit(f"--mesh {args.mesh} on the cards: launch with torchrun --nproc-per-node {need}")
        with multihost.group_of_one(device="cuda"):
            return run_sharded(args, n_time, n_space, torch.device("cuda", torch.cuda.current_device()))
    if dist.get_world_size() < need:
        raise SystemExit(f"--mesh {args.mesh} needs {need} ranks, the group has {dist.get_world_size()}")
    return run_sharded(args, n_time, n_space, device)


def run_sharded(args, n_time, n_space, device):
    """The sharded solve on this rank (JAX ``run.py:run_sharded``): both
    model families, and ``--mesh-file`` through the eigenbasis Woodbury
    solve. Rank 0 prints the JSON record (the JAX CLI's fields plus the
    layout's collective counts) and returns it; ranks outside the grid
    return None."""
    import math

    import numpy as np
    import torch

    from optimal_control_paradiag_torch import ProblemConfig, SolverConfig, WaveControlProblem
    from optimal_control_paradiag_torch.parallel.sharding import make_layout
    from optimal_control_paradiag_torch.parallel.solve import gather, make_sharded_heat_solver, make_sharded_solver

    dtype = torch.float64 if args.dtype == "float64" else torch.float32
    solver = SolverConfig(
        method=args.method, pc=None if args.pc == "none" else args.pc, pc_variant=args.pc_variant,
        inner=args.inner, rtol=args.rtol, restart=args.restart, maxiter=args.maxiter,
    )
    layout = make_layout(n_time, n_space)
    if layout is None:
        return None
    space = None
    if args.mesh_file:
        # a user mesh rides the sharded Woodbury stage layouts over its
        # pencil eigenbasis (the V products are mode-local: no all-gather)
        from optimal_control_paradiag_torch.fem.general import make_general_space
        from optimal_control_paradiag_torch.paradiag.eigbasis import EigBasisSpace, build_eig_basis

        z = np.load(args.mesh_file)
        gsp = make_general_space(z["points"], z["triangles"], dtype=dtype,
                                 interior=z["interior"] if "interior" in z.files else None, device=device)
        # rank 0 builds the basis and every rank transforms with its V and
        # applies its eigenvalues (with its grade, for the step count)
        grades = ("f64", "f32", "f32_sdc")
        if layout.index == 0:
            basis = build_eig_basis(gsp, method=args.eig_method)
            V, grade = basis.V, grades.index(basis.quality)
            lam = torch.as_tensor(basis.lam, dtype=torch.float64, device=device)
        else:
            V = torch.empty((gsp.n, gsp.n), dtype=dtype, device=device)
            lam, grade = torch.empty(gsp.n, dtype=torch.float64, device=device), 0
        grade_t = layout.broadcast(torch.tensor([grade], dtype=torch.int64, device=device))
        space = EigBasisSpace(base=gsp, lam=layout.broadcast(lam).cpu().numpy(), V=layout.broadcast(V),
                              quality=grades[int(grade_t.item())])
        args.dim = 2
    cfg = ProblemConfig(N_x=args.nx, N_t=args.nt, T=args.T, gamma=args.gamma,
                        dim=args.dim, mass=args.mass, dtype=dtype)
    if args.model == "heat":
        from optimal_control_paradiag_torch.models.heat import HeatControlProblem, HeatSolution

        prob = HeatControlProblem(cfg, device=device)
        run, sharding = make_sharded_heat_solver(prob, solver, layout)
    else:
        prob = WaveControlProblem(cfg, device=device, space=space)
        run, sharding = make_sharded_solver(prob, solver, layout)
    b = sharding.shard(prob.rhs) if sharding is not None else prob.rhs
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    times = {}
    for stage in ("solve (compile + run)", "solve (cached)"):
        layout.counts.clear()
        sync()
        t0 = time.perf_counter()
        x, res = run(b)
        sync()
        times[stage] = (time.perf_counter() - t0) * 1e3
    counts = dict(layout.counts)
    N_t, n = prob.rhs.shape[-2:]
    x = gather(layout, x, N_t, n)
    if args.model == "heat":
        s = math.sqrt(cfg.gamma)
        sol = HeatSolution(u=x[0] / s, p=x[1], result=res)
        resid = prob.relative_residual(sol)
    else:
        from optimal_control_paradiag_torch.models.wave import WaveSolution

        u, p = prob._unscale(x)
        sol = WaveSolution(u=u, p=p, result=res)
        resid = float(prob.residual_norm(sol))
    record = {
        "mesh": {"time": n_time, "space": n_space, "devices": n_time * n_space},
        "model": args.model,
        "iterations": int(res.iterations) if res is not None else None,
        "residual": resid,
        "relative_residual_f64": prob.relative_residual_f64(sol) if layout.index == 0 else None,
        "timings_ms": times,
        "collectives": counts,
    }
    if layout.index == 0:
        print(json.dumps(record, indent=2))
        if _RECORD_ENV in os.environ:
            with open(os.environ[_RECORD_ENV], "w") as f:
                json.dump(record, f)
    return record


def rebuild_eig_cache(args):
    """Build the eigenbasis of the JAX bench's wall-size mesh (the unit
    square with N = ``--nx`` (default 144) cells per side, interior nodes
    moved by ``default_rng(0).uniform(+-0.18/N)``, float32) with
    ``--eig-method`` and save it to ``EIG_CACHE_DIR/eig_basis_N{N}.npz``,
    where ``paradiag.eigbasis.load_eig_basis`` restores it. Prints and
    returns the record."""
    import numpy as np
    import torch

    from optimal_control_paradiag_torch import native
    from optimal_control_paradiag_torch.fem.general import boundary_nodes, make_general_space
    from optimal_control_paradiag_torch.paradiag.eigbasis import build_eig_basis, save_eig_basis
    from optimal_control_paradiag_torch.utils.constants import resolve_device

    try:
        device = resolve_device("cpu" if args.platform == "cpu" else "cuda")
    except RuntimeError as exc:
        raise SystemExit(f"--platform {args.platform}: {exc} (--platform cpu)") from exc
    N = args.nx if args.nx else 144
    n = (N - 1) ** 2
    method = args.eig_method
    if method == "auto":
        method = "device" if device.type == "cuda" else "torch"
    print(f"building eig basis: N={N} (n={n} interior DoFs), method={method}, device={device}", flush=True)
    pts, tris = native.unit_square_mesh(N, diagonal="left")
    bnd = boundary_nodes(pts.shape[0], tris)
    rng = np.random.default_rng(0)
    pts = pts.copy()
    pts[~bnd] += rng.uniform(-0.18 / N, 0.18 / N, size=pts[~bnd].shape)
    sp = make_general_space(pts, tris, dtype=torch.float32, device=device)
    phases = {}
    t0 = time.time()
    basis = build_eig_basis(sp, method=method, timings=phases)
    t_build = time.time() - t0
    os.makedirs(EIG_CACHE_DIR, exist_ok=True)
    path = save_eig_basis(os.path.join(EIG_CACHE_DIR, f"eig_basis_N{N}.npz"), basis)
    rec = {"N": N, "n": n, "method": method, "quality": basis.quality, "build_s": t_build,
           "phases_s": phases, "path": path}
    print(json.dumps(rec, indent=2))
    return rec


def run_heat(args, dtype, solver, device="cuda"):
    """The heat-control family (models/heat.py). ``--sweep`` runs the
    tau-refinement study (N_t doubling at fixed N_x): backward Euler's O(tau)
    is the analogue of the reference's O(N^-2) wave sweep
    (``Control_Wave_PC.py:583-631``)."""
    import numpy as np

    from optimal_control_paradiag_torch import ProblemConfig
    from optimal_control_paradiag_torch.models.heat import HeatControlProblem
    from optimal_control_paradiag_torch.utils.constants import host_array
    from optimal_control_paradiag_torch.utils.timing import StageTimer

    if solver.method not in ("woodbury", "gmres", "minres", "direct"):
        raise SystemExit(
            f"--model heat supports woodbury/gmres/minres/direct, not {solver.method!r}"
        )

    if args.sweep:
        Nts = [8, 16, 32, 64, 128]
        nx = args.nx if args.nx is not None else 128
        errors, iters = [], []
        for N_t in Nts:
            prob = HeatControlProblem(
                ProblemConfig(N_x=nx, N_t=N_t, T=args.T,
                              gamma=args.gamma, dim=args.dim, mass=args.mass, dtype=dtype),
                device=device,
            )
            sol = prob.solve(solver)
            errors.append(prob.error_vs_analytic(sol))
            iters.append(int(sol.result.iterations) if sol.result is not None else 0)
            print(f"N_t={N_t:4d} iters={iters[-1]:3d} e={errors[-1]:.6e}")
        np.savetxt(os.path.join(args.out, "error.out"), np.asarray(errors))
        with open(os.path.join(args.out, "sweep.json"), "w") as f:
            json.dump({"N_t": Nts, "error": errors, "iterations": iters}, f, indent=2)
        return {"N_t": Nts, "errors": errors}

    cfg = ProblemConfig(
        N_x=args.nx, N_t=args.nt, T=args.T, gamma=args.gamma,
        dim=args.dim, mass=args.mass, dtype=dtype,
    )
    timer = StageTimer()
    with timer.stage("setup") as out:
        prob = HeatControlProblem(cfg, device=device)
        out["fence"] = prob.rhs
    with timer.stage("solve (compile + run)") as out:
        sol = prob.solve(solver)
        out["fence"] = sol.u
    with timer.stage("solve (cached)") as out:
        sol = prob.solve(solver)
        out["fence"] = sol.u
    record = {
        "config": {k: str(v) for k, v in vars(args).items()},
        "iterations": int(sol.result.iterations) if sol.result is not None else None,
        "relative_residual": prob.relative_residual(sol),
        "error_vs_analytic": prob.error_vs_analytic(sol),
        "timings_ms": {k: v * 1000 for k, v in timer.records.items()},
    }
    print(json.dumps(record, indent=2))
    np.savez(
        os.path.join(args.out, "heat_solution.npz"),
        u=host_array(sol.u), p=host_array(sol.p),
    )
    return record


def run_sweep(args, dtype, solver, device="cuda"):
    """The reference's convergence sweep (``Control_Wave_PC.py:583-631``):
    N_x = N_t = N for N in 5..70 step 5; writes ``error.out`` (their format:
    one error per line) plus a richer JSON record."""
    import numpy as np

    from optimal_control_paradiag_torch import ProblemConfig, WaveControlProblem

    Ns = list(range(5, 71, 5))
    errors, aligned, iters = [], [], []
    for N in Ns:
        t0 = time.time()
        prob = WaveControlProblem(
            ProblemConfig(N_x=N, N_t=N, T=args.T, gamma=args.gamma, dim=args.dim, mass=args.mass, dtype=dtype),
            device=device,
        )
        sol = prob.solve(solver)
        errors.append(prob.error_vs_analytic(sol))
        aligned.append(prob.error_aligned(sol))
        iters.append(int(sol.result.iterations) if sol.result is not None else 0)
        print(f"N={N:3d} iters={iters[-1]:3d} e_ref={errors[-1]:.6e} e_aligned={aligned[-1]:.6e} ({time.time() - t0:.2f}s)")
    np.savetxt(os.path.join(args.out, "error.out"), np.asarray(errors))
    with open(os.path.join(args.out, "sweep.json"), "w") as f:
        json.dump({"N": Ns, "error_reference_metric": errors, "error_aligned_metric": aligned, "iterations": iters}, f, indent=2)
    if args.plot:
        from optimal_control_paradiag_torch.viz.plotting import plot_convergence

        plot_convergence(Ns, errors, aligned, out=os.path.join(args.out, "convergence.png"))
    return {"N": Ns, "errors": errors}


if __name__ == "__main__":
    main()
