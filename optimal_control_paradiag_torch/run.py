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

It runs on the CUDA card unless ``--platform cpu`` is given, in both dtypes
(the JAX CLI picks the CPU for float64, which its TPU lacks). The sharded
``--mesh`` runs (with or without ``--mesh-file``) are not ported yet and
exit naming their ROADMAP item. The JAX CLI's persistent compilation cache
has no counterpart here but the kernels' build cache (``csrc/_build/``).
"""

from __future__ import annotations

import argparse
import json
import os
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
        help="run the solve sharded over a ('time','space') device mesh, e.g. "
        "'4,2' (not ported yet: ROADMAP Queue A item 14)",
    )
    p.add_argument(
        "--mesh-file",
        default=None,
        metavar="NPZ",
        help="solve on an arbitrary triangle mesh: an .npz with 'points' (n,2) "
        "float and 'triangles' (m,3) int, optional boolean 'interior' "
        "(the wave model; with --mesh not ported yet: ROADMAP Queue A item 14)",
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


def _exit_not_ported(what: str, item: str):
    raise SystemExit(f"{what} is not ported yet: ROADMAP Queue A item {item}")


def main(argv=None):
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
    if args.rebuild_eig_cache:
        return rebuild_eig_cache(args)
    if args.mesh:
        _exit_not_ported("--mesh (the sharded solve)", "14")
    # --nx default resolution: None means "not given" so per-mode defaults
    # (wave: 80, heat sweep: 128) never collide with an explicit value.
    if args.nx is None and not (args.model == "heat" and args.sweep):
        args.nx = 80
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
