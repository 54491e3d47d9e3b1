"""The readings a cell's limit of ``correct`` is set from, on the card, in one process.

    python3 portbench/control.py --workload <cell> --seeds 1,2,... --control-seeds 1,2,3
    python3 portbench/control.py --config <file> --traffic <mix> --seeds ... --control-seeds ...

For each of ``--seeds`` it drives the cell's timed entry once over the
pool of that seed, as a run's window does, and judges every answer as a
run does (the program's readings: the lower end of the limit). For each of
``--control-seeds`` it puts the reference's solve in the program's
place, computed in the precision below the traffic's
(``reference.solve.control_precision``), and judges its answers the same
way (the control's readings: an upper end). On a space the sine transform
does not diagonalize (the 2D consistent mass), where the control is GMRES
preconditioned by the sine solve of a surrogate, each control seed gives one
more line, ``"side": "surrogate"``: the surrogate's float64 solve alone in
the program's place, judged the same way (another upper end); those lines
also give the control's GMRES steps per lane and each side's peak device
memory, and the program's lines its peak too. A mesh (a configuration's
``"mesh"``) is such a space. One JSON line per seed and side; the
benchmark's own runs never run this.

``--config`` and ``--traffic`` in place of ``--workload`` take a
configuration file and a traffic mix that no cell pairs yet: the lines are
the same, and nothing is judged against a limit (there is none), so a
cell's limit can be set before the cell exists.
"""

import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = ROOT
else:
    sys.path.insert(0, ROOT)
os.environ["PARADIAG_COMPILE_CACHE"] = os.path.join(ROOT, "optimal_control_paradiag_torch", "csrc", "_build")


def readings(cell, seed, answers, device):
    from portbench import cell as cellmod

    c = cellmod.check(cell, cellmod.judge(cell, seed, answers, device))
    return c["rel_residual"]["value"], c["answered"]["value"]


def peak(device, reset=False):
    """The card's peak allocated bytes since the last reset (None off the
    card); ``reset`` starts the count anew."""
    import torch

    if device.type != "cuda":
        return None
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
    return int(torch.cuda.max_memory_allocated(device))


def program(cell, seeds, device, sync):
    from portbench import cell as cellmod
    from portbench.reference import solve as rs

    extra = not rs.diagonalizable(cell.config["problem_config"])
    space = cellmod.mesh_space(cell, device)
    fn = cellmod.entry(cell, device, space)
    for seed in seeds:
        peak(device, reset=True)
        pool = cellmod.inputs(cell, seed, device, space)
        answers, iters, t0 = [], [], time.perf_counter()
        for b in pool:
            x, rec = fn(b)
            answers.append(x)
            if rec is not None and hasattr(rec, "iterations"):
                iters.append(float(rec.iterations.float().mean()))
        sync()
        solve_s = time.perf_counter() - t0
        del pool
        peak_bytes = peak(device)  # before the reference runs on the device
        rel, answered = readings(cell, seed, answers, device)
        line = {"side": "program", "cell": cell.name, "seed": seed, "rel_residual": rel, "answered": answered,
                "iterations": iters, "solve_s": solve_s}
        if extra:
            line["peak_bytes"] = peak_bytes
        print(json.dumps(line), flush=True)


def control(cell, seeds, device):
    import torch

    from portbench import cell as cellmod
    from portbench.reference import model as ref, solve as rs

    problem, pc, tr = cell.config["problem"], cell.config["problem_config"], cell.traffic
    precision = rs.control_precision(tr)
    batch, pool = int(tr["batch"]), int(tr["pool"])
    extra = not rs.diagonalizable(pc)  # a GMRES control, and the surrogate beside it
    mesh = cellmod.reference_mesh(cell, device)
    sides = [("control", precision, lambda b, its: rs.solve(problem, pc, b, precision, its, mesh))]
    if extra:
        sides.append(("surrogate", "float64", lambda b, its: rs.surrogate_solve(problem, pc, b)))
    for seed in seeds:
        for side, prec, solve in sides:
            peak(device, reset=True)
            t0 = time.perf_counter()
            answers, its = [], []
            for j in range(pool):
                bs = []
                for lane in range(batch):
                    data = {k: torch.from_numpy(v).to(device) for k, v in cellmod.member(cell, seed, j * batch + lane).items()}
                    bs.append(ref.rhs(problem, pc, data, mesh))
                b = torch.stack(bs) if batch > 1 else bs[0]
                answers.append(solve(b, its))
            solve_s = time.perf_counter() - t0
            rel, answered = readings(cell, seed, answers, device)
            line = {"side": side, "precision": prec, "cell": cell.name, "seed": seed,
                    "rel_residual": rel, "answered": answered, "solve_s": solve_s}
            if extra:
                line["iterations"] = its
                line["peak_bytes"] = peak(device)
            print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    which = ap.add_mutually_exclusive_group(required=True)
    which.add_argument("--workload", help="a cell of BENCHMARK.json")
    which.add_argument("--config", help="a configuration file that no cell names yet (with --traffic)")
    ap.add_argument("--traffic", help="the traffic mix of --config")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if (args.config is None) != (args.traffic is None):
        ap.error("--config and --traffic go together")

    import torch

    from portbench import manifest

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 2
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    if args.workload is not None:
        cell = manifest.load_cell(args.workload, trace=False)
    else:
        config = manifest.load_json(args.config)
        traffic = manifest.load_json(os.path.join(manifest.HERE, "traffic", args.traffic + ".json"))
        # no cell, so no limit: nothing is judged against one
        cell = manifest.Cell(name=f"{config['name']}.{args.traffic}", chips=1, config=config, traffic=traffic,
                             limits={"rel_residual": math.inf}, metrics=[])
    seeds = [int(s) for s in args.seeds.split(",") if s]
    if seeds:
        program(cell, seeds, device, sync)
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    if cseeds:
        control(cell, cseeds, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
