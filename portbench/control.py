"""The readings a cell's limit of ``correct`` is set from, on the card, in one process.

    python3 portbench/control.py --workload <cell> --seeds 1,2,... --control-seeds 1,2,3

For each of ``--seeds`` it drives the cell's timed entry once over the
pool of that seed, as a run's window does, and judges every answer as a
run does (the program's readings: the lower end of the limit). For each of
``--control-seeds`` it puts the reference's direct solve in the program's
place, computed in the precision below the traffic's
(``reference.solve.control_precision``), and judges its answers the same
way (the control's readings: the upper end). One JSON line per seed; the
benchmark's own runs never run this.
"""

import json
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


def program(cell, seeds, device, sync):
    from portbench import cell as cellmod

    fn = cellmod.entry(cell, device)
    for seed in seeds:
        pool = cellmod.inputs(cell, seed, device)
        answers, iters, t0 = [], [], time.perf_counter()
        for b in pool:
            x, rec = fn(b)
            answers.append(x)
            if rec is not None and hasattr(rec, "iterations"):
                iters.append(float(rec.iterations.float().mean()))
        sync()
        solve_s = time.perf_counter() - t0
        del pool
        rel, answered = readings(cell, seed, answers, device)
        print(json.dumps({"side": "program", "cell": cell.name, "seed": seed, "rel_residual": rel,
                          "answered": answered, "iterations": iters, "solve_s": solve_s}), flush=True)


def control(cell, seeds, device):
    import torch

    from portbench import cell as cellmod
    from portbench.reference import model as ref, solve as rs

    problem, pc, tr = cell.config["problem"], cell.config["problem_config"], cell.traffic
    precision = rs.control_precision(tr)
    batch, pool = int(tr["batch"]), int(tr["pool"])
    for seed in seeds:
        t0 = time.perf_counter()
        answers = []
        for j in range(pool):
            bs = []
            for lane in range(batch):
                data = {k: torch.from_numpy(v).to(device) for k, v in cellmod.member(cell, seed, j * batch + lane).items()}
                bs.append(ref.rhs(problem, pc, data))
            b = torch.stack(bs) if batch > 1 else bs[0]
            answers.append(rs.solve(problem, pc, b, precision))
        solve_s = time.perf_counter() - t0
        rel, answered = readings(cell, seed, answers, device)
        print(json.dumps({"side": "control", "precision": precision, "cell": cell.name, "seed": seed,
                          "rel_residual": rel, "answered": answered, "solve_s": solve_s}), flush=True)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from portbench import manifest

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 2
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    cell = manifest.load_cell(args.workload, trace=False)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    if seeds:
        program(cell, seeds, device, sync)
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    if cseeds:
        control(cell, cseeds, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
