"""Run one cell of the port's benchmark once, on the card, and print one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. ``--trace 0`` measures the window and
prints the cell's end-to-end metrics; ``--trace 1`` profiles the traffic's
``trace_passes`` passes over the pool and prints its per-layer metrics and
a ``breakdown``. Both judge the answers (``correct``) and print each number compared beside its
limit, last on standard error and under ``check`` in the line. Without a
CUDA card, or with fewer cards than the cell asks for, it exits 2 and prints
no result; with the JAX package or JAX loaded once the window has closed, 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = ROOT  # import portbench as a package; its trace.py must not hide the standard library's
else:
    sys.path.insert(0, ROOT)

# every build and kernel cache at a fixed path inside the checkout
CACHE = os.path.join(ROOT, ".portbench_cache")
os.environ["PARADIAG_COMPILE_CACHE"] = os.path.join(ROOT, "optimal_control_paradiag_torch", "csrc", "_build")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"

FORBIDDEN = {"jax", "jaxlib", "flax", "optimal_control_paradiag_tpu"}


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import manifest

    cell = manifest.load_cell(args.workload, trace=bool(args.trace))

    import torch

    torch_s = time.perf_counter() - T_START
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: cell {cell.name} needs {cell.chips} CUDA card(s), found {found}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.set_num_threads(1)

    from portbench.cell import run_cell

    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device="cuda", t_start=T_START)
    out["device"]["power_limit"] = power_limit()

    loaded = sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}; the port's benchmark must not", file=sys.stderr)
        return 3
    phases = {"torch": torch_s, **out.pop("setup_phases")}
    out["check"] = out.pop("check")  # the numbers compared come last
    print("setup " + " ".join(f"{k}={v:.3f}" for k, v in phases.items()), file=sys.stderr)
    print(json.dumps(out), flush=True)
    for name, c in out["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
