"""B1's share of its roofline as the preconditioner's solve of the 2D
consistent mass's tensor GMRES: the least time of its launches (bytes
over 3.35 TB/s, or float64 operations over the CUDA cores' 34 TFLOP/s
where larger) over their measured device time, in percent.

It reads the ``woodbury_slab_kernel`` and ``woodbury_streaming_kernel``
launches of the traced run, one a preconditioner apply. Bytes and
operations of one launch of B lanes are
``woodbury_roofline_pct.launch_bytes_flops`` at n = (N_x - 1)^2, 8-byte
reals and refine 0, the route's (it takes no ``refine`` from the
traffic): at N_x = 192, N_t = 128, B = 8, 1.277 GB, 0.381 ms at 3.35
TB/s (the 1.52 GFLOP take 0.045 ms). None outside a 2D consistent-mass
wave cell on the kernel, and where the trace holds no launch of it (a
program whose route does not run B1).
"""

from portbench import peaks, trace
from portbench.metrics import woodbury_roofline_pct

# NVIDIA's H100 SXM data sheet, float64 outside the tensor cores (B1's
# arithmetic), dense, at the full 700 W
FP64_FLOPS_PER_S = 34e12
REFINE = 0  # the route's surrogate solve runs B1 at refine 0


def launch_bytes_flops(N_x: int, N_t: int, lanes: int):
    return woodbury_roofline_pct.launch_bytes_flops("wave", N_t, (N_x - 1) ** 2, lanes, REFINE, 8)


def read(run):
    cfg, tr = run.cell.config, run.cell.traffic
    pc = cfg["problem_config"]
    if (run.events is None or cfg["problem"] != "wave" or pc["dim"] != 2 or pc["mass"] != "consistent"
            or tr["dtype"] != "float64" or tr["solver"].get("method") != "woodbury"
            or not tr["solver"].get("use_pallas")):
        return None
    pat = woodbury_roofline_pct.KERNELS["wave"]
    us = [e["dur"] for e in trace.kernels(run.events) if pat.search(e["name"])]
    if not us:
        return None
    nbytes, flops = launch_bytes_flops(pc["N_x"], pc["N_t"], int(tr["batch"]))
    least = len(us) * peaks.bound_s(nbytes, flops, FP64_FLOPS_PER_S)
    return 100.0 * least / (sum(us) / 1e6)
