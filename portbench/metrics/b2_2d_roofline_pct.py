"""B2's share of its roofline in a 2D heat cell: the least time of its
launches (bytes over 3.35 TB/s, or float32 operations over 67 TFLOP/s
where larger) over their measured device time, in percent.

It reads the ``heat_slab_kernel`` and ``heat_streaming_kernel`` launches of
the traced run. Bytes and operations of one launch of B lanes are
``woodbury_roofline_pct.launch_bytes_flops`` at n = (N_x - 1)^2: each
lane's b and x (eight real (K, n) planes), the constants once. At N_x =
256, N_t = 64, B = 8, refine 1: 576.6 MB, 0.1721 ms at 3.35 TB/s (the
2.95 GFLOP take 0.044 ms). None outside a 2D heat cell on the kernel.
"""

from portbench import peaks, trace
from portbench.metrics import woodbury_roofline_pct


def read(run):
    cfg, tr = run.cell.config, run.cell.traffic
    pc = cfg["problem_config"]
    if run.events is None or cfg["problem"] != "heat" or pc["dim"] != 2 or not tr["solver"].get("use_pallas"):
        return None
    pat = woodbury_roofline_pct.KERNELS["heat"]
    us = [e["dur"] for e in trace.kernels(run.events) if pat.search(e["name"])]
    if not us:
        return None
    itemsize = 4 if tr["dtype"] == "float32" else 8
    nbytes, flops = woodbury_roofline_pct.launch_bytes_flops("heat", pc["N_t"], (pc["N_x"] - 1) ** 2, int(tr["batch"]),
                                                             int(tr["solver"].get("refine", 1)), itemsize)
    least = len(us) * peaks.bound_s(nbytes, flops, peaks.FP32_FLOPS_PER_S)
    return 100.0 * least / (sum(us) / 1e6)
