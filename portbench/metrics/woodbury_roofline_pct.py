"""The fused Woodbury kernels' share of their roofline: the least time of
their launches (bytes over 3.35 TB/s, or float32 operations over 67 TFLOP/s
where larger) over their measured device time, in percent.

Bytes of one launch of B lanes, frozen from PERF.md's kernel table: each
lane's b and x, eight real (K, n) planes, and the constants once: a11r,
a11i and invdet (K, n) and the small ones (B1: colc (4, n), gc (16, n),
phases (K, 16); B2: colc (6, n), phases (K, 8)); K = N_t // 2 + 1. One
lane: B1 46.4 MB, B2 46.3 MB; B1 at B = 8: 281.6 MB. Operations per element
and lane: B1 80 + 140 refine, B2 64 + 108 refine.
"""

import re

from portbench import peaks, trace

KERNELS = {"wave": re.compile(r"woodbury_slab_kernel|woodbury_streaming_kernel"),
           "heat": re.compile(r"heat_slab_kernel|heat_streaming_kernel")}


def launch_bytes_flops(problem: str, N_t: int, n: int, lanes: int, refine: int, itemsize: int = 4):
    K = N_t // 2 + 1
    if problem == "wave":
        small, per_element = 20 * n + 16 * K, 80 + 140 * refine
    else:
        small, per_element = 6 * n + 8 * K, 64 + 108 * refine
    return itemsize * (8 * K * n * lanes + 3 * K * n + small), per_element * K * n * lanes


def read(run):
    cfg, tr = run.cell.config, run.cell.traffic
    pc = cfg["problem_config"]
    if run.events is None or pc["dim"] != 1 or not tr["solver"].get("use_pallas"):
        return None
    pat = KERNELS[cfg["problem"]]
    us = [e["dur"] for e in trace.kernels(run.events) if pat.search(e["name"])]
    if not us:
        return None
    itemsize = 4 if tr["dtype"] == "float32" else 8
    nbytes, flops = launch_bytes_flops(cfg["problem"], pc["N_t"], pc["N_x"] - 1, int(tr["batch"]),
                                       int(tr["solver"].get("refine", 1)), itemsize)
    least = len(us) * peaks.bound_s(nbytes, flops, peaks.FP32_FLOPS_PER_S)
    return 100.0 * least / (sum(us) / 1e6)
