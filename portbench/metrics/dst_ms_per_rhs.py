"""Device ms of the sine transform's kernels per right-hand side traced:
cuBLAS / CUTLASS GEMMs (the 'matmul' DST; the direct solves run no other
GEMM) and B3's split pass and GEMMs (``dst_precision='high'``)."""

import re

from portbench import trace

PATTERN = re.compile(r"gemm|xmma|cutlass|bf16x3_split_kernel|bf16x3_wgmma_kernel|bf16x3_gemm_kernel", re.I)


def read(run):
    if run.events is None or run.rhs == 0:
        return None
    us = [e["dur"] for e in trace.kernels(run.events) if PATTERN.search(e["name"])]
    return sum(us) / 1e3 / run.rhs if us else None
