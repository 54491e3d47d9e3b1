"""The 2D sine transform's GEMMs' share of their roofline: the least time
of the float32 operations of the traced calls' transforms at 67 TFLOP/s
(outside the tensor cores: the port keeps TF32 off) over the GEMM
kernels' measured device time, in percent.

A call of a 2D heat direct solve runs four axis passes, each one product
of its (rows, N_x - 1) operand with the (N_x - 1)^2 DST matrix: the forward
transform's x and y passes and the inverse's (``P1Space._dst``; the
``transforms/dst.x`` and ``transforms/dst.y`` counters read two each a
call). Rows = lanes x 2 x N_t x (N_x - 1), so a call is
4 x 2 x rows x (N_x - 1)^2 operations: at N_x = 256, N_t = 64, B = 8,
135.8 GFLOP, 2.027 ms. The GEMM kernels are those ``dst_ms_per_rhs``
reads, by its pattern; the heat direct solve runs no other GEMM. The
inverse's scale and any copy are not GEMMs and are not counted. None outside a 2D float32 'highest' matmul-DST heat cell.
"""

from portbench import peaks, trace
from portbench.metrics.dst_ms_per_rhs import PATTERN

PASSES = 4  # x and y, forward and inverse


def call_flops(N_x: int, N_t: int, lanes: int) -> float:
    """Float operations of the 2D sine transforms of one call."""
    m = N_x - 1
    return PASSES * 2.0 * (lanes * 2 * N_t * m) * m * m


def read(run):
    cfg, tr = run.cell.config, run.cell.traffic
    pc = cfg["problem_config"]
    if run.events is None or run.calls == 0 or cfg["problem"] != "heat" or pc["dim"] != 2:
        return None
    # 'auto' past the matmul's budget takes the FFT route, which runs no GEMM
    if tr["dtype"] != "float32" or tr["dst_precision"] != "highest" or tr["dst_method"] not in ("auto", "matmul"):
        return None
    us = [e["dur"] for e in trace.kernels(run.events) if PATTERN.search(e["name"])]
    if not us:
        return None
    least = run.calls * call_flops(pc["N_x"], pc["N_t"], int(tr["batch"])) / peaks.FP32_FLOPS_PER_S
    return 100.0 * least / (sum(us) / 1e6)
