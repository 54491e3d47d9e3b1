"""The host layer the fused Woodbury kernels B1 and B2 share
(``paradiag/fused.py``), on the CPU: every refusal of its argument checks,
each raised before any pointer reaches a kernel. The checks read tensor
metadata alone, so CPU (and meta) tensors stand in for the card's. No card,
no JAX."""

import dataclasses

import pytest
import torch

from optimal_control_paradiag_torch import HeatControlProblem, ProblemConfig, WaveControlProblem
from optimal_control_paradiag_torch.paradiag import cuda_heat as ch
from optimal_control_paradiag_torch.paradiag import cuda_woodbury as cw
from optimal_control_paradiag_torch.paradiag import fused

torch.set_num_threads(1)

K, N = 6, 11  # N_x = 12, N_t = 10


def _case(family):
    """The family's kernel, its float64 constants at K = 6, n = 11, the
    schedule a solve launches and a good (2, K, n) input."""
    cfg = ProblemConfig(N_x=12, N_t=10)
    if family == "wave":
        c = cw.pack_constants(WaveControlProblem(cfg, device="cpu").operator)
        return cw.KERNEL, c, fused.schedule(cw.KERNEL, K, N, 8)
    c = ch.pack_heat_constants(HeatControlProblem(cfg, device="cpu"))
    return ch.KERNEL, c, c.schedule


def _misaligned(t):
    """A contiguous copy of ``t`` one element (8 bytes) off 16-byte alignment."""
    base = torch.zeros(t.numel() + 1, dtype=t.dtype)
    out = base[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16
    return out


def _with(c, **fields):
    return dataclasses.replace(c, **fields)


def _b(shape=(2, K, N), dtype=torch.complex128, device="cpu"):
    return torch.zeros(shape, dtype=dtype, device=device)


# name: (families, change of (kernel, consts, sched, b_hat, refine), message)
REFUSALS = {
    "unknown-kind": (("wave", "heat"), lambda k, c, s, b, r: (k, c, dataclasses.replace(s, kind="tiled"), b, r),
                     "unknown schedule kind"),
    "slab-of-other-columns": (("heat",), lambda k, c, s, b, r: (
        k, c, fused.slab_schedule(k, K, s.cols // 2, 8), b, r), "packed for"),
    "slab-on-streaming-constants": (("heat",), lambda k, c, s, b, r: (
        k, _with(c, schedule=fused.streaming_schedule(k, 8)), s, b, r), "packed for"),
    "misaligned-phases": (("wave",), lambda k, c, s, b, r: (k, _with(c, phases=_misaligned(c.phases)), s, b, r),
                          "16-byte aligned"),
    "misaligned-table": (("heat",), lambda k, c, s, b, r: (k, _with(c, table=_misaligned(c.table)), s, b, r),
                         "16-byte aligned"),
    "misaligned-image": (("heat",), lambda k, c, s, b, r: (k, _with(c, image=_misaligned(c.image)), s, b, r),
                         "16-byte aligned"),
    "real-b-hat": (("wave", "heat"), lambda k, c, s, b, r: (k, c, s, _b(dtype=torch.float64), r), "complex"),
    "b-hat-of-other-shape": (("wave", "heat"), lambda k, c, s, b, r: (k, c, s, _b((2, K, N - 1)), r), "contiguous"),
    "strided-b-hat": (("wave", "heat"), lambda k, c, s, b, r: (k, c, s, _b((2, N, K)).transpose(1, 2), r),
                      "contiguous"),
    "conjugate-view": (("wave", "heat"), lambda k, c, s, b, r: (k, c, s, b.conj(), r), "resolved"),
    "two-batch-axes": (("wave", "heat"), lambda k, c, s, b, r: (k, c, s, _b((2, 2, 2, K, N)), r), "contiguous"),
    "no-lane-axis": (("wave", "heat"), lambda k, c, s, b, r: (k, c, s, _b((K, N)), r), "contiguous"),
    "zero-lanes": (("wave", "heat"), lambda k, c, s, b, r: (k, c, s, _b((0, 2, K, N)), r), "1 to 65535 lanes"),
    "65536-lanes": (("wave", "heat"), lambda k, c, s, b, r: (
        k, c, s, _b((fused.MAX_BATCH + 1, 2, K, N), device="meta"), r), "1 to 65535 lanes"),
    "constants-of-other-dtype": (("wave", "heat"), lambda k, c, s, b, r: (k, c, s, _b(dtype=torch.complex64), r),
                                 "constant a11r"),
    "constants-on-other-device": (("wave", "heat"), lambda k, c, s, b, r: (k, c, s, _b(device="meta"), r),
                                  "constant a11r .* on meta"),
    "strided-constant": (("wave", "heat"), lambda k, c, s, b, r: (
        k, _with(c, colc=c.colc.t().contiguous().t()), s, b, r), "constant colc"),
    "constant-of-other-shape": (("wave", "heat"), lambda k, c, s, b, r: (
        k, _with(c, colc=torch.cat([c.colc, c.colc[:1]])), s, b, r), "inconsistent"),
    "negative-refine": (("wave", "heat"), lambda k, c, s, b, r: (k, c, s, b, -1), "refine"),
    "float-refine": (("wave", "heat"), lambda k, c, s, b, r: (k, c, s, b, 1.0), "refine"),
}
CASES = [(family, name) for name, (families, _, _) in REFUSALS.items() for family in families]


@pytest.mark.parametrize("family,refusal", CASES, ids=[f"{f}-{n}" for f, n in CASES])
def test_check_launch_refuses(family, refusal):
    """Each condition alone is refused with a ValueError that names it; the
    unchanged arguments pass."""
    kernel, consts, sched = _case(family)
    _, change, match = REFUSALS[refusal]
    ptrs, sizes = fused.check_launch(kernel, _b(), consts, 1, sched)
    assert len(ptrs) == len(kernel.const_shapes(sched, 8)) and sizes[:4] == (K, N, 1, 1)
    args = change(kernel, consts, sched, _b(), 1)
    with pytest.raises(ValueError, match=match):
        fused.check_launch(args[0], args[3], args[1], args[4], args[2])


@pytest.mark.parametrize("family", ["wave", "heat"])
def test_launch_refuses_cpu_tensors_before_any_build(family):
    """``fused.launch`` takes CUDA tensors only; a CPU one is refused before
    the kernel is built (no nvcc here) or counted."""
    kernel, consts, sched = _case(family)
    with pytest.raises(ValueError, match="run on CUDA tensors"):
        fused.launch(kernel, _b(), consts, 1, sched)
