"""The schedule rule of the fused wave Woodbury kernel
(``paradiag/fused.py:schedule`` of ``cuda_woodbury.KERNEL``), on the CPU:
which of ``csrc/woodbury.cu``'s two kernels runs at a shape, its columns
per block, K-lanes and shared memory. Pure arithmetic: no card, no JAX."""

import pytest
import torch

from optimal_control_paradiag_torch.paradiag import cuda_woodbury as cw
from optimal_control_paradiag_torch.paradiag import fused

torch.set_num_threads(1)

F32, F64 = 4, 8


@pytest.mark.parametrize(
    "K,n,itemsize,cols",
    [(513, 2047, F32, 8), (513, 2047, F64, 2), (33, 65025, F32, 32), (33, 65025, F64, 32)],
    ids=["headline-f32", "headline-f64", "2d-lumped-f32", "2d-lumped-f64"],
)
def test_main_shapes_take_the_slab(K, n, itemsize, cols):
    s = fused.schedule(cw.KERNEL, K, n, itemsize)
    assert (s.kind, s.cols) == ("slab", cols)
    assert s.smem_bytes <= fused.SMEM_PER_BLOCK_MAX == 232_448
    assert s.stride >= K and s.cols * s.lanes in (128, 256)


@pytest.mark.parametrize(
    "N_t,itemsize",
    [(10000, F64), (10000, F32), (2 * 1873, F32), (2 * 1000, F64)],
    ids=["10000-f64", "10000-f32", "3746-f32", "2000-f64"],
)
def test_long_k_takes_the_streaming_kernel(N_t, itemsize):
    s = fused.schedule(cw.KERNEL, N_t // 2 + 1, 7, itemsize)
    assert s == fused.streaming_schedule(cw.KERNEL, itemsize)
    assert (s.kind, s.cols, s.lanes) == ("streaming", 16, 32)


@pytest.mark.parametrize("itemsize,k_max", [(F32, 1873), (F64, 1000)], ids=["f32", "f64"])
def test_one_column_slab_up_to_the_block_limit(itemsize, k_max):
    """The slab runs while one column and the staged phase table fit
    232,448 B."""
    s = fused.schedule(cw.KERNEL, k_max, 2047, itemsize)
    assert (s.kind, s.cols, s.lanes) == ("slab", 1, 128)
    assert s.smem_bytes <= fused.SMEM_PER_BLOCK_MAX
    assert fused.schedule(cw.KERNEL, k_max + 1, 2047, itemsize).kind == "streaming"


@pytest.mark.parametrize("itemsize", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [1, 7, 2047, 65025])
def test_schedule_sweep_over_k(itemsize, n):
    """Over a sweep of K: C is a power of two <= 32 and no wider than n
    needs; the slab's bytes, recomputed here from its parts, never exceed
    the block limit; the stride pads K by less than 64; a wider slab would
    not have fitted."""
    for K in list(range(1, 70)) + list(range(70, 3000, 37)):
        s = fused.schedule(cw.KERNEL, K, n, itemsize)
        if s.kind == "streaming":
            assert (11 + 16 + 16 // itemsize) * K * itemsize > fused.SMEM_PER_BLOCK_MAX
            continue
        c, lanes = s.cols, s.lanes
        assert c & (c - 1) == 0 and 1 <= c <= 32 and (c == 1 or c < 2 * n)
        assert lanes * c == (128 if c <= 4 else 256) and lanes & (lanes - 1) == 0
        red = 2 * c * (lanes // 32) * 4 * itemsize if lanes > 32 else 0
        assert s.smem_bytes == (c * s.stride * 11 + (16 + 16 // itemsize) * K) * itemsize + red
        assert s.smem_bytes <= fused.SMEM_PER_BLOCK_MAX
        assert K <= s.stride < K + 64
        if c < 32 and c < n:
            assert fused.slab_schedule(cw.KERNEL, K, 2 * c, itemsize).smem_bytes > fused.SMEM_PER_BLOCK_MAX


def test_slab_schedule_sizes():
    """At the headline in float32, C = 2 lets two blocks share an SM (the
    narrower schedule chip_smoke.py times); C = 16 fits no block in either
    real type."""
    two = fused.slab_schedule(cw.KERNEL, 513, 2, F32)
    assert (two.kind, two.cols, two.lanes) == ("slab", 2, 64)
    assert 2 * (two.smem_bytes + 1024) <= 228 * 1024
    for itemsize in (F32, F64):
        assert fused.slab_schedule(cw.KERNEL, 513, 16, itemsize).smem_bytes > fused.SMEM_PER_BLOCK_MAX
