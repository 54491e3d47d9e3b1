"""The schedule rule of the fused heat Woodbury kernel
(``paradiag/cuda_heat.py:heat_schedule``) and the slab's constant image, on
the CPU: which of ``csrc/heat_woodbury.cu``'s two kernels runs at a shape,
its columns per block, K-lanes and shared memory, and that the image the
slab kernel bulk-copies holds the (K, n) constant planes bitwise. Pure
arithmetic and copies: no card, no JAX."""

import dataclasses

import numpy as np
import pytest
import torch

from optimal_control_paradiag_torch import HeatControlProblem, ProblemConfig
from optimal_control_paradiag_torch.paradiag import cuda_heat as ch
from optimal_control_paradiag_torch.paradiag import cuda_woodbury as cw

torch.set_num_threads(1)

F32, F64 = 4, 8
K_MAX = {F32: 2525, F64: 1382}  # the longest K one column's slab holds


def _bytes(K, cols, lanes, stride, itemsize):
    """A slab block's shared memory recomputed from its parts: mbarrier,
    phase table [bin][8 + pad], the constant image (3 reals per bin and
    column, padded to 16 bytes), b and x, cross-warp partials."""
    image = 3 * cols * stride
    image += -image % (16 // itemsize)
    red = 2 * cols * (lanes // 32) * 2 * itemsize if lanes > 32 else 0
    return 16 + ((8 + 16 // itemsize) * K + image + 8 * cols * stride) * itemsize + red


@pytest.mark.parametrize(
    "K,n,itemsize,cols,lanes,stride,smem",
    [
        (513, 2047, F32, 8, 32, 514, 205_568),
        (513, 2047, F64, 4, 32, 514, 221_984),
        (33, 65025, F32, 32, 8, 40, 57_920),
        (33, 65025, F64, 32, 8, 40, 115_296),
    ],
    ids=["1d-f32", "1d-f64", "2d-lumped-f32", "2d-lumped-f64"],
)
def test_main_shapes_take_the_slab(K, n, itemsize, cols, lanes, stride, smem):
    s = ch.heat_schedule(K, n, itemsize)
    assert s == cw.WoodburySchedule("slab", cols, lanes, stride, smem)
    assert s.smem_bytes == _bytes(K, cols, lanes, stride, itemsize) <= cw.SMEM_PER_BLOCK_MAX


@pytest.mark.parametrize("itemsize", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [1, 7, 2047, 65025])
def test_schedule_sweep_over_k(itemsize, n):
    """Over a sweep of K: C is a power of two <= 32 and no wider than n
    needs; the slab's bytes, recomputed from its parts, never exceed the
    block limit; the stride pads K by less than 64; a wider slab would not
    have fitted; past the long-K limit the streaming kernel runs."""
    for K in list(range(1, 70)) + list(range(70, 3200, 37)):
        s = ch.heat_schedule(K, n, itemsize)
        if s.kind == "streaming":
            assert K > K_MAX[itemsize]
            assert ch.heat_slab_schedule(K, 1, itemsize).smem_bytes > cw.SMEM_PER_BLOCK_MAX
            continue
        c, lanes = s.cols, s.lanes
        assert c & (c - 1) == 0 and 1 <= c <= 32 and (c == 1 or c < 2 * n)
        assert lanes * c == (128 if c <= 4 else 256) and lanes & (lanes - 1) == 0
        assert s.smem_bytes == _bytes(K, c, lanes, s.stride, itemsize) <= cw.SMEM_PER_BLOCK_MAX
        assert K <= s.stride < K + 64
        if c < 32 and c < n:
            assert ch.heat_slab_schedule(K, 2 * c, itemsize).smem_bytes > cw.SMEM_PER_BLOCK_MAX


@pytest.mark.parametrize("itemsize", [F32, F64], ids=["f32", "f64"])
def test_long_k_switches_one_bin_past_the_limit(itemsize):
    """The slab runs while one column and the staged phase table fit
    232,448 B; one bin more and the schedule takes the streaming kernel."""
    k_max = K_MAX[itemsize]
    s = ch.heat_schedule(k_max, 2047, itemsize)
    assert (s.kind, s.cols, s.lanes, s.stride) == ("slab", 1, 128, k_max)
    assert s.smem_bytes <= cw.SMEM_PER_BLOCK_MAX
    long = ch.heat_schedule(k_max + 1, 2047, itemsize)
    assert long == ch.heat_streaming_schedule(itemsize)
    assert (long.kind, long.cols, long.lanes) == ("streaming", 16, 32)


def _unpack(image, sched, K, n):
    """The (K, n) planes back from a slab image, by the layout the kernel
    reads: per block, (a11r, a11i) of column c, bin k at pair c * stride + k,
    then invdet at c * stride + k."""
    C, ks = sched.cols, sched.stride
    S = C * ks
    img = image.numpy()
    a11r, a11i, invdet = (np.zeros((K, n), dtype=img.dtype) for _ in range(3))
    for blk in range(img.shape[0]):
        for c in range(C):
            j = blk * C + c
            for k in range(ks):
                vals = (img[blk, 2 * (c * ks + k)], img[blk, 2 * (c * ks + k) + 1], img[blk, 2 * S + c * ks + k])
                if j < n and k < K:
                    a11r[k, j], a11i[k, j], invdet[k, j] = vals
                else:
                    assert vals == (0, 0, 0)
    assert not img[:, 3 * S :].any()
    return a11r, a11i, invdet


@pytest.mark.parametrize(
    "kw,dtype,cols",
    [
        (dict(N_x=40, N_t=24), torch.float64, None),  # n = 39: C = 32, last block 7 live columns
        (dict(N_x=22, N_t=13), torch.float32, 8),  # n = 21, K = 7: last block 5 live columns
        (dict(N_x=10, N_t=12, dim=2, mass="lumped"), torch.float32, None),  # n = 81, C = 32
        (dict(N_x=12, N_t=10), torch.float64, 2),  # L = 64: cross-warp partials
    ],
    ids=["1d-f64-rule", "1d-f32-c8", "2d-lumped-f32-rule", "1d-f64-c2"],
)
def test_slab_image_unpacks_to_the_planes_bitwise(kw, dtype, cols):
    prob = HeatControlProblem(ProblemConfig(**kw, dtype=dtype), device="cpu")
    K = kw["N_t"] // 2 + 1
    c = ch.pack_heat_constants(prob)
    assert c.schedule.kind == "slab"
    if cols is not None:  # the image of a narrower slab than the rule's
        s = ch.heat_slab_schedule(K, cols, c.a11r.element_size())
        c = dataclasses.replace(c, schedule=s, image=ch._slab_image(c.a11r, c.a11i, c.invdet, s))
    n, s = c.a11r.shape[1], c.schedule
    assert n % s.cols and c.image.dtype == dtype and c.image.is_contiguous()
    itemsize = c.image.element_size()
    assert c.image.shape == (-(-n // s.cols), ch._image_reals(s.cols * s.stride, itemsize))
    assert c.image.shape[1] * itemsize % 16 == 0
    for got, plane in zip(_unpack(c.image, s, K, n), (c.a11r, c.a11i, c.invdet)):
        assert np.array_equal(got.view(np.uint8), plane.numpy().view(np.uint8))
    # the staged phase table: the phases and 16 bytes of zeros per bin
    assert c.table.shape == (K, 8 + 16 // itemsize) and c.table.is_contiguous()
    assert torch.equal(c.table[:, :8], c.phases) and not c.table[:, 8:].any()


def test_long_k_packs_no_image():
    """Past the slab's K the constants carry the streaming schedule and an
    empty image; the twin still runs on the planes."""
    prob = HeatControlProblem(ProblemConfig(N_x=4, N_t=2800), device="cpu")
    c = ch.pack_heat_constants(prob)
    assert c.schedule == ch.heat_streaming_schedule(8) and c.image.shape == (0, 0)
    assert c.a11r.shape == (1401, 3)
    b_hat = torch.ones(2, 1401, 3, dtype=torch.complex128)
    assert torch.isfinite(torch.view_as_real(ch.fused_heat(b_hat, c, 1))).all()
