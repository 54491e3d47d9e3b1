"""The fused Woodbury CUDA kernels (csrc/woodbury.cu for the wave family,
csrc/heat_woodbury.cu for the heat family) vs their plain PyTorch twins, on
the card. Each family has two kernels: the slab kernel, which the wrapper
launches wherever one column's slab fits a block, and the streaming kernel,
forced here at shapes the slab takes and chosen by the schedule at a long K.
These tests need a CUDA card and nvcc; they skip without one. The file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda_kernel.py -q

Tolerances (relative max-abs vs the twin): float64 1e-12. float32 at the
headline shape 2e-4: the kernel's strided K sums reorder the twin's, and the
rank-4 capacity correction amplifies the reordering to the size of the
float32 solve's own error (chip_smoke.py prints both). The heat kernel's
float32 tolerance at its headline shape is chip_smoke.py's ``HEAT_TOL_F32``,
set the same way.
"""

import dataclasses

import numpy as np
import pytest
import torch

from optimal_control_paradiag_torch import (
    HeatControlProblem,
    ProblemConfig,
    SolverConfig,
    WaveControlProblem,
)
from optimal_control_paradiag_torch.ops.transforms import time_rfft_conj_packed
from optimal_control_paradiag_torch.paradiag import cuda_heat as ch
from optimal_control_paradiag_torch.paradiag import cuda_woodbury as cw
from optimal_control_paradiag_torch.paradiag.spectral import _capacity_matrices

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kw,dtype,refine,tol",
    [
        (dict(N_x=40, N_t=24), torch.float64, 0, 1e-12),
        (dict(N_x=40, N_t=24), torch.float64, 1, 1e-12),
        (dict(N_x=64, N_t=33), torch.float64, 2, 1e-12),
        (dict(N_x=9, N_t=12, dim=2, mass="lumped"), torch.float64, 1, 1e-12),
        (dict(N_x=2048, N_t=1024), torch.float32, 1, 2e-4),
    ],
    ids=["40x24-r0", "40x24-r1", "64x33-r2", "2d-lumped-r1", "headline-f32-r1"],
)
def test_kernel_matches_twin(cuda, kw, dtype, refine, tol):
    prob = WaveControlProblem(ProblemConfig(**kw, dtype=dtype), device=cuda)
    c = cw.pack_constants(prob.operator)
    assert cw.woodbury_schedule(*c.a11r.shape, c.a11r.element_size()).kind == "slab"
    b_hat = time_rfft_conj_packed(prob.space.dst(prob.rhs), kw["N_t"])
    before = cw.fused_woodbury.launches
    x = cw.fused_woodbury(b_hat, c, refine)
    torch.cuda.synchronize()
    assert cw.fused_woodbury.launches == before + 1
    assert x.dtype == b_hat.dtype and x.shape == b_hat.shape
    assert _rel(x, cw.fused_woodbury_reference(b_hat, c, refine)) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kw,dtype,refine,tol,forced",
    [
        (dict(N_x=40, N_t=24), torch.float64, 0, 1e-12, True),
        (dict(N_x=40, N_t=24), torch.float64, 1, 1e-12, True),
        (dict(N_x=2048, N_t=1024), torch.float32, 1, 2e-4, True),
        (dict(N_x=8, N_t=10000, T=20.0), torch.float64, 1, 1e-12, False),
        (dict(N_x=256, N_t=64, dim=2, mass="lumped"), torch.float32, 1, 2e-4, False),
    ],
    ids=["streaming-40x24-r0", "streaming-40x24-r1", "streaming-headline-f32-r1",
         "long-k-8x10000-T20-f64-r1", "wide-2d-lumped-256x64-f32-r1"],
)
def test_schedules_match_twin(cuda, monkeypatch, kw, dtype, refine, tol, forced):
    """The streaming kernel forced where the slab would run; a long K (5001
    bins, 440 KB per column in float64) where the schedule takes the
    streaming kernel itself; and the wide, short wave 2D lumped shape
    (n = 65025, K = 33), where it takes 32 columns per slab block.

    The long-K case keeps the headline's time step (T = 20 over 10000
    slices): at T = 2 the solve is so ill-conditioned that any two summation
    orders differ by ~1e-12 in float64. The imaginary part of its capacity
    matrices is 8.6e-11 of the real one, close to the plan's 1e-10 limit (as
    in the JAX package), so the real part is taken unchecked: the kernel and
    its twin compute the same function of any constants."""
    if kw["N_t"] == 10000:
        monkeypatch.setattr(cw, "_real_capacity_matrices", lambda pl: _capacity_matrices(pl).real)
    prob = WaveControlProblem(ProblemConfig(**kw, dtype=dtype), device=cuda)
    c = cw.pack_constants(prob.operator)
    sched = cw.woodbury_schedule(*c.a11r.shape, c.a11r.element_size())
    b_hat = time_rfft_conj_packed(prob.space.dst(prob.rhs), kw["N_t"])
    before = cw.fused_woodbury.launches
    if forced:
        assert sched.kind == "slab"
        x = cw._fused_woodbury_streaming(b_hat, c, refine)
    else:
        assert sched.kind == ("streaming" if kw["N_t"] == 10000 else "slab")
        x = cw.fused_woodbury(b_hat, c, refine)
    torch.cuda.synchronize()
    assert cw.fused_woodbury.launches == before + 1
    assert x.dtype == b_hat.dtype and x.shape == b_hat.shape
    assert _rel(x, cw.fused_woodbury_reference(b_hat, c, refine)) <= tol


@pytest.mark.cuda
def test_refused_slab_launch_raises(cuda):
    """A schedule the launcher or the card refuses raises; nothing falls
    back to the twin."""
    prob = WaveControlProblem(ProblemConfig(N_x=12, N_t=10), device=cuda)
    c = cw.pack_constants(prob.operator)
    b_hat = torch.zeros(2, 6, 11, dtype=torch.complex128, device=cuda)
    sched = cw.woodbury_schedule(6, 11, 8)
    for bad in (dataclasses.replace(sched, smem_bytes=sched.smem_bytes - 8),
                dataclasses.replace(sched, lanes=3),
                cw.WoodburySchedule("slab", 1, 128, 6, 300_000)):
        with pytest.raises(RuntimeError, match="launch failed"):
            cw._launch(b_hat, c, 1, bad)


@pytest.mark.cuda
def test_refused_slab_launch_leaves_no_stale_error(cuda):
    """A launch whose shared-memory request the card refuses
    (``cudaFuncSetAttribute``) clears CUDA's last error: the next good
    launch on the same stream succeeds and matches the twin."""
    prob = WaveControlProblem(ProblemConfig(N_x=12, N_t=10), device=cuda)
    c = cw.pack_constants(prob.operator)
    rng = np.random.default_rng(7)
    noise = rng.standard_normal((2, 6, 11)) + 1j * rng.standard_normal((2, 6, 11))
    b_hat = torch.from_numpy(noise).to(cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        cw._launch(b_hat, c, 1, cw.WoodburySchedule("slab", 1, 128, 6, 300_000))
    before = cw.fused_woodbury.launches
    x = cw.fused_woodbury(b_hat, c, 1)
    torch.cuda.synchronize()
    assert cw.fused_woodbury.launches == before + 1
    assert _rel(x, cw.fused_woodbury_reference(b_hat, c, 1)) <= 1e-12


@pytest.mark.cuda
def test_solve_on_card_matches_cpu(cuda):
    cfg = ProblemConfig(N_x=48, N_t=32)
    solver = SolverConfig(method="woodbury", use_pallas=True)
    before = cw.fused_woodbury.launches
    s_gpu = WaveControlProblem(cfg, device=cuda).solve(solver)
    assert cw.fused_woodbury.launches == before + 1
    s_cpu = WaveControlProblem(cfg, device="cpu").solve(solver)
    assert _rel(s_gpu.u.cpu(), s_cpu.u) <= 1e-11
    assert _rel(s_gpu.p.cpu(), s_cpu.p) <= 1e-11


@pytest.mark.cuda
def test_kernel_rejects_bad_input(cuda):
    prob = WaveControlProblem(ProblemConfig(N_x=12, N_t=10), device=cuda)
    c = cw.pack_constants(prob.operator)
    wrong = torch.zeros(2, 6, 10, dtype=torch.complex128, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        cw.fused_woodbury(wrong, c, 1)
    f32 = torch.zeros(2, 6, 11, dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError, match="constant"):
        cw.fused_woodbury(f32, c, 1)
    assert np.isfinite(cw.fused_woodbury(torch.zeros(2, 6, 11, dtype=torch.complex128, device=cuda), c, 0).abs().max().item())


HEAT_TOL_F32 = 1e-6  # chip_smoke.py HEAT_TOL_F32


def _heat_case(cuda, kw, dtype):
    prob = HeatControlProblem(ProblemConfig(**kw, dtype=dtype), device=cuda)
    return ch.pack_heat_constants(prob), time_rfft_conj_packed(prob.space.dst(prob.rhs), kw["N_t"])


def _counted(fn, kind):
    """Run ``fn()``; check it launched one heat kernel, of ``kind``."""
    before, kinds = ch.fused_heat.launches, dict(ch.fused_heat.kinds)
    x = fn()
    torch.cuda.synchronize()
    assert ch.fused_heat.launches == before + 1
    assert ch.fused_heat.kinds[kind] == kinds.get(kind, 0) + 1
    return x


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kw,dtype,refine,tol",
    [
        (dict(N_x=40, N_t=24), torch.float64, 0, 1e-12),
        (dict(N_x=40, N_t=25), torch.float64, 1, 1e-12),
        (dict(N_x=64, N_t=33), torch.float64, 2, 1e-12),
        (dict(N_x=9, N_t=12, dim=2, mass="lumped"), torch.float64, 1, 1e-12),
        (dict(N_x=2048, N_t=1024), torch.float32, 1, HEAT_TOL_F32),
        (dict(N_x=256, N_t=64, dim=2, mass="lumped"), torch.float32, 1, HEAT_TOL_F32),
    ],
    ids=["40x24-r0", "40x25-r1", "64x33-r2", "2d-lumped-r1", "headline-f32-r1", "2d-lumped-256x64-f32-r1"],
)
def test_heat_kernel_matches_twin(cuda, kw, dtype, refine, tol):
    """The slab kernel, which the schedule takes at every one of these
    shapes (C = 32 at the 2D lumped shape, K = 33, n = 65025)."""
    c, b_hat = _heat_case(cuda, kw, dtype)
    assert c.schedule.kind == "slab"
    x = _counted(lambda: ch.fused_heat(b_hat, c, refine), "slab")
    assert x.dtype == b_hat.dtype and x.shape == b_hat.shape
    assert _rel(x, ch.fused_heat_reference(b_hat, c, refine)) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kw,dtype,refine,tol,forced",
    [
        (dict(N_x=40, N_t=24), torch.float64, 1, 1e-12, True),
        (dict(N_x=2048, N_t=1024), torch.float32, 1, HEAT_TOL_F32, True),
        (dict(N_x=8, N_t=2800), torch.float64, 1, 1e-12, False),
        (dict(N_x=8, N_t=6000), torch.float32, 1, HEAT_TOL_F32, False),
    ],
    ids=["streaming-40x24-f64-r1", "streaming-headline-f32-r1", "long-k-8x2800-f64-r1", "long-k-8x6000-f32-r1"],
)
def test_heat_streaming_matches_twin(cuda, kw, dtype, refine, tol, forced):
    """The streaming kernel forced where the slab would run, and at a long K
    (1401 bins in float64, 3001 in float32), where one column's slab does
    not fit a block and the schedule takes it itself."""
    c, b_hat = _heat_case(cuda, kw, dtype)
    if forced:
        assert c.schedule.kind == "slab"
        x = _counted(lambda: ch._fused_heat_streaming(b_hat, c, refine), "streaming")
    else:
        assert c.schedule == ch.heat_streaming_schedule(c.a11r.element_size())
        x = _counted(lambda: ch.fused_heat(b_hat, c, refine), "streaming")
    assert x.dtype == b_hat.dtype and x.shape == b_hat.shape
    assert _rel(x, ch.fused_heat_reference(b_hat, c, refine)) <= tol


@pytest.mark.cuda
def test_heat_refused_slab_launch_raises(cuda):
    """A slab schedule the launcher or the card refuses raises; nothing
    falls back to the twin or to the streaming kernel. A schedule other than
    the one the image was packed for is refused before any launch."""
    prob = HeatControlProblem(ProblemConfig(N_x=12, N_t=10), device=cuda)
    c = ch.pack_heat_constants(prob)
    b_hat = torch.zeros(2, 6, 11, dtype=torch.complex128, device=cuda)
    sched = c.schedule
    one = ch.heat_slab_schedule(6, 1, 8)
    c1 = dataclasses.replace(c, schedule=one, image=ch._slab_image(c.a11r, c.a11i, c.invdet, one))
    before = ch.fused_heat.launches
    for consts, bad in ((c, dataclasses.replace(sched, smem_bytes=sched.smem_bytes - 8)),
                        (c, dataclasses.replace(sched, lanes=3)),
                        (c1, dataclasses.replace(one, smem_bytes=300_000))):
        with pytest.raises(RuntimeError, match="launch failed"):
            ch._launch(b_hat, consts, 1, bad)
    with pytest.raises(ValueError, match="packed for"):
        ch._launch(b_hat, c, 1, one)
    assert ch.fused_heat.launches == before
    x = _counted(lambda: ch.fused_heat(b_hat, c1, 1), "slab")
    assert x.abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("polish", [0, 1])
def test_heat_solve_on_card_matches_cpu(cuda, polish):
    cfg = ProblemConfig(N_x=48, N_t=32)
    solver = SolverConfig(method="woodbury", use_pallas=True, polish=polish)
    before, slabs = ch.fused_heat.launches, ch.fused_heat.kinds["slab"]
    s_gpu = HeatControlProblem(cfg, device=cuda).solve(solver)
    assert ch.fused_heat.launches == before + 1 + polish
    assert ch.fused_heat.kinds["slab"] == slabs + 1 + polish
    s_cpu = HeatControlProblem(cfg, device="cpu").solve(solver)
    assert _rel(s_gpu.u.cpu(), s_cpu.u) <= 1e-11
    assert _rel(s_gpu.p.cpu(), s_cpu.p) <= 1e-11


@pytest.mark.cuda
def test_heat_kernel_rejects_bad_input(cuda):
    prob = HeatControlProblem(ProblemConfig(N_x=12, N_t=10), device=cuda)
    c = ch.pack_heat_constants(prob)
    with pytest.raises(ValueError, match="contiguous"):
        ch.fused_heat(torch.zeros(2, 6, 10, dtype=torch.complex128, device=cuda), c, 1)
    with pytest.raises(ValueError, match="contiguous"):
        ch.fused_heat(torch.zeros(2, 11, 6, dtype=torch.complex128, device=cuda).transpose(1, 2), c, 1)
    with pytest.raises(ValueError, match="constant"):
        ch.fused_heat(torch.zeros(2, 6, 11, dtype=torch.complex64, device=cuda), c, 1)
    with pytest.raises(ValueError, match="refine"):
        ch.fused_heat(torch.zeros(2, 6, 11, dtype=torch.complex128, device=cuda), c, -1)
    assert ch.fused_heat(torch.zeros(2, 6, 11, dtype=torch.complex128, device=cuda), c, 0).abs().max().item() == 0.0


# ---------------------------------------------------------------------------
# The batch axis: B lanes in one launch (blockIdx.y), constants shared.

def _batch_case(cuda, family, kw, dtype, B=3):
    """Packed constants and B distinct kernel inputs (B, 2, K, n): the main
    path's input of the problem and seeded noise of its scale."""
    prob = (WaveControlProblem if family == "wave" else HeatControlProblem)(ProblemConfig(**kw, dtype=dtype), device=cuda)
    c = cw.pack_constants(prob.operator) if family == "wave" else ch.pack_heat_constants(prob)
    b0 = time_rfft_conj_packed(prob.space.dst(prob.rhs), kw["N_t"])
    rng = np.random.default_rng(11)
    noise = torch.from_numpy(rng.standard_normal((B - 1,) + tuple(b0.shape)) + 1j * rng.standard_normal(
        (B - 1,) + tuple(b0.shape))).to(b0.dtype).to(cuda)
    return c, torch.cat([b0[None], b0.abs().max() * noise]).contiguous()


BATCH_CASES = [
    (dict(N_x=40, N_t=24), torch.float64, 1e-12),
    (dict(N_x=9, N_t=12, dim=2, mass="lumped"), torch.float64, 1e-12),
    (dict(N_x=2048, N_t=1024), torch.float32, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["slab", "streaming"])
@pytest.mark.parametrize("family", ["wave", "heat"])
@pytest.mark.parametrize("kw,dtype,tol", BATCH_CASES, ids=["40x24-f64", "2d-lumped-f64", "headline-f32"])
def test_batched_launch_is_bitwise_per_lane(cuda, kw, dtype, tol, family, kind):
    """B1 and B2, slab and streaming, on a B = 3 batch: ONE launch, each
    lane bitwise equal to a launch on that lane alone, and the batch equal
    to the batched twin within the single launch's tolerance."""
    c, bs = _batch_case(cuda, family, kw, dtype)
    if family == "wave":
        fn = cw.fused_woodbury if kind == "slab" else cw._fused_woodbury_streaming
        twin, counter = cw.fused_woodbury_reference, cw.fused_woodbury
        tol = tol or 2e-4
    else:
        fn = ch.fused_heat if kind == "slab" else ch._fused_heat_streaming
        twin, counter = ch.fused_heat_reference, ch.fused_heat
        tol = tol or HEAT_TOL_F32
    before = counter.launches
    xs = fn(bs, c, 1)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert xs.shape == bs.shape and xs.dtype == bs.dtype
    for i in range(bs.shape[0]):
        assert torch.equal(xs[i], fn(bs[i].contiguous(), c, 1))
    ref = twin(bs, c, 1)
    for i in range(bs.shape[0]):
        assert _rel(xs[i], ref[i]) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["wave", "heat"])
def test_batch_sizes_refused(cuda, family):
    """B = 0 and B > 65535 (the grid's y axis) are refused before any
    launch, with a clear error; the C launchers refuse them too."""
    kw = dict(N_x=3, N_t=3)  # n = 2, K = 2
    c, bs = _batch_case(cuda, family, kw, torch.float64, B=2)
    fn, counter = (cw.fused_woodbury, cw.fused_woodbury) if family == "wave" else (ch.fused_heat, ch.fused_heat)
    before = counter.launches
    for B in (0, 65536):
        with pytest.raises(ValueError, match="1 to 65535 lanes"):
            fn(torch.zeros((B,) + tuple(bs.shape[1:]), dtype=bs.dtype, device=cuda), c, 1)
    assert counter.launches == before
    if family == "wave":
        lib = cw._kernel_library()
        x = torch.empty_like(bs)
        for B in (0, 65536):
            err = lib.woodbury_streaming_f64(bs.data_ptr(), x.data_ptr(), c.a11r.data_ptr(), c.a11i.data_ptr(),
                                             c.invdet.data_ptr(), c.colc.data_ptr(), c.gc.data_ptr(),
                                             c.phases.data_ptr(), 2, 2, B, 1, torch.cuda.current_device(),
                                             torch.cuda.current_stream().cuda_stream)
            assert err != 0
    x = fn(bs, c, 1)  # a good launch after the refusals
    torch.cuda.synchronize()
    assert counter.launches == before + 1 and torch.isfinite(x.abs()).all()
