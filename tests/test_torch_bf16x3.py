"""The bf16x3 product of the PyTorch port (``ops/bf16x3.py``) and what runs
on it: ``P1Space.dst`` with ``dst_precision='high'``, the four-step plans'
``precision='high'``, and the polished wave and heat solves, against an
independent numpy emulation and the JAX package, on the CPU.

On the CPU the JAX package's XLA backend ignores ``Precision.HIGH`` and
computes full float32, while the port runs its bf16x3 twin; so a port
result is held to JAX's at the bf16x3 transform's own error. Tolerances
(relative max-abs, ``|a - b|.max() <= tol * |a|.max()``, a the reference):

- hi + lo against x, elementwise: 2^-16 |x| (bf16 keeps 8 significant
  bits: |x - hi| <= 2^-8 |x|, and lo rounds that remainder to 8 bits);
- the twin against the numpy emulation (float64 sums of the same three
  exact products): 1e-6, the float32 sums' rounding over K <= 255;
- the port's 'high' DST and plans against JAX's: 2e-5, the float32 DST
  tolerance of tests/test_transforms.py (the bf16x3 DST at N_x = 2048
  reads 3.6e-6 against float64);
- float64 'high' against 'highest': bitwise, in both packages;
- the polished solves' float64 residuals: 1.25 x the port's own 'highest'
  polished residual and 1.25 x JAX's 'high' polished residual.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optimal_control_paradiag_tpu as J
from optimal_control_paradiag_torch import HeatControlProblem, ProblemConfig, SolverConfig, WaveControlProblem
from optimal_control_paradiag_torch.fem.space import make_space as t_make_space
from optimal_control_paradiag_torch.interop import heat_problem_from_jax, problem_from_jax
from optimal_control_paradiag_torch.ops import bf16x3 as b3
from optimal_control_paradiag_torch.ops import transforms as t_tr
from optimal_control_paradiag_torch.utils.timing import counters
from optimal_control_paradiag_tpu.fem.space import make_space as j_make_space
from optimal_control_paradiag_tpu.models.heat import HeatControlProblem as JHeat
from optimal_control_paradiag_tpu.ops import transforms as j_tr

torch.set_num_threads(1)

SPLIT_TOL = 2.0**-16
EMULATION_TOL = 1e-6
JAX_TOL = 2e-5
RESIDUAL_FACTOR = 1.25


def _close(ref, got, tol):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape
    assert np.abs(ref - got).max() <= tol * np.abs(ref).max()


def _rne_bf16(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bf16 value (ties to even), as float32, by bit
    arithmetic on the float32 pattern."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _emulate(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """bf16x3 ``a @ b`` of float32 arrays: the bit-mask split, the three
    products and their sums in float64."""
    split = lambda x: (_rne_bf16(x), _rne_bf16(x - _rne_bf16(x)))
    (ah, al), (bh, bl) = split(a), split(b)
    f = lambda x: x.astype(np.float64)
    return f(ah) @ f(bl) + f(al) @ f(bh) + f(ah) @ f(bh)


def test_split_bf16_is_rne_and_exact():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * 10.0 ** rng.uniform(-6, 6, 4096)).astype(np.float32)
    hi, lo = b3.split_bf16(torch.from_numpy(x))
    assert hi.dtype == lo.dtype == torch.bfloat16
    np.testing.assert_array_equal(hi.float().numpy(), _rne_bf16(x))
    np.testing.assert_array_equal(lo.float().numpy(), _rne_bf16(x - _rne_bf16(x)))
    err = np.abs(x.astype(np.float64) - hi.double().numpy() - lo.double().numpy())
    assert (err <= SPLIT_TOL * np.abs(x.astype(np.float64))).all()


@pytest.mark.parametrize("M,K,N", [(1, 1, 1), (17, 33, 9), (1, 255, 255), (64, 127, 129), (130, 255, 7), (5, 40, 300)])
def test_twin_matches_numpy_emulation(M, K, N):
    rng = np.random.default_rng(M * 1000 + K + N)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    split = b3.split_matrix(torch.from_numpy(b))
    out = b3.bf16x3_matmul(torch.from_numpy(a), split)
    assert out.dtype == torch.float32 and out.shape == (M, N)
    _close(_emulate(a, b), out, EMULATION_TOL)
    _close(_emulate(a, b), b3.bf16x3_matmul_reference(torch.from_numpy(a), split.hi, split.lo), EMULATION_TOL)


def test_split_matrix_pads_to_sixteen_bytes():
    b = torch.arange(1.0, 1.0 + 5 * 9, dtype=torch.float32).reshape(5, 9)
    s = b3.split_matrix(b)
    assert s.planes.shape == (2, 5, 16) and s.planes.dtype == torch.bfloat16 and (s.k, s.n) == (5, 9)
    assert (s.planes[:, :, 9:] == 0).all()
    torch.testing.assert_close(s.hi.float() + s.lo.float(), b, rtol=SPLIT_TOL, atol=0.0)
    with pytest.raises(ValueError, match="float32"):
        b3.split_matrix(b.double())


def test_wrapper_refuses_what_the_kernel_does_not_take():
    s = b3.split_matrix(torch.ones(4, 3))
    with pytest.raises(ValueError, match="float32"):
        b3.bf16x3_matmul(torch.ones(2, 4, dtype=torch.float64), s)
    with pytest.raises(ValueError, match="float32"):
        b3.bf16x3_matmul(torch.ones(2, 5), s)
    with pytest.raises(ValueError, match="contiguous"):
        b3.bf16x3_matmul(torch.ones(4, 2).T, s)
    with pytest.raises(ValueError, match="lies on"):
        b3.bf16x3_matmul(torch.ones(2, 4, device="meta"), s)
    launches = counters["b3.launches"]
    assert b3.bf16x3_matmul(torch.ones(0, 4), s).shape == (0, 3)
    assert counters["b3.launches"] == launches  # the CPU runs the twin



# ------------------------------------------- the two routes and their layouts

T = b3.WGMMA_MIN_WIDTH


@pytest.mark.parametrize("n,k,route", [
    (T, T, "wgmma"), (T - 1, T - 1, "mma"), (T + 1, T + 1, "wgmma"), (2047, 2047, "wgmma"), (255, 255, "wgmma"),
    (32, 32, "mma"), (T - 1, 2047, "mma"), (2047, T - 1, "mma"), (0, 0, "mma"),
])
def test_route_is_chosen_from_the_shape(n, k, route):
    """Both N and K must reach the threshold (the crossover of chip_smoke's
    table, N = K) for the split pass and the wgmma GEMM: the headline DST
    (2047) and the heat 2D axes (255) take it, the time plans' radix
    products (32 at N_t = 1024) do not."""
    assert b3.bf16x3_route(n, k) == route


@pytest.mark.parametrize("k,ld", [(0, 0), (1, 64), (63, 64), (64, 64), (65, 128), (255, 256), (2047, 2048)])
def test_padded_width_is_k_rounded_up_to_64(k, ld):
    assert b3.padded_width(k) == ld and ld % b3.ROW_ALIGN == 0


@pytest.mark.parametrize("K,N", [(70, 9), (5, 3), (128, 130)])
def test_kmajor_split_matrix_is_padded_and_keeps_its_views(K, N):
    """The 'wgmma' layout: K-major (2, N, ld) planes, ld a multiple of 64
    (rows on 128 bytes), zero past K; ``.hi`` and ``.lo`` are (K, N) views
    bitwise those of the 'mma' layout and of :func:`split_bf16`."""
    b = torch.from_numpy(np.random.default_rng(K * N).standard_normal((K, N)).astype(np.float32))
    s, m = b3.split_matrix(b, route="wgmma"), b3.split_matrix(b, route="mma")
    ld = b3.padded_width(K)
    assert s.route == "wgmma" and (s.k, s.n) == (K, N) and s.planes.dtype == torch.bfloat16
    assert s.planes.shape == (2, N, ld) and s.planes.is_contiguous() and s.planes.stride(1) * 2 % 128 == 0
    assert (s.planes[:, :, K:] == 0).all()
    hi, lo = b3.split_bf16(b)
    for view, ref in ((s.hi, hi), (s.lo, lo), (m.hi, hi), (m.lo, lo)):
        assert view.shape == (K, N) and torch.equal(view, ref)
    torch.testing.assert_close(b3.bf16x3_matmul(torch.ones(3, K), s), b3.bf16x3_matmul(torch.ones(3, K), m),
                               rtol=1e-6, atol=1e-6)


def test_split_matrix_takes_the_shape_route_by_default():
    for k in (T - 1, T):
        s = b3.split_matrix(torch.ones(k, k))
        assert s.route == b3.bf16x3_route(k, k)
        assert s.planes.shape == ((2, k, b3.padded_width(k)) if s.route == "wgmma" else (2, k, -(-k // 8) * 8))
    with pytest.raises(ValueError, match="route"):
        b3.split_matrix(torch.ones(4, 4), route="tf32")


@pytest.mark.parametrize("M,K,ld", [(3, 70, 128), (1, 1, 64), (4, 64, 64), (2, 0, 64), (0, 5, 64)])
def test_split_rows_pads_with_zeros(M, K, ld):
    """The split pass's plain version: the (2, M, ld) planes of
    :func:`split_bf16`, zero past K."""
    rng = np.random.default_rng(M + K)
    a = torch.from_numpy((rng.standard_normal((M, K)) * 10.0 ** rng.uniform(-6, 6, (M, K))).astype(np.float32))
    planes = b3.split_rows(a, ld)
    assert planes.shape == (2, M, ld) and planes.dtype == torch.bfloat16
    hi, lo = b3.split_bf16(a)
    assert torch.equal(planes[0, :, :K], hi) and torch.equal(planes[1, :, :K], lo)
    assert (planes[:, :, K:] == 0).all()


@pytest.mark.parametrize("route", ["wgmma", "mma"])
def test_cpu_calls_run_the_twins_and_count_no_launch(route):
    """On CPU tensors the wrapper and the split pass run their plain twins
    and leave every launch count as it was."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((5, 130)).astype(np.float32))
    split = b3.split_matrix(torch.from_numpy(rng.standard_normal((130, 129)).astype(np.float32)), route=route)
    counts = lambda: (counters["b3.launches"], counters["b3.launches.wgmma"], counters["b3.split.launches"])
    before = counts()
    assert torch.equal(b3.bf16x3_matmul(a, split), b3.bf16x3_matmul_reference(a, split.hi, split.lo))
    assert torch.equal(b3.split_rows(a, 192), b3.split_rows_reference(a, 192))
    assert counts() == before


def test_split_rows_refuses_bad_widths():
    for a, ld in ((torch.ones(2, 70), 64), (torch.ones(2, 8), 72), (torch.ones(2, 8, dtype=torch.float64), 64),
                  (torch.ones(8, 2).T, 64)):
        with pytest.raises(ValueError, match="split_rows"):
            b3.split_rows(a, ld)


def test_high_dst_at_the_threshold_takes_the_kmajor_split():
    """A 'high' space whose n reaches the threshold splits its DST-I matrix
    K-major, and its DST still agrees with JAX's."""
    kw = dict(dim=1, N_x=T + 1)
    ts = t_make_space(**kw, dtype=torch.float32, device="cpu", dst_precision="high")
    assert ts.dst_matrix_split.route == "wgmma"
    x = np.random.default_rng(T).standard_normal((2, 3, ts.n)).astype(np.float32)
    js = j_make_space(**kw, dtype=jnp.float32, dst_precision="high")
    _close(js.dst(jnp.asarray(x)), ts.dst(torch.from_numpy(x)), JAX_TOL)
    _close(js.idst(jnp.asarray(x)), ts.idst(torch.from_numpy(x)), JAX_TOL)


# ------------------------------------------------------------ the sine transform

DST_CASES = [
    (dict(dim=1, N_x=256), (2, 16), False),
    (dict(dim=1, N_x=33), (3, 2, 5), False),
    (dict(dim=1, N_x=64), (2, 8), True),
    (dict(dim=2, N_x=32, mass="lumped"), (2, 4), False),
    (dict(dim=2, N_x=17, mass="lumped"), (2, 3), True),
]
DST_IDS = ["1d", "1d-batched", "1d-complex", "2d", "2d-complex"]


@pytest.mark.parametrize("kw,lead,cplx", DST_CASES, ids=DST_IDS)
def test_high_dst_matches_jax(kw, lead, cplx):
    js = j_make_space(**kw, dtype=jnp.float32, dst_precision="high")
    ts = t_make_space(**kw, dtype=torch.float32, device="cpu", dst_precision="high")
    assert ts._bf16x3 and not ts._use_fft_dst
    rng = np.random.default_rng(kw["N_x"])
    x = rng.standard_normal(lead + (ts.n,))
    if cplx:
        x = x + 1j * rng.standard_normal(lead + (ts.n,))
    x = x.astype(np.complex64 if cplx else np.float32)
    got = ts.dst(torch.from_numpy(x))
    assert got.dtype == (torch.complex64 if cplx else torch.float32)
    _close(js.dst(jnp.asarray(x)), got, JAX_TOL)
    _close(js.idst(jnp.asarray(x)), ts.idst(torch.from_numpy(x)), JAX_TOL)
    # bf16x3 is not the full float32 product: it moves the result
    full = t_make_space(**kw, dtype=torch.float32, device="cpu").dst(torch.from_numpy(x))
    assert not torch.equal(full, got)


@pytest.mark.parametrize("dim", [1, 2])
def test_float64_high_is_highest_bitwise(dim):
    kw = dict(dim=dim, N_x=24, mass="lumped")
    x = np.random.default_rng(dim).standard_normal((2, 5, (kw["N_x"] - 1) ** dim))
    jh, jf = (j_make_space(**kw, dst_precision=p) for p in ("high", "highest"))
    np.testing.assert_array_equal(np.asarray(jh.dst(jnp.asarray(x))), np.asarray(jf.dst(jnp.asarray(x))))
    th, tf = (t_make_space(**kw, device="cpu", dst_precision=p) for p in ("high", "highest"))
    assert not th._bf16x3
    assert torch.equal(th.dst(torch.from_numpy(x)), tf.dst(torch.from_numpy(x)))


@pytest.mark.parametrize("dst_method", ["fft", "mxu4"])
def test_fft_and_mxu4_ignore_dst_precision(dst_method):
    kw = dict(dim=1, N_x=40, dtype=torch.float32, device="cpu", dst_method=dst_method)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 6, 39)).astype(np.float32))
    high = t_make_space(**kw, dst_precision="high")
    assert torch.equal(high.dst(x), t_make_space(**kw).dst(x))


def test_unknown_dst_precision_raises():
    with pytest.raises(ValueError, match="dst_precision"):
        t_make_space(dim=1, N_x=8, device="cpu", dst_precision="low")


# ----------------------------------------------------------------- the plans


@pytest.mark.parametrize("N", [16, 81, 12, 1024])
def test_high_time_plans_match_jax(N):
    rng = np.random.default_rng(N)
    x = rng.standard_normal((2, N, 7)).astype(np.float32)
    jp = j_tr.FourStepPlan(N, jnp.float32)
    tp = t_tr.FourStepPlan(N, torch.float32, precision="high", device="cpu")
    assert set(tp.splits) == {"Cb", "Sb", "Ca", "Sa", "Cb1", "Sb1"}
    fwd = t_tr.time_rfft_conj_mm4(torch.from_numpy(x), tp)
    assert fwd.dtype == torch.complex64
    ref = j_tr.time_rfft_conj_mm4(jnp.asarray(x), jp)
    _close(ref, fwd, JAX_TOL)
    xi = np.array(ref)
    back = t_tr.time_irfft_conj_mm4(torch.from_numpy(xi), tp)
    _close(j_tr.time_irfft_conj_mm4(jnp.asarray(xi), jp), back, JAX_TOL)


@pytest.mark.parametrize("N_x", [8, 9, 80, 128])
def test_high_dst_plan_matches_jax(N_x):
    x = np.random.default_rng(N_x).standard_normal((3, 5, N_x - 1)).astype(np.float32)
    jp = j_tr.DstFourStepPlan(N_x, jnp.float32)
    tp = t_tr.DstFourStepPlan(N_x, torch.float32, precision="high", device="cpu")
    assert set(tp.splits) == {"Cb", "Sb", "Ca", "Sa"}
    _close(j_tr.dst1_mm4(jnp.asarray(x), jp), t_tr.dst1_mm4(torch.from_numpy(x), tp), JAX_TOL)


def test_float64_high_plans_are_full_precision():
    """In float64 'high' splits nothing: the plans' products are the float64
    einsums, bitwise those of ``precision=None``."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 16, 3)))
    hi, full = (t_tr.FourStepPlan(16, torch.float64, precision=p, device="cpu") for p in ("high", None))
    assert hi.splits == {}
    assert torch.equal(t_tr.time_rfft_conj_mm4(x, hi), t_tr.time_rfft_conj_mm4(x, full))
    assert t_tr.DstFourStepPlan(16, torch.float64, precision="high", device="cpu").splits == {}
    assert t_tr.FourStepPlan(16, torch.float32, precision="highest", device="cpu").splits == {}


# ------------------------------------------------ problems and polished solves


def test_problem_from_jax_carries_high():
    jcfg = J.ProblemConfig(N_x=32, N_t=16, dtype=jnp.float32, dst_precision="high")
    jp = J.WaveControlProblem(jcfg)
    tp = problem_from_jax(dataclasses.asdict(jcfg), {k: np.asarray(v) for k, v in jp._data.items()}, device="cpu")
    assert tp.config.dst_precision == "high" and tp.space._bf16x3
    torch.testing.assert_close(tp.space.dst_matrix_split.hi.float() + tp.space.dst_matrix_split.lo.float(),
                               tp.space.dst_matrix, rtol=SPLIT_TOL, atol=0.0)
    _close(jp.rhs, tp.rhs, 1e-6)
    jh = JHeat(jcfg)
    th = heat_problem_from_jax(dataclasses.asdict(jcfg), {k: np.asarray(v) for k, v in jh._data.items()},
                               device="cpu")
    assert th.space._bf16x3
    _close(jh.rhs, th.rhs, 1e-6)


SOLVE_CASES = [
    ("wave", dict(N_x=128, N_t=64)),
    ("heat", dict(N_x=128, N_t=64)),
    ("heat", dict(N_x=32, N_t=16, dim=2, mass="lumped")),
    ("wave", dict(N_x=32, N_t=16, dim=2, mass="lumped")),
]
SOLVE_IDS = ["wave-1d", "heat-1d", "heat-2d", "wave-2d"]


@pytest.mark.parametrize("family,kw", SOLVE_CASES, ids=SOLVE_IDS)
def test_high_polished_solve_lands_on_the_floor(family, kw):
    """'high' with one polish step: within 1.25x of the port's 'highest'
    polished solve and of JAX's 'high' polished solve (full float32 on the
    CPU); without polish the bf16x3 rounding shows (printed)."""
    TProb, JProb = (WaveControlProblem, J.WaveControlProblem) if family == "wave" else (HeatControlProblem, JHeat)
    pol = SolverConfig(method="woodbury", use_pallas=True, polish=1)
    tres = {}
    for prec in ("highest", "high"):
        tp = TProb(ProblemConfig(**kw, dtype=torch.float32, dst_precision=prec), device="cpu")
        tres[prec] = tp.relative_residual_f64(tp.solve(pol))
    jp = JProb(J.ProblemConfig(**kw, dtype=jnp.float32, dst_precision="high"))
    jres = jp.relative_residual_f64(jp.solve(J.SolverConfig(method="woodbury", polish=1)))
    plain = tp.relative_residual_f64(tp.solve(SolverConfig(method="woodbury", use_pallas=True)))
    print(family, kw, "port highest/high polished", tres, "jax high polished", jres, "port high plain", plain)
    assert tres["high"] <= RESIDUAL_FACTOR * tres["highest"]
    assert tres["high"] <= RESIDUAL_FACTOR * jres
