"""PyTorch port vs JAX package: the P1 space (stencils, sine transform,
spectrum) and the all-at-once operator and right-hand side, on the same
seeded numpy inputs, in float64 on the CPU. Tolerance: relative max-abs
1e-12 (``|a - b|.max() <= tol * |a|.max()``, a the JAX result); the float32
'fft' and 'mxu4' sine transforms 2e-5 against the matmul, as
tests/test_transforms.py holds the four-step DST."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_control_paradiag_torch.fem.space import make_space as t_make_space
from optimal_control_paradiag_torch.ops.allatonce import build_operator as t_build_operator
from optimal_control_paradiag_torch.ops.allatonce import build_rhs as t_build_rhs
from optimal_control_paradiag_tpu.fem.space import make_space as j_make_space
from optimal_control_paradiag_tpu.ops.allatonce import build_operator as j_build_operator
from optimal_control_paradiag_tpu.ops.allatonce import build_rhs as j_build_rhs

torch.set_num_threads(1)

TOL = 1e-12
SPACES = [
    dict(dim=1, N_x=17, mass="consistent"),
    dict(dim=1, N_x=16, mass="lumped"),
    dict(dim=2, N_x=7, mass="lumped"),
    dict(dim=2, N_x=6, mass="consistent"),
]
IDS = ["1d-consistent", "1d-lumped", "2d-lumped", "2d-consistent"]


def _assert_close(ref, got, tol=TOL):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape
    assert np.abs(ref - got).max() <= tol * np.abs(ref).max()


def _spaces(kw):
    return j_make_space(**kw), t_make_space(**kw, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("kw", SPACES, ids=IDS)
def test_stencils_match_jax(kw):
    js, ts = _spaces(kw)
    x = np.random.default_rng(0).standard_normal((3, js.n))
    xt = torch.from_numpy(x)
    _assert_close(js.apply_mass(jnp.asarray(x)), ts.apply_mass(xt))
    _assert_close(js.apply_stiffness(jnp.asarray(x)), ts.apply_stiffness(xt))
    _assert_close(js.apply_mass_host_f64(x), ts.apply_mass_host_f64(x))
    _assert_close(js.apply_stiffness_host_f64(x), ts.apply_stiffness_host_f64(x))


@pytest.mark.parametrize("kw", SPACES, ids=IDS)
def test_sine_transform_matches_jax(kw):
    js, ts = _spaces(kw)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, js.n))
    z = x + 1j * rng.standard_normal(x.shape)
    _assert_close(js.dst_matrix, ts.dst_matrix)
    _assert_close(js.dst(jnp.asarray(x)), ts.dst(torch.from_numpy(x)))
    _assert_close(js.idst(jnp.asarray(x)), ts.idst(torch.from_numpy(x)))
    _assert_close(js.dst(jnp.asarray(z)), ts.dst(torch.from_numpy(z)))
    # DST-I is its own inverse up to the idst scale
    _assert_close(x, ts.idst(ts.dst(torch.from_numpy(x))))


@pytest.mark.parametrize("kw", SPACES, ids=IDS)
def test_spectrum_coords_interpolate_match_jax(kw):
    js, ts = _spaces(kw)
    (jM, jK), (tM, tK) = js.spectrum, ts.spectrum
    _assert_close(jK, tK)
    assert (jM is None) == (tM is None) == (not ts.diagonalizable)
    if jM is not None:
        _assert_close(jM, tM)
    for jc, tc in zip(js.coords, ts.coords):
        _assert_close(jc, tc)
    fn = lambda *xy: np.sin(np.pi * xy[0]) * (1.0 + sum(xy))
    _assert_close(js.interpolate(fn), ts.interpolate(fn))


@pytest.mark.parametrize("kw", SPACES, ids=IDS)
@pytest.mark.parametrize("scaled,gamma", [(True, 0.5), (False, 2.0)])
def test_operator_and_rhs_match_jax(kw, scaled, gamma):
    js, ts = _spaces(kw)
    N_t, dt = 7, 0.3
    jop = j_build_operator(js, N_t, dt, gamma, scaled=scaled)
    top = t_build_operator(ts, N_t, dt, gamma, scaled=scaled)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, N_t, js.n))
    _assert_close(jop.matvec(jnp.asarray(x)), top.matvec(torch.from_numpy(x)))
    _assert_close(jop.matvec_host_f64(x), top.matvec_host_f64(x))
    f, g = rng.standard_normal((2, N_t, js.n))
    u0, u1 = rng.standard_normal((2, js.n))
    _assert_close(
        j_build_rhs(jop, *(jnp.asarray(a) for a in (f, g, u0, u1))),
        t_build_rhs(top, *(torch.from_numpy(a) for a in (f, g, u0, u1))),
    )


def _half_rows_uncached(op, x):
    """``AllAtOnceOperator._half_rows`` as it was before its columns were
    cached: built anew on every call."""
    cu = torch.ones((op.N_t, 1), dtype=x.dtype, device=x.device)
    cp = torch.ones((op.N_t, 1), dtype=x.dtype, device=x.device)
    cu[0, 0] = 0.5
    cp[-1, 0] = 0.5
    return cu, cp


@pytest.mark.parametrize("kw", SPACES, ids=IDS)
def test_cached_half_rows_leave_matvecs_bitwise_unchanged(kw, monkeypatch):
    """The cached (cu, cp) columns give bit for bit the matvecs of the
    uncached ones, in both dtypes, on repeated and interleaved calls."""
    top = t_build_operator(t_make_space(**kw, device="cpu"), 7, 0.3, 0.5)
    rng = np.random.default_rng(9)
    xs = {dt: torch.from_numpy(rng.standard_normal((2, 7, top.space.n))).to(dt)
          for dt in (torch.float64, torch.float32)}
    with monkeypatch.context() as m:
        m.setattr(type(top), "_half_rows", _half_rows_uncached)
        before = {dt: (top.matvec(x), top.matvec_accurate(x)) for dt, x in xs.items()}
    for _ in range(2):
        for dt, x in xs.items():
            assert torch.equal(top.matvec(x), before[dt][0])
            assert torch.equal(top.matvec_accurate(x), before[dt][1])
    assert len(top._half_cache) == 2


def test_float32_stencils_stay_float32():
    ts = t_make_space(dim=1, N_x=9, dtype=torch.float32, device="cpu")
    x = torch.ones(4, ts.n, dtype=torch.float32)
    for y in (ts.apply_mass(x), ts.apply_stiffness(x), ts.dst(x), ts.idst(x)):
        assert y.dtype == torch.float32
    op = t_build_operator(ts, 4, 0.1, 1.0)
    assert op.matvec(torch.ones(2, 4, ts.n, dtype=torch.float32)).dtype == torch.float32


def test_make_space_defaults_to_the_card():
    """Without a device the space goes to the card, and without a card it
    raises: the port never falls back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        t_make_space(dim=1, N_x=8)


@pytest.mark.parametrize("kw", SPACES, ids=IDS)
@pytest.mark.parametrize("method", ["fft", "mxu4"])
def test_space_dst_methods_match_jax(kw, method):
    js = j_make_space(**kw, dst_method=method)
    ts = t_make_space(**kw, dtype=torch.float64, device="cpu", dst_method=method)
    matmul = t_make_space(**kw, dtype=torch.float64, device="cpu", dst_method="matmul")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, js.n))
    z = x + 1j * rng.standard_normal(x.shape)
    for v in (x, z):
        got = ts.dst(torch.from_numpy(v))
        assert got.dtype == (torch.complex128 if np.iscomplexobj(v) else torch.float64)
        _assert_close(js.dst(jnp.asarray(v)), got, 1e-12)
        _assert_close(js.idst(jnp.asarray(v)), ts.idst(torch.from_numpy(v)), 1e-12)
        _assert_close(matmul.dst(torch.from_numpy(v)), got, 1e-12)
    _assert_close(x, ts.idst(ts.dst(torch.from_numpy(x))), 1e-12)
    # float32 stays float32, to tests/test_transforms.py's DST tolerance
    t32 = t_make_space(**kw, dtype=torch.float32, device="cpu", dst_method=method)
    out = t32.dst(torch.from_numpy(x.astype(np.float32)))
    assert out.dtype == torch.float32
    _assert_close(matmul.dst(torch.from_numpy(x)), out, 2e-5)


def test_auto_dst_past_budget_takes_fft():
    """float64, n1d = 2900: a 67 MB dense matrix, past the 64 MB 'auto'
    budget; 'auto' takes the FFT sine transform, as in the JAX package, and
    builds no matrix. float32 switches past n1d = 4096."""
    ts = t_make_space(dim=1, N_x=2901, dtype=torch.float64, device="cpu")
    js = j_make_space(dim=1, N_x=2901)
    assert ts._use_fft_dst and js._use_fft_dst
    x = np.random.default_rng(2).standard_normal((2, ts.n))
    _assert_close(js.dst(jnp.asarray(x)), ts.dst(torch.from_numpy(x)), 1e-12)
    assert "dst_matrix" not in ts.__dict__
    assert not t_make_space(dim=1, N_x=2897, dtype=torch.float64, device="cpu")._use_fft_dst
    assert not t_make_space(dim=1, N_x=4097, dtype=torch.float32, device="cpu")._use_fft_dst
    assert t_make_space(dim=1, N_x=4098, dtype=torch.float32, device="cpu")._use_fft_dst
