"""Blocked dense linear algebra of the PyTorch port (``ops/blocked.py``) vs
the JAX package's, on the CPU: the cases of tests/test_blocked.py, each run
in both packages on the same seeded inputs.

Tolerances: each case's own gates (test_blocked.py), in float32 as there;
and in float64 the port's result against JAX's on the same inputs, relative
max-abs 1e-10 (the Cholesky factor and triangular solves; cholqr2's Q up to
the sign-free uniqueness of a QR with a positive-diagonal R, so Q itself)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimal_control_paradiag_torch.ops.blocked import blocked_cholesky, cholqr, cholqr2, tri_solve_lower
from optimal_control_paradiag_tpu.ops import blocked as j_blocked

torch.set_num_threads(1)


def _spd(p, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((p, p)).astype(dtype)
    return (A @ A.T) / p + np.eye(p, dtype=dtype)


def _close(ref, got, tol):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert ref.shape == got.shape
    assert np.abs(ref - got).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("p,b", [(200, 64), (500, 96), (96, 96), (50, 96)])
def test_blocked_cholesky_matches(p, b):
    """tests/test_blocked.py:26, and the float64 factor equal to JAX's."""
    A = _spd(p)
    L = blocked_cholesky(torch.from_numpy(A), block=b).double().numpy()
    assert np.abs(np.triu(L, 1)).max() == 0.0
    assert np.linalg.norm(L @ L.T - A) / np.linalg.norm(A) <= 1e-6
    A64 = _spd(p, dtype=np.float64)
    _close(j_blocked.blocked_cholesky(jnp.asarray(A64), block=b), blocked_cholesky(torch.from_numpy(A64), block=b),
           1e-10)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("p,b", [(300, 64), (100, 128)])
def test_tri_solve_lower(p, b, transpose):
    """tests/test_blocked.py:34, and the float64 solve equal to JAX's."""
    A = _spd(p, seed=2)
    L = np.linalg.cholesky(A.astype(np.float64)).astype(np.float32)
    B = np.random.default_rng(3).standard_normal((p, 17)).astype(np.float32)
    X = tri_solve_lower(torch.from_numpy(L), torch.from_numpy(B), block=b, transpose=transpose).double().numpy()
    M = L.T if transpose else L
    assert np.linalg.norm(M.astype(np.float64) @ X - B) / np.linalg.norm(B) <= 1e-5
    L64, B64 = np.linalg.cholesky(_spd(p, seed=2, dtype=np.float64)), B.astype(np.float64)
    _close(j_blocked.tri_solve_lower(jnp.asarray(L64), jnp.asarray(B64), block=b, transpose=transpose),
           tri_solve_lower(torch.from_numpy(L64), torch.from_numpy(B64), block=b, transpose=transpose), 1e-10)


def test_cholqr2_orthonormal_and_range():
    """tests/test_blocked.py:48, and the float64 Q equal to JAX's."""
    Y = np.random.default_rng(0).standard_normal((400, 150)).astype(np.float32)
    Q = cholqr2(torch.from_numpy(Y), block=96).double().numpy()
    assert np.linalg.norm(Q.T @ Q - np.eye(150)) <= 5e-5
    assert np.linalg.norm(Q @ (Q.T @ Y) - Y) / np.linalg.norm(Y) <= 1e-5
    Y64 = Y.astype(np.float64)
    _close(j_blocked.cholqr2(jnp.asarray(Y64), block=96), cholqr2(torch.from_numpy(Y64), block=96), 1e-10)


def test_cholqr2_survives_high_condition():
    """tests/test_blocked.py:57: kappa(Y) = 2e4, past plain CholQR2's float32
    boundary; one unshifted pass is not orthonormal there, in either
    package."""
    rng = np.random.default_rng(1)
    p, k = 400, 120
    U, _ = np.linalg.qr(rng.standard_normal((p, k)))
    V, _ = np.linalg.qr(rng.standard_normal((k, k)))
    Y = (U * np.logspace(0, -4.3, k)[None, :]) @ V.T
    Yf = Y.astype(np.float32)
    Q = cholqr2(torch.from_numpy(Yf), block=96).double().numpy()
    assert np.linalg.norm(Q.T @ Q - np.eye(k)) <= 1e-4
    assert np.linalg.norm(Q @ (Q.T @ Y) - Y) / np.linalg.norm(Y) <= 1e-2
    Q1 = cholqr(torch.from_numpy(Yf), block=96).double().numpy()
    assert np.linalg.norm(Q1.T @ Q1 - np.eye(k)) > 1e-2
    jQ1 = np.asarray(j_blocked.cholqr(jnp.asarray(Yf), block=96), np.float64)
    assert np.linalg.norm(jQ1.T @ jQ1 - np.eye(k)) > 1e-2


@pytest.mark.parametrize("shifted", [False, True])
def test_cholqr_pass_matches_jax_f64(shifted):
    """One CholeskyQR pass, plain and shifted, equal to JAX's in float64
    (the same ridge on the Gram)."""
    Y = np.random.default_rng(4).standard_normal((300, 70))
    _close(j_blocked.cholqr(jnp.asarray(Y), block=32, shifted=shifted),
           cholqr(torch.from_numpy(Y), block=32, shifted=shifted), 1e-10)
