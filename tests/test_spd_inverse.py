"""Batched SPD inversion (linalg.spd_inverse) and the dense_inv factor."""

import numpy as np
import pytest

import jax.numpy as jnp

from osqp_tpu.linalg import spd_inverse

from conftest import assert_allclose


def _spd(B, n, seed=0, cond=10.0):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n))
    S = np.einsum("bij,bkj->bik", M, M) / n + np.eye(n) / cond
    return S


def _ill(n, cond, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    M = (Q * np.logspace(0, np.log10(cond), n)) @ Q.T
    return 0.5 * (M + M.T)


@pytest.mark.parametrize("n", [1, 3, 8, 17, 32, 100, 130])
def test_matches_numpy_inverse(n):
    M = _spd(4, n, seed=n)
    X = spd_inverse(jnp.asarray(M))
    assert_allclose(X, np.linalg.inv(M), tol=1e-8)


def test_identity_residual_small_f32():
    n = 100
    M = _spd(8, n, seed=1).astype(np.float32)
    X = spd_inverse(jnp.asarray(M))
    assert X.dtype == jnp.float32
    R = np.eye(n) - np.einsum("bij,bjk->bik", M, np.asarray(X))
    assert np.max(np.abs(R)) < 1e-4


@pytest.mark.nanok
def test_nan_propagates_for_indefinite():
    M = _spd(2, 16, seed=2)
    M[1] -= 3.0 * np.eye(16)  # make instance 1 indefinite
    X = np.asarray(spd_inverse(jnp.asarray(M)))
    assert np.all(np.isfinite(X[0]))
    assert np.any(np.isnan(X[1]))


def test_zero_dim():
    M = jnp.zeros((3, 0, 0))
    assert spd_inverse(M).shape == (3, 0, 0)


def test_dense_inv_factor_is_schur_inverse():
    """dense_inv.init stores M^-1 of the Schur complement and the
    transposed (A M^-1)' the hot loop reads."""
    from osqp_tpu.linsys import dense_inv
    from osqp_tpu.linsys.dense_chol import form_schur

    rng = np.random.default_rng(5)
    B, n, m = 3, 12, 20
    P = jnp.asarray(_spd(B, n, seed=5))
    A = jnp.asarray(rng.standard_normal((B, m, n)) / np.sqrt(n))
    rho = jnp.asarray(0.1 + rng.random((B, m)))
    f = dense_inv.init(P, A, jnp.float64(1e-6), rho)
    M = np.asarray(form_schur(P, A, 1e-6, rho))
    Minv = np.linalg.inv(M)
    assert_allclose(f["Minv"], Minv, tol=1e-9)
    assert_allclose(f["AMinvT"], Minv @ np.swapaxes(np.asarray(A), 1, 2),
                    tol=1e-9)
    assert not np.asarray(f["refine"]).any()


def test_dense_inv_refine_flag_is_per_instance():
    """Only the ill-conditioned instance gets the per-solve refinement
    flag; the others keep the plain loop body."""
    from osqp_tpu.linsys import dense_inv

    n, B = 64, 4
    mats = [_ill(n, 1e7 if i == 2 else 1e2, seed=i) for i in range(B)]
    P = jnp.asarray(np.stack(mats), jnp.float32)
    A = jnp.zeros((B, 0, n), jnp.float32)
    f = dense_inv.init(P, A, jnp.float32(0.0), jnp.zeros((B, 0), jnp.float32))
    assert np.asarray(f["refine"]).tolist() == [False, False, True, False]
    assert np.isfinite(np.asarray(f["Minv"])).all()


def test_dense_inv_ill_conditioned_f32_inverse_usable():
    """cond 1e7 in f32: the Cholesky inverse stays finite and its
    residual is small enough for refinement to recover the solve."""
    from osqp_tpu.linsys import dense_inv

    n = 64
    P = jnp.asarray(_ill(n, 1e7, seed=3)[None], jnp.float32)
    A = jnp.zeros((1, 0, n), jnp.float32)
    f = dense_inv.init(P, A, jnp.float32(0.0), jnp.zeros((1, 0), jnp.float32))
    X = np.asarray(f["Minv"], np.float64)
    assert np.isfinite(X).all()
    R = np.eye(n) - np.asarray(P[0], np.float64) @ X[0]
    assert np.abs(R).max() < 1.0
