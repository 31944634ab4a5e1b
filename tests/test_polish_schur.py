"""Polish Schur-complement path (large-KKT; polish.py:_make_kkt_solver).

The batched-LU and SPD-Schur factorizations sit behind one solve
interface chosen by static KKT dimension; these tests force the Schur
path via the threshold and check it reproduces the LU path's polished
solution and still satisfies the acceptance criterion.
"""

import numpy as np
import pytest

import osqp_tpu.polish as polish_mod
from osqp_tpu import Solver


def _qp(n, m, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n)) / np.sqrt(n)
    P = M @ M.T + 0.1 * np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    x0 = rng.standard_normal(n)
    s = np.abs(rng.standard_normal(m)) + 0.05
    return P, q, A, A @ x0 - s, A @ x0 + s


def test_schur_polish_matches_lu(monkeypatch):
    P, q, A, l, u = _qp(30, 50)
    kw = dict(P=P, q=q, A=A, l=l, u=u, polish=True, verbose=False,
              eps_abs=1e-5, eps_rel=1e-5)

    res_lu = Solver(**kw).solve()
    assert res_lu.info.status_polish == 1

    monkeypatch.setattr(polish_mod, "_SCHUR_KKT_DIM", 1)
    res_sc = Solver(**kw).solve()
    assert res_sc.info.status_polish == 1
    np.testing.assert_allclose(res_sc.x, res_lu.x, rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(res_sc.y, res_lu.y, rtol=1e-7, atol=1e-7)
    assert abs(res_sc.info.obj_val - res_lu.info.obj_val) < 1e-8


def test_schur_polish_equalities(monkeypatch):
    # All-active rows (equality constraints) stress the augmented term.
    rng = np.random.default_rng(3)
    n, m = 24, 12
    M = rng.standard_normal((n, n)) / np.sqrt(n)
    P = M @ M.T + 0.1 * np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    b = A @ rng.standard_normal(n)
    monkeypatch.setattr(polish_mod, "_SCHUR_KKT_DIM", 1)
    res = Solver(P=P, q=q, A=A, l=b, u=b, polish=True, verbose=False).solve()
    assert res.info.status == "solved"
    assert res.info.status_polish == 1
    np.testing.assert_allclose(A @ res.x, b, atol=1e-7)


@pytest.mark.slow
def test_schur_polish_large_smoke():
    # Real threshold: n + m > _SCHUR_KKT_DIM routes to Schur organically.
    n, m = 2200, 2000
    assert n + m > polish_mod._SCHUR_KKT_DIM
    P, q, A, l, u = _qp(n, m, seed=1)
    res = Solver(P=P, q=q, A=A, l=l, u=u, polish=True, verbose=False,
                 eps_abs=1e-4, eps_rel=1e-4).solve()
    assert res.info.status == "solved"
    assert res.info.status_polish == 1
    # Polished point satisfies stationarity tightly.
    dua = P @ res.x + q + A.T @ res.y
    assert np.max(np.abs(dua)) < 1e-6
