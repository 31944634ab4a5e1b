"""Host-exact polish (polish_host.py) + new polish settings.

The B = 1 sparse path polishes via an exact scipy splu of the true
reduced KKT (setup-class work on the host — the device CG polish
needs 24-40k iterations on DTOC3-class masked KKTs, where one exact
sparse factorization does)."""

import numpy as np
import pytest
import scipy.sparse as sp

import osqp_tpu
from osqp_tpu import constants as con
from osqp_tpu.polish_host import polish_host

from conftest import assert_allclose


def _banded(n, seed=0):
    rng = np.random.default_rng(seed)
    main = 2.0 + rng.uniform(0.5, 1.5, n)
    off = rng.uniform(-0.4, 0.4, n - 1)
    P = sp.diags([off, main, off], [-1, 0, 1], format="csc")
    A = sp.diags(
        [rng.uniform(0.5, 1.0, n - 1), np.ones(n), rng.uniform(0.5, 1.0, n - 1)],
        [-1, 0, 1], format="csc",
    )
    q = rng.normal(size=n)
    u = rng.uniform(0.5, 1.5, n)
    l = -u
    return P, q, A, l, u


def test_sparse_single_uses_host_polish_and_matches_dense():
    n = 300
    P, q, A, l, u = _banded(n)
    r_sp = osqp_tpu.solve_sparse(
        P, q, A, l, u, polish=True, verbose=False, eps_abs=1e-4, eps_rel=1e-4
    )
    assert int(np.asarray(r_sp.status_val)[0]) == con.OSQP_SOLVED
    assert int(np.asarray(r_sp.status_polish)[0]) == 1
    # dense reference solve of the same problem
    s = osqp_tpu.Solver(P, q, A, l, u, polish=True, verbose=False,
                        eps_abs=1e-4, eps_rel=1e-4)
    r_d = s.solve()
    assert r_d.info.status_polish == 1
    assert_allclose(np.asarray(r_sp.x)[0], r_d.x, tol=1e-6)
    # polished residuals are direct-solve quality
    assert float(np.asarray(r_sp.pri_res)[0]) < 1e-8
    assert float(np.asarray(r_sp.dua_res)[0]) < 1e-8


def test_polish_host_acceptance_guard():
    """The acceptance test must refuse when it cannot strictly improve
    BOTH residuals (polish.c:301-314): claiming exactly-zero ADMM
    residuals makes strict improvement impossible."""
    n = 50
    P, q, A, l, u = _banded(n, seed=1)
    x = np.zeros(n)
    y = np.zeros(n)
    ok, x2, y2, obj, pri, dua = polish_host(
        P, A, q, l, u, x, y, admm_pri_res=0.0, admm_dua_res=0.0
    )
    assert not ok
    np.testing.assert_array_equal(x2, x)


def test_polish_dtype_validation():
    P, q, A, l, u = _banded(8)
    with pytest.raises(con.OSQPError, match="polish_dtype"):
        osqp_tpu.Solver(P, q, A, l, u, polish_dtype="int32")
    # float64 target requires x64 — enabled in the test env, so accepted
    s = osqp_tpu.Solver(P, q, A, l, u, polish=True, polish_dtype="float64",
                        dtype="float32", verbose=False)
    r = s.solve()
    assert r.info.status_val == con.OSQP_SOLVED


def test_polish_passes_validation():
    P, q, A, l, u = _banded(8)
    with pytest.raises(con.OSQPError, match="polish_passes"):
        osqp_tpu.Solver(P, q, A, l, u, polish_passes=0)


def test_polish_host_scaled_space_on_badly_scaled_problem():
    """Round-5 regression: polish_host runs the reference pipeline on
    the RUIZ-SCALED problem.  On raw badly-scaled data, delta = 1e-6 is
    a vanishing relative perturbation of huge operators and the reduced
    KKT turns numerically singular (measured: every active-set guess
    failed at pri ~ 9.9 on CVXQP1_M before the fix).  This reproducer
    scales a well-behaved banded QP by 1e8 on P/q and mixed 1e4 row
    factors on A/l/u — polish must still accept and land at
    machine-level residuals."""
    n = 200
    P, q, A, l, u = _banded(n, seed=3)
    rng = np.random.default_rng(7)
    rowscale = 10.0 ** rng.uniform(0, 4, n)
    E = sp.diags(rowscale)
    P2 = (1e8 * P).tocsc()
    q2 = 1e8 * q
    A2 = (E @ A).tocsc()
    l2, u2 = rowscale * l, rowscale * u

    s = osqp_tpu.Solver(
        P=P2, q=q2, A=A2, l=l2, u=u2, verbose=False, polish=False,
        eps_abs=1e-5, eps_rel=1e-5,
    )
    r = s.solve()
    assert r.info.status_val == con.OSQP_SOLVED
    ok, x_p, y_p, obj, pri, dua = polish_host(
        P2, A2, q2, l2, u2, np.asarray(r.x), np.asarray(r.y),
        float(r.info.pri_res), float(r.info.dua_res),
    )
    assert ok, "scaled-space host polish must accept on scaled data"
    assert pri <= r.info.pri_res and dua <= r.info.dua_res
