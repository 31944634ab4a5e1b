"""Sparse (ELL) operand path: osqp_tpu.sparse_ops + osqp_tpu.large.

Covers the reference's CSC kernel role (src/cs.c:28-318,
src/lin_alg.c:241-323): products match dense, the sparse solve agrees
with the dense cg solve, and large-n problems run without densifying.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import osqp_tpu
from osqp_tpu import constants as con
from osqp_tpu.large import solve_sparse
from osqp_tpu.verify import kkt_check, primal_infeasibility_check
from conftest import TESTS_TOL


def _rand_sparse_qp(n, m, density, seed):
    rng = np.random.default_rng(seed)
    M = sp.random(n, n, density=density, random_state=rng, format="csc")
    P = (M @ M.T).tocsc() + 0.1 * sp.eye(n, format="csc")
    A = sp.random(m, n, density=density, random_state=rng, format="csc")
    # guarantee no empty columns so the QP is bounded in every coordinate
    A = A + sp.diags(np.ones(min(m, n)), shape=(m, n), format="csc")
    q = rng.standard_normal(n)
    x0 = rng.standard_normal(n)
    Ax = np.asarray(A @ x0).ravel()
    s = np.abs(rng.standard_normal(m)) + 0.1
    return P, q, A, Ax - s, Ax + s


def test_ell_products_match_dense():
    import jax.numpy as jnp

    from osqp_tpu.sparse_ops import (
        ELLMatrix,
        ell_col_norms,
        ell_diagonal,
        ell_from_scipy,
        ell_matvec,
        ell_row_norms,
        ell_sq_colsums,
        ell_tmatvec,
    )

    rng = np.random.default_rng(0)
    m, n, B = 17, 11, 3
    A = sp.random(m, n, density=0.3, random_state=rng, format="csr")
    E = ell_from_scipy(A, jnp.float64, batch=B)
    Ad = A.toarray()
    x = rng.standard_normal((B, n))
    y = rng.standard_normal((B, m))
    np.testing.assert_allclose(ell_matvec(E, x), x @ Ad.T, atol=1e-12)
    np.testing.assert_allclose(ell_tmatvec(E, y), y @ Ad, atol=1e-12)
    w = np.abs(rng.standard_normal((B, m))) + 0.1
    np.testing.assert_allclose(
        ell_sq_colsums(E, w), np.einsum("bm,mn->bn", w, Ad**2), atol=1e-12
    )
    cw = np.abs(rng.standard_normal((B, n))) + 0.1
    np.testing.assert_allclose(
        ell_row_norms(E, cw),
        np.max(np.abs(Ad)[None] * cw[:, None, :], axis=-1),
        atol=1e-12,
    )
    rw = np.abs(rng.standard_normal((B, m))) + 0.1
    np.testing.assert_allclose(
        ell_col_norms(E, rw),
        np.max(np.abs(Ad)[None] * rw[:, :, None], axis=-2),
        atol=1e-12,
    )
    # square matrix diagonal
    Pn = sp.random(n, n, density=0.4, random_state=rng, format="csr") + sp.eye(n)
    EP = ell_from_scipy(Pn, jnp.float64, batch=1)
    np.testing.assert_allclose(
        ell_diagonal(EP)[0], Pn.toarray().diagonal(), atol=1e-12
    )
    assert isinstance(E, ELLMatrix)


def test_sparse_solve_matches_dense_cg():
    from osqp_tpu.batch import solve_batch

    P, q, A, l, u = _rand_sparse_qp(40, 60, 0.15, seed=1)
    res_s = solve_sparse(P, q, A, l, u, verbose=False)
    from osqp_tpu.sparse import triu_to_full, to_upper_csc

    Pd = triu_to_full(to_upper_csc(P, 40))
    res_d = solve_batch(
        Pd[None], q[None], A.toarray()[None], l[None], u[None],
        linsys_solver="cg", verbose=False,
    )
    assert int(res_s.status_val[0]) == con.OSQP_SOLVED
    assert int(res_d.status_val[0]) == con.OSQP_SOLVED
    np.testing.assert_allclose(
        np.asarray(res_s.x[0]), np.asarray(res_d.x[0]), atol=1e-3
    )
    assert abs(float(res_s.obj_val[0]) - float(res_d.obj_val[0])) < TESTS_TOL
    chk = kkt_check(P, q, A, l, u, res_s.x[0], res_s.y[0])
    assert chk["ok"], chk


def test_sparse_batched_values():
    """B instances sharing the pattern: per-instance q/l/u."""
    P, q, A, l, u = _rand_sparse_qp(20, 30, 0.2, seed=2)
    B = 4
    qs = np.stack([q * (1 + 0.1 * i) for i in range(B)])
    res = solve_sparse(P, qs, A, np.tile(l, (B, 1)), np.tile(u, (B, 1)),
                       verbose=False)
    assert np.all(np.asarray(res.status_val) == con.OSQP_SOLVED)
    for b in range(B):
        chk = kkt_check(P, qs[b], A, l, u, res.x[b], res.y[b])
        assert chk["ok"], (b, chk)


@pytest.mark.nanok
def test_sparse_primal_infeasible():
    P, q, A, l, u = _rand_sparse_qp(15, 20, 0.3, seed=3)
    A2 = sp.vstack([A, A.getrow(-1)], format="csr")
    l2 = np.concatenate([l, [u[-1] + 1.0]])
    u2 = np.concatenate([u, [u[-1] + 2.0]])
    res = solve_sparse(P, q, A2, l2, u2, verbose=False)
    assert int(res.status_val[0]) in (
        con.OSQP_PRIMAL_INFEASIBLE,
        con.OSQP_PRIMAL_INFEASIBLE_INACCURATE,
    )
    chk = primal_infeasibility_check(
        A2, l2, u2, np.asarray(res.prim_inf_cert[0])
    )
    assert chk["ok"], chk


@pytest.mark.slow
def test_sparse_large_n():
    """n = 20_000 banded QP solves matrix-free on CPU — impossible for
    the dense layout (O(n^2) = 3.2 GB/instance)."""
    n = 20_000
    rng = np.random.default_rng(0)
    main = 2.0 + np.abs(rng.standard_normal(n))
    off = 0.5 * rng.standard_normal(n - 1)
    P = sp.diags([off, main, off], [-1, 0, 1], format="csc")
    A = sp.eye(n, format="csc")
    q = rng.standard_normal(n)
    l = np.full(n, -1.0)
    u = np.full(n, 1.0)
    res = solve_sparse(P, q, A, l, u, verbose=False)
    assert int(res.status_val[0]) == con.OSQP_SOLVED
    chk = kkt_check(P, q, A, l, u, res.x[0], res.y[0])
    assert chk["ok"], chk


class TestSparseSolver:
    """Stateful Solver-style API over the sparse path (large.SparseSolver)."""

    def _problem(self, n=80, seed=0):
        rng = np.random.default_rng(seed)
        P = sp.diags(np.abs(rng.standard_normal(n)) + 1.0).tocsc()
        A = sp.vstack(
            [sp.eye(n), sp.diags([1.0] * (n - 1), 1).tocsr()[: n - 1]]
        ).tocsc()
        q = rng.standard_normal(n)
        m = A.shape[0]
        return P, q, A, -np.ones(m), np.ones(m)

    def test_solve_matches_solve_sparse(self):
        P, q, A, l, u = self._problem()
        s = osqp_tpu.SparseSolver(P=P, q=q, A=A, l=l, u=u, verbose=False)
        r = s.solve()
        assert r.info.status == "solved"
        ref = osqp_tpu.solve_sparse(P, q, A, l, u, verbose=False)
        np.testing.assert_allclose(r.x, np.asarray(ref.x)[0], atol=1e-12)
        assert r.info.iter == int(np.asarray(ref.iter)[0])

    def test_warm_start_resolve_one_interval(self):
        # Re-solving at the optimum terminates at the first check
        # (test_basic_qp.h:893 behaviour).
        P, q, A, l, u = self._problem()
        s = osqp_tpu.SparseSolver(P=P, q=q, A=A, l=l, u=u, verbose=False,
                                  check_termination=1)
        r1 = s.solve()
        r2 = s.solve()
        assert r2.info.iter == 1
        # one extra iteration from a just-converged point moves x within
        # the eps=1e-3 tolerance band
        np.testing.assert_allclose(r2.x, r1.x, atol=5e-3)

    def test_updates(self):
        P, q, A, l, u = self._problem()
        s = osqp_tpu.SparseSolver(P=P, q=q, A=A, l=l, u=u, verbose=False)
        s.solve()
        # q update changes the solution
        s.update_lin_cost(-q)
        r = s.solve()
        assert r.info.status == "solved"
        # P value update via indexed semantics
        s.update_P(Px=s._Pu.data * 2.0)
        r2 = s.solve()
        assert r2.info.status == "solved"
        # bounds validation
        with pytest.raises(osqp_tpu.OSQPError):
            s.update_bounds(l=np.ones(s.m), u=-np.ones(s.m))
        # equivalence with a fresh solve on the updated data
        fresh = osqp_tpu.solve_sparse(
            sp.csc_matrix(sp.triu(s._Pu)), -q, A, l, u, verbose=False
        )
        np.testing.assert_allclose(
            r2.x, np.asarray(fresh.x)[0], atol=1e-4
        )

    def test_update_A_then_solve(self):
        P, q, A, l, u = self._problem()
        s = osqp_tpu.SparseSolver(P=P, q=q, A=A, l=l, u=u, verbose=False)
        s.solve()
        s.update_A(Ax=s._Ac.data * 0.5)
        r = s.solve()
        assert r.info.status == "solved"
        A2 = A * 0.5
        assert np.all(A2 @ r.x <= u + 1e-3)

    def test_not_setup_errors(self):
        s = osqp_tpu.SparseSolver()
        with pytest.raises(osqp_tpu.OSQPError):
            s.solve()

    def test_settings_setters(self):
        P, q, A, l, u = self._problem(n=20)
        s = osqp_tpu.SparseSolver(P=P, q=q, A=A, l=l, u=u, verbose=False)
        s.update_eps_abs(1e-4)
        s.update_eps_rel(1e-4)
        s.update_max_iter(900)
        assert s.settings.eps_abs == 1e-4 and s.settings.max_iter == 900
        with pytest.raises(osqp_tpu.OSQPError):
            s.update_eps_abs(-1.0)
        with pytest.raises(osqp_tpu.OSQPError):
            s.update_rho(0.0)
        assert s.solve().info.status == "solved"


def test_sparse_polish_matches_dense_polish():
    """polish=True on the sparse path (matrix-free reduced-KKT CG,
    polish.py:_make_kkt_solver ELL branch) must reach the same refined
    solution as the dense polish on a problem both paths can solve
    (src/polish.c:212-350 parity)."""
    P, q, A, l, u = _rand_sparse_qp(40, 60, 0.2, seed=11)
    r_dense = osqp_tpu.Solver(
        P=P, q=q, A=A, l=l, u=u, polish=True, verbose=False
    ).solve()
    assert r_dense.info.status_polish == 1
    r_sparse = solve_sparse(P, q, A, l, u, polish=True, verbose=False)
    assert int(r_sparse.status_polish[0]) == 1
    np.testing.assert_allclose(
        np.asarray(r_sparse.x)[0], r_dense.x, atol=TESTS_TOL
    )
    np.testing.assert_allclose(
        np.asarray(r_sparse.y)[0], r_dense.y, atol=TESTS_TOL
    )
    # Polished residuals beat the unpolished ADMM solve's.
    r_plain = solve_sparse(P, q, A, l, u, polish=False, verbose=False)
    assert float(r_sparse.pri_res[0]) <= float(r_plain.pri_res[0]) + 1e-15
    assert float(r_sparse.dua_res[0]) <= float(r_plain.dua_res[0])


def test_sparse_polish_banded_medium():
    """A banded n=2000 problem (LISWET-class structure): sparse polish
    succeeds and tightens residuals by orders of magnitude."""
    n = 2000
    main = 2.0 * np.ones(n)
    off = -1.0 * np.ones(n - 1)
    P = sp.diags([off, main, off], [-1, 0, 1], format="csc") + 0.1 * sp.eye(n)
    A = sp.diags([np.ones(n - 1), -2 * np.ones(n - 1)],
                 [0, 1], shape=(n - 1, n), format="csc")
    rng = np.random.default_rng(5)
    q = rng.standard_normal(n)
    x0 = rng.standard_normal(n)
    Ax = np.asarray(A @ x0).ravel()
    s = np.abs(rng.standard_normal(n - 1)) + 0.1
    l, u = Ax - s, Ax + s
    res = solve_sparse(P, q, A, l, u, polish=True, verbose=False)
    assert int(res.status_val[0]) == con.OSQP_SOLVED
    assert int(res.status_polish[0]) == 1
    chk = kkt_check(
        P, q, A, l, u, np.asarray(res.x)[0], np.asarray(res.y)[0],
        eps_abs=1e-6, eps_rel=1e-6,
    )
    assert chk["ok"], chk


class TestSparseSolverDeviceResident:
    """Round-3 redesign: ELL operands/scaling/iterates stay on device
    across solves; updates scatter values through the slot maps
    (osqp.c:765-1279 parametric-loop semantics)."""

    def _problem(self, n=60, seed=3):
        rng = np.random.default_rng(seed)
        P = sp.diags(np.abs(rng.standard_normal(n)) + 1.0).tocsc()
        A = sp.vstack([sp.eye(n),
                       sp.diags([1.0] * (n - 1), 1).tocsr()[: n - 1]]).tocsc()
        q = rng.standard_normal(n)
        m = A.shape[0]
        return P, q, A, -np.ones(m), np.ones(m)

    def test_pattern_built_once(self, monkeypatch):
        """update_P / update_A / update_bounds must NOT redo host
        pattern work (the round-2 critique: every solve rebuilt ELL
        operands from scipy)."""
        import osqp_tpu.sparse_ops as so

        P, q, A, l, u = self._problem()
        s = osqp_tpu.SparseSolver(P=P, q=q, A=A, l=l, u=u, verbose=False)
        s.solve()

        def boom(*a, **k):
            raise AssertionError("host ELL pattern rebuild after setup")

        monkeypatch.setattr(so, "ell_pattern_from_scipy", boom)
        monkeypatch.setattr(so, "ell_value_maps", boom)
        monkeypatch.setattr(so, "ell_from_scipy", boom)
        s.update_P(Px=s._Pu.data * 1.5)
        s.update_lin_cost(-q)
        s.update_bounds(l=l - 0.5, u=u + 0.5)
        r = s.solve()
        assert r.info.status == "solved"

    def test_update_equivalence_vs_fresh(self):
        """K updates x re-solve lands exactly where a fresh setup on the
        final data lands (same scaled pipeline, reference
        update-then-solve equivalence)."""
        P, q, A, l, u = self._problem()
        s = osqp_tpu.SparseSolver(P=P, q=q, A=A, l=l, u=u, verbose=False,
                                  warm_start=False)
        s.solve()
        for k in range(3):
            # q first, P second: update_P rescales everything from
            # scratch (osqp.c:1066), so the final scaled problem is
            # identical to a fresh setup on the final data; an
            # update_lin_cost AFTER the last update_P would instead be
            # scaled by the existing Ruiz factors (osqp.c:765-795) —
            # reference semantics, but not fresh-setup-identical.
            s.update_lin_cost(q * (0.5 + k))
            s.update_P(Px=s._Pu.data * 1.1)
            s.solve()
        fresh = osqp_tpu.SparseSolver(
            P=sp.csc_matrix(sp.triu(s._Pu)), q=q * 2.5, A=A, l=l, u=u,
            verbose=False, warm_start=False,
        )
        rf = fresh.solve()
        rs = s.solve()
        assert rs.info.iter == rf.info.iter  # identical trajectory
        np.testing.assert_allclose(rs.x, rf.x, atol=1e-12)

    def test_polish_on_sparse_solver(self):
        P, q, A, l, u = self._problem()
        s = osqp_tpu.SparseSolver(P=P, q=q, A=A, l=l, u=u, verbose=False,
                                  polish=True)
        r = s.solve()
        assert r.info.status == "solved"
        assert r.info.status_polish == 1
        # polish wrote back into the device iterates: warm re-solve
        # terminates at the first check (polish.c:323-327 "NB: z needed
        # for warm starting")
        s.update_check_termination(1)
        assert s.solve().info.iter == 1

    def test_indexed_updates_device_path(self):
        """Indexed nnz updates (osqp.c:1031-1062) flow through the
        gather maps to the device operand."""
        P, q, A, l, u = self._problem(n=20)
        s = osqp_tpu.SparseSolver(P=P, q=q, A=A, l=l, u=u, verbose=False,
                                  warm_start=False)
        s.solve()
        idx = np.array([0, 3, 7])
        s.update_P(Px=np.full(3, 9.0), Px_idx=idx)
        assert np.allclose(s._Pu.data[idx], 9.0)
        r = s.solve()
        assert r.info.status == "solved"
        fresh = osqp_tpu.solve_sparse(
            sp.csc_matrix(sp.triu(s._Pu)), q, A, l, u, verbose=False
        )
        np.testing.assert_allclose(r.x, np.asarray(fresh.x)[0], atol=1e-10)

    def test_export_supported(self):
        """SparseSolver.export is the pattern-baked AOT artifact since
        round 3 (tests/test_export.py::test_sparse_pattern_export_roundtrip
        covers the round trip); here just check it produces bytes."""
        P, q, A, l, u = self._problem(n=10)
        s = osqp_tpu.SparseSolver(P=P, q=q, A=A, l=l, u=u, verbose=False)
        blob = s.export()
        assert isinstance(blob, bytes) and len(blob) > 0


def test_sparse_first_dispatch_inner_budget(monkeypatch):
    """The FIRST dispatch of a bounded-dispatch solve is budgeted in
    INNER iterations: with a deep cg_max_iter one outer iteration hides
    a proportionally deep inner loop, and an unbudgeted 100-outer first
    dispatch runs minutes of device work on DTOC3 (n=14999, cg cap
    1500) with no chance to poll.  probe =
    _PROBE_INNER_BUDGET // cg_depth, floored at one outer iteration."""
    import osqp_tpu.batch as batch_mod

    seen = []
    real = batch_mod._start_c

    def spy(cfg_, *args):
        seen.append((int(getattr(cfg_, "cg_max_iter", 0)), int(args[-1])))
        return real(cfg_, *args)

    monkeypatch.setattr(batch_mod, "_start_c", spy)
    P, q, A, l, u = _rand_sparse_qp(30, 40, 0.2, seed=22)
    # deep explicit cap -> 15000 // 1500 = 10 outer iterations
    solve_sparse(P, q, A, l, u, verbose=False, max_iter=50000,
                 eps_abs=1e-6, eps_rel=1e-6, cg_max_iter=1500)
    # unbounded cap -> depth n+m; still >= 1 outer iteration
    solve_sparse(P, q, A, l, u, verbose=False, max_iter=50000,
                 eps_abs=1e-6, eps_rel=1e-6)
    (cg1, end1), (cg2, end2) = seen
    assert cg1 == 1500 and end1 == batch_mod._PROBE_INNER_BUDGET // 1500
    assert cg2 == 0 and 1 <= end2 <= batch_mod._PROBE_INNER_BUDGET


def test_sparse_dispatch_cap(monkeypatch):
    """solve_sparse bounds every device dispatch (max_fused_iters): a
    single fused program can span tens of minutes on long CG solves,
    so the sparse path polls at a coarse cadence even with no time
    limit."""
    import osqp_tpu.batch as batch_mod

    seen = []
    real = batch_mod._start_c

    def spy(cfg_, *args):
        seen.append(int(args[-1]))
        return real(cfg_, *args)

    monkeypatch.setattr(batch_mod, "_start_c", spy)
    P, q, A, l, u = _rand_sparse_qp(30, 40, 0.2, seed=21)
    solve_sparse(P, q, A, l, u, verbose=False, max_iter=50000,
                 eps_abs=0.0, eps_rel=1e-14)
    assert seen and seen[0] <= 2000


def test_explicit_zero_placeholder_update():
    """A stored explicit zero in triu(P) is the reference's documented
    placeholder workflow (store the slot, write it later via update_P,
    osqp.c:1031-1062).  The ELL pattern and the value maps must both
    keep it; deriving the pattern from the value matrix dropped it
    (scipy binop cancellation) and every later gather mis-paired
    (round-3 review finding, confirmed silent wrong answer)."""
    import osqp_tpu.sparse_ops as so

    P = sp.csc_matrix(
        (np.array([1.0, 0.0, 1.0, 1.0]),
         (np.array([0, 0, 1, 2]), np.array([0, 1, 1, 2]))),
        shape=(3, 3),
    )  # explicit zero at (0, 1)
    q = np.array([1.0, -1.0, 0.5])
    A = sp.eye(3, format="csc")
    l = -np.ones(3)
    u = np.ones(3)

    # pattern and maps agree slot-for-slot
    idx, t_idx, shape = so.ell_pattern_from_scipy(P, sym_from_triu=True)
    src, t_src = so.ell_value_maps(P, sym_from_triu=True)
    assert src.shape == idx.shape and t_src.shape == t_idx.shape

    s = osqp_tpu.SparseSolver(P=P, q=q, A=A, l=l, u=u, verbose=False)
    s.update_P(Px=np.array([1.0, 0.4, 1.0, 1.0]))  # write the placeholder
    r = s.solve()
    assert r.info.status == "solved"

    P2 = sp.csc_matrix(np.array([[1.0, 0.4, 0.0],
                                 [0.4, 1.0, 0.0],
                                 [0.0, 0.0, 1.0]]))
    ref = osqp_tpu.solve_sparse(P2, q, A, l, u, verbose=False)
    np.testing.assert_allclose(
        np.asarray(r.x), np.asarray(ref.x)[0], atol=1e-6
    )
