"""Segmented-solve path: verbose printing, time_limit, and exact parity
with the whole-loop path (same iteration counts / statuses / solutions).
References: osqp.c:374-407 (time limit + SIGINT), util.c:152-175 rows,
test_basic_qp.h time_limit section."""

import numpy as np
import scipy.sparse as sp

import osqp_tpu
from osqp_tpu import constants as con


def problem():
    P = sp.triu([[4.0, 1.0], [1.0, 2.0]], format="csc")
    q = np.ones(2)
    A = sp.csc_matrix(np.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0], [0.0, 1.0]]))
    l = np.array([1.0, 0.0, 0.0, -np.inf])
    u = np.array([1.0, 0.7, 0.7, np.inf])
    return dict(P=P, q=q, A=A, l=l, u=u)


def test_segmented_equals_whole_loop(capsys):
    """verbose=True forces the segmented path; results must be identical
    to the fully-jitted path (global iteration counter keeps the check /
    rho-adaptation schedule aligned)."""
    s1 = osqp_tpu.Solver(**problem(), verbose=False)
    r1 = s1.solve()
    s2 = osqp_tpu.Solver(**problem(), verbose=True)
    r2 = s2.solve()
    out = capsys.readouterr().out
    assert "iter" in out and "status:" in out  # header + footer printed
    assert r1.info.iter == r2.info.iter
    assert r1.info.status_val == r2.info.status_val
    np.testing.assert_allclose(r1.x, r2.x, atol=1e-12)
    np.testing.assert_allclose(r1.y, r2.y, atol=1e-12)


def test_time_limit_reached():
    """An effectively-zero time limit -> OSQP_TIME_LIMIT_REACHED
    (test_basic_qp.h time-limit section; osqp.c:398-406)."""
    s = osqp_tpu.Solver(
        **problem(),
        verbose=False,
        time_limit=1e-9,
        eps_abs=1e-12,
        eps_rel=1e-12,
        check_termination=1,
        adaptive_rho=False,
        max_iter=200000,
    )
    res = s.solve()
    assert res.info.status_val == con.OSQP_TIME_LIMIT_REACHED
    assert res.info.status == "run time limit reached"


def test_time_limit_generous_still_solves():
    s = osqp_tpu.Solver(**problem(), verbose=False, time_limit=100.0)
    res = s.solve()
    assert res.info.status_val == con.OSQP_SOLVED


def test_batch_happy_path_single_dispatch(monkeypatch):
    """With no time limit the batched driver fuses the ENTIRE iteration
    range into the first dispatch: the continuation machinery
    (_segment_c, _finish_c) must never run, and no host poll of the
    active mask happens (each poll is a device sync and a host round
    trip on real hardware)."""
    import osqp_tpu.batch as batch_mod

    d = problem()
    Pb = np.asarray(d["P"].todense())
    Pb = (Pb + Pb.T - np.diag(np.diag(Pb)))[None]
    Ab = np.asarray(d["A"].todense())[None]

    def fail(*a, **k):
        raise AssertionError("continuation path used on the happy path")

    monkeypatch.setattr(batch_mod, "_segment_c", fail)
    monkeypatch.setattr(batch_mod, "_finish_c", fail)
    res = batch_mod.solve_batch(
        Pb, d["q"][None], Ab, d["l"][None], d["u"][None], verbose=False
    )
    assert int(res.status_val[0]) == con.OSQP_SOLVED


def test_batch_time_limit_polls_early(monkeypatch):
    """With a time limit the fused first segment shrinks to ONE polling
    quantum so the clock is checked early (reference polls every
    iteration, osqp.c:387-407) — not after 4 segments."""
    import osqp_tpu.batch as batch_mod

    d = problem()
    Pb = np.asarray(d["P"].todense())
    Pb = (Pb + Pb.T - np.diag(np.diag(Pb)))[None]
    Ab = np.asarray(d["A"].todense())[None]

    seen = []
    real = batch_mod._start_c

    def spy(cfg, *args):
        seen.append(int(args[-1]))  # end1 (the fused first segment end)
        return real(cfg, *args)

    monkeypatch.setattr(batch_mod, "_start_c", spy)
    batch_mod.solve_batch(
        Pb, d["q"][None], Ab, d["l"][None], d["u"][None],
        verbose=False, time_limit=1e6, max_iter=4000,
        eps_abs=0.0, eps_rel=1e-18,
    )
    assert seen and seen[0] <= 100  # one quantum, not 400/max_iter
