"""Sanitizer-grade checks — the valgrind/leak-canary analogue (SURVEY §5:
reference CI runs valgrind memcheck + a custom_memory allocation counter,
custom_memory/custom_memory.c:5-8).  Under JAX the failure classes are
tracer leaks (host references keeping device buffers alive past a trace)
and NaNs escaping jitted computations (covered suite-wide by
JAX_SANITIZE=1 / jax_debug_nans; see conftest.py)."""

import jax
import numpy as np

from osqp_tpu.solver import Solver


def _problem():
    P = np.array([[4.0, 1.0], [1.0, 2.0]])
    q = np.array([1.0, 1.0])
    A = np.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    l = np.array([1.0, 0.0, 0.0])
    u = np.array([1.0, 0.7, 0.7])
    return P, q, A, l, u


def test_no_tracer_leaks():
    """The full setup+solve pipeline leaks no tracers out of its traces
    (jax_check_tracer_leaks)."""
    with jax.checking_leaks():
        s = Solver(*_problem(), verbose=False, polish=True)
        res = s.solve()
    assert res.info.status == "solved"


def test_no_nans_on_solved_path():
    """A solvable QP produces no NaNs in any jitted output
    (jax_debug_nans aborts otherwise) — the default mode of the
    sanitize CI leg, exercised inline here so the check also runs in
    the plain suite."""
    jax.config.update("jax_debug_nans", True)
    try:
        s = Solver(*_problem(), verbose=False, polish=True)
        res = s.solve()
        assert res.info.status == "solved"
    finally:
        jax.config.update("jax_debug_nans", False)
