"""Host-side problem ingestion: scipy/numpy -> validated dense arrays.

The reference consumes upper-triangular CSC for P and CSC for A
(include/types.h:21-29, src/cs.c) and validates in validate_data
(auxil.c:791-879).  On the device the layout is dense batched arrays;
CSC survives only as the *ingestion* format so that the value-indexed
update entry points (osqp_update_P / osqp_update_A, osqp.c:1012-1279)
keep their exact nnz-index semantics.
"""

from __future__ import annotations

import numpy as np

try:  # scipy is available in the target environment; degrade gracefully
    import scipy.sparse as sp
except ImportError:  # pragma: no cover
    sp = None

from .constants import ErrorCode, OSQPError, OSQP_INFTY


def _is_sparse(M) -> bool:
    return sp is not None and sp.issparse(M)


def to_upper_csc(P, n: int):
    """Return upper-triangular CSC of P (cs.c:238-318 csc_to_triu analogue).

    Dense input keeps the full upper-triangle pattern; sparse input keeps
    its own triu pattern.  Raises if P has entries strictly below the
    diagonal that break symmetry (the reference rejects non-triu P,
    auxil.c:846-855; the official python binding triu-s silently — we
    accept full symmetric input like the binding does).
    """
    if _is_sparse(P):
        Pc = P.tocsc().astype(np.float64)
        if Pc.shape != (n, n):
            raise OSQPError(
                ErrorCode.DATA_VALIDATION_ERROR,
                f"P does not have dimension n x n with n = {n}",
            )
        lower = sp.tril(Pc, -1)
        if lower.nnz:
            # accept symmetric input, reject asymmetric
            if (abs(lower - sp.triu(Pc, 1).T).max() if lower.nnz else 0) > 0:
                raise OSQPError(
                    ErrorCode.DATA_VALIDATION_ERROR, "P is not upper triangular"
                )
        Pu = sp.triu(Pc, format="csc")
        Pu.sort_indices()
        return Pu
    P = np.asarray(P, dtype=np.float64)
    if P.ndim != 2 or P.shape != (n, n):
        raise OSQPError(
            ErrorCode.DATA_VALIDATION_ERROR,
            f"P does not have dimension n x n with n = {n}",
        )
    if not np.allclose(P, P.T, rtol=0.0, atol=1e-12 * max(1.0, np.abs(P).max())):
        raise OSQPError(ErrorCode.DATA_VALIDATION_ERROR, "P is not symmetric")
    if sp is None:  # pragma: no cover
        raise OSQPError(ErrorCode.DATA_VALIDATION_ERROR, "scipy required")
    Pu = sp.triu(sp.csc_matrix(np.triu(P)), format="csc")
    Pu.sort_indices()
    return Pu


def triu_to_full(Pu) -> np.ndarray:
    """Dense symmetric P from upper-triangular CSC (the two-pass
    mat_vec/mat_tpose_vec trick of lin_alg.c:241-323 becomes one dense
    symmetric matrix on the device)."""
    Pd = np.asarray(Pu.todense(), dtype=np.float64)
    return Pd + np.triu(Pd, 1).T


def to_csc(A, m: int, n: int):
    if A is None:
        if sp is None:  # pragma: no cover
            raise OSQPError(ErrorCode.DATA_VALIDATION_ERROR, "scipy required")
        return sp.csc_matrix((m, n), dtype=np.float64)
    if _is_sparse(A):
        Ac = A.tocsc().astype(np.float64)
    else:
        Aa = np.asarray(A, dtype=np.float64)
        if Aa.ndim != 2:
            raise OSQPError(ErrorCode.DATA_VALIDATION_ERROR, "A must be 2-D")
        Ac = sp.csc_matrix(Aa)
    if Ac.shape != (m, n):
        raise OSQPError(
            ErrorCode.DATA_VALIDATION_ERROR,
            f"A does not have dimension {m} x {n}",
        )
    Ac.sort_indices()
    return Ac


def clamp_bounds(v: np.ndarray) -> np.ndarray:
    """Map +-inf (and anything beyond) to +-OSQP_INFTY = 1e30, the
    reference's finite infinity (constants.h:98-100) — required so that
    products like u * max(dy, 0) never produce inf * 0 = NaN."""
    return np.clip(np.asarray(v, dtype=np.float64), -OSQP_INFTY, OSQP_INFTY)


def validate_problem(P, q, A, l, u):
    """validate_data (auxil.c:791-879).  Returns canonical host data
    (Pu_csc, q, A_csc, l, u, n, m)."""
    if P is None:
        raise OSQPError(ErrorCode.DATA_VALIDATION_ERROR, "Missing matrix P")
    if q is None:
        raise OSQPError(ErrorCode.DATA_VALIDATION_ERROR, "Missing vector q")

    q = np.atleast_1d(np.asarray(q, dtype=np.float64))
    n = q.shape[0]
    if n <= 0:
        raise OSQPError(
            ErrorCode.DATA_VALIDATION_ERROR, "n must be positive"
        )
    Pu = to_upper_csc(P, n)

    if A is None and (l is not None or u is not None):
        raise OSQPError(ErrorCode.DATA_VALIDATION_ERROR, "Missing matrix A")
    if A is not None:
        m = A.shape[0]
    else:
        m = 0
    if m < 0:
        raise OSQPError(ErrorCode.DATA_VALIDATION_ERROR, "m must be nonnegative")
    Ac = to_csc(A, m, n)

    l = (
        clamp_bounds(l)
        if l is not None
        else np.full(m, -OSQP_INFTY, dtype=np.float64)
    )
    u = (
        clamp_bounds(u)
        if u is not None
        else np.full(m, OSQP_INFTY, dtype=np.float64)
    )
    if l.shape != (m,) or u.shape != (m,):
        raise OSQPError(ErrorCode.DATA_VALIDATION_ERROR, "bounds dimension mismatch")
    if np.any(l > u):
        j = int(np.argmax(l > u))
        raise OSQPError(
            ErrorCode.DATA_VALIDATION_ERROR,
            f"Lower bound at index {j} is greater than upper bound: "
            f"{l[j]:.4e} > {u[j]:.4e}",
        )
    return Pu, q, Ac, l, u, n, m
