"""Dense Schur-complement Cholesky backend.

Replaces AMD + QDLDL sparse LDL' (lin_sys/direct/qdldl/) with a batched
dense Cholesky of the n x n reduced matrix

    M = P + sigma I + A' diag(rho) A

Dense storage has no fill-in and no ordering problem; a batched dense
factorization of M is one cuSOLVER call on a GPU and the per-iteration
work is two batched triangular solves + two batched matvecs.

Equivalence with the reference KKT solve (qdldl_interface.c:350-376):
eliminating nu from

    [P + sigma I   A'          ] [x~]   [rhs_x]
    [A            -diag(1/rho) ] [nu] = [rhs_z]

gives  M x~ = rhs_x + A' (rho * rhs_z)  and  nu = rho * (A x~ - rhs_z),
so the reference's recovered  z~ = rhs_z + nu / rho  equals  A x~ exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..linalg import mat_tvec, mat_vec


def form_schur(P, A, sigma, rho_vec):
    """M = P + sigma I + A' diag(rho) A, batched (B, n, n)."""
    n = P.shape[-1]
    eye = jnp.eye(n, dtype=P.dtype)
    M = P + sigma * eye
    if A.shape[-2]:
        M = M + jnp.einsum(
            "bmn,bm,bmk->bnk",
            A,
            rho_vec,
            A,
            preferred_element_type=P.dtype,
            precision="highest",
        )
    return M


def init(P, A, sigma, rho_vec, **_):
    """Factorize. Returns the batched lower Cholesky factor.

    A non-PD M yields NaNs in the factor; like the reference's D-sign
    count (qdldl_interface.c:93-99) this signals non-convexity, surfaced
    by the setup-time convexity check or the runtime divergence check.
    """
    M = form_schur(P, A, sigma, rho_vec)
    return {"L": jnp.linalg.cholesky(M)}


def _cho_solve(L, b):
    """Solve (L L') x = b, batched; b is (B, n)."""
    y = jax.lax.linalg.triangular_solve(
        L, b[..., None], left_side=True, lower=True, transpose_a=False
    )
    x = jax.lax.linalg.triangular_solve(
        L, y, left_side=True, lower=True, transpose_a=True
    )
    return x[..., 0]


def solve(factor, A, rho_vec, rhs_x, rhs_z, x0=None):
    """One KKT solve: returns (x_tilde, z_tilde = A x_tilde)."""
    b = rhs_x
    if A.shape[-2]:
        b = b + mat_tvec(A, rho_vec * rhs_z)
    x_t = _cho_solve(factor["L"], b)
    z_t = mat_vec(A, x_t)
    return x_t, z_t
