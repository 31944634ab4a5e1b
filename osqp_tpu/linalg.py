"""Batched dense linear-algebra primitives.

The reference implements ~25 CSC/vector kernels in C (src/lin_alg.c:7-413).
Over dense batched arrays almost all of them collapse to fused jnp
expressions; only the handful used across modules live here.  Everything
takes a leading batch axis B.

Matrix products are batched matvecs expressed as einsum at
``precision="highest"``.
"""

from __future__ import annotations

from functools import wraps

import jax
import jax.numpy as jnp


def with_high_precision(fn):
    """Trace ``fn`` under float32 matmul precision.

    On GPUs with tensor cores XLA may run float32 dots in TF32 (a 10-bit
    mantissa, ~1e-3 relative error) by default; a QP solver converging
    to eps = 1e-3..1e-5 needs true f32 accumulation.  Wrapping the traced
    body also covers the dots *inside* XLA's cholesky / triangular_solve
    / LU expansions.
    """

    @wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


def norm_inf(v: jax.Array) -> jax.Array:
    """Batched infinity norm over the last axis (lin_alg.c:32-43).

    Zero-length axis returns 0 (the reference loop never executes for m=0).
    """
    if v.shape[-1] == 0:
        return jnp.zeros(v.shape[:-1], v.dtype)
    return jnp.max(jnp.abs(v), axis=-1)


def scaled_norm_inf(S: jax.Array, v: jax.Array) -> jax.Array:
    """||diag(S) v||_inf (lin_alg.c:19-30)."""
    if v.shape[-1] == 0:
        return jnp.zeros(v.shape[:-1], v.dtype)
    return jnp.max(jnp.abs(S * v), axis=-1)


def _is_ell(A) -> bool:
    from .sparse_ops import ELLMatrix

    return isinstance(A, ELLMatrix)


def mat_vec(A, x: jax.Array) -> jax.Array:
    """Batched A @ x:  (B, m, n) x (B, n) -> (B, m)  (lin_alg.c:241-271).

    Dense operands lower to a batched matmul; ELL sparse operands
    (osqp_tpu.sparse_ops) to a gather + rowwise reduce.
    """
    if _is_ell(A):
        from .sparse_ops import ell_matvec

        return ell_matvec(A, x)
    return jnp.einsum("bmn,bn->bm", A, x, preferred_element_type=x.dtype, precision="highest")


def mat_tvec(A, y: jax.Array) -> jax.Array:
    """Batched A^T @ y:  (B, m, n) x (B, m) -> (B, n)  (lin_alg.c:273-323)."""
    if _is_ell(A):
        from .sparse_ops import ell_tmatvec

        return ell_tmatvec(A, y)
    return jnp.einsum("bmn,bm->bn", A, y, preferred_element_type=y.dtype, precision="highest")


def quad_form(P, x: jax.Array) -> jax.Array:
    """0.5 x' P x with symmetric P (lin_alg.c:387-413)."""
    if _is_ell(P):
        return 0.5 * vec_dot(x, mat_vec(P, x))
    return 0.5 * jnp.einsum(
        "bn,bnk,bk->b", x, P, x, preferred_element_type=x.dtype, precision="highest"
    )


def vec_dot(a: jax.Array, b: jax.Array) -> jax.Array:
    """Batched inner product over last axis (lin_alg.c:143-152)."""
    if a.shape[-1] == 0:
        return jnp.zeros(a.shape[:-1], a.dtype)
    return jnp.sum(a * b, axis=-1)


def spd_inverse(M: jax.Array) -> jax.Array:
    """Explicit inverse of batched SPD matrices (B, n, n).

    Batched Cholesky + one wide triangular solve (cuSOLVER ``potrf`` and
    cuBLAS ``trsm`` on a GPU), then M^-1 = T' T with T = L^-1.  A
    symmetric Jacobi equilibration (unit diagonal; exact, since
    inv(M) = D inv(DMD) D) keeps the explicit-inverse product well
    scaled.  Instances that are not positive definite come back as NaN,
    the convexity signal callers rely on.
    """
    n = M.shape[-1]
    if n == 0:
        return M
    dg = jnp.diagonal(M, axis1=-2, axis2=-1)
    d = jnp.where(dg > 0, 1.0 / jnp.sqrt(jnp.where(dg > 0, dg, 1.0)),
                  jnp.asarray(jnp.nan, M.dtype))
    Ms = M * d[..., :, None] * d[..., None, :]
    L = jnp.linalg.cholesky(Ms)
    eye = jnp.broadcast_to(jnp.eye(n, dtype=M.dtype), M.shape)
    T = jax.lax.linalg.triangular_solve(L, eye, left_side=True, lower=True)
    X = jnp.einsum(
        "...kn,...km->...nm", T, T, preferred_element_type=M.dtype,
        precision="highest",
    )
    return X * d[..., :, None] * d[..., None, :]


def bwhere(mask: jax.Array, new, old):
    """Per-instance select: mask (B,) applied to (B, ...) pytrees."""

    def sel(n, o):
        m = mask.reshape(mask.shape + (1,) * (n.ndim - mask.ndim))
        return jnp.where(m, n, o)

    return jax.tree_util.tree_map(sel, new, old)
