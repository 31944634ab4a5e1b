"""Block-tridiagonal Schur-complement backend (MPC / optimal control).

For QPs with stage-wise structure — model-predictive control and other
optimal-control problems where the decision vector is ordered by stage
``v = (x_0, u_0, x_1, u_1, ..., x_N)`` — the reduced matrix

    M = P + sigma I + A' diag(rho) A

is *block tridiagonal* with block size ``b = nx + nu``: stage costs make
P block diagonal, and dynamics rows ``x_{k+1} = A_d x_k + B_d u_k``
couple only adjacent stage blocks.  The reference handles such structure
implicitly through sparse LDL' with AMD ordering
(lin_sys/direct/qdldl/qdldl_interface.c:177-323); on batched dense
arrays the idiomatic
equivalent is a *blocked Cholesky (block Thomas / discrete-Riccati-style)
recursion* over the stages:

    C_0 = chol(D_0)
    G_i = O_i C_{i-1}^{-T}            (i = 1..N-1)
    C_i = chol(D_i - G_i G_i')

computed with one ``lax.scan`` over stages, each step a *batched* b x b
Cholesky over the instance axis.  Cost is O(N b^3) per instance instead
of the dense backends' O((N b)^3) — for long horizons this is the
asymptotically right factorization, and every step is a dense batched
matmul.

The per-iteration solve is a forward scan (``y_i = C_i^{-1} (b_i - G_i
y_{i-1})``) and a reverse scan (``x_i = C_i^{-T} (y_i - G_{i+1}' x_{i+1})``),
then ``z~ = A x~`` exactly as in the other Schur backends
(split-solution equivalence with qdldl_interface.c:359-370).

Requirements: ``block_size`` must divide n, and M must truly have
block-tridiagonal structure (entries outside the band are *ignored*).
Use :func:`check_block_structure` host-side to validate a problem class
once; it returns the largest out-of-band magnitude.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..linalg import mat_tvec, mat_vec
from .dense_chol import form_schur


def _extract_blocks(M, b):
    """Diagonal blocks D (Nb, B, b, b) and sub-diagonal blocks O
    (Nb-1, B, b, b) with O_i = M[block i, block i-1]."""
    B, n, _ = M.shape
    Nb = n // b
    # (B, Nb, b, Nb, b) -> (Nb, Nb, B, b, b)
    Mb = M.reshape(B, Nb, b, Nb, b).transpose(1, 3, 0, 2, 4)
    idx = jnp.arange(Nb)
    D = Mb[idx, idx]  # (Nb, B, b, b)
    O = Mb[idx[1:], idx[:-1]] if Nb > 1 else jnp.zeros((0, B, b, b), M.dtype)
    return D, O


def check_block_structure(P, A, sigma, rho_vec, block_size):
    """Largest |entry| of M outside the block-tridiagonal band (host-side
    validation helper; 0.0 means the backend is exact for this problem)."""
    M = form_schur(
        jnp.asarray(P), jnp.asarray(A), jnp.asarray(sigma), jnp.asarray(rho_vec)
    )
    n = M.shape[-1]
    b = int(block_size)
    if b <= 0 or n % b:
        raise ValueError(f"block_size {b} must divide n = {n}")
    blk = jnp.arange(n) // b
    inband = jnp.abs(blk[:, None] - blk[None, :]) <= 1
    out = jnp.where(inband, 0.0, jnp.abs(M))
    return float(jnp.max(out)) if n else 0.0


def validate_structure(P, A, block_size: int, tol: float = 0.0):
    """Setup-time guard: reject problems whose reduced matrix is NOT
    block tridiagonal (entries outside the band would be silently
    ignored by :func:`init` and produce wrong answers with SOLVED
    status).  Pattern check on |P| + |A|'|A| — conservative for every
    rho/sigma (no reliance on numeric cancellation, which a later rho
    update could undo).  Host-side, called from Solver/solve_batch/
    BatchedSolver setup when ``linsys_solver="block_tridiag"``; raises
    the reference's data-validation error (osqp.c:82, auxil.c:791)."""
    import numpy as np
    import scipy.sparse as sp

    from ..constants import ErrorCode, OSQPError

    b = int(block_size)

    if sp.issparse(P) or sp.issparse(A):
        Pp = abs(sp.csc_matrix(P))
        Pp = Pp + Pp.T  # accept triu or full storage
        Ap = abs(sp.csc_matrix(A))
        S = (Pp + Ap.T @ Ap).tocoo()
        n = S.shape[0]
        if b <= 0 or (n and n % b):
            raise OSQPError(
                ErrorCode.DATA_VALIDATION_ERROR,
                f"block_size {b} must divide n = {n}",
            )
        off = np.abs(S.row // b - S.col // b) > 1
        worst = float(np.max(S.data[off])) if off.any() else 0.0
    else:
        P = np.abs(np.asarray(P))
        A = np.abs(np.asarray(A))
        if P.ndim == 3:  # union pattern over the batch
            P = P.max(axis=0)
        if A.ndim == 3:
            A = A.max(axis=0)
        n = P.shape[-1]
        if b <= 0 or (n and n % b):
            raise OSQPError(
                ErrorCode.DATA_VALIDATION_ERROR,
                f"block_size {b} must divide n = {n}",
            )
        S = P + A.T @ A
        blk = np.arange(n) // b
        off = np.abs(blk[:, None] - blk[None, :]) > 1
        worst = float(np.max(np.where(off, S, 0.0))) if n else 0.0

    if worst > tol:
        raise OSQPError(
            ErrorCode.DATA_VALIDATION_ERROR,
            "block_tridiag: P + A'A has entries outside the "
            f"block-tridiagonal band (block_size={b}, worst out-of-band "
            f"magnitude {worst:.3e}); this backend would silently drop "
            "them — use dense_inv/dense_chol/cg, or fix block_size",
        )


def init(P, A, sigma, rho_vec, block_size: int = 0, **_):
    n = P.shape[-1]
    b = int(block_size)
    if b <= 0 or (n and n % b):
        raise ValueError(
            f"block_tridiag backend needs block_size dividing n (got "
            f"block_size={b}, n={n}); set Settings(block_size=...)"
        )
    M = form_schur(P, A, sigma, rho_vec)
    D, O = _extract_blocks(M, b)  # stage-leading

    C0 = jnp.linalg.cholesky(D[0])

    def step(C_prev, inp):
        D_i, O_i = inp
        # G_i solves  G_i @ C_{i-1}' = O_i
        G = jax.lax.linalg.triangular_solve(
            C_prev, O_i, left_side=False, lower=True, transpose_a=True
        )
        S = D_i - jnp.einsum(
            "bij,bkj->bik", G, G, preferred_element_type=G.dtype,
            precision="highest",
        )
        C = jnp.linalg.cholesky(S)
        return C, (C, G)

    if D.shape[0] > 1:
        _, (Cs, Gs) = jax.lax.scan(step, C0, (D[1:], O))
        C = jnp.concatenate([C0[None], Cs], axis=0)
    else:
        C = C0[None]
        Gs = jnp.zeros_like(O)
    # Store batch-leading so rho-adaptation's per-instance factor select
    # (admm._apply_rho_adaptation) masks the right axis.
    return {
        "C": jnp.swapaxes(C, 0, 1),  # (B, Nb, b, b)
        "G": jnp.swapaxes(Gs, 0, 1),  # (B, Nb-1, b, b)
    }


def _tsolve(C, v, transpose):
    """Batched C x = v (or C' x = v) with b-vector rhs."""
    return jax.lax.linalg.triangular_solve(
        C, v[..., None], left_side=True, lower=True, transpose_a=transpose
    )[..., 0]


def solve(factor, A, rho_vec, rhs_x, rhs_z, x0=None):
    C = jnp.swapaxes(factor["C"], 0, 1)  # (Nb, B, b, b)
    G = jnp.swapaxes(factor["G"], 0, 1)  # (Nb-1, B, b, b)
    Nb, B, b, _ = C.shape

    t = rhs_x
    if A.shape[-2]:
        t = t + mat_tvec(A, rho_vec * rhs_z)
    r = t.reshape(B, Nb, b).transpose(1, 0, 2)  # (Nb, B, b)

    # Forward block substitution
    y0 = _tsolve(C[0], r[0], transpose=False)

    def fwd(y_prev, inp):
        C_i, G_i, r_i = inp
        y = _tsolve(
            C_i,
            r_i - jnp.einsum("bij,bj->bi", G_i, y_prev, precision="highest"),
            transpose=False,
        )
        return y, y

    if Nb > 1:
        _, ys = jax.lax.scan(fwd, y0, (C[1:], G, r[1:]))
        y = jnp.concatenate([y0[None], ys], axis=0)
    else:
        y = y0[None]

    # Backward block substitution
    xN = _tsolve(C[-1], y[-1], transpose=True)

    def bwd(x_next, inp):
        C_i, G_next, y_i = inp
        x = _tsolve(
            C_i,
            y_i - jnp.einsum("bji,bj->bi", G_next, x_next, precision="highest"),
            transpose=True,
        )
        return x, x

    if Nb > 1:
        _, xs = jax.lax.scan(bwd, xN, (C[:-1], G, y[:-1]), reverse=True)
        x_st = jnp.concatenate([xs, xN[None]], axis=0)
    else:
        x_st = xN[None]

    x_t = x_st.transpose(1, 0, 2).reshape(B, Nb * b)
    z_t = mat_vec(A, x_t)
    return x_t, z_t
