"""Modified Ruiz equilibration, batched and jit-pure.

Reference: src/scaling.c:44-156.  Each sweep:

1. d_j = inf-norm of KKT column j over [P; A],  e_i = inf-norm of row i of A
2. limit to [MIN_SCALING -> 1, MAX_SCALING], take 1/sqrt
3. P <- dPd, A <- eAd, q <- dq;  accumulate D *= d, E *= e
4. cost scaling: c_t = 1 / limit(max(mean_j maxcol_j |P|, limit(||q||_inf)))
   P *= c_t, q *= c_t, c *= c_t

Finally l <- E l, u <- E u and inverses are stored.

The reference runs this matrix-free over CSC (scaling.c:28-42); here P is
dense symmetric so column and row norms are plain max-reductions that XLA
fuses into two passes per sweep.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .constants import MAX_SCALING, MIN_SCALING
from .types import QPData, ScalingData


def limit_scaling(v: jax.Array) -> jax.Array:
    """scaling.c:7-14: values below MIN_SCALING -> 1, above MAX_SCALING -> MAX."""
    v = jnp.where(v < MIN_SCALING, jnp.ones_like(v), v)
    return jnp.minimum(v, MAX_SCALING)


def _col_norms_kkt(P: jax.Array, A: jax.Array):
    """Inf-norms of the columns of [P A'; A 0] (scaling.c:28-42).

    d over variable columns: max(colnorm(P), colnorm(A));
    e over constraint columns: rownorm(A).  P is symmetric dense, so
    colnorm(P) equals the reference's mat_inf_norm_cols_sym_triu.
    """
    Pn = jnp.max(jnp.abs(P), axis=-2) if P.shape[-1] else P.sum(axis=-2)
    if A.shape[-2]:  # m > 0
        An_col = jnp.max(jnp.abs(A), axis=-2)  # (B, n)
        e = jnp.max(jnp.abs(A), axis=-1)  # (B, m)
        d = jnp.maximum(Pn, An_col)
    else:
        e = jnp.zeros(A.shape[:-1], A.dtype)
        d = Pn
    return d, e


def scale_data(data: QPData, n_iters: int) -> tuple[QPData, ScalingData]:
    """Run ``n_iters`` Ruiz sweeps (scaling.c:44-156). Returns scaled data.

    The sweeps are *read-only over P and A*: the scaled matrices are
    never materialized per sweep; instead the accumulated (c, D, E) are
    folded into the norm computations on the fly (colnorm of c·DPD is
    c·D_j·max_i D_i|P_ij|, etc.) and applied to P/A once at the end.
    This is algebraically identical to the reference's in-place loop but
    streams ~3x fewer device-memory bytes per sweep — the big matrices are only read.

    ELL sparse operands (osqp_tpu.sparse_ops) take the matrix-free
    branch below — the same sweeps with gather-based norm reductions,
    exactly the reference's matrix-free formulation (scaling.c:28-42).
    """
    from .sparse_ops import ELLMatrix

    if isinstance(data.A, ELLMatrix) or isinstance(data.P, ELLMatrix):
        return _scale_data_ell(data, n_iters)
    B, n = data.q.shape
    m = data.l.shape[-1]
    dtype = data.q.dtype
    absP = jnp.abs(data.P)
    absA = jnp.abs(data.A)
    q0 = data.q

    def p_colmax(D):
        """colmax_j(D_i |P_ij|) * D_j — the c-free column norm of DPD."""
        return jnp.max(absP * D[:, :, None], axis=-2) * D

    # The cost-normalization norm of sweep k and the d-norm of sweep k+1
    # read the SAME reduction over P (the accumulated D does not change
    # between them; only the scalar c does, and it factors out), so one
    # P pass per sweep suffices: carry the c-free reduction.
    def sweep(carry, _):
        c, D, E, Pcol = carry

        # Column norms of the *currently scaled* KKT (c·DPD / EAD; the
        # cost scalar enters P's norms only, scaling.c:28-42 + 110-141).
        Pn = Pcol * c[:, None] if n else jnp.zeros((B, n), dtype)
        if m:
            An_col = jnp.max(absA * E[:, :, None], axis=-2) * D
            e_norm = jnp.max(absA * D[:, None, :], axis=-1) * E
            d_norm = jnp.maximum(Pn, An_col)
        else:
            e_norm = jnp.zeros((B, m), dtype)
            d_norm = Pn
        d = 1.0 / jnp.sqrt(limit_scaling(d_norm))
        e = 1.0 / jnp.sqrt(limit_scaling(e_norm))
        D = D * d
        E = E * e

        # Cost normalization (scaling.c:110-141) on the scaled P, q —
        # the sweep's single pass over P.
        Pcol = p_colmax(D) if n else Pcol
        col_norm_P = Pcol * c[:, None] if n else jnp.zeros((B, n), dtype)
        c_temp = jnp.mean(col_norm_P, axis=-1)
        inf_norm_q = limit_scaling(
            jnp.max(jnp.abs(q0) * D, axis=-1) * c
        )
        c_temp = limit_scaling(jnp.maximum(c_temp, inf_norm_q))
        c = c / c_temp
        return (c, D, E, Pcol), None

    init = (
        jnp.ones((B,), dtype),
        jnp.ones((B, n), dtype),
        jnp.ones((B, m), dtype),
        p_colmax(jnp.ones((B, n), dtype)) if n else jnp.zeros((B, n), dtype),
    )
    (c, D, E, _), _ = jax.lax.scan(sweep, init, None, length=n_iters)

    scl = ScalingData(c=c, cinv=1.0 / c, D=D, Dinv=1.0 / D, E=E, Einv=1.0 / E)
    scaled = QPData(
        P=c[:, None, None] * (D[:, :, None] * data.P * D[:, None, :]),
        q=c[:, None] * (D * q0),
        A=E[:, :, None] * data.A * D[:, None, :],
        l=E * data.l,
        u=E * data.u,
    )
    return scaled, scl


def _scale_data_ell(data: QPData, n_iters: int) -> tuple[QPData, ScalingData]:
    """Sparse (ELL) Ruiz sweeps — same accumulate-then-apply scheme with
    gather-only norm reductions; see scale_data."""
    from .sparse_ops import ell_col_norms, ell_row_norms, ell_scale

    P, A = data.P, data.A
    B, n = data.q.shape
    m = data.l.shape[-1]
    dtype = data.q.dtype
    q0 = data.q

    # Same one-P-pass-per-sweep carry as the dense branch.
    def sweep(carry, _):
        c, D, E, Pcol = carry
        Pn = Pcol * c[:, None] if n else jnp.zeros((B, n), dtype)
        if m:
            An_col = ell_col_norms(A, E) * D
            e_norm = ell_row_norms(A, D) * E
            d_norm = jnp.maximum(Pn, An_col)
        else:
            e_norm = jnp.zeros((B, m), dtype)
            d_norm = Pn
        d = 1.0 / jnp.sqrt(limit_scaling(d_norm))
        e = 1.0 / jnp.sqrt(limit_scaling(e_norm))
        D = D * d
        E = E * e

        Pcol = ell_col_norms(P, D) * D if n else Pcol
        col_norm_P = Pcol * c[:, None] if n else jnp.zeros((B, n), dtype)
        c_temp = jnp.mean(col_norm_P, axis=-1)
        inf_norm_q = limit_scaling(jnp.max(jnp.abs(q0) * D, axis=-1) * c)
        c_temp = limit_scaling(jnp.maximum(c_temp, inf_norm_q))
        c = c / c_temp
        return (c, D, E, Pcol), None

    ones_n = jnp.ones((B, n), dtype)
    init = (
        jnp.ones((B,), dtype),
        ones_n,
        jnp.ones((B, m), dtype),
        ell_col_norms(P, ones_n) * ones_n if n else jnp.zeros((B, n), dtype),
    )
    (c, D, E, _), _ = jax.lax.scan(sweep, init, None, length=n_iters)

    scl = ScalingData(c=c, cinv=1.0 / c, D=D, Dinv=1.0 / D, E=E, Einv=1.0 / E)
    scaled = QPData(
        P=ell_scale(P, D, D, c),
        q=c[:, None] * (D * q0),
        A=ell_scale(A, E, D),
        l=E * data.l,
        u=E * data.u,
    )
    return scaled, scl


def unscale_solution(x: jax.Array, y: jax.Array, scl: ScalingData):
    """scaling.c:177-192: x <- D x,  y <- cinv E y."""
    return scl.D * x, scl.cinv[:, None] * (scl.E * y)
