"""Explicit-inverse Schur-complement backend (default).

Same reduction as :mod:`.dense_chol` (M = P + sigma I + A' diag(rho) A),
but at factorization time the *inverse operator* is materialized:

    W = [ M^-1     ]      (B, n+m, n)
        [ A M^-1   ]

so the per-iteration KKT solve is a single batched GEMV

    [x~; z~] = W @ (rhs_x + A'(rho * rhs_z))

with zero triangular substitutions.  Rationale: a batched triangular
solve with a width-1 right-hand side is a chain of n dependent steps,
while W @ t is one memory-bound fused product — the speed-of-light
formulation for the batched regime (thousands of instances per card).

Numerics: applying an explicit inverse has forward error O(kappa(M) eps),
the same order as triangular solves; Ruiz equilibration bounds kappa and
ADMM is a fixed-point iteration that tolerates inexact subproblem solves
(and polish performs iterative refinement, polish.c:134-181).  For
ill-conditioned problems select ``dense_chol`` or ``kkt_lu``.

Factorization cost: one batched Cholesky + one n-wide triangular solve
+ two GEMMs (:func:`osqp_tpu.linalg.spd_inverse`), paid once at setup
and once per rho update (reference parity: qdldl_interface.c:305,407-409).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..linalg import spd_inverse
from .dense_chol import form_schur

# Operands stay f32: bf16 operand storage was tried and rejected — its
# fixed ~2e-3 operator error stalls ADMM at the default tolerances.


# Per-iteration refinement gate.  An explicit-inverse solve has forward
# error ~ ||I - XM||; ADMM tolerates ~1e-6 relative subproblem error at
# default tolerances, but beyond that the error couples into the dual
# ascent through rho_eq = 1e3 rho and puts a FLOOR under the dual
# residual (measured on CVXQP1_M f32: dua_res plateaus at ~0.85, rho
# adaptation never fires, 16.5-20k iterations vs 375 for the exact-solve
# f64 trajectory).  One matrix-free residual-correction step per solve
# (3 extra GEMVs) restores the f64-like trajectory: 1625/175/125
# iterations on CVXQP1_M/2_M/3_S.  The gate below enables it per batch
# only when some instance's inverse residual exceeds the tolerance —
# well-conditioned batches (bench class: resid ~5e-7) skip the branch
# entirely via scalar lax.cond.
_REFINE_TOL_F32 = 3e-6
_REFINE_TOL_F64 = 1e-12


def init(P, A, sigma, rho_vec, **_):
    M = form_schur(P, A, sigma, rho_vec)
    n = P.shape[-1]
    Minv = spd_inverse(M)
    if n:
        # The inverse residual sets the per-instance refinement flag
        # below; NaN (non-PD) compares False and stays unrefined.
        R = jnp.eye(n, dtype=M.dtype) - jnp.einsum(
            "bij,bjk->bik", M, Minv, preferred_element_type=M.dtype,
            precision="highest",
        )
        resid = jnp.max(jnp.abs(R), axis=(-2, -1))
    else:
        resid = jnp.zeros(M.shape[0], M.dtype)
    if A.shape[-2]:
        # (A M^-1)' = M^-1 A' stored transposed, (B, n, m): both
        # per-iteration GEMV reductions then contract the second-to-last
        # axis (M^-1 is symmetric, so it contracts either way).
        AMinvT = jnp.einsum(
            "bnk,bmk->bnm", Minv, A, preferred_element_type=P.dtype,
            precision="highest",
        )
    else:
        AMinvT = jnp.zeros((P.shape[0], n, 0), P.dtype)
    tol = _REFINE_TOL_F32 if M.dtype == jnp.float32 else _REFINE_TOL_F64
    # P and sigma ride along by reference (no copies under jit) for the
    # matrix-free refinement residual M x = P x + sigma x + A'(rho (A x)).
    return {
        "Minv": Minv,
        "AMinvT": AMinvT,
        "refine": resid > tol,
        "P": P,
        "sigma": jnp.asarray(sigma, M.dtype),
    }


def refine_signal(factor):
    """Traced scalar: does some instance in this batch need per-solve
    refinement?  Evaluated ONCE per segment by admm.run_segment (a cond
    *inside* the hot loop measurably breaks XLA's loop-body fusion:
    20.1k -> 13.0k QPs/s on the headline bench), selecting between the
    plain and refined loop bodies."""
    return jnp.any(factor["refine"])


def solve(factor, A, rho_vec, rhs_x, rhs_z, x0=None, refine=False):
    t = rhs_x
    # Broadcast-multiply + reduce over the second-to-last axis (see
    # init): the hot GEMV is memory-bound and XLA fuses each into one
    # exact-f32 pass over its operand.  Minv symmetric.
    if A.shape[-2]:
        t = t + jnp.sum(A * (rho_vec * rhs_z)[:, :, None], axis=1)
    x_t = jnp.sum(factor["Minv"] * t[:, :, None], axis=1)

    if refine:
        hi = (
            jnp.float64
            if jax.config.jax_enable_x64 and t.dtype == jnp.float32
            else None
        )
        if hi is not None:
            # Two refinement steps with the residual ACCUMULATED IN F64.
            # An f32 residual r = t - Mx cannot be computed to better
            # than ~eps_f32 * ||M|| * ||x||; with ||M|| ~ 1e4 after Ruiz
            # (equality rows at rho_eq = 1e3 rho) that floor is ~1e-3 —
            # above default tolerances, so f32-residual refinement
            # leaves a dual-residual plateau and iteration counts
            # explode (measured, portfolio n=550 f32: mean 1190 / max
            # 4000 iterations vs the f64 trajectory's 130/150; one
            # f64-residual step: 511/3325; two steps: 130/150 — the
            # exact f64 trajectory at f32 storage).  The f32->f64
            # upcasts are exact and XLA fuses them into the operand
            # reads; only the residual GEMVs run in f64, the correction
            # and iterates stay f32.
            P64 = factor["P"].astype(hi)
            A64 = A.astype(hi)
            rho64 = rho_vec.astype(hi)
            t64 = t.astype(hi)
            sig64 = factor["sigma"].astype(hi)
            x = x_t
            for _ in range(2):
                x64 = x.astype(hi)
                Mx = jnp.sum(P64 * x64[:, :, None], axis=1) + sig64 * x64
                if A.shape[-2]:
                    Ax = jnp.sum(A64 * x64[:, None, :], axis=2)
                    Mx = Mx + jnp.sum(
                        A64 * (rho64 * Ax)[:, :, None], axis=1
                    )
                r = (t64 - Mx).astype(t.dtype)
                x = x + jnp.sum(factor["Minv"] * r[:, :, None], axis=1)
            x_t = x
        else:
            # No x64 available (or native f64 solve): single f32/f64
            # matrix-free residual-correction step.
            x = x_t
            Mx = (
                jnp.sum(factor["P"] * x[:, :, None], axis=1)
                + factor["sigma"] * x
            )
            if A.shape[-2]:
                Ax = jnp.einsum("bmn,bn->bm", A, x, precision="highest")
                Mx = Mx + jnp.sum(A * (rho_vec * Ax)[:, :, None], axis=1)
            r = t - Mx
            x_t = x + jnp.sum(factor["Minv"] * r[:, :, None], axis=1)
        z_t = jnp.einsum("bmn,bn->bm", A, x_t, precision="highest")
        return x_t, z_t

    z_t = jnp.sum(factor["AMinvT"] * t[:, :, None], axis=1)
    return x_t, z_t
