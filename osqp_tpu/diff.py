"""Differentiable QP layer — implicit differentiation through the KKT
conditions.

The reference C solver has no derivative support (differentiation lives
in external ecosystem projects); here a differentiable batched QP is a
first-class layer for end-to-end learning (OptNet-style).  Forward =
the batched solve; backward = one linear solve against the *same masked
reduced KKT* machinery the polish step uses (polish.py), so the
backward pass is also pure batched dense algebra.

Derivation (standard implicit-function argument at a solution with
strict complementarity): with active rows A_a treated as equalities
``A_a x = b_a`` the optimum satisfies

    [P    A_a'] [x ]   [-q ]
    [A_a  0   ] [y_a] = [b_a]

For a loss L(x*), solving the (symmetric) adjoint system

    [P    A_a'] [u]   [g]            g = dL/dx*
    [A_a  0   ] [v] = [0]

gives   dL/dq = -u
        dL/dP = -(u x*' + x* u')/2          (symmetrized)
        dL/dA = -(y* u' + v x*')
        dL/dl_i = v_i (lower-active rows),  dL/du_i = v_i (upper-active)

Degenerate problems (weakly active constraints) have nonunique
derivatives; like other QP layers this returns the one induced by the
regularized masked KKT.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .batch import solve_batch
from .linalg import mat_tvec, mat_vec
from .linsys import kkt_lu


def _adjoint_solve(P, A, active_mask, g, delta, refine_iter=3):
    """Solve [P, (MA)'; MA, 0] [u; v] = [g; 0] via the delta-regularized
    masked KKT + iterative refinement (same trick as polish.py)."""
    B, n = g.shape
    m = A.shape[1]
    dtype = g.dtype
    MA = active_mask[:, :, None] * A
    delta_vec = jnp.full((B, m), delta, dtype)
    K = kkt_lu.form_kkt(P, MA, delta, delta_vec)
    factor = kkt_lu._lu_factor(K)
    rhs = jnp.concatenate([g, jnp.zeros((B, m), dtype)], axis=-1)
    sol = kkt_lu.solve_raw(factor, rhs)

    def refine(_, sol):
        su, sv = sol[..., :n], sol[..., n:]
        r_u = g - (mat_vec(P, su) + mat_tvec(MA, sv))
        r_v = -mat_vec(MA, su)
        d = kkt_lu.solve_raw(factor, jnp.concatenate([r_u, r_v], axis=-1))
        return sol + d

    sol = jax.lax.fori_loop(0, refine_iter, refine, sol)
    return sol[..., :n], active_mask * sol[..., n:]


def make_qp_layer(active_tol: float = 1e-8, **settings):
    """Build a differentiable batched QP layer.

        layer = make_qp_layer(eps_abs=1e-8, eps_rel=1e-8)
        x_star = layer(P, q, A, l, u)        # (B, n), differentiable

    Solve settings should be tight (the gradient assumes an accurate
    optimum); polish defaults on.  Returns only the primal solution.
    """
    settings.setdefault("polish", True)
    settings.setdefault("verbose", False)

    def _solve(P, q, A, l, u):
        res = solve_batch(P, q, A, l, u, **settings)
        return res.x, res.y

    @jax.custom_vjp
    def layer(P, q, A, l, u):
        return _solve(P, q, A, l, u)[0]

    def fwd(P, q, A, l, u):
        x, y = _solve(P, q, A, l, u)
        return x, (P, q, A, l, u, x, y)

    def bwd(saved, g):
        P, q, A, l, u, x, y = saved
        dtype = x.dtype
        lower = y < -active_tol
        upper = y > active_tol
        mask = (lower | upper).astype(dtype)
        delta = 1e-6 if dtype == jnp.float32 else 1e-9
        u_adj, v = _adjoint_solve(
            jnp.asarray(P, dtype), jnp.asarray(A, dtype), mask, g, delta
        )
        dq = -u_adj
        dP = -0.5 * (
            u_adj[:, :, None] * x[:, None, :] + x[:, :, None] * u_adj[:, None, :]
        )
        dA = -(y[:, :, None] * u_adj[:, None, :] + v[:, :, None] * x[:, None, :])
        dl = jnp.where(lower, v, 0.0)
        du = jnp.where(upper, v, 0.0)
        return dP, dq, dA, dl, du

    layer.defvjp(fwd, bwd)
    return layer
