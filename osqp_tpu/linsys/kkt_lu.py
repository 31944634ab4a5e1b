"""Dense full-KKT LU backend.

Factors the (n+m) quasi-definite KKT matrix

    K = [P + sigma I    A'          ]
        [A             -diag(1/rho) ]

with batched partially-pivoted LU.  This is the structural analogue of
the reference's second backend (MKL Pardiso on the full KKT,
lin_sys/direct/pardiso/pardiso_interface.c:73-300): it proves the backend
registry and is robust for P that is PSD-but-singular where the Schur
complement can be marginal.  Also reused by polish (src/polish.c:232-272)
with param1 = param2 = delta.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def form_kkt(P, A, sigma, rho_inv_vec):
    """K as above, batched (B, n+m, n+m) (mirrors kkt.c:6-177 dense)."""
    B, n = P.shape[0], P.shape[-1]
    m = A.shape[-2]
    dtype = P.dtype
    top = jnp.concatenate(
        [P + sigma * jnp.eye(n, dtype=dtype), jnp.swapaxes(A, -1, -2)], axis=-1
    )
    lower_right = -rho_inv_vec[:, :, None] * jnp.eye(m, dtype=dtype)
    bot = jnp.concatenate([A, lower_right], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def _lu_factor(K):
    lu, _, perm = jax.lax.linalg.lu(K)
    return {"lu": lu, "perm": perm}


def _lu_solve(factor, b):
    """Batched P A = L U solve:  x = U^-1 L^-1 b[perm]."""
    lu, perm = factor["lu"], factor["perm"]
    pb = jnp.take_along_axis(b, perm, axis=-1)[..., None]
    y = jax.lax.linalg.triangular_solve(
        lu, pb, left_side=True, lower=True, unit_diagonal=True
    )
    x = jax.lax.linalg.triangular_solve(lu, y, left_side=True, lower=False)
    return x[..., 0]


def init(P, A, sigma, rho_vec, **_):
    return _lu_factor(form_kkt(P, A, sigma, 1.0 / rho_vec))


def solve(factor, A, rho_vec, rhs_x, rhs_z, x0=None):
    """KKT solve + split-solution recovery (qdldl_interface.c:359-370):

    solves K [x~; nu] = [rhs_x; rhs_z], returns x~ and
    z~ = rhs_z + nu / rho  (== A x~).
    """
    sol = _lu_solve(factor, jnp.concatenate([rhs_x, rhs_z], axis=-1))
    n = rhs_x.shape[-1]
    x_t = sol[..., :n]
    nu = sol[..., n:]
    z_t = rhs_z + nu / rho_vec
    return x_t, z_t


def solve_raw(factor, rhs):
    """Raw KKT solve without the z~ recovery — the polish path
    (qdldl_interface.c:354-357, ``polish=1``)."""
    return _lu_solve(factor, rhs)
