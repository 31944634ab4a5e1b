"""Intra-problem sharding: ONE large QP spread across the mesh.

SURVEY.md §2 names two scaling axes; this is axis (b): when a single
QP is too large for one chip, shard the *constraint dimension m* of the
matrix-free ``cg`` backend across devices.  The per-iteration operators
partition naturally:

    A @ x           row-sharded output, no communication
    A' (rho ∘ v)    local partial products + one psum over the row axis
    norms over m    one psum

Nothing is hand-written: the arrays carry ``NamedSharding`` and XLA's
SPMD partitioner inserts the collectives (the scaling-book recipe: pick
a mesh, annotate shardings, let XLA do the rest).  The factor-free cg
backend means there is no sharded Cholesky to write.

Polish runs on BOTH sharded paths: the sparse one via the matrix-free
reduced-KKT CG (ELL branch of polish._make_kkt_solver) and the dense
one via the Schur branch, whose AtA contraction partitions over the
row shards (XLA inserts the psum) — the cg-backend flag routes polish
away from the unpartitionable batched-LU custom call.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from ..batch import BatchSolveResults, solve_batch
from ..constants import OSQP_INFTY
from .mesh import make_mesh


def solve_single_sharded(
    P,
    q,
    A,
    l,
    u,
    mesh: Mesh | None = None,
    axis_name: str = "batch",
    **settings,
) -> BatchSolveResults:
    """Solve one QP with A's rows sharded over the mesh.

    P: (n, n) dense symmetric (replicated); A: (m, n); l, u: (m,).
    Rows are padded with loose all-zero constraints to a multiple of the
    mesh size (exact — rho classifies them loose, residuals are zero).
    Returns a batch-of-1 :class:`BatchSolveResults`.
    """
    from ..constants import ErrorCode, OSQPError

    settings.setdefault("linsys_solver", "cg")
    if settings["linsys_solver"] != "cg":
        raise OSQPError(
            ErrorCode.SETTINGS_VALIDATION_ERROR,
            "intra-problem sharding requires the cg backend",
        )
    mesh = mesh or make_mesh(axis_name=axis_name)
    n_dev = mesh.devices.size

    P = np.asarray(P)
    q = np.asarray(q)
    A = np.asarray(A)
    l = np.asarray(l)
    u = np.asarray(u)
    m, n = A.shape
    pad = (-m) % n_dev
    if pad:
        A = np.concatenate([A, np.zeros((pad, n), A.dtype)], axis=0)
        l = np.concatenate([l, np.full(pad, -OSQP_INFTY)])
        u = np.concatenate([u, np.full(pad, OSQP_INFTY)])

    row = NamedSharding(mesh, PartitionSpec(None, axis_name))
    row3 = NamedSharding(mesh, PartitionSpec(None, axis_name, None))
    repl = NamedSharding(mesh, PartitionSpec())

    A_s = jax.device_put(jnp.asarray(A)[None], row3)
    l_s = jax.device_put(jnp.asarray(l)[None], row)
    u_s = jax.device_put(jnp.asarray(u)[None], row)
    P_s = jax.device_put(jnp.asarray(P)[None], repl)
    q_s = jax.device_put(jnp.asarray(q)[None], repl)

    res = solve_batch(P_s, q_s, A_s, l_s, u_s, **settings)
    if pad:
        res = res._replace(
            y=res.y[:, :m], prim_inf_cert=res.prim_inf_cert[:, :m]
        )
    return res


def solve_single_sharded_sparse(
    P,
    q,
    A,
    l,
    u,
    mesh: Mesh | None = None,
    axis_name: str = "batch",
    **settings,
):
    """One LARGE SPARSE QP with A's rows sharded over the mesh — the
    composition of the two scaling stories: the never-densifying ELL
    path (osqp_tpu.large) under the intra-problem sharding recipe.

    Sharding layout (annotate + let XLA insert collectives):

    * ``A.val`` / ``A.idx`` / ``l`` / ``u`` row-sharded over m — the
      gather-only ``A @ x`` is fully local (x replicated);
    * ``A.t_val`` / ``A.t_idx`` replicated (they are nnz-sized, tiny
      for sparse problems) — ``A' y`` gathers the row-sharded y, which
      XLA resolves with one all-gather of y (O(m) bytes) per product;
    * P (ELL) and all n-vectors replicated.

    P/A are scipy sparse.  ``polish=True`` runs the matrix-free
    reduced-KKT CG polish (polish.py ELL branch) under the same
    shardings — its products are the very operators sharded above, so
    XLA partitions the refinement like the main loop (padded rows are
    loose, hence inactive and zero-masked).  Validation, dtype
    resolution, ELL construction and configs are the shared
    :func:`osqp_tpu.large.prepare_sparse`; only the row padding and
    device placement live here.  Returns a batch-of-1
    BatchSolveResults.
    """
    import scipy.sparse as sp

    from ..batch import _solve_segmented
    from ..large import prepare_sparse
    from ..sparse_ops import ELLMatrix

    mesh = mesh or make_mesh(axis_name=axis_name)
    n_dev = mesh.devices.size

    l = np.asarray(l, np.float64).ravel()
    u = np.asarray(u, np.float64).ravel()
    A = sp.csr_matrix(A)
    m0 = A.shape[0]
    pad = (-m0) % n_dev
    if pad:
        A = sp.vstack([A, sp.csr_matrix((pad, A.shape[1]))], format="csr")
        l = np.concatenate([l, np.full(pad, -OSQP_INFTY)])
        u = np.concatenate([u, np.full(pad, OSQP_INFTY)])

    s, dtype, cfg, dyn, P_ell, A_ell, q2, l2, u2 = prepare_sparse(
        P, q, A, l, u, settings
    )

    row2 = NamedSharding(mesh, PartitionSpec(axis_name, None))
    row3 = NamedSharding(mesh, PartitionSpec(None, axis_name, None))
    rowv = NamedSharding(mesh, PartitionSpec(None, axis_name))
    repl = NamedSharding(mesh, PartitionSpec())

    A_ell = ELLMatrix(
        val=jax.device_put(A_ell.val, row3),
        idx=jax.device_put(A_ell.idx, row2),
        t_val=jax.device_put(A_ell.t_val, repl),
        t_idx=jax.device_put(A_ell.t_idx, repl),
        shape=A_ell.shape,
    )
    P_ell = jax.tree_util.tree_map(
        lambda a: jax.device_put(a, repl), P_ell
    )
    res = _solve_segmented(
        cfg, int(s.scaling), bool(s.polish), int(s.polish_refine_iter),
        P_ell,
        jax.device_put(jnp.asarray(q2, dtype), repl),
        A_ell,
        jax.device_put(jnp.asarray(l2, dtype), rowv),
        jax.device_put(jnp.asarray(u2, dtype), rowv),
        jnp.full((1,), s.rho, dtype),
        dyn, None, None,
        time_limit=float(s.time_limit),
        max_fused_iters=2000,  # same dispatch bound as large.py
    )
    if pad:
        res = res._replace(
            y=res.y[:, :m0], prim_inf_cert=res.prim_inf_cert[:, :m0]
        )
    return res
