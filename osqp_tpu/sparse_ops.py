"""Device-side sparse operands (ELL format) for large problems.

The reference's CSC kernel + SpMV (src/cs.c:28-318, src/lin_alg.c:241-323)
let it solve n ~ 1e4-1e5 Maros-Meszaros problems; the dense (B, n, n)
device layout cannot represent them (O(n^2) memory).  This module is the
accelerator equivalent: **ELL (padded-row) storage** — every row padded
to the max nnz/row — because a sparse matvec built from *gathers* with a
static shape is one data-parallel XLA program, while CSC-style indptr
loops are not.

    A x   = sum_k val[:, i, k] * x[:, idx[i, k]]          (row gather)
    A' y  = sum_k t_val[:, j, k] * y[:, t_idx[j, k]]      (gather on A')

The transpose is stored explicitly (second ELL of A') so BOTH products
are gather-only — no scatter/segment-sum in the hot loop.  Values carry
a leading batch axis (scenario batches share the sparsity pattern);
``idx`` is pattern-only and unbatched.

P is stored with its FULL symmetric pattern (the reference keeps triu
and uses the skip_diag SpMV pair, lin_alg.c:273-323; with gathers the
symmetric form costs the same and needs one product instead of two).

Used by the ``cg`` (matrix-free) backend via the dispatchers in
:mod:`osqp_tpu.linalg`; dense backends reject ELL operands by shape.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ELLMatrix:
    """Batched-values ELL matrix with explicit transpose.

    val:   (B, m, k)  row-padded values
    idx:   (m, k)     column index per slot (0 where padded; val = 0)
    t_val: (B, n, kt) values of A' (row-padded over A''s rows = A's cols)
    t_idx: (n, kt)    row index of A per slot
    shape: (m, n)     logical shape (static)
    """

    val: jax.Array
    idx: jax.Array
    t_val: jax.Array
    t_idx: jax.Array
    shape: tuple  # static

    def tree_flatten(self):
        return (self.val, self.idx, self.t_val, self.t_idx), self.shape

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves, shape=aux)

    @property
    def dtype(self):
        return self.val.dtype

    @property
    def batch(self):
        return self.val.shape[0]

    def block_until_ready(self):
        self.val.block_until_ready()
        return self


def _to_ell_rows(M: "sp.csr_matrix"):
    """(idx (m, k) int32, val (m, k) f64) from a CSR matrix.

    Vectorized O(nnz) construction — a per-row Python loop costs seconds
    at the n ~ 1e5 scale this path targets, and runs on every
    SparseSolver.solve() re-entry."""
    m = M.shape[0]
    counts = np.diff(M.indptr)
    k = max(int(counts.max()) if m else 0, 1)
    idx = np.zeros((m, k), np.int32)
    val = np.zeros((m, k), np.float64)
    if M.nnz:
        slot = np.arange(k)[None, :] < counts[:, None]  # (m, k) bool
        idx[slot] = M.indices
        val[slot] = M.data
    return idx, val


def ell_from_scipy(M, dtype, batch: int = 1, sym_from_triu: bool = False):
    """Build an ELLMatrix from a scipy sparse (or dense) matrix.

    ``sym_from_triu``: treat M as the upper triangle of a symmetric
    matrix and store the full symmetric pattern (P convention).
    Values are broadcast over ``batch``.
    """
    M = sp.csr_matrix(M)
    if sym_from_triu:
        U = sp.triu(M, format="csr")
        M = (U + U.T - sp.diags(U.diagonal())).tocsr()
    idx, val = _to_ell_rows(M)
    t_idx, t_val = _to_ell_rows(M.T.tocsr())
    to = lambda a: jnp.broadcast_to(
        jnp.asarray(a, dtype)[None], (batch,) + a.shape
    )
    return ELLMatrix(
        val=to(val),
        idx=jnp.asarray(idx),
        t_val=to(t_val),
        t_idx=jnp.asarray(t_idx),
        shape=tuple(M.shape),
    )


# ---------------------------------------------------------------------------
# Products (gather-only; gradients not needed in the solve path)
# ---------------------------------------------------------------------------
def ell_matvec(A: ELLMatrix, x: jax.Array) -> jax.Array:
    """(B, n) -> (B, m)."""
    if A.shape[0] == 0:
        return jnp.zeros((x.shape[0], 0), x.dtype)
    g = jnp.take(x, A.idx, axis=-1)  # (B, m, k)
    return jnp.sum(A.val * g, axis=-1)


def ell_tmatvec(A: ELLMatrix, y: jax.Array) -> jax.Array:
    """(B, m) -> (B, n) via the stored transpose."""
    if A.shape[1] == 0:
        return jnp.zeros((y.shape[0], 0), y.dtype)
    g = jnp.take(y, A.t_idx, axis=-1)  # (B, n, kt)
    return jnp.sum(A.t_val * g, axis=-1)


def ell_diagonal(P: ELLMatrix) -> jax.Array:
    """(B, n) diagonal of a square ELL matrix."""
    rows = jnp.arange(P.shape[0])[:, None]
    mask = (P.idx == rows).astype(P.dtype)
    return jnp.sum(P.val * mask, axis=-1)


def ell_sq_colsums(A: ELLMatrix, w: jax.Array) -> jax.Array:
    """(B, n) columns sums  sum_i w_i A_ij^2  (Jacobi preconditioner
    term) via the transpose copy — gather-only."""
    g = jnp.take(w, A.t_idx, axis=-1)
    return jnp.sum(A.t_val * A.t_val * g, axis=-1)


def ell_row_norms(A: ELLMatrix, col_w: jax.Array) -> jax.Array:
    """(B, m) row inf-norms of diag(col_w-gather) scaling:
    max_j |A_ij| col_w_j."""
    g = jnp.take(col_w, A.idx, axis=-1)
    return jnp.max(jnp.abs(A.val) * g, axis=-1) if A.shape[0] else jnp.zeros(
        (A.val.shape[0], 0), A.dtype
    )


def ell_col_norms(A: ELLMatrix, row_w: jax.Array) -> jax.Array:
    """(B, n) column inf-norms  max_i row_w_i |A_ij|  (via transpose)."""
    g = jnp.take(row_w, A.t_idx, axis=-1)
    return jnp.max(jnp.abs(A.t_val) * g, axis=-1) if A.shape[1] else jnp.zeros(
        (A.val.shape[0], 0), A.dtype
    )


def ell_scale(A: ELLMatrix, row_s, col_s, c=None) -> ELLMatrix:
    """diag(row_s) A diag(col_s) (optionally * c), batched."""
    val = A.val * row_s[..., None] * jnp.take(col_s, A.idx, axis=-1)
    t_val = A.t_val * col_s[..., None] * jnp.take(row_s, A.t_idx, axis=-1)
    if c is not None:
        val = val * c[:, None, None]
        t_val = t_val * c[:, None, None]
    return ELLMatrix(val=val, idx=A.idx, t_val=t_val, t_idx=A.t_idx,
                     shape=A.shape)


# ---------------------------------------------------------------------------
# Value maps: CSC nnz index -> ELL slot (device-resident updates)
# ---------------------------------------------------------------------------
def _tag_matrix(M):
    """Copy of ``M`` whose data are 1-based nnz indices (tags)."""
    T = M.copy()
    T.data = np.arange(1, M.nnz + 1, dtype=np.float64)
    return T


def ell_value_maps(M, sym_from_triu: bool = False):
    """Host-side gather maps from a CSC/CSR matrix's nnz order into ELL
    slots, so new values scatter onto the device operand WITHOUT
    rebuilding the pattern (the reference's in-place numeric update,
    osqp.c:1052-1062 + update_KKT_P/A maps, kkt.c:184-212).

    Returns ``(src (m, k) int32, t_src (n, kt) int32)`` with -1 in
    padding slots, such that for values ``v`` (in ``M.data`` order)

        val[i, s]   = v[src[i, s]]    (0 where src < 0)
        t_val[j, s] = v[t_src[j, s]]  (0 where t_src < 0)

    reproduces ``ell_from_scipy(M_with_values)`` exactly: the tag
    matrix is pushed through the SAME structural pipeline (csr
    conversion, triu symmetrization, transpose), and those scipy ops
    order the result by pattern only.  ``sym_from_triu`` mirrors each
    off-diagonal triu entry into both symmetric slots (one shared
    source index).
    """
    T = sp.csr_matrix(_tag_matrix(M))
    if sym_from_triu:
        U = sp.triu(T, format="csr")
        # diagonal tags survive exactly: t + t - t = t
        T = (U + U.T - sp.diags(U.diagonal())).tocsr()
    idx_t, val_t = _to_ell_rows(T)
    t_idx_t, t_val_t = _to_ell_rows(T.T.tocsr())
    src = np.rint(val_t).astype(np.int32) - 1
    t_src = np.rint(t_val_t).astype(np.int32) - 1
    return src, t_src


def ell_pattern_from_scipy(M, sym_from_triu: bool = False):
    """The unbatched integer pattern (idx, t_idx, shape) paired with
    :func:`ell_value_maps` for device-resident value updates.

    The pattern is derived from the TAG matrix (data = 1..nnz), not the
    value matrix: explicit-zero stored entries — the reference's
    documented placeholder workflow, where a zero is stored so a later
    ``update_P``/``update_A`` can write it (osqp.c:1031-1062) — must
    occupy an ELL slot.  Pushing the values through scipy's binops
    instead can cancel them out of the pattern while the maps keep
    them, silently mis-pairing every subsequent value gather."""
    T = sp.csr_matrix(_tag_matrix(M))  # line-identical to ell_value_maps
    if sym_from_triu:
        U = sp.triu(T, format="csr")
        T = (U + U.T - sp.diags(U.diagonal())).tocsr()
    idx, _ = _to_ell_rows(T)
    t_idx, _ = _to_ell_rows(T.T.tocsr())
    return idx, t_idx, tuple(T.shape)


def ell_with_values(idx, t_idx, shape, src, t_src, values, dtype, batch=1):
    """Device-side: assemble an :class:`ELLMatrix` by gathering
    ``values`` (1-D, CSC nnz order) through the maps.  O(nnz) gathers,
    no host pattern work — the device-resident update path."""
    if src.shape != idx.shape or t_src.shape != t_idx.shape:
        raise ValueError(
            f"value maps {src.shape}/{t_src.shape} disagree with the "
            f"pattern {idx.shape}/{t_idx.shape} — pattern and maps must "
            "come from the same matrix (explicit zeros included)"
        )
    v = jnp.asarray(values, dtype)
    val = jnp.where(src >= 0, v[jnp.clip(src, 0)], 0)
    t_val = jnp.where(t_src >= 0, v[jnp.clip(t_src, 0)], 0)
    to = lambda a: jnp.broadcast_to(a[None], (batch,) + a.shape)
    return ELLMatrix(
        val=to(val), idx=jnp.asarray(idx),
        t_val=to(t_val), t_idx=jnp.asarray(t_idx), shape=shape,
    )
