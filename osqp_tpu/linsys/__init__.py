"""Linear-system backends behind one protocol.

Mirrors the reference ``LinSysSolver`` vtable + factory
(types.h:298-319, src/lin_sys.c:15-75), with the same 3-method contract
(solve / update_matrices / update_rho_vec collapse to `init` = recompute):

* ``dense_chol`` — batched dense Cholesky of the n x n Schur complement
  ``P + sigma I + A' diag(rho) A`` (the reference documents this reduced
  form for indirect methods, docs/solver/index.rst:52-58).  Plays the
  role of QDLDL (lin_sys/direct/qdldl/qdldl_interface.c).
* ``dense_inv`` — the default: the same Schur complement, inverted
  explicitly at factor time so each iteration is batched GEMVs.
* ``kkt_lu`` — batched dense LU of the full (n+m) quasi-definite KKT
  ``[P + sigma I, A'; A, -diag(1/rho)]``; robust fallback and the polish
  path.  Plays the role of MKL Pardiso (the second backend proving the
  registry abstraction, lin_sys/direct/pardiso/pardiso_interface.c).
* ``cg`` — matrix-free Jacobi-preconditioned conjugate gradient on the
  Schur complement; the "indirect solver" from the reference ROADMAP.md:2.

Each backend exposes:

``init(P, A, sigma, rho_vec) -> factor``      (batched pytree)
``solve(factor, data, sigma, rho_state, rhs_x, rhs_z) -> (x_tilde, z_tilde)``

with the exact split-solution semantics of the reference: the returned
``z_tilde`` equals ``rhs_z + rho_inv * nu`` which algebraically is
``A @ x_tilde`` (qdldl_interface.c:367-370).
"""

from __future__ import annotations

from . import block_tridiag, cg, dense_chol, dense_inv, kkt_lu

_REGISTRY = {
    "dense_inv": dense_inv,
    "dense_chol": dense_chol,
    "kkt_lu": kkt_lu,
    "cg": cg,
    "block_tridiag": block_tridiag,
}

# Reference enum names (constants.h:35) map onto these backends.
_ALIASES = {
    "qdldl": "dense_inv",
    "mkl pardiso": "kkt_lu",
}


def available() -> list[str]:
    return sorted(_REGISTRY)


def get(name: str):
    """Factory: init_linsys_solver (lin_sys.c:56-75)."""
    key = _ALIASES.get(str(name).lower(), str(name).lower())
    if key not in _REGISTRY:
        raise KeyError(f"unknown linsys solver {name!r}; available: {available()}")
    return _REGISTRY[key]


def init_factor(cfg, P, A, sigma, rho_vec):
    """Factorize with the backend + options selected by ``cfg``
    (StaticConfig) — the single entry point all (re)factorization
    sites share (setup, rho update, bounds-class change)."""
    return get(cfg.linsys_solver).init(
        P,
        A,
        sigma,
        rho_vec,
        cg_max_iter=cfg.cg_max_iter,
        cg_tol_fraction=cfg.cg_tol_fraction,
        block_size=cfg.block_size,
    )
