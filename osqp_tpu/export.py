"""AOT export — the compiled-program analogue of the reference's EMBEDDED mode.

The reference's EMBEDDED build (CMakeLists.txt:48-55, include/osqp.h:35-60)
produces an allocation-free solver for a *fixed problem structure*:
trace/allocate once at codegen time, then pure compute at run time.
That contract is exactly jit's model — this module makes it a durable
artifact: serialize the traced-and-lowered batched solve for fixed
(B, n, m, settings) with ``jax.export`` so a deployment target can run
the solver without the Python solver code (only jax + the artifact).

    blob = export_solver(B=64, n=10, m=20, dtype="float32", polish=True)
    open("solver.bin", "wb").write(blob)
    ...
    fn = load_solver(open("solver.bin", "rb").read())
    res = fn(P, q, A, l, u)   # dict of per-instance outputs

The exported program contains the full pipeline: Ruiz scaling, rho
classification, factorization, masked ADMM loop, optional polish,
unscaling, certificates.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import export as jexport

from .batch import make_config, solve_batch_jit
from .solver import Settings, validate_settings
from .types import DynSettings

# Stable output order for the exported calling convention.
_FIELDS = (
    "x",
    "y",
    "status_val",
    "iter",
    "obj_val",
    "pri_res",
    "dua_res",
    "rho_updates",
    "rho_estimate",
    "status_polish",
    "prim_inf_cert",
    "dual_inf_cert",
)


def _build_fn(B: int, n: int, m: int, s: Settings, dtype):
    cfg = make_config(n, m, s, dtype)
    dyn = DynSettings.make(
        dtype,
        sigma=s.sigma,
        alpha=s.alpha,
        eps_abs=s.eps_abs,
        eps_rel=s.eps_rel,
        eps_prim_inf=s.eps_prim_inf,
        eps_dual_inf=s.eps_dual_inf,
        adaptive_rho_tolerance=s.adaptive_rho_tolerance,
        delta=s.delta,
    )
    rho0 = jnp.full((B,), s.rho, dtype)

    def fn(P, q, A, l, u):
        res = solve_batch_jit(
            cfg,
            int(s.scaling),
            bool(s.polish),
            int(s.polish_refine_iter),
            P,
            q,
            A,
            l,
            u,
            rho0,
            dyn,
            None,
            None,
        )
        return tuple(getattr(res, f) for f in _FIELDS)

    return fn


def export_solver(
    B: int,
    n: int,
    m: int,
    dtype="float32",
    platforms=None,
    **settings,
) -> bytes:
    """Serialize a compiled batched solver for fixed (B, n, m, settings).

    ``platforms``: list like ["cuda"], ["cpu"]; defaults to the current
    default backend.
    """
    s = Settings(dtype=dtype, **settings)
    validate_settings(s)
    dt = jnp.dtype(s.dtype)
    fn = _build_fn(B, n, m, s, dt)
    specs = (
        jax.ShapeDtypeStruct((B, n, n), dt),
        jax.ShapeDtypeStruct((B, n), dt),
        jax.ShapeDtypeStruct((B, m, n), dt),
        jax.ShapeDtypeStruct((B, m), dt),
        jax.ShapeDtypeStruct((B, m), dt),
    )
    exp = jexport.export(jax.jit(fn), platforms=platforms)(*specs)
    return bytes(exp.serialize())


def load_solver(blob: bytes):
    """Deserialize an exported solver into a callable

        fn(P, q, A, l, u) -> dict(field -> array)
    """
    exp = jexport.deserialize(blob)

    def fn(P, q, A, l, u):
        out = jax.jit(exp.call)(P, q, A, l, u)
        return dict(zip(_FIELDS, out))

    return fn


def export_sparse_solver(
    P,
    A,
    B: int = 1,
    dtype="float32",
    platforms=None,
    **settings,
) -> bytes:
    """Serialize a compiled SPARSE solver for a fixed sparsity pattern.

    The EMBEDDED contract for the large-problem path: the ELL pattern
    and the CSC-nnz -> ELL-slot gather maps (the PtoKKT/AtoKKT
    analogue, kkt.c:184-212) are baked into the artifact as constants;
    the exported callable takes only VALUES —

        fn(P_val (nnzP,), q (B, n), A_val (nnzA,), l (B, m), u (B, m))

    in the CSC order of the ``P`` (upper-triangular) / ``A`` matrices
    given at export time — the same value vectors osqp_update_P/A take
    (osqp.c:1031-1062).  Backend is the matrix-free cg (the sparse
    path's only backend)."""
    import scipy.sparse as sp

    from .sparse_ops import (
        ell_pattern_from_scipy,
        ell_value_maps,
        ell_with_values,
    )

    settings.setdefault("linsys_solver", "cg")
    s = Settings(dtype=dtype, **settings)
    validate_settings(s)
    if s.linsys_solver != "cg":
        from . import constants as con

        raise con.OSQPError(
            con.ErrorCode.SETTINGS_VALIDATION_ERROR,
            "the sparse path supports only the matrix-free 'cg' backend",
        )
    dt = jnp.dtype(s.dtype)

    Pu = sp.triu(sp.csc_matrix(P), format="csc")
    Ac = sp.csc_matrix(A)
    n = Pu.shape[0]
    m = Ac.shape[0]
    Pp = ell_pattern_from_scipy(Pu, sym_from_triu=True)
    Pm = ell_value_maps(Pu, sym_from_triu=True)
    Ap = ell_pattern_from_scipy(Ac)
    Am = ell_value_maps(Ac)

    cfg = make_config(n, m, s, dt)
    dyn = DynSettings.make(
        dt,
        sigma=s.sigma,
        alpha=s.alpha,
        eps_abs=s.eps_abs,
        eps_rel=s.eps_rel,
        eps_prim_inf=s.eps_prim_inf,
        eps_dual_inf=s.eps_dual_inf,
        adaptive_rho_tolerance=s.adaptive_rho_tolerance,
        delta=s.delta,
    )
    rho0 = jnp.full((B,), s.rho, dt)

    def fn(P_val, q, A_val, l, u):
        P_ell = ell_with_values(*Pp, *Pm, P_val, dt, batch=B)
        A_ell = ell_with_values(*Ap, *Am, A_val, dt, batch=B)
        res = solve_batch_jit(
            cfg,
            int(s.scaling),
            bool(s.polish),
            int(s.polish_refine_iter),
            P_ell,
            q,
            A_ell,
            l,
            u,
            rho0,
            dyn,
            None,
            None,
        )
        return tuple(getattr(res, f) for f in _FIELDS)

    specs = (
        jax.ShapeDtypeStruct((Pu.nnz,), dt),
        jax.ShapeDtypeStruct((B, n), dt),
        jax.ShapeDtypeStruct((Ac.nnz,), dt),
        jax.ShapeDtypeStruct((B, m), dt),
        jax.ShapeDtypeStruct((B, m), dt),
    )
    exp = jexport.export(jax.jit(fn), platforms=platforms)(*specs)
    return bytes(exp.serialize())


def load_sparse_solver(blob: bytes):
    """Deserialize a sparse-pattern artifact into a callable

        fn(P_val, q, A_val, l, u) -> dict(field -> array)

    (same calling convention the artifact was exported with; the
    pattern and gather maps travel inside the blob)."""
    return load_solver(blob)
