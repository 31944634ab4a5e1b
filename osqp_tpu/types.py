"""Core pytree types for the batched OSQP solver.

The reference keeps all state in a malloc'd ``OSQPWorkspace`` struct
(reference: include/types.h:182-289).  Here state is a set of immutable
pytree dataclasses with a mandatory leading batch axis ``B`` — the whole
ADMM loop is natively batched so that thousands of QP instances run in
one compiled program on a chip (and shard across a mesh).

Settings are split in two, mirroring the reference's compile-time vs
runtime split (types.h:139-176, osqp_configure.h):

* :class:`StaticConfig` — hashable, changes retrigger compilation
  (problem shape, iteration schedule, backend choice, dtype).
* :class:`DynSettings` — traced scalars, can change without recompiling
  (tolerances, rho/sigma/alpha).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp

from . import constants as con


def _pytree(cls=None, *, meta: tuple[str, ...] = ()):
    """Register a dataclass as a jax pytree with the given metadata fields."""
    if cls is None:
        return partial(_pytree, meta=meta)
    cls = dataclasses.dataclass(frozen=True)(cls)
    data_fields = [f.name for f in dataclasses.fields(cls) if f.name not in meta]
    jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=list(meta)
    )
    return cls


def _replace(obj, **kwargs):
    return dataclasses.replace(obj, **kwargs)


# ---------------------------------------------------------------------------
# Problem data (scaled, on device)  — reference OSQPData (types.h:125-133)
# ---------------------------------------------------------------------------
@_pytree
class QPData:
    """Batched dense QP data.  All leaves carry a leading batch axis B.

    ``P`` is stored dense *symmetric* (the reference stores upper-triangular
    CSC and multiplies in two passes, lin_alg.c:241-323; one dense
    symmetric batched matmul replaces both passes).
    """

    P: jax.Array  # (B, n, n) symmetric
    q: jax.Array  # (B, n)
    A: jax.Array  # (B, m, n)
    l: jax.Array  # (B, m)   clamped to [-OSQP_INFTY, OSQP_INFTY]
    u: jax.Array  # (B, m)


@_pytree
class ScalingData:
    """Ruiz equilibration state — reference OSQPScaling (types.h:45-52)."""

    c: jax.Array  # (B,)   cost scaling
    cinv: jax.Array  # (B,)
    D: jax.Array  # (B, n)
    Dinv: jax.Array  # (B, n)
    E: jax.Array  # (B, m)
    Einv: jax.Array  # (B, m)

    @staticmethod
    def identity(B: int, n: int, m: int, dtype) -> "ScalingData":
        one = jnp.ones
        return ScalingData(
            c=one((B,), dtype),
            cinv=one((B,), dtype),
            D=one((B, n), dtype),
            Dinv=one((B, n), dtype),
            E=one((B, m), dtype),
            Einv=one((B, m), dtype),
        )


# ---------------------------------------------------------------------------
# Settings
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StaticConfig:
    """Hashable compile-time configuration (static under jit)."""

    n: int
    m: int
    max_iter: int = con.MAX_ITER
    check_termination: int = con.CHECK_TERMINATION
    adaptive_rho: bool = con.ADAPTIVE_RHO
    # Resolved interval: 0 is resolved at setup to the deterministic
    # fallback (constants.h:111-112); the reference's PROFILING time-based
    # auto-interval (osqp.c:456-485) is intentionally replaced by the
    # deterministic path, which is jit-friendly and reproducible.
    adaptive_rho_interval: int = (
        con.ADAPTIVE_RHO_MULTIPLE_TERMINATION * con.CHECK_TERMINATION
    )
    scaled_termination: bool = con.SCALED_TERMINATION
    linsys_solver: str = "dense_inv"
    dtype: str = "float64"
    # Indirect (CG) backend knobs — play the role MKL Pardiso options play
    # for the second reference backend (pardiso_interface.c:73-228).
    cg_max_iter: int = 0  # 0 -> n + m
    cg_tol_fraction: float = 1e-7
    # Stage-block size for the block_tridiag (MPC/OCP) backend.
    block_size: int = 0
    # Active-set polish passes (reference = 1, polish.c:212-350; extra
    # passes re-guess the set at the polished point and keep the best —
    # see polish.polish for the measured motivation).
    polish_passes: int = con.POLISH_PASSES
    # Run polish in a different precision than the solve (typically
    # "float64" over an f32 solve: polish runs once per solve, so f64
    # there costs little).  None = same
    # dtype as the solve.  float64 requires jax_enable_x64.
    polish_dtype: str | None = None

    @property
    def jdtype(self):
        return jnp.dtype(self.dtype)


@_pytree
class DynSettings:
    """Traced runtime settings — reference OSQPSettings (types.h:139-176).

    All per-solver scalars; stored as rank-0 arrays so they can be updated
    without recompilation.  ``rho`` lives in :class:`RhoState` because it is
    per-instance once adaptation kicks in.
    """

    sigma: jax.Array
    alpha: jax.Array
    eps_abs: jax.Array
    eps_rel: jax.Array
    eps_prim_inf: jax.Array
    eps_dual_inf: jax.Array
    adaptive_rho_tolerance: jax.Array
    delta: jax.Array  # polish regularization

    @staticmethod
    def make(
        dtype,
        sigma=con.SIGMA,
        alpha=con.ALPHA,
        eps_abs=con.EPS_ABS,
        eps_rel=con.EPS_REL,
        eps_prim_inf=con.EPS_PRIM_INF,
        eps_dual_inf=con.EPS_DUAL_INF,
        adaptive_rho_tolerance=con.ADAPTIVE_RHO_TOLERANCE,
        delta=con.DELTA,
    ) -> "DynSettings":
        a = lambda v: jnp.asarray(v, dtype)
        return DynSettings(
            sigma=a(sigma),
            alpha=a(alpha),
            eps_abs=a(eps_abs),
            eps_rel=a(eps_rel),
            eps_prim_inf=a(eps_prim_inf),
            eps_dual_inf=a(eps_dual_inf),
            adaptive_rho_tolerance=a(adaptive_rho_tolerance),
            delta=a(delta),
        )


# ---------------------------------------------------------------------------
# Rho state — per-constraint penalty (auxil.c:76-142)
# ---------------------------------------------------------------------------
@_pytree
class RhoState:
    rho: jax.Array  # (B,)   current scalar rho per instance
    rho_vec: jax.Array  # (B, m)
    rho_inv_vec: jax.Array  # (B, m)
    constr_type: jax.Array  # (B, m) int8: -1 loose, 0 ineq, 1 eq


# ---------------------------------------------------------------------------
# Solver iterates / loop state
# ---------------------------------------------------------------------------
@_pytree
class Iterates:
    x: jax.Array  # (B, n)
    z: jax.Array  # (B, m)
    y: jax.Array  # (B, m)

    @staticmethod
    def cold(B: int, n: int, m: int, dtype) -> "Iterates":
        """cold_start (auxil.c:155-159)."""
        z = jnp.zeros
        return Iterates(x=z((B, n), dtype), z=z((B, m), dtype), y=z((B, m), dtype))


@_pytree
class InfoState:
    """Per-instance solve info — reference OSQPInfo (types.h:66-91).

    Timing fields live host-side in :class:`osqp_tpu.solver.Info`.
    """

    iter: jax.Array  # (B,) int32
    status_val: jax.Array  # (B,) int32
    obj_val: jax.Array  # (B,)
    pri_res: jax.Array  # (B,)
    dua_res: jax.Array  # (B,)
    rho_updates: jax.Array  # (B,) int32
    rho_estimate: jax.Array  # (B,)

    @staticmethod
    def fresh(B: int, dtype, rho) -> "InfoState":
        return InfoState(
            iter=jnp.zeros((B,), jnp.int32),
            status_val=jnp.full((B,), con.OSQP_UNSOLVED, jnp.int32),
            obj_val=jnp.zeros((B,), dtype),
            pri_res=jnp.full((B,), jnp.inf, dtype),
            dua_res=jnp.full((B,), jnp.inf, dtype),
            rho_updates=jnp.zeros((B,), jnp.int32),
            rho_estimate=jnp.broadcast_to(jnp.asarray(rho, dtype), (B,)),
        )


@_pytree
class SolveResult:
    """Output of the jitted solve core (still scaled; host unscales)."""

    iterates: Iterates  # final (scaled) iterates, post-termination
    info: InfoState
    rho_state: RhoState
    factor: Any  # linsys factorization state after possible rho updates
    delta_x: jax.Array  # (B, n) dual-infeasibility certificate (scaled)
    delta_y: jax.Array  # (B, m) primal-infeasibility certificate (scaled,
    #                     polar-cone-projected; E-scaled on termination)
