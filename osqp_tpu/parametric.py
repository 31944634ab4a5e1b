"""Batched parametric solving — the reference's update/re-solve workflow
at batch scale.

The reference's killer parametric loop (docs/examples/mpc.rst: solve,
apply, osqp_update_bounds, re-solve warm-started) is single-problem.
:class:`BatchedSolver` keeps B problems' scaled data, factorization and
iterates resident on device and exposes the same update surface over
whole batches, so e.g. B independent MPC controllers step in lockstep
with one compiled program per phase:

    bs = BatchedSolver(P, q, A, l, u, ...)        # (B, ...) arrays
    res = bs.solve()                              # warm-started batch solve
    bs.update_bounds(l_new, u_new)                # one device update
    res = bs.solve()

Update semantics mirror src/osqp.c exactly:

* ``update_lin_cost`` — rescale q only (osqp.c:765-795)
* ``update_bounds`` — rescale l, u; reclassify rho; refactor only the
  batch if any instance changed constraint class (osqp.c:797-846,
  auxil.c:100-142)
* ``update_rho`` — clamp, rebuild rho_vec, refactor (osqp.c:1281-1332)
* ``warm_start`` — scale iterates, z = A x (osqp.c:942-1007)
* ``update_P`` / ``update_A`` / ``update_P_A`` — new batched values,
  rescale from scratch, refactor (osqp.c:1012-1279)
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import constants as con
from .batch import (
    BatchSolveResults,
    _postprocess,
    _prepare_c,
    make_config,
)
from .admm import rho_vec_from_type, solve_core, update_rho_state
from .linalg import with_high_precision
from .solver import Settings, reject_time_based_rho, validate_settings
from .solver import _device_refactor
from .types import DynSettings, Iterates

_solve_core_jit = jax.jit(
    with_high_precision(solve_core), static_argnames=("cfg",)
)
_post_jit = jax.jit(
    with_high_precision(_postprocess),
    static_argnames=("cfg", "do_polish", "refine_iter"),
)


@partial(
    jax.jit,
    static_argnames=("cfg", "do_polish", "refine_iter", "has_q", "has_bounds"),
)
@with_high_precision
def _resolve_jit(
    cfg, do_polish, refine_iter, has_q, has_bounds,
    data, scl, dyn, rho_state, factor, it,
    q_new, l_new, u_new,
):
    """Fused parametric update + warm-started solve + postprocess — ONE
    device program.

    The reference's update entry points are designed cheap
    (osqp.c:765-846); on an accelerator the real cost of the naive
    update->solve->postprocess sequence is the *dispatch count* (eager
    scaling ops + two jitted calls = 4-6 host round trips per
    re-solve).  Fusing the whole loop body collapses that to one
    dispatch + one download.

    Update semantics inside the program match osqp.c exactly:
    q_scaled = c D q (765-795); bounds rescaled by E with rho
    reclassification and a refactorization ONLY where an instance's
    constraint class changed (797-846, auxil.c:100-142), matching
    BatchedSolver.update_bounds.
    """
    if has_q:
        data = dataclasses.replace(
            data, q=q_new * scl.D * scl.c[:, None]
        )
    if has_bounds:
        ls = data.l if l_new is None else (
            jnp.clip(l_new, -con.OSQP_INFTY, con.OSQP_INFTY) * scl.E
        )
        us = data.u if u_new is None else (
            jnp.clip(u_new, -con.OSQP_INFTY, con.OSQP_INFTY) * scl.E
        )
        data = dataclasses.replace(data, l=ls, u=us)
        rho_state, changed = update_rho_state(data, rho_state)

        def _refactor(args):
            rs, factor = args
            from . import linsys as linsys_registry

            new = linsys_registry.init_factor(
                cfg, data.P, data.A, dyn.sigma, rs.rho_vec
            )

            def sel(n_, o_):
                if n_.ndim == 0 or jnp.issubdtype(n_.dtype, jnp.integer):
                    return n_
                from .linalg import bwhere

                return bwhere(changed, n_, o_)

            return jax.tree_util.tree_map(sel, new, factor)

        factor = jax.lax.cond(
            jnp.any(changed), _refactor, lambda args: args[1],
            (rho_state, factor),
        )
    result = solve_core(cfg, data, scl, dyn, rho_state, factor, it)
    out = _postprocess(cfg, do_polish, refine_iter, data, scl, dyn, result)
    return data, result.rho_state, result.factor, result.iterates, out


class BatchedSolver:
    """Device-resident batch of B same-shape QPs with parametric updates."""

    def __init__(self, P, q, A, l, u, **settings):
        s = Settings(**settings)
        validate_settings(s)
        reject_time_based_rho(s)
        self.settings = s
        q = jnp.asarray(q)
        if q.ndim != 2:
            raise ValueError("q must be (B, n)")
        B, n = q.shape
        if s.dtype is not None:
            dtype = jnp.dtype(s.dtype)
        else:
            dtype = jnp.dtype(
                jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
            )
        self._dtype = dtype
        A = jnp.asarray(A, dtype)
        m = A.shape[1]
        self.B, self.n, self.m = B, n, m
        self._cfg = make_config(n, m, s, dtype)
        if s.linsys_solver == "block_tridiag":
            from .linsys import block_tridiag as _bt

            import numpy as _np

            _bt.validate_structure(_np.asarray(P), _np.asarray(A), s.block_size)
        self._dyn = DynSettings.make(
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
        self._setup_data(P, q, A, l, u, rho=float(s.rho))
        self.iterates = Iterates.cold(B, n, m, dtype)

    # -- internals -----------------------------------------------------------
    def _clamp(self, v):
        return jnp.clip(jnp.asarray(v, self._dtype), -con.OSQP_INFTY, con.OSQP_INFTY)

    def _setup_data(self, P, q, A, l, u, rho):
        dtype = self._dtype
        P = jnp.asarray(P, dtype)
        q = jnp.asarray(q, dtype)
        A = jnp.asarray(A, dtype)
        # rho may be a scalar (fresh setup) or the (B,) per-instance
        # adapted values (matrix updates preserve each instance's rho,
        # matching B independent Solvers).
        rho0 = jnp.broadcast_to(jnp.asarray(rho, dtype), (self.B,))
        scaled, scl, rho_state, factor, _ = _prepare_c(
            self._cfg, int(self.settings.scaling), P, q, A,
            self._clamp(l), self._clamp(u), rho0, self._dyn, None, None,
        )
        self.data = scaled
        self.scaling = scl
        self.rho_state = rho_state
        self.factor = factor

    # -- solve ----------------------------------------------------------------
    def solve(self) -> BatchSolveResults:
        it = self.iterates
        if not self.settings.warm_start:
            it = Iterates.cold(self.B, self.n, self.m, self._dtype)
        result = _solve_core_jit(
            self._cfg, self.data, self.scaling, self._dyn,
            self.rho_state, self.factor, it,
        )
        # Persist adapted rho/factor + iterates for warm starting
        self.rho_state = result.rho_state
        self.factor = result.factor
        self.iterates = result.iterates
        return _post_jit(
            self._cfg,
            bool(self.settings.polish),
            int(self.settings.polish_refine_iter),
            self.data, self.scaling, self._dyn, result,
        )

    def resolve(self, q=None, l=None, u=None) -> BatchSolveResults:
        """Parametric update + warm-started re-solve as ONE fused device
        program (see :func:`_resolve_jit`) — the fast path for the
        reference's update/re-solve loop (osqp.c:765-846 + 288).

        ``q``/``l``/``u`` are new UNSCALED values (any may be omitted).
        Semantically identical to ``update_lin_cost``/``update_bounds``
        followed by ``solve()``; collapses 4-6 dispatches to one."""
        has_q = q is not None
        has_bounds = l is not None or u is not None
        it = self.iterates
        if not self.settings.warm_start:
            it = Iterates.cold(self.B, self.n, self.m, self._dtype)
        to = lambda v: None if v is None else jnp.asarray(v, self._dtype)
        data, rho_state, factor, iterates, out = _resolve_jit(
            self._cfg,
            bool(self.settings.polish),
            int(self.settings.polish_refine_iter),
            has_q, has_bounds,
            self.data, self.scaling, self._dyn,
            self.rho_state, self.factor, it,
            to(q), to(l), to(u),
        )
        self.data = data
        self.rho_state = rho_state
        self.factor = factor
        self.iterates = iterates
        return out

    # -- parametric updates ----------------------------------------------------
    def update_lin_cost(self, q_new):
        """q_scaled = c * D * q_new (osqp.c:765-795)."""
        qs = (
            jnp.asarray(q_new, self._dtype)
            * self.scaling.D
            * self.scaling.c[:, None]
        )
        self.data = dataclasses.replace(self.data, q=qs)

    def update_bounds(self, l=None, u=None):
        """Rescale bounds; refactor iff a constraint changed class
        (osqp.c:797-846)."""
        ls = self.data.l if l is None else self._clamp(l) * self.scaling.E
        us = self.data.u if u is None else self._clamp(u) * self.scaling.E
        if bool(jnp.any(ls > us)):
            raise con.OSQPError(
                con.ErrorCode.DATA_VALIDATION_ERROR,
                "lower bound must be lower than or equal to upper bound",
            )
        self.data = dataclasses.replace(self.data, l=ls, u=us)
        self.rho_state, changed = update_rho_state(self.data, self.rho_state)
        if bool(jnp.any(changed)):
            self.factor = _device_refactor(
                self._cfg, self.data.P, self.data.A,
                self._dyn.sigma, self.rho_state.rho_vec,
            )

    def update_rho(self, rho_new: float):
        """osqp_update_rho (osqp.c:1281-1332)."""
        if rho_new <= 0:
            raise con.OSQPError(
                con.ErrorCode.SETTINGS_VALIDATION_ERROR, "rho must be positive"
            )
        rho = float(np.clip(rho_new, con.RHO_MIN, con.RHO_MAX))
        rho_arr = jnp.full((self.B,), rho, self._dtype)
        rv = rho_vec_from_type(self.rho_state.constr_type, rho_arr)
        self.rho_state = dataclasses.replace(
            self.rho_state, rho=rho_arr, rho_vec=rv, rho_inv_vec=1.0 / rv
        )
        self.factor = _device_refactor(
            self._cfg, self.data.P, self.data.A,
            self._dyn.sigma, self.rho_state.rho_vec,
        )

    def update_P(self, P_new=None, A_new=None, l=None, u=None, q=None):
        """New batched P (and optionally A/q/l/u) values: unscale-free
        full re-preparation, preserving iterates (osqp.c:1012-1279)."""
        # Reconstruct unscaled data for the pieces not being replaced.
        Dinv = self.scaling.Dinv
        Einv = self.scaling.Einv
        cinv = self.scaling.cinv
        P_u = (
            jnp.asarray(P_new, self._dtype)
            if P_new is not None
            else cinv[:, None, None] * self.data.P * Dinv[:, :, None] * Dinv[:, None, :]
        )
        A_u = (
            jnp.asarray(A_new, self._dtype)
            if A_new is not None
            else self.data.A * Einv[:, :, None] * Dinv[:, None, :]
        )
        q_u = (
            jnp.asarray(q, self._dtype)
            if q is not None
            else cinv[:, None] * self.data.q * Dinv
        )
        l_u = self._clamp(l) if l is not None else self.data.l * Einv
        u_u = self._clamp(u) if u is not None else self.data.u * Einv
        self._setup_data(P_u, q_u, A_u, l_u, u_u, rho=self.rho_state.rho)

    def update_A(self, A_new):
        self.update_P(A_new=A_new)

    def update_P_A(self, P_new, A_new):
        self.update_P(P_new=P_new, A_new=A_new)

    def warm_start(self, x=None, y=None):
        """Scale iterates, z = A x (osqp.c:942-1007)."""
        it = self.iterates
        if x is not None:
            xs = jnp.asarray(x, self._dtype) * self.scaling.Dinv
            zs = jnp.einsum(
                "bmn,bn->bm", self.data.A, xs, precision="highest"
            )
            it = Iterates(x=xs, z=zs, y=it.y)
        if y is not None:
            ys = (
                jnp.asarray(y, self._dtype)
                * self.scaling.Einv
                * self.scaling.c[:, None]
            )
            it = Iterates(x=it.x, z=it.z, y=ys)
        self.iterates = it
