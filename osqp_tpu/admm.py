"""The batched ADMM solve core — one jitted program for the whole solve.

Re-derivation of the reference hot loop (osqp.c:288-654, auxil.c:161-225)
as a ``lax.while_loop`` over a natively *batched* state: every leaf
carries a leading instance axis B, and per-instance termination freezes
instances via masked selects while the global loop keeps a scalar
iteration counter ``k``.  Because ``k`` is a scalar (the loop is never
vmapped), the periodic events — termination checks every
``check_termination`` iterations (osqp.c:411-449) and rho adaptation
every ``adaptive_rho_interval`` iterations (osqp.c:456-529) — compile to
real ``lax.cond`` branches: the expensive residual/refactorization work
only executes at those iterations, exactly like the reference.

The reference's pointer-swap workspace (auxil.c:147-153) becomes loop
carry; the split xz_tilde vector becomes a tuple from the linsys backend.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from . import linsys as linsys_registry
from .constants import (
    MIN_SCALING,
    OSQP_DUAL_INFEASIBLE,
    OSQP_DUAL_INFEASIBLE_INACCURATE,
    OSQP_INFTY,
    OSQP_MAX_ITER_REACHED,
    OSQP_NON_CVX,
    OSQP_PRIMAL_INFEASIBLE,
    OSQP_PRIMAL_INFEASIBLE_INACCURATE,
    OSQP_SOLVED,
    OSQP_SOLVED_INACCURATE,
    RHO_EQ_OVER_RHO_INEQ,
    RHO_MAX,
    RHO_MIN,
    RHO_TOL,
)
from .linalg import bwhere, quad_form, vec_dot
from .termination import check_termination, compute_rho_estimate
from .types import (
    DynSettings,
    InfoState,
    Iterates,
    QPData,
    RhoState,
    ScalingData,
    SolveResult,
    StaticConfig,
)


# ---------------------------------------------------------------------------
# rho vector classification (auxil.c:76-142)
# ---------------------------------------------------------------------------
def classify_constraints(l, u):
    """-1 loose / 1 equality / 0 inequality per row (auxil.c:81-95)."""
    loose = (l < -OSQP_INFTY * MIN_SCALING) & (u > OSQP_INFTY * MIN_SCALING)
    eq = u - l < RHO_TOL
    return jnp.where(loose, -1, jnp.where(eq, 1, 0)).astype(jnp.int8)


def rho_vec_from_type(constr_type, rho):
    """rho_vec entries by class (auxil.c:84-95): loose->RHO_MIN,
    eq->1e3*rho, ineq->rho."""
    rho_b = rho[:, None]
    return jnp.where(
        constr_type == -1,
        jnp.asarray(RHO_MIN, rho.dtype),
        jnp.where(constr_type == 1, RHO_EQ_OVER_RHO_INEQ * rho_b, rho_b),
    )


def set_rho_state(data: QPData, rho) -> RhoState:
    """set_rho_vec (auxil.c:76-98).  ``rho`` is (B,)."""
    rho = jnp.clip(rho, RHO_MIN, RHO_MAX)
    ct = classify_constraints(data.l, data.u)
    rv = rho_vec_from_type(ct, rho)
    return RhoState(rho=rho, rho_vec=rv, rho_inv_vec=1.0 / rv, constr_type=ct)


def update_rho_state(data: QPData, rs: RhoState) -> tuple[RhoState, jax.Array]:
    """update_rho_vec after a bounds change (auxil.c:100-142).

    Returns the new state and a (B,) bool mask of instances whose
    constraint classification changed (those need refactorization).
    """
    ct = classify_constraints(data.l, data.u)
    changed = (
        jnp.any(ct != rs.constr_type, axis=-1)
        if ct.shape[-1]
        else jnp.zeros(ct.shape[:-1], bool)
    )
    rv = rho_vec_from_type(ct, rs.rho)
    return (
        RhoState(rho=rs.rho, rho_vec=rv, rho_inv_vec=1.0 / rv, constr_type=ct),
        changed,
    )


# ---------------------------------------------------------------------------
# One ADMM iteration (auxil.c:161-225)
# ---------------------------------------------------------------------------
def admm_step(
    backend,
    factor,
    data: QPData,
    dyn: DynSettings,
    rs: RhoState,
    it: Iterates,
    y_lo=None,
):
    """x~/z~ solve + relaxed x/z/y updates.

    Returns (Iterates, delta_x, delta_y, y_lo).

    ``y_lo`` is the compensated-accumulation carry for the dual ascent
    (f32 only; None disables).  The dual update ``y += delta_y`` is the
    one *running accumulation* in the loop: with equality rows at
    rho_eq = 1e3 rho, |y| reaches 1e4+ on real problems (CVXQP*) and
    f32 addition then swallows increments below |y| eps ~ 1e-3 — the
    dual residual plateaus (measured: ~0.85 on CVXQP1_M forever), rho
    adaptation never fires, and iteration counts explode ~44x vs the
    f64 reference trajectory.  Knuth TwoSum keeps the swallowed low
    bits in ``y_lo`` and re-injects them into the next increment, which
    restores the f64 iteration trajectory at pure-f32 storage cost
    (one extra (B, m) vector, 5 elementwise adds)."""
    x_prev, z_prev, y = it.x, it.z, it.y
    alpha = dyn.alpha

    # compute_rhs (auxil.c:161-175)
    rhs_x = dyn.sigma * x_prev - data.q
    rhs_z = z_prev - rs.rho_inv_vec * y

    # update_xz_tilde (auxil.c:177-183) — z~ comes back as A x~
    x_t, z_t = backend.solve(factor, data.A, rs.rho_vec, rhs_x, rhs_z, x0=x_prev)

    # update_x (auxil.c:185-198)
    x = alpha * x_t + (1.0 - alpha) * x_prev
    delta_x = x - x_prev

    # update_z (auxil.c:200-212) + projection (proj.c:4-14)
    z_relaxed = alpha * z_t + (1.0 - alpha) * z_prev
    z = jnp.clip(z_relaxed + rs.rho_inv_vec * y, data.l, data.u)

    # update_y (auxil.c:214-225)
    delta_y = rs.rho_vec * (z_relaxed - z)
    if y_lo is None:
        y = y + delta_y
    else:
        # TwoSum(y, delta_y + y_lo): exact sum split into (hi, lo).
        b = delta_y + y_lo
        s = y + b
        bb = s - y
        y_lo = (y - (s - bb)) + (b - bb)
        y = s

    return Iterates(x=x, z=z, y=y), delta_x, delta_y, y_lo


# ---------------------------------------------------------------------------
# Solve core
# ---------------------------------------------------------------------------
class _Carry(NamedTuple):
    k: jax.Array  # scalar int32 — global iteration counter
    it: Iterates
    delta_x: jax.Array
    delta_y: jax.Array
    rho_state: RhoState
    factor: Any
    info: InfoState
    active: jax.Array  # (B,) bool
    y_lo: Any = None  # (B, m) compensated dual-ascent carry (f32 only)


def _apply_check(cfg, data, scl, dyn, c: _Carry, iter_number, approximate=False):
    """update_info + check_termination for active instances (osqp.c:420-449)."""
    tr = check_termination(
        cfg, data, scl, dyn, c.it.x, c.it.z, c.it.y, c.delta_x, c.delta_y, approximate
    )
    newly = c.active & tr.terminated
    solved_like = (tr.status == OSQP_SOLVED) | (tr.status == OSQP_SOLVED_INACCURATE)
    info = replace(
        c.info,
        iter=jnp.where(c.active, jnp.asarray(iter_number, jnp.int32), c.info.iter),
        status_val=jnp.where(newly, tr.status, c.info.status_val),
        obj_val=jnp.where(newly & ~solved_like, tr.obj_at_term, c.info.obj_val),
        pri_res=jnp.where(c.active, tr.pri_res, c.info.pri_res),
        dua_res=jnp.where(c.active, tr.dua_res, c.info.dua_res),
    )
    # Store certificates for instances terminating with an infeasible status
    # (check_termination unscales them at that moment, auxil.c:762-781).
    pinf = newly & (
        (tr.status == OSQP_PRIMAL_INFEASIBLE)
        | (tr.status == OSQP_PRIMAL_INFEASIBLE_INACCURATE)
    )
    dinf = newly & (
        (tr.status == OSQP_DUAL_INFEASIBLE)
        | (tr.status == OSQP_DUAL_INFEASIBLE_INACCURATE)
    )
    # Backends with an inexact-solve schedule (cg) retune their inner
    # tolerance from the just-computed residuals (linsys/cg.py).
    factor = c.factor
    upd_tol = getattr(linsys_registry.get(cfg.linsys_solver), "update_tolerance", None)
    if upd_tol is not None:
        factor = upd_tol(factor, tr.tol_ratio, dyn)

    return c._replace(
        info=info,
        factor=factor,
        active=c.active & ~tr.terminated,
        delta_x=bwhere(dinf, tr.dx_cert, c.delta_x),
        delta_y=bwhere(pinf, tr.dy_cert, c.delta_y),
    )


def _apply_rho_adaptation(cfg, data, dyn, c: _Carry) -> _Carry:
    """adapt_rho (auxil.c:54-74) + osqp_update_rho (osqp.c:1281-1332).

    Updates rho where the estimate is more than adaptive_rho_tolerance x
    off, rebuilds rho_vec (loose rows stay at RHO_MIN) and refactors.  The
    batched refactorization is skipped entirely (scalar cond) when no
    instance needs it.
    """
    rs = c.rho_state
    est = compute_rho_estimate(data, c.it.x, c.it.z, c.it.y, rs.rho)
    info = replace(
        c.info, rho_estimate=jnp.where(c.active, est, c.info.rho_estimate)
    )
    tol = dyn.adaptive_rho_tolerance
    upd = c.active & ((est > rs.rho * tol) | (est < rs.rho / tol))

    def select_factor(new, old):
        # cg factors carry unbatched scalar config leaves and (for ELL
        # operands) integer sparsity-pattern leaves; both are identical
        # across the branch, so pass the new one through.
        if new.ndim == 0 or jnp.issubdtype(new.dtype, jnp.integer):
            return new
        return bwhere(upd, new, old)

    def do_update(args):
        rs, factor, info = args
        new_rho = jnp.where(upd, jnp.clip(est, RHO_MIN, RHO_MAX), rs.rho)
        new_rv = rho_vec_from_type(rs.constr_type, new_rho)
        new_rs = RhoState(
            rho=new_rho,
            rho_vec=new_rv,
            rho_inv_vec=1.0 / new_rv,
            constr_type=rs.constr_type,
        )
        new_factor = linsys_registry.init_factor(
            cfg, data.P, data.A, dyn.sigma, new_rv
        )
        factor = jax.tree_util.tree_map(select_factor, new_factor, factor)
        new_info = replace(info, rho_updates=info.rho_updates + upd.astype(jnp.int32))
        return new_rs, factor, new_info

    rs, factor, info = jax.lax.cond(
        jnp.any(upd), do_update, lambda args: args, (rs, c.factor, info)
    )
    return c._replace(rho_state=rs, factor=factor, info=info)


def init_carry(
    cfg: StaticConfig,
    data: QPData,
    rho_state: RhoState,
    factor: Any,
    iterates: Iterates,
) -> _Carry:
    B, n = data.q.shape
    dtype = data.q.dtype
    return _Carry(
        k=jnp.asarray(1, jnp.int32),
        it=iterates,
        delta_x=jnp.zeros((B, n), dtype),
        delta_y=jnp.zeros((B, cfg.m), dtype),
        rho_state=rho_state,
        factor=factor,
        info=InfoState.fresh(B, dtype, rho_state.rho),
        active=jnp.ones((B,), bool),
        # Compensated dual accumulation (see admm_step): needed in f32,
        # a no-op waste in f64.
        y_lo=(
            jnp.zeros((B, cfg.m), dtype)
            if dtype == jnp.float32
            else None
        ),
    )


def run_segment(
    cfg: StaticConfig,
    data: QPData,
    scl: ScalingData,
    dyn: DynSettings,
    c: _Carry,
    end_iter,
) -> _Carry:
    """Run ADMM iterations while ``k <= end_iter`` and any instance is
    active.  ``end_iter`` may be traced, so one compiled segment serves
    arbitrary host-side chunking (time_limit polling, Ctrl-C polling,
    PRINT_INTERVAL rows) while the global counter ``k`` keeps the
    termination-check and rho-adaptation schedules aligned with the
    reference's whole-loop iteration numbering."""
    backend = linsys_registry.get(cfg.linsys_solver)
    check = int(cfg.check_termination)
    interval = int(cfg.adaptive_rho_interval) if cfg.adaptive_rho else 0
    end_iter = jnp.minimum(jnp.asarray(end_iter, jnp.int32), cfg.max_iter)

    def loop_cond(c: _Carry):
        return (c.k <= end_iter) & jnp.any(c.active)

    def make_loop_body(refine: bool):
        if refine:
            bk_solve = lambda *a, **k: backend.solve(*a, refine=True, **k)
        else:
            bk_solve = backend.solve
        bk = type("_BK", (), {"solve": staticmethod(bk_solve)})

        # Compensated dual accumulation only in the refined body: the
        # plain body serves well-conditioned batches that terminate in
        # tens of iterations, where the extra (B, m) carry traffic costs
        # ~3% headline throughput for nothing; ill-conditioned runs (the
        # long ones where f32 swamping in y actually bites) are exactly
        # the ones routed to the refined body.
        y_lo_here = refine or getattr(backend, "refine_signal", None) is None

        def loop_body(c: _Carry) -> _Carry:
            it_new, dx_new, dy_new, y_lo_new = admm_step(
                bk, c.factor, data, dyn, c.rho_state, c.it,
                c.y_lo if y_lo_here else None,
            )
            it_masked = bwhere(c.active, it_new, c.it)
            c = c._replace(
                it=it_masked,
                delta_x=bwhere(c.active, dx_new, c.delta_x),
                delta_y=bwhere(c.active, dy_new, c.delta_y),
                y_lo=(
                    bwhere(c.active, y_lo_new, c.y_lo)
                    if y_lo_new is not None
                    else c.y_lo
                ),
            )

            if check > 0:
                c = jax.lax.cond(
                    c.k % check == 0,
                    lambda cc: _apply_check(cfg, data, scl, dyn, cc, cc.k),
                    lambda cc: cc,
                    c,
                )
            if interval > 0:
                c = jax.lax.cond(
                    c.k % interval == 0,
                    lambda cc: _apply_rho_adaptation(cfg, data, dyn, cc),
                    lambda cc: cc,
                    c,
                )
            return c._replace(k=c.k + 1)

        return loop_body

    refine_signal = getattr(backend, "refine_signal", None)
    if refine_signal is None:
        return jax.lax.while_loop(loop_cond, make_loop_body(False), c)

    # Per-segment precision selection: ill-conditioned batches (some
    # instance's factor-time inverse residual above the backend's
    # tolerance) run the refined loop body; everyone else runs the plain
    # one.  The cond sits OUTSIDE the while_loop — a per-iteration cond
    # breaks XLA's loop fusion and cost ~32% headline throughput when it
    # was inside.  The signal is re-evaluated at every segment boundary,
    # so a mid-segment rho refactorization that changes conditioning is
    # picked up at the next segment.
    return jax.lax.cond(
        refine_signal(c.factor),
        lambda cc: jax.lax.while_loop(loop_cond, make_loop_body(True), cc),
        lambda cc: jax.lax.while_loop(loop_cond, make_loop_body(False), cc),
        c,
    )


def finalize(
    cfg: StaticConfig,
    data: QPData,
    scl: ScalingData,
    dyn: DynSettings,
    c: _Carry,
    fallback_status: int = OSQP_MAX_ITER_REACHED,
    run_checks: bool = True,
) -> SolveResult:
    """Post-loop logic (osqp.c:537-640): final update_info + plain check,
    approximate-tolerance pass, fallback status for the rest, objective
    and final rho estimate.

    Re-running the plain check when the last iteration was already a
    check iteration is idempotent (identical inputs -> identical failed
    checks), so it runs unconditionally.  ``fallback_status`` is
    MAX_ITER_REACHED on the normal path and TIME_LIMIT_REACHED when the
    host aborted on settings.time_limit (osqp.c:585-589).
    ``run_checks=False`` is the SIGINT path (osqp.c:377-385 jumps
    straight to exit without further checks)."""
    last_iter = jnp.minimum(c.k - 1, cfg.max_iter)
    if run_checks:
        c = _apply_check(cfg, data, scl, dyn, c, last_iter, approximate=False)

        # Approximate-tolerance pass for instances still UNSOLVED
        # (osqp.c:576-581: check_termination(work, 1)).
        c = _apply_check(cfg, data, scl, dyn, c, last_iter, approximate=True)
    else:
        c = c._replace(
            info=replace(
                c.info,
                iter=jnp.where(c.active, last_iter, c.info.iter),
            )
        )
    info = replace(
        c.info,
        status_val=jnp.where(
            c.active, jnp.asarray(fallback_status, jnp.int32), c.info.status_val
        ),
    )

    # Objective for instances that have a solution (osqp.c:564-566,
    # auxil.c:227-238): obj = (0.5 x'Px + q'x) * cinv.
    has_sol = (
        (info.status_val != OSQP_PRIMAL_INFEASIBLE)
        & (info.status_val != OSQP_PRIMAL_INFEASIBLE_INACCURATE)
        & (info.status_val != OSQP_DUAL_INFEASIBLE)
        & (info.status_val != OSQP_DUAL_INFEASIBLE_INACCURATE)
        & (info.status_val != OSQP_NON_CVX)
    )
    obj = scl.cinv * (quad_form(data.P, c.it.x) + vec_dot(data.q, c.it.x))
    info = replace(
        info,
        obj_val=jnp.where(has_sol, obj, info.obj_val),
        # Final rho estimate (osqp.c:595)
        rho_estimate=compute_rho_estimate(
            data, c.it.x, c.it.z, c.it.y, c.rho_state.rho
        ),
    )

    return SolveResult(
        iterates=c.it,
        info=info,
        rho_state=c.rho_state,
        factor=c.factor,
        delta_x=c.delta_x,
        delta_y=c.delta_y,
    )


def solve_core(
    cfg: StaticConfig,
    data: QPData,
    scl: ScalingData,
    dyn: DynSettings,
    rho_state: RhoState,
    factor: Any,
    iterates: Iterates,
) -> SolveResult:
    """Run the full ADMM solve (osqp.c:354-640, minus host-side concerns)
    as one traced program: init -> single whole-range segment -> finalize.

    Everything is scaled; the caller unscales the solution.  ``iterates``
    is the warm/cold start.  Returns per-instance statuses, residuals and
    certificates.
    """
    c = init_carry(cfg, data, rho_state, factor, iterates)
    c = run_segment(cfg, data, scl, dyn, c, cfg.max_iter)
    return finalize(cfg, data, scl, dyn, c)


def segment_row_info(cfg, data, scl, dyn, c: _Carry):
    """Residuals + objective at the current iterates, for verbose
    per-interval rows (print_summary columns, util.c:152-175)."""
    from .termination import compute_products, residual_norms

    pr = compute_products(data, c.it.x, c.it.z, c.it.y)
    pri, dua = residual_norms(cfg, scl, pr)
    obj = scl.cinv * (quad_form(data.P, c.it.x) + vec_dot(data.q, c.it.x))
    return obj, pri, dua, c.rho_state.rho
