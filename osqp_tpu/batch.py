"""Batched multi-QP solving — the accelerator scaling axis.

The reference is strictly single-problem, single-threaded (SURVEY §2);
on an accelerator the first-class parallelism is *instance batching*:
B problems of identical shape (n, m) solved by ONE compiled program
whose every op is batched over the leading axis.  Per-instance
termination freezes finished instances (masked selects) while the
global loop runs until all are done; statuses, iteration counts,
residuals and infeasibility certificates are all per-instance.

The entire pipeline — Ruiz scaling, rho classification, factorization,
ADMM loop, polish, unscaling, certificate normalization — is one jit.
For multi-chip scaling see :mod:`osqp_tpu.parallel`.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import admm as admm_mod
from . import constants as con
from . import linsys as linsys_registry
from .admm import set_rho_state
from .linalg import bwhere, norm_inf, with_high_precision
from .polish import polish as polish_fn
from .scaling import scale_data, unscale_solution
from .solver import (Settings, make_config, reject_time_based_rho,
                     validate_settings)
from .types import (
    DynSettings,
    Iterates,
    QPData,
    ScalingData,
    SolveResult,
    StaticConfig,
)


class BatchSolveResults(NamedTuple):
    x: Any  # (B, n)
    y: Any  # (B, m)
    status_val: Any  # (B,) int32
    iter: Any  # (B,) int32
    obj_val: Any  # (B,)
    pri_res: Any  # (B,)
    dua_res: Any  # (B,)
    rho_updates: Any  # (B,) int32
    rho_estimate: Any  # (B,)
    status_polish: Any  # (B,) int32 (0 = not run, 1 = success, -1 = failed)
    prim_inf_cert: Any  # (B, m) (rows valid where status is primal infeasible)
    dual_inf_cert: Any  # (B, n)


def _prepare(cfg, scaling_iters, P, q, A, l, u, rho0, dyn, x0, y0):
    """Scale + classify rho + factorize + warm/cold start
    (osqp.c:192-215, 942-965)."""
    B, n = q.shape
    m = cfg.m
    dtype = q.dtype
    data = QPData(P=P, q=q, A=A, l=l, u=u)
    if scaling_iters > 0:
        scaled, scl = scale_data(data, scaling_iters)
    else:
        scaled, scl = data, ScalingData.identity(B, n, m, dtype)
    rho_state = set_rho_state(scaled, rho0)
    factor = linsys_registry.init_factor(
        cfg, scaled.P, scaled.A, dyn.sigma, rho_state.rho_vec
    )
    if x0 is None:
        it = Iterates.cold(B, n, m, dtype)
    else:
        from .linalg import mat_vec

        xs = x0 * scl.Dinv
        ys = y0 * scl.Einv * scl.c[:, None] if m else jnp.zeros((B, m), dtype)
        zs = mat_vec(scaled.A, xs)
        it = Iterates(x=xs, z=zs, y=ys)
    return scaled, scl, rho_state, factor, it


def _postprocess(cfg, do_polish, refine_iter, scaled, scl, dyn, result):
    """Polish + store_solution + certificate normalization
    (osqp.c:604-640, auxil.c:524-562)."""
    B = scaled.q.shape[0]
    m = cfg.m
    dtype = scaled.q.dtype
    info = result.info
    it = result.iterates

    status_polish = jnp.zeros((B,), jnp.int32)
    obj_val, pri_res, dua_res = info.obj_val, info.pri_res, info.dua_res
    if do_polish:
        solved = info.status_val == con.OSQP_SOLVED
        pol = polish_fn(
            cfg, scaled, scl, dyn, it.x, it.z, it.y, pri_res, dua_res, refine_iter
        )
        ok = solved & pol.success
        it = Iterates(
            x=bwhere(ok, pol.x, it.x),
            z=bwhere(ok, pol.z, it.z),
            y=bwhere(ok, pol.y, it.y),
        )
        obj_val = jnp.where(ok, pol.obj_val, obj_val)
        pri_res = jnp.where(ok, pol.pri_res, pri_res)
        dua_res = jnp.where(ok, pol.dua_res, dua_res)
        status_polish = jnp.where(
            solved, jnp.where(ok, 1, -1), 0
        ).astype(jnp.int32)

    # store_solution (auxil.c:524-562): unscale or NaN-fill + certificates
    sv = info.status_val
    has_sol = (
        (sv != con.OSQP_PRIMAL_INFEASIBLE)
        & (sv != con.OSQP_PRIMAL_INFEASIBLE_INACCURATE)
        & (sv != con.OSQP_DUAL_INFEASIBLE)
        & (sv != con.OSQP_DUAL_INFEASIBLE_INACCURATE)
        & (sv != con.OSQP_NON_CVX)
    )
    x_u, y_u = unscale_solution(it.x, it.y, scl)
    nan = jnp.asarray(jnp.nan, dtype)
    x_out = jnp.where(has_sol[:, None], x_u, nan)
    y_out = jnp.where(has_sol[:, None], y_u, nan) if m else y_u

    def _normalize(v):
        nrm = norm_inf(v)
        return v / jnp.where(nrm > 0, nrm, 1.0)[:, None]

    prim_cert = _normalize(result.delta_y) if m else result.delta_y
    dual_cert = _normalize(result.delta_x)

    return BatchSolveResults(
        x=x_out,
        y=y_out,
        status_val=sv,
        iter=info.iter,
        obj_val=obj_val,
        pri_res=pri_res,
        dua_res=dua_res,
        rho_updates=info.rho_updates,
        rho_estimate=info.rho_estimate,
        status_polish=status_polish,
        prim_inf_cert=prim_cert,
        dual_inf_cert=dual_cert,
    )


def solve_batch_jit(
    cfg: StaticConfig,
    scaling_iters: int,
    do_polish: bool,
    refine_iter: int,
    P,
    q,
    A,
    l,
    u,
    rho0,
    dyn: DynSettings,
    x0,
    y0,
):
    """End-to-end batched solve as ONE device program (the AOT-export /
    non-interactive mode); all inputs unscaled device arrays.  Reuses the
    segmented driver's fused first-dispatch executable with the segment
    spanning the whole iteration range, so the two paths share a single
    compilation per config."""
    return _start_c(
        cfg, scaling_iters, do_polish, refine_iter,
        P, q, A, l, u, rho0, dyn, x0, y0, cfg.max_iter,
    )[5]


# ---------------------------------------------------------------------------
# Adaptive dispatch-duration band for bounded-dispatch (sparse) solves:
# grow the fused segment geometrically while dispatches finish under
# _ADAPT_LO_S, halve when one exceeds _ADAPT_HI_S.  Bounded dispatches
# keep Ctrl-C / time_limit responsive on long solves while host polling
# stays negligible (one poll per tens of seconds).  Whether the band
# still earns its code on a local GPU is open (ROADMAP 3.1).
_ADAPT_LO_S = 10.0
_ADAPT_HI_S = 45.0
# The FIRST dispatch can't be measured before it runs, and one outer
# ADMM iteration hides up to a cg_max_iter-deep inner loop on the
# indirect backend, so the probe is budgeted in INNER iterations
# (DTOC3, n=14999, cg cap 1500: a 100-outer first dispatch is minutes
# of device work; ~15k inner iterations stay in the tens of seconds).
_PROBE_INNER_BUDGET = 15_000


# Segmented driver: always-on Ctrl-C / time_limit + optional compaction
# ---------------------------------------------------------------------------
# The default solve path.  The device loop runs in host-sized segments so
# the host can poll wall-clock time (osqp.c:387-407) and catch Ctrl-C
# (osqp.c:374-385) between segments — the reference polls both every
# iteration; here the granularity is a segment (the compiled segment
# exits early on its own when every instance terminates, so large
# segments cost nothing except polling latency).  Iteration counts and
# results are bit-identical to the single-program path because the
# global counter ``k`` keeps the termination/rho schedules aligned.
#
# Optional *instance compaction* (no reference analogue): in the masked
# while_loop, terminated instances still cost full memory bandwidth
# until the slowest instance finishes.  With ``compact=True`` the driver,
# whenever at least half the working set has terminated, gathers the
# still-active instances into a power-of-two-sized sub-batch (finalizing
# and scattering the finished ones into full-size accumulators).  The
# per-instance math is bit-identical — compaction only changes which
# instances share a program.

_prepare_c = jax.jit(
    with_high_precision(_prepare), static_argnames=("cfg", "scaling_iters")
)
_init_carry_c = jax.jit(
    with_high_precision(admm_mod.init_carry), static_argnames=("cfg",)
)


@partial(
    jax.jit,
    static_argnames=("cfg", "scaling_iters", "do_polish", "refine_iter"),
)
@with_high_precision
def _start_c(
    cfg, scaling_iters, do_polish, refine_iter,
    P, q, A, l, u, rho0, dyn, x0, y0, end1,
):
    """Fused first dispatch of the segmented driver: prepare + first
    segment + *speculative* finalize/postprocess.  If every instance
    terminates within ``end1`` iterations (the common case), ``res`` is
    the complete answer and the whole solve was ONE device program —
    the same dispatch count as an unsegmented solve.  Otherwise the
    host continues from ``carry`` and ``res`` is discarded (its compute
    overlapped with host work; no extra round trip)."""
    scaled, scl, rho_state, factor, it = _prepare(
        cfg, scaling_iters, P, q, A, l, u, rho0, dyn, x0, y0
    )
    c = admm_mod.init_carry(cfg, scaled, rho_state, factor, it)
    c = admm_mod.run_segment(cfg, scaled, scl, dyn, c, end1)
    fin = admm_mod.finalize(cfg, scaled, scl, dyn, c)
    res = _postprocess(cfg, do_polish, refine_iter, scaled, scl, dyn, fin)
    return scaled, scl, rho_state, factor, c, res


@partial(jax.jit, static_argnames=("cfg", "do_polish", "refine_iter",
                                   "fallback_status", "run_checks"))
@with_high_precision
def _finish_c(
    cfg, do_polish, refine_iter, scaled, scl, dyn, c,
    fallback_status, run_checks,
):
    """Fused final dispatch: finalize + postprocess."""
    fin = admm_mod.finalize(
        cfg, scaled, scl, dyn, c,
        fallback_status=fallback_status, run_checks=run_checks,
    )
    return _postprocess(cfg, do_polish, refine_iter, scaled, scl, dyn, fin)
_segment_c = jax.jit(
    with_high_precision(admm_mod.run_segment), static_argnames=("cfg",)
)
_finalize_c = jax.jit(
    with_high_precision(admm_mod.finalize),
    static_argnames=("cfg", "fallback_status", "run_checks"),
)
_post_c = jax.jit(
    with_high_precision(_postprocess),
    static_argnames=("cfg", "do_polish", "refine_iter"),
)


def _next_pow2(v: int) -> int:
    return 1 << max(0, (int(v) - 1)).bit_length() if v > 1 else 1


@jax.jit
def _gather_tree(tree, idx):
    """Take rows ``idx`` of every batch-leading leaf (scalar and
    non-batch leaves pass through)."""

    def take(a):
        if a.ndim >= 1:
            return a[idx]
        return a

    return jax.tree_util.tree_map(take, tree)


@jax.jit
def _scatter_tree(acc, sub, gidx):
    """Write sub rows into full-size acc at global indices ``gidx``;
    out-of-bounds indices are dropped (used for padding lanes)."""

    def put(a, s):
        return a.at[gidx].set(s, mode="drop")

    return jax.tree_util.tree_map(put, acc, sub)


def _solve_segmented(
    cfg, scaling_iters, do_polish, refine_iter,
    P, q, A, l, u, rho0, dyn, x0, y0,
    compact: bool = False, min_batch: int = 256, time_limit: float = 0.0,
    base_time: float = 0.0, max_fused_iters: int | None = None,
    verbose: bool = False,
):
    t0 = time.perf_counter()
    B = q.shape[0]
    if compact:
        from .sparse_ops import ELLMatrix

        if isinstance(P, ELLMatrix) or isinstance(A, ELLMatrix):
            # _gather_tree indexes every ndim>=1 leaf by instance row;
            # ELL pattern leaves (idx (m,k), t_idx (n,kt)) are unbatched
            # and would be silently corrupted.
            raise con.OSQPError(
                con.ErrorCode.DATA_VALIDATION_ERROR,
                "instance compaction is not supported with ELL (sparse) "
                "operands",
            )
    check = cfg.check_termination if cfg.check_termination > 0 else 25
    # Segment length = Ctrl-C / time_limit polling granularity.  The
    # compiled segment exits on its own as soon as every instance
    # terminates, so long segments waste no iterations; compaction wants
    # per-check granularity to react to terminations.
    # Verbose needs per-check granularity for the live summary rows
    # (util.c:152-175); otherwise long segments cost nothing.
    seg = check if (compact or verbose) else max(4 * check, 100)
    fallback = con.OSQP_MAX_ITER_REACHED
    run_checks = True

    if verbose and not compact:
        from .solver import _device_row_info
        from .utils.printing import IterRowPrinter

        rows = IterRowPrinter(t0)

        def _maybe_row(scaled, scl, c, end):
            rows.maybe(
                end, lambda: _device_row_info(cfg, scaled, scl, dyn, c)
            )
    else:
        # Compact mode gathers/re-indexes the working set as instances
        # finish, so "instance 0" is not a stable row subject; verbose
        # compact solves print header + footer only.
        verbose = False

        def _maybe_row(scaled, scl, c, end):
            pass

    if not compact:
        # First dispatch is the fused program (speculative result); the
        # continuation loop uses depth-1 pipelined polling: enqueue the
        # NEXT segment before downloading the previous segment's active
        # mask, so the device never idles on the host round trip (an
        # enqueued segment whose instances all terminated is a no-op —
        # the while_loop cond fails at entry).
        #
        # With no time limit the fused first dispatch spans the ENTIRE
        # iteration range: the happy path is then literally one device
        # program with zero host polls (the device loop exits at
        # termination on its own), matching the single-program
        # solve_batch_jit cost exactly — each host poll is a device
        # sync and a host round trip.
        # Ctrl-C during that single dispatch propagates as
        # KeyboardInterrupt from whichever host call first blocks on the
        # result (same contract as solve_batch_jit); the polling loop —
        # and its SIGINT -> OSQP_SIGINT status conversion — engages
        # whenever a time limit makes host polling necessary anyway.
        # With a time limit the FIRST poll must come early (the
        # reference polls the clock every iteration, osqp.c:387-407),
        # so the fused segment shrinks to one polling quantum.
        # ``max_fused_iters`` bounds any single device program: a fused
        # dispatch can otherwise span tens of minutes (long sparse CG
        # solves at max_iter ~ 2e4) with no chance to poll, so
        # long-running paths poll at a coarse, cheap cadence instead
        # (osqp_tpu.large sets this).
        adapt_cap = None
        if verbose or time_limit > 0:
            # rows (and the time-limit poll) need the first dispatch at
            # polling granularity, not the fused whole-range program
            first_end = min(seg, cfg.max_iter)
        elif max_fused_iters:
            # Bounded-dispatch mode (the sparse path): a fixed
            # iteration bound is the wrong unit — dispatch *duration*
            # is what polling latency cares about, and the
            # wall time of one ADMM iteration varies by orders of
            # magnitude with problem size and inner-CG depth (a 2000-
            # iteration dispatch is milliseconds on a small problem and
            # tens of minutes on CVXQP1_L with cg_max_iter=1500).  So
            # the segment length ADAPTS to measured dispatch time: an
            # inner-iteration-budgeted probe first, then geometric
            # ramp-up from the polling quantum while dispatches stay
            # fast, halving when one runs long.  ``max_fused_iters``
            # remains the hard iteration cap on any single dispatch.
            adapt_cap = max(int(max_fused_iters), seg)
            inner = 1
            if cfg.linsys_solver == "cg":
                inner = int(cfg.cg_max_iter) or (cfg.n + cfg.m)
            probe = max(1, min(seg, _PROBE_INNER_BUDGET // max(inner, 1)))
            seg = check
            first_end = min(probe, cfg.max_iter)
        else:
            first_end = cfg.max_iter
        t_probe = time.perf_counter()
        try:
            scaled, scl, rho_state, factor, c, res = _start_c(
                cfg, scaling_iters, do_polish, refine_iter,
                P, q, A, l, u, rho0, dyn, x0, y0, first_end,
            )
        except KeyboardInterrupt:
            # Interrupted before any usable state — rerun the minimal
            # pieces (cached programs) for a well-formed all-SIGINT result.
            scaled, scl, rho_state, factor, it = _prepare_c(
                cfg, scaling_iters, P, q, A, l, u, rho0, dyn, x0, y0
            )
            c = _init_carry_c(cfg, scaled, rho_state, factor, it)
            return _finish_c(
                cfg, do_polish, refine_iter, scaled, scl, dyn, c,
                fallback_status=con.OSQP_SIGINT, run_checks=False,
            )
        try:
            _maybe_row(scaled, scl, c, first_end)
            if first_end >= cfg.max_iter:
                return res  # whole range fit in the fused program
            act = np.asarray(c.active)  # the only poll on the happy path
            if not act.any():
                # Everything terminated within the fused first program:
                # its speculative result is the answer and the whole
                # solve was ONE dispatch + one small download.
                return res
            if adapt_cap is not None:
                # Derive the ramp's STARTING segment from the probe's
                # measured wall time, so dispatch #2 never outruns the
                # duration band on a problem whose single iteration
                # is seconds (deep inner CG at n ~ 1e5).  The probe
                # time includes compile on a cold cache, which inflates
                # the per-iteration estimate and only makes the start
                # more conservative; the measured band re-grows it
                # geometrically within a few polls either way.
                per_iter = (time.perf_counter() - t_probe) / max(first_end, 1)
                seg = int(min(seg, max(_ADAPT_LO_S / max(per_iter, 1e-9), 1)))
            # Long solve: depth-1 pipelined polling — enqueue the NEXT
            # segment before downloading the current one's active mask,
            # so the device never idles on the host round trip (an
            # enqueued segment whose instances all terminated is a
            # no-op — the while_loop cond fails at entry).
            end1 = min(first_end + seg, cfg.max_iter)
            c1 = _segment_c(cfg, scaled, scl, dyn, c, end1)
            c = c1  # on interrupt, finalize from the newest bounded segment
            last_poll = time.perf_counter()
            seg_compiled = False  # first measured interval includes compile
            while True:
                if end1 >= cfg.max_iter:
                    c = c1  # finalize applies the MAX_ITER fallback
                    break
                end2 = min(end1 + seg, cfg.max_iter)
                c2 = _segment_c(cfg, scaled, scl, dyn, c1, end2)
                c = c1
                act = np.asarray(c1.active)  # overlaps c2 on device
                if adapt_cap is not None:
                    # Measured ramp: with depth-1 pipelining the time
                    # between consecutive mask downloads ~= one segment
                    # of device time, so it directly reads off the
                    # dispatch duration.
                    now = time.perf_counter()
                    dt, last_poll = now - last_poll, now
                    if not seg_compiled:
                        seg_compiled = True  # dt included compile; skip
                    elif dt < _ADAPT_LO_S and seg < adapt_cap:
                        seg = min(seg * 2, adapt_cap)
                    elif dt > _ADAPT_HI_S and seg > 1:
                        # sub-check segments are fine: termination and
                        # rho schedules key off the global counter k,
                        # not segment boundaries (run_segment)
                        seg = max(seg // 2, 1)
                _maybe_row(scaled, scl, c1, end1)
                if not act.any():
                    c = c2  # queued no-op; same state
                    break
                if time_limit > 0 and (
                    base_time + time.perf_counter() - t0 >= time_limit
                ):
                    # c1 (completed) respects the limit; c2's extra
                    # segment is discarded device work.
                    c = c1
                    fallback = con.OSQP_TIME_LIMIT_REACHED
                    break
                c1, end1 = c2, end2
        except KeyboardInterrupt:
            # osqp.c:374-385: SIGINT exits immediately, no further checks.
            fallback = con.OSQP_SIGINT
            run_checks = False
            print("Solver interrupted")
        return _finish_c(
            cfg, do_polish, refine_iter, scaled, scl, dyn, c,
            fallback_status=fallback, run_checks=run_checks,
        )

    scaled, scl, rho_state, factor, it = _prepare_c(
        cfg, scaling_iters, P, q, A, l, u, rho0, dyn, x0, y0
    )
    carry = _init_carry_c(cfg, scaled, rho_state, factor, it)

    # Full-size device accumulators for the result pieces _postprocess
    # needs; initialized from the fresh carry (overwritten via scatter).
    acc = {
        "it": carry.it,
        "info": carry.info,
        "dx": carry.delta_x,
        "dy": carry.delta_y,
    }

    data, sclc, c = scaled, scl, carry
    gidx = np.arange(B, dtype=np.int32)  # host mirror: local row -> global

    k = 1
    try:
        while k <= cfg.max_iter:
            end = min(k + seg - 1, cfg.max_iter)
            c = _segment_c(cfg, data, sclc, dyn, c, end)
            k = end + 1
            act = np.asarray(c.active)
            na = int(act.sum())
            if na == 0 or k > cfg.max_iter:
                break
            if time_limit > 0 and (
                base_time + time.perf_counter() - t0 >= time_limit
            ):
                fallback = con.OSQP_TIME_LIMIT_REACHED
                break
            Bs = act.shape[0]
            target = max(_next_pow2(na), int(min_batch))
            if target > Bs // 2:
                continue

            keep = np.nonzero(act)[0]
            drop = np.nonzero(~act)[0]

            # Finalize + scatter the finished cohort (padded to a bucket so
            # the finalize program compiles once per size; capped at Bs so a
            # large drop set on a non-power-of-two batch still compacts).
            dsize = min(max(_next_pow2(len(drop)), int(min_batch)), Bs)
            if dsize >= len(drop):
                didx = np.zeros(dsize, np.int32)
                didx[: len(drop)] = drop
                didx_dev = jnp.asarray(didx)
                sub_data = _gather_tree(data, didx_dev)
                sub_scl = _gather_tree(sclc, didx_dev)
                sub_c = _gather_tree(c, didx_dev)
                fin = _finalize_c(cfg, sub_data, sub_scl, dyn, sub_c)
                gsc = np.full(dsize, B, np.int32)  # OOB = dropped
                gsc[: len(drop)] = gidx[drop]
                acc = _scatter_tree(
                    acc,
                    {
                        "it": fin.iterates,
                        "info": fin.info,
                        "dx": fin.delta_x,
                        "dy": fin.delta_y,
                    },
                    jnp.asarray(gsc),
                )

                # Compact the active cohort.
                kidx = np.zeros(target, np.int32)
                kidx[:na] = keep
                kidx_dev = jnp.asarray(kidx)
                data = _gather_tree(data, kidx_dev)
                sclc = _gather_tree(sclc, kidx_dev)
                c = _gather_tree(c, kidx_dev)
                pad_mask = jnp.asarray(np.arange(target) < na)
                c = c._replace(active=c.active & pad_mask)
                new_gidx = np.full(target, B, np.int32)
                new_gidx[:na] = gidx[keep]
                gidx = new_gidx
    except KeyboardInterrupt:
        # osqp.c:374-385: SIGINT exits immediately, no further checks.
        fallback = con.OSQP_SIGINT
        run_checks = False
        print("Solver interrupted")

    # Final cohort: normal finalize (fallback status for still-active).
    fin = _finalize_c(
        cfg, data, sclc, dyn, c, fallback_status=fallback, run_checks=run_checks
    )
    acc = _scatter_tree(
        acc,
        {"it": fin.iterates, "info": fin.info, "dx": fin.delta_x,
         "dy": fin.delta_y},
        jnp.asarray(gidx),
    )

    result = SolveResult(
        iterates=acc["it"],
        info=acc["info"],
        rho_state=rho_state,
        factor=factor,
        delta_x=acc["dx"],
        delta_y=acc["dy"],
    )
    return _post_c(cfg, do_polish, refine_iter, scaled, scl, dyn, result)



def solve_batch(
    P, q, A, l, u, x0=None, y0=None, compact=False, min_compact_batch=256,
    segmented=True, **settings,
) -> BatchSolveResults:
    """Solve B same-shape QPs as one batched device program.

    Args:
      P: (B, n, n) dense symmetric cost matrices.
      q: (B, n); A: (B, m, n); l, u: (B, m) (entries beyond +-1e30 are
         clamped to the reference's finite infinity, constants.h:98-100).
      x0, y0: optional warm starts (unscaled).
      compact: shrink the working batch as instances terminate (saves
         the bandwidth wasted on frozen instances when iteration counts
         are dispersed; per-instance results identical).
         ``min_compact_batch`` floors the sub-batch size.
      segmented: run via the host-segmented driver (default), which
         honors ``time_limit`` and Ctrl-C between segments the way the
         reference polls them every iteration (osqp.c:374-407).  Pass
         False to trace the entire solve as one device program (no host
         interaction — the AOT-export/embedded mode).
      **settings: reference setting names (see :class:`Settings`).

    Returns a :class:`BatchSolveResults` of device arrays.
    """
    s = Settings(**settings)
    validate_settings(s)
    reject_time_based_rho(s)

    q = jnp.asarray(q)
    if q.ndim != 2:
        raise ValueError("q must be (B, n)")
    B, n = q.shape
    if s.dtype is not None:
        dtype = jnp.dtype(s.dtype)
    else:
        dtype = jnp.dtype(jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)

    P = jnp.asarray(P, dtype)
    q = q.astype(dtype)
    A = jnp.asarray(A, dtype)
    m = A.shape[1]
    clamp = lambda v: jnp.clip(jnp.asarray(v, dtype), -con.OSQP_INFTY, con.OSQP_INFTY)
    l = clamp(l)
    u = clamp(u)

    cfg = make_config(n, m, s, dtype)
    if s.linsys_solver == "block_tridiag" and not any(
        isinstance(v, jax.core.Tracer) for v in (P, A)
    ):
        from .linsys import block_tridiag as _bt

        _bt.validate_structure(np.asarray(P), np.asarray(A), s.block_size)
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
    if x0 is not None or y0 is not None:
        # reference osqp_warm_start: either side alone is allowed, the
        # other defaults to zero (osqp.c:967-1010)
        x0 = jnp.asarray(x0, dtype) if x0 is not None else jnp.zeros((B, n), dtype)
        y0 = jnp.asarray(y0, dtype) if y0 is not None else jnp.zeros((B, m), dtype)

    args = (
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
        x0,
        y0,
    )
    # Under an outer jax trace (jit/vmap/grad of a caller — e.g. the
    # differentiable QP layer inside a jitted training step) the
    # host-segmented driver cannot poll device state; trace the whole
    # solve as one pure program instead.  Semantics are identical except
    # Ctrl-C/time_limit polling, which a traced context cannot do anyway.
    traced = any(
        isinstance(v, jax.core.Tracer) for v in (P, q, A, l, u, x0, y0)
        if v is not None
    )
    # verbose output needs the host-segmented driver (rows are printed
    # between segments); the pure-traced path stays silent rather than
    # emitting a header whose promised rows/footer never come
    verbose = bool(s.verbose) and not traced and (compact or segmented)
    if verbose:
        from .utils.printing import print_setup_header_vals

        nnz = int(np.count_nonzero(np.triu(np.asarray(P[0])))) + int(
            np.count_nonzero(np.asarray(A[0]))
        )
        print_setup_header_vals(s, n, m, nnz, B=B)
    if (compact or segmented) and not traced:
        t0 = time.perf_counter()
        res = _solve_segmented(
            *args,
            compact=bool(compact),
            min_batch=int(min_compact_batch),
            time_limit=float(s.time_limit),
            verbose=verbose,
        )
        if verbose:
            from .utils.printing import print_batch_footer

            print_batch_footer(res, s, time.perf_counter() - t0)
        return res
    return solve_batch_jit(*args)
