"""Maros-Meszaros benchmark harness.

The reference defers its accuracy benchmark to the external
osqp_benchmarks repo (README.md:42-43); this harness plays that role:
parse QPS files, solve each at eps_abs = eps_rel = 1e-3 (reference
defaults) with polish and infeasibility detection, and report the pass
rate.

Usage:
    python -m osqp_tpu.maros DIR_OR_FILES... [--eps 1e-3] [--no-polish]
        [--single] [--shard i/k] [--max-iter 4000] [--dtype float64]

``--shard i/k`` partitions the problem list across k hosts (sorted by
size, round-robin) — the multi-host axis of the benchmark: each host
works an independent shard, nothing crosses DCN during solves.
``--single`` solves one-by-one via :class:`osqp_tpu.Solver`; default
batches same-bucket problems through :func:`osqp_tpu.buckets.solve_problems`.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np


from . import constants as con
from .buckets import solve_problems
from .io.qps import load_qps


def collect_paths(args_paths):
    paths = []
    for p in args_paths:
        if os.path.isdir(p):
            paths += sorted(
                glob.glob(os.path.join(p, "*.qps"))
                + glob.glob(os.path.join(p, "*.QPS"))
                + glob.glob(os.path.join(p, "*.qps.gz"))
            )
        else:
            paths.append(p)
    return paths


# Problems whose n or m exceeds this go through large.solve_sparse
# (ELL operands, cg) instead of the dense bucketed batch — the dense
# embedding is wasteful past a few thousand and impossible at 1e4+.
SPARSE_N_CUTOFF = 4096
# Mid-size problems that are STRUCTURALLY sparse also route through the
# sparse path above this size: the dense embedding both wastes memory and
# can be f32-hostile (AUG3D: a diagonal P with zero weights on boundary
# faces conditions the dense f32 factor past the residual guard, forcing
# the f64 fallback; the ELL path solves it in f64 with host polish to
# 8-digit objective agreement).
SPARSE_MIN_N = 2048
SPARSE_DENSITY = 5e-3


# Strict terminal statuses: a definitive answer at full accuracy.
_STRICT_FINAL = (
    con.OSQP_SOLVED,
    con.OSQP_PRIMAL_INFEASIBLE,
    con.OSQP_DUAL_INFEASIBLE,
)


def _row_rank(status_val, status_polish):
    """Orders outcomes so a fallback retry can never DEMOTE a row:
    strict statuses and certificates above inaccurate, above non-final;
    polish success breaks ties.  On equal rank the retry wins — the f64
    trajectory is the one that matches the reference oracle's iteration
    counts (PARITY.md)."""
    if status_val in _STRICT_FINAL:
        s = 2
    elif status_val in (
        con.OSQP_SOLVED_INACCURATE,
        con.OSQP_PRIMAL_INFEASIBLE_INACCURATE,
        con.OSQP_DUAL_INFEASIBLE_INACCURATE,
    ):
        s = 1
    else:
        s = 0
    return (s, 1 if status_polish == 1 else 0)


def _route_sparse(qp) -> bool:
    if max(qp.n, qp.m) > SPARSE_N_CUTOFF:
        return True
    if max(qp.n, qp.m) <= SPARSE_MIN_N:
        return False
    import scipy.sparse as _sp

    nnz = _sp.csc_matrix(qp.P).nnz + _sp.csc_matrix(qp.A).nnz
    return nnz <= SPARSE_DENSITY * (qp.n * qp.n + qp.m * qp.n)


def _solve_one_sparse(qp, settings):
    """One large problem through the never-densifying path (polish runs
    matrix-free there since round 3, polish.py:_make_kkt_solver).

    Sparse problems run at f64 whenever the process has x64: the cg
    backend's subproblem accuracy bounds the trajectory (round-4
    measurement: CVXQP1_L needs ~1e-8-relative KKT solves for the
    reference's 650-iteration trajectory — 18,300 iterations without
    them — and f32 cannot reach that floor).  The CG path is
    gather/elementwise-bound, so f64 costs a small multiple."""
    import jax as _jax

    from .large import solve_sparse

    if _jax.config.jax_enable_x64:
        settings = dict(settings)
        settings["dtype"] = "float64"
        settings.pop("polish_dtype", None)  # same dtype already

    t = time.perf_counter()
    res = solve_sparse(qp.P, qp.q, qp.A, qp.l, qp.u, **settings)
    sv = int(np.asarray(res.status_val)[0])
    return dict(
        name=qp.name,
        n=qp.n,
        m=qp.m,
        status=con.STATUS_MESSAGE.get(sv, "?"),
        status_val=sv,
        iter=int(np.asarray(res.iter)[0]),
        obj=float(np.asarray(res.obj_val)[0]) + qp.obj_constant,
        pri_res=float(np.asarray(res.pri_res)[0]),
        dua_res=float(np.asarray(res.dua_res)[0]),
        status_polish=int(np.asarray(res.status_polish)[0]),
        time=time.perf_counter() - t,
        sparse=True,
        x=np.asarray(res.x)[0],
        y=np.asarray(res.y)[0],
    )


def run_maros(
    paths,
    eps: float = 1e-3,
    polish: bool = True,
    single: bool = False,
    max_iter: int = 4000,
    dtype=None,
    fallback_dtype=None,
    shard: tuple[int, int] | None = None,
    verbose: bool = True,
    keep_solutions: bool = False,
    cg_max_iter: int = 0,
    polish_dtype=None,
):
    """Solve a QPS file list; returns (per-problem rows, summary).

    ``fallback_dtype``: problems that fail to solve in the primary dtype
    (e.g. f32 losing to ill-conditioning that Ruiz cannot fix —
    SURVEY.md §7 'hard parts') are retried one-by-one in this dtype
    (typically "float64"); the row gains ``fallback=True``.
    """
    problems = []
    for p in paths:
        qp = load_qps(p)
        problems.append(qp)

    if shard is not None:
        i, k = shard
        order = sorted(range(len(problems)), key=lambda j: -problems[j].n)
        keep = set(order[i::k])
        problems = [p for j, p in enumerate(problems) if j in keep]

    settings = dict(
        eps_abs=eps,
        eps_rel=eps,
        polish=polish,
        max_iter=max_iter,
        verbose=False,
    )
    if polish_dtype is not None:
        # precision-upgraded polish (f64 over an f32 solve) — see
        # polish.polish; requires jax_enable_x64 for float64
        settings["polish_dtype"] = polish_dtype
    if dtype is not None:
        settings["dtype"] = dtype
    if cg_max_iter:
        # bounds the indirect backend's inner loop — long sparse solves
        # with unbounded inner CG can make one device dispatch very
        # long (see large.py max_fused_iters)
        settings["cg_max_iter"] = int(cg_max_iter)

    t0 = time.perf_counter()
    rows = []
    if single:
        from .solver import Solver

        for qp in problems:
            if _route_sparse(qp):
                # densifying these would be multi-GB; same routing as
                # the batched branch
                rows.append(_solve_one_sparse(qp, settings))
                continue
            t = time.perf_counter()
            s = Solver(P=qp.P, q=qp.q, A=qp.A, l=qp.l, u=qp.u, **settings)
            r = s.solve()
            rows.append(
                dict(
                    name=qp.name,
                    n=qp.n,
                    m=qp.m,
                    status=r.info.status,
                    status_val=r.info.status_val,
                    iter=r.info.iter,
                    obj=r.info.obj_val + qp.obj_constant,
                    pri_res=r.info.pri_res,
                    dua_res=r.info.dua_res,
                    status_polish=r.info.status_polish,
                    time=time.perf_counter() - t,
                    x=r.x,
                    y=r.y,
                )
            )
    else:
        # LISWET/CONT-class problems (n or m beyond the dense cutoff)
        # route through the never-densifying sparse path; the rest go
        # through the bucketed dense batch.  Rows stay in input order.
        dense_idx = [
            i for i, qp in enumerate(problems)
            if not _route_sparse(qp)
        ]
        dense_res = solve_problems(
            [
                (problems[i].name, problems[i].P, problems[i].q,
                 problems[i].A, problems[i].l, problems[i].u)
            for i in dense_idx],
            **settings,
        )
        by_idx = dict(zip(dense_idx, dense_res))
        for i, qp in enumerate(problems):
            if i in by_idx:
                r = by_idx[i]
                rows.append(
                    dict(
                        name=r.name,
                        n=r.n,
                        m=r.m,
                        status=con.STATUS_MESSAGE.get(r.status_val, "?"),
                        status_val=r.status_val,
                        iter=r.iter,
                        obj=r.obj_val + qp.obj_constant,
                        pri_res=r.pri_res,
                        dua_res=r.dua_res,
                        status_polish=r.status_polish,
                        time=float("nan"),
                        x=r.x,
                        y=r.y,
                    )
                )
            else:
                rows.append(_solve_one_sparse(qp, settings))
    # f64 (or other) fallback for problems that failed *numerically*.
    # Infeasibility verdicts carry certificates and are final — retrying
    # them would relabel a legitimate detection as a precision issue.
    # Retry anything short of a STRICT status — the inaccurate variants
    # miss the eps criterion by definition, so the f64 fallback should
    # take a crack at them too.
    _final_statuses = _STRICT_FINAL
    if fallback_dtype is not None:
        fb_settings = dict(settings)
        fb_settings["dtype"] = fallback_dtype
        # rows is in problems order in both the single and batched paths.
        # Failures are re-bucketed and re-solved as batches (one device
        # program per shape bucket) rather than one-by-one — fallback
        # wall-clock scales with bucket count, not failure count.
        # Polish failure also escalates: an f32-state solve CANNOT follow
        # the f64 trajectory on stiff equality-heavy problems (CVXQP
        # class) — measured: even the best-possible f32-returned KKT
        # solve (exact solution rounded to f32) floors the dual residual
        # ~8x above the f64 trajectory, because rho_eq = 1e3 rho
        # amplifies the x~ representation rounding through the dual
        # ascent (tools bisect, docs/performance.md round 5).  The
        # reference polishes every solve (polish.c:212); where the f64
        # path demonstrably polishes and f32 cannot, rerunning at f64
        # is the correct accuracy/speed split, and the re-solve is
        # batched per shape bucket like the status fallback below.
        # Effective primary dtype: an explicit ``dtype`` argument, else
        # the Settings default (f64 under x64).  Polish-failure
        # escalation is pointless when the primary solve already ran in
        # the fallback dtype — the retry would repeat the identical
        # solve (the sparse branch has the same guard by construction).
        if dtype is not None:
            _primary = str(dtype)
        else:
            import jax

            _primary = (
                "float64" if jax.config.jax_enable_x64 else "float32"
            )
        _polish_escalates = str(fallback_dtype) != _primary

        def _escalate(r):
            if r["status_val"] not in _final_statuses:
                return True
            # Dense-path polish failures only: sparse rows already ran
            # at f64 (see _solve_one_sparse), so a retry would repeat
            # the identical solve.
            return (
                _polish_escalates
                and bool(settings.get("polish", True))
                and not r.get("sparse")
                and r["status_val"] == con.OSQP_SOLVED
                and r.get("status_polish") == -1
            )

        retry = [
            (i, qp)
            for i, (r, qp) in enumerate(zip(rows, problems))
            if _escalate(r)
        ]
        # Large problems retry through the sparse path too (densifying
        # them in the fallback would defeat the routing).
        retry_sp = [t for t in retry if _route_sparse(t[1])]
        retry = [t for t in retry if not _route_sparse(t[1])]
        if retry_sp:
            from .buckets import fallback_context

            with fallback_context(fallback_dtype):
                for i, qp in retry_sp:
                    row = _solve_one_sparse(qp, fb_settings)
                    row["fallback"] = True
                    if _row_rank(
                        row["status_val"], row.get("status_polish")
                    ) < _row_rank(
                        rows[i]["status_val"], rows[i].get("status_polish")
                    ):
                        continue  # retry came back worse — keep original
                    rows[i] = row
        if retry:
            from .buckets import fallback_context

            with fallback_context(fallback_dtype):
                fb_results = solve_problems(
                    [(qp.name, qp.P, qp.q, qp.A, qp.l, qp.u)
                     for _, qp in retry],
                    **fb_settings,
                )
            for (i, qp), rr in zip(retry, fb_results):
                if _row_rank(rr.status_val, rr.status_polish) < _row_rank(
                    rows[i]["status_val"], rows[i].get("status_polish")
                ):
                    # The f64 retry came back WORSE (e.g. max_iter on a
                    # different trajectory) — keep the original row.
                    continue
                rows[i].update(
                    status=con.STATUS_MESSAGE.get(rr.status_val, "?"),
                    status_val=rr.status_val,
                    iter=rr.iter,
                    obj=rr.obj_val + qp.obj_constant,
                    pri_res=rr.pri_res,
                    dua_res=rr.dua_res,
                    status_polish=rr.status_polish,
                    fallback=True,
                    x=rr.x,
                    y=rr.y,
                )

    if polish:
        # Host-exact polish rescue for dense rows whose DEVICE polish
        # failed: the device uses the masked fixed-shape KKT with a
        # clamped regularization (polish.py, d >= 1e-4 on the Schur
        # path), which is platform-marginal on CVXQP-class problems;
        # polish_host is the reference's true dynamic-shape reduced KKT
        # at delta = 1e-6 (polish.c:212-350) and polishes them
        # deterministically.  Sparse (B=1) rows already polish on the
        # host (large.py); this closes the same gap for the dense path.
        # Polish is setup-class work — one splu per rescued problem.
        # The rescue deliberately runs AFTER the f64 escalation, not
        # instead of it: the f64 re-solve is what restores the
        # reference-oracle iteration trajectory on the CVXQP class
        # (f32 CVXQP1_S runs 9.9x the oracle's count, f64 matches it
        # exactly — PARITY.md), so the retry is paid for parity even
        # when the host polish alone would fix the accuracy.
        from .polish_host import polish_host

        # rows is in problems order on every path (the batched solver
        # and _solve_one_sparse both preserve input order) — pair by
        # position, not by QPS NAME, which need not be unique.
        for r, qp in zip(rows, problems):
            if (
                r["status_val"] == con.OSQP_SOLVED
                and r.get("status_polish") == -1
                and not r.get("sparse")
                and r.get("x") is not None
            ):
                ok, x_p, y_p, obj, pri, dua = polish_host(
                    qp.P, qp.A, qp.q, qp.l, qp.u, r["x"], r["y"],
                    float(r["pri_res"]), float(r["dua_res"]),
                )
                if ok:
                    r.update(
                        status_polish=1,
                        host_polish=True,
                        obj=obj + qp.obj_constant,
                        pri_res=pri,
                        dua_res=dua,
                        x=x_p,
                        y=y_p,
                    )

    if not keep_solutions:
        for r in rows:
            r.pop("x", None)
            r.pop("y", None)

    total_time = time.perf_counter() - t0

    # "final" = a definitive answer: solved, or a correctly-certified
    # infeasibility status (the Maros set and our corpus both contain
    # infeasible instances whose DETECTION is the pass criterion).
    final = (
        con.OSQP_SOLVED,
        con.OSQP_SOLVED_INACCURATE,
        con.OSQP_PRIMAL_INFEASIBLE,
        con.OSQP_PRIMAL_INFEASIBLE_INACCURATE,
        con.OSQP_DUAL_INFEASIBLE,
        con.OSQP_DUAL_INFEASIBLE_INACCURATE,
    )
    solved = sum(
        1
        for r in rows
        if r["status_val"] in (con.OSQP_SOLVED, con.OSQP_SOLVED_INACCURATE)
    )
    finished = sum(1 for r in rows if r["status_val"] in final)
    summary = dict(
        problems=len(rows),
        solved=solved,
        final=finished,
        pass_rate=finished / max(len(rows), 1),
        # polish observability (src/polish.c outcomes across the corpus)
        polish_success=sum(1 for r in rows if r.get("status_polish") == 1),
        polish_fail=sum(1 for r in rows if r.get("status_polish") == -1),
        total_time=total_time,
    )
    if verbose:
        for r in rows:
            print(
                f"{r['name']:<16} n={r['n']:<6} m={r['m']:<6} "
                f"{r['status']:<28} iter={r['iter']:<5} obj={r['obj']:+.6e} "
                f"pri={r['pri_res']:.2e} dua={r['dua_res']:.2e}"
            )
        print(json.dumps(summary))
    return rows, summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="+")
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--no-polish", action="store_true")
    ap.add_argument("--single", action="store_true")
    ap.add_argument("--max-iter", type=int, default=4000)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--fallback-dtype", default=None)
    ap.add_argument("--shard", default=None, help="i/k host shard")
    args = ap.parse_args(argv)

    shard = None
    if args.shard:
        i, k = args.shard.split("/")
        shard = (int(i), int(k))

    paths = collect_paths(args.paths)
    if not paths:
        print("no QPS files found", file=sys.stderr)
        return 1
    _, summary = run_maros(
        paths,
        eps=args.eps,
        polish=not args.no_polish,
        single=args.single,
        max_iter=args.max_iter,
        dtype=args.dtype,
        fallback_dtype=args.fallback_dtype,
        shard=shard,
    )
    return 0 if summary["pass_rate"] == 1.0 else 2


if __name__ == "__main__":
    sys.exit(main())
