"""Heterogeneous-shape QP batching via shape-bucketed padding.

XLA programs have static shapes, so QPs of different (n, m) cannot share
a compiled batch directly.  This module rounds shapes up to buckets
(powers of two), embeds each QP in the padded shape, and scatters the
batched results back.

The padding is *exact*, not approximate:

* extra variables get P = I, q = 0 and appear in no constraint row, so
  their optimum is exactly 0 with zero objective/residual contribution;
* extra constraint rows are all-zero with (-inf, +inf) bounds, which the
  rho classifier treats as loose (auxil.c:82-86) and whose residuals are
  identically zero.

Note: padding changes Ruiz scaling slightly (the cost scalar averages
over padded columns), so iteration counts may differ from an unpadded
solve — solutions agree within tolerances.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np

from .batch import solve_batch
from .constants import (
    OSQP_DUAL_INFEASIBLE,
    OSQP_DUAL_INFEASIBLE_INACCURATE,
    OSQP_INFTY,
    OSQP_PRIMAL_INFEASIBLE,
    OSQP_PRIMAL_INFEASIBLE_INACCURATE,
)


def fallback_context(dtype_str):
    """Context for re-solving failed instances in a wider dtype: enables
    x64 when the process runs f32, so a float64 re-solve runs as float64
    on the default device.  The reference's f64 is unconditional; here
    f32 is the fast path and this is the accuracy escape hatch.  No-op
    for non-64-bit fallbacks or when x64 is already on."""
    from contextlib import ExitStack

    import jax

    st = ExitStack()
    if dtype_str is None or "64" not in str(dtype_str):
        return st
    if not jax.config.jax_enable_x64:
        st.enter_context(jax.enable_x64(True))
    return st


def _next_bucket(v: int, minimum: int = 8) -> int:
    """Powers of two up to 1024, then multiples of 512: doubling a
    n=4224 problem to 8192 wastes ~2x memory and ~4-8x factor FLOPs at
    sizes where both actually matter; fine steps cost only an extra
    compile for shapes that are rare to begin with."""
    b = minimum
    while b < v and b < 1024:
        b *= 2
    if b >= v:
        return b
    return -(-v // 512) * 512


# Per-instance dense device footprint for a padded (N, M) QP:
# P + Minv (N^2 each), A + AMinvT + scaled copies (~4 N M), plus
# transient factor/polish temps of the same order — (3 N^2 + 5 N M)
# words.  One bucket dispatch may use _MEMORY_FRACTION of the memory the
# device reports as its limit (the rest is headroom for the estimate's
# slack, XLA's temporaries and other live arrays).  The CPU backend
# reports no limit; it gets _CPU_BUDGET.  An accelerator that reports no
# limit is an error: a guessed budget either OOMs or starves it.
_MEMORY_FRACTION = 0.25
_CPU_BUDGET = 4e9


def _memory_budget(device=None) -> float:
    """Bytes one bucket dispatch may use on ``device`` (default: this
    process's first device)."""
    import jax

    device = device or jax.local_devices()[0]
    stats = device.memory_stats() or {}
    if "bytes_limit" in stats:
        return _MEMORY_FRACTION * float(stats["bytes_limit"])
    if device.platform == "cpu":
        return _CPU_BUDGET
    raise RuntimeError(
        f"device {device} ({device.platform}) reports no memory limit; "
        "cannot size bucket chunks"
    )


def _max_chunk(N: int, M: int, dtype_bytes: int = 4, device=None) -> int:
    per = (3 * N * N + 5 * N * M) * dtype_bytes
    return max(1, int(_memory_budget(device) / max(per, 1)))


@dataclass
class ProblemResult:
    name: str
    status_val: int
    iter: int
    obj_val: float
    pri_res: float
    dua_res: float
    x: np.ndarray
    y: np.ndarray
    n: int
    m: int
    prim_inf_cert: np.ndarray | None = None  # set on primal-infeasible exits
    dual_inf_cert: np.ndarray | None = None  # set on dual-infeasible exits
    status_polish: int = 0  # polish.c outcome: 0 not run, 1 success, -1 failed


def pad_problem(P, q, A, l, u, N: int, M: int):
    """Embed an (n, m) dense QP into padded (N, M) arrays."""
    n, m = q.shape[0], l.shape[0]
    Pp = np.eye(N)
    Pp[:n, :n] = P
    qp_ = np.zeros(N)
    qp_[:n] = q
    Ap = np.zeros((M, N))
    Ap[:m, :n] = A
    lp = np.full(M, -OSQP_INFTY)
    up = np.full(M, OSQP_INFTY)
    lp[:m] = np.clip(l, -OSQP_INFTY, OSQP_INFTY)
    up[:m] = np.clip(u, -OSQP_INFTY, OSQP_INFTY)
    return Pp, qp_, Ap, lp, up


def solve_problems(
    problems: Sequence[tuple[str, Any, Any, Any, Any, Any]],
    progress: bool = False,
    **settings,
) -> list[ProblemResult]:
    """Solve a list of (name, P, q, A, l, u) QPs of arbitrary shapes.

    P may be scipy sparse upper-triangular or dense symmetric; A scipy
    sparse or dense.  Problems are grouped into shape buckets; each
    bucket is one batched device solve.  Returns results in input order.
    ``progress`` prints one stderr line per bucket dispatch (long runs
    compile one program per bucket — otherwise silent for minutes).
    """
    import scipy.sparse as sp

    from .sparse import to_upper_csc, triu_to_full

    prepared = []
    for idx, (name, P, q, A, l, u) in enumerate(problems):
        q = np.asarray(q, np.float64).ravel()
        n = q.shape[0]
        Pd = triu_to_full(to_upper_csc(P, n))
        Ad = (
            np.asarray(A.todense(), np.float64)
            if sp.issparse(A)
            else np.asarray(A, np.float64)
        )
        l = np.asarray(l, np.float64).ravel()
        u = np.asarray(u, np.float64).ravel()
        prepared.append((idx, name, Pd, q, Ad, l, u))

    buckets: dict[tuple[int, int], list] = defaultdict(list)
    for item in prepared:
        _, _, Pd, q, Ad, l, u = item
        key = (_next_bucket(q.shape[0]), _next_bucket(max(l.shape[0], 1)))
        buckets[key].append(item)

    results: list[ProblemResult | None] = [None] * len(prepared)
    dtype_bytes = _dtype_bytes(settings.get("dtype"))
    for (N, M), all_items in buckets.items():
        chunk = _max_chunk(N, M, dtype_bytes)
        chunks = [
            all_items[i : i + chunk] for i in range(0, len(all_items), chunk)
        ]
        for ci, items in enumerate(chunks):
            if progress:
                import sys
                import time as _time

                print(
                    f"[buckets] ({N}, {M}) chunk {ci + 1}/{len(chunks)} "
                    f"B={len(items)} ...",
                    file=sys.stderr,
                    flush=True,
                )
                t0 = _time.perf_counter()
            _solve_bucket(N, M, items, results, settings)
            if progress:
                print(
                    f"[buckets] ({N}, {M}) chunk {ci + 1}/{len(chunks)} "
                    f"done in {_time.perf_counter() - t0:.1f}s",
                    file=sys.stderr,
                    flush=True,
                )
    return results  # type: ignore[return-value]


def _dtype_bytes(dtype) -> int:
    """Bytes per element of the solve: an explicit ``dtype`` setting,
    else the Settings default (f64 under x64)."""
    import jax

    if dtype is None:
        return 8 if jax.config.jax_enable_x64 else 4
    return np.dtype(dtype).itemsize


def _solve_bucket(N, M, items, results, settings):
    """One batched device solve of a (memory-capped) bucket chunk;
    scatters ProblemResults into ``results`` at the items' indices."""
    Ps, qs, As, ls, us = [], [], [], [], []
    for _, _, Pd, q, Ad, l, u in items:
        Pp, qp_, Ap, lp, up = pad_problem(Pd, q, Ad, l, u, N, M)
        Ps.append(Pp)
        qs.append(qp_)
        As.append(Ap)
        ls.append(lp)
        us.append(up)
    res = solve_batch(
        np.stack(Ps), np.stack(qs), np.stack(As), np.stack(ls), np.stack(us),
        **settings,
    )
    x = np.asarray(res.x)
    y = np.asarray(res.y)
    sv = np.asarray(res.status_val)
    it = np.asarray(res.iter)
    obj = np.asarray(res.obj_val)
    pri = np.asarray(res.pri_res)
    dua = np.asarray(res.dua_res)
    pic = np.asarray(res.prim_inf_cert)
    dic = np.asarray(res.dual_inf_cert)
    spol = np.asarray(res.status_polish)
    _PINF = (OSQP_PRIMAL_INFEASIBLE, OSQP_PRIMAL_INFEASIBLE_INACCURATE)
    _DINF = (OSQP_DUAL_INFEASIBLE, OSQP_DUAL_INFEASIBLE_INACCURATE)
    for b, (idx, name, Pd, q, Ad, l, u) in enumerate(items):
        n, m = q.shape[0], l.shape[0]
        results[idx] = ProblemResult(
            name=name,
            status_val=int(sv[b]),
            iter=int(it[b]),
            obj_val=float(obj[b]),
            pri_res=float(pri[b]),
            dua_res=float(dua[b]),
            x=x[b, :n],
            y=y[b, :m],
            n=n,
            m=m,
            prim_inf_cert=pic[b, :m] if int(sv[b]) in _PINF else None,
            dual_inf_cert=dic[b, :n] if int(sv[b]) in _DINF else None,
            status_polish=int(spol[b]),
        )
