"""Timings that decided the GPU bring-up choices (PERF.md, "Bring-up
findings").  One process, one card; every timing is warm and ends in
``block_until_ready``.

    python tools/bringup_timings.py [--parent DIR] [--out FILE]

* factor: the explicit SPD inverse of ``linalg.spd_inverse`` (batched
  Cholesky + triangular solve) against the recursive GEMM-only blocked
  Cholesky it replaced, loaded from ``DIR/osqp_tpu/ops/spd_inverse.py``
  (``git archive 9234f8a osqp_tpu | tar -x -C DIR``), at B=8192 n=100 f32 and at
  the polish Schur sizes B=1 n=2048/8192 in f32 and f64; plus the
  headline batch end to end with each factor;
* gemv: the ADMM loop's per-iteration time (two-point fixed-iteration
  slope) with the broadcast-multiply-reduce GEMVs over a transposed
  ``AMinvT`` against ``einsum(precision="highest")`` over an
  untransposed ``A M^-1``, at B=8192 n=100 m=200 f32;
* polish: the polish KKT solver's batched LU against its SPD Schur path
  (factor + one solve, B=1) at KKT dims 1024-8192 in f32 and f64;
* trace: device busy/idle share of one warm ``solve_sparse`` (banded
  n = m = 1e5, polish on) from a profiler trace.

Without ``--parent`` the factor comparison times the current path only.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

HEADLINE = (8192, 100, 200)  # B, n, m
FACTOR_CASES = ((8192, 100, "float32"), (1, 2048, "float32"),
                (1, 2048, "float64"), (1, 8192, "float32"),
                (1, 8192, "float64"))  # B, n, dtype
POLISH_KKT_DIMS = (1024, 2048, 4096, 8192)
SPARSE_N = 100_000


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "no nvidia-smi"


def _time(fn, *args, reps=7):
    """Median warm seconds of fn(*args) (after one compile call)."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _spd(B, n, dtype, seed=0):
    import jax
    import jax.numpy as jnp

    k = jax.random.PRNGKey(seed)
    G = jax.random.normal(k, (B, n, n), dtype)
    hi = jax.jit(lambda g: jnp.einsum("bij,bkj->bik", g, g,
                                      precision="highest") / n
                 + 0.1 * jnp.eye(n, dtype=dtype))
    return jax.block_until_ready(hi(G))


def _load_recursive(parent):
    path = os.path.join(parent, "osqp_tpu", "ops", "spd_inverse.py")
    spec = importlib.util.spec_from_file_location("parent_spd_inverse", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.spd_inverse


def factor_timings(parent):
    import jax
    import jax.numpy as jnp

    from osqp_tpu.linalg import spd_inverse, with_high_precision

    impls = {"cholesky": spd_inverse}
    if parent:
        impls["recursive"] = _load_recursive(parent)
    rows = []
    for B, n, dt in FACTOR_CASES:
        M = _spd(B, n, jnp.dtype(dt))
        for name, f in impls.items():
            fn = jax.jit(with_high_precision(f))
            t = _time(fn, M, reps=5)
            X = fn(M)
            R = jnp.max(jnp.abs(jnp.eye(n, dtype=M.dtype) - jnp.einsum(
                "bij,bjk->bik", M, X, precision="highest")))
            rows.append(dict(B=B, n=n, dtype=dt, impl=name, ms=t * 1e3,
                             resid=float(R)))
            print(json.dumps(rows[-1]), flush=True)
    return rows


def _headline_data():
    import jax
    import jax.numpy as jnp

    from bench import make_qps

    return [jax.device_put(jnp.asarray(v)) for v in make_qps(*HEADLINE)]


def _with_variant(patch, fn):
    """Run fn() with dense_inv attributes patched; jit caches are
    cleared on both sides so each variant traces its own program."""
    import jax

    from osqp_tpu.linsys import dense_inv

    saved = {k: getattr(dense_inv, k) for k in patch}
    jax.clear_caches()
    for k, v in patch.items():
        setattr(dense_inv, k, v)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            setattr(dense_inv, k, v)
        jax.clear_caches()


def headline_factor_e2e(parent, data):
    """Headline solve_batch warm time with each factor path."""
    from osqp_tpu.batch import solve_batch

    kw = dict(dtype="float32", eps_abs=1e-3, eps_rel=1e-3, polish=False,
              verbose=False)
    run = lambda: _time(lambda: solve_batch(*data, **kw), reps=5)
    out = {"cholesky": run()}
    if parent:
        out["recursive"] = _with_variant(
            {"spd_inverse": _load_recursive(parent)}, run)
    print(json.dumps({"headline_e2e_s": out}), flush=True)
    return out


def _einsum_variant():
    import jax.numpy as jnp

    from osqp_tpu.linsys import dense_inv

    base_init, base_solve = dense_inv.init, dense_inv.solve

    def init(P, A, sigma, rho_vec, **kw):
        f = base_init(P, A, sigma, rho_vec, **kw)
        f["AMinv"] = jnp.swapaxes(f.pop("AMinvT"), -1, -2)
        return f

    def solve(factor, A, rho_vec, rhs_x, rhs_z, x0=None, refine=False):
        if refine:
            f = dict(factor, AMinvT=jnp.swapaxes(factor["AMinv"], -1, -2))
            return base_solve(f, A, rho_vec, rhs_x, rhs_z, x0, refine)
        t = rhs_x + jnp.einsum("bmn,bm->bn", A, rho_vec * rhs_z,
                               precision="highest")
        x = jnp.einsum("bij,bj->bi", factor["Minv"], t, precision="highest")
        z = jnp.einsum("bmn,bn->bm", factor["AMinv"], t, precision="highest")
        return x, z

    return {"init": init, "solve": solve}


def gemv_timings(data):
    from osqp_tpu.batch import solve_batch

    kw = dict(dtype="float32", verbose=False, polish=False,
              check_termination=0, adaptive_rho=False)

    def slope():
        t = {it: _time(lambda: solve_batch(*data, max_iter=it, **kw), reps=5)
             for it in (16, 64)}
        return (t[64] - t[16]) / 48.0

    out = {}
    for rnd in range(2):  # A B B A
        for name in (("reduce", "einsum") if rnd == 0 else ("einsum", "reduce")):
            s = slope() if name == "reduce" else _with_variant(_einsum_variant(), slope)
            out.setdefault(name, []).append(s * 1e3)
            print(json.dumps({"gemv": name, "ms_per_iter": s * 1e3}), flush=True)
    # unpadded bytes per iteration: Minv (n^2) + AMinvT (n m) + A (m n) f32
    B, n, m = HEADLINE
    bytes_iter = B * (n * n + 2 * n * m) * 4
    for name, v in out.items():
        ms = float(np.median(v))
        print(json.dumps({"gemv": name, "median_ms_per_iter": ms,
                          "GB_per_s": bytes_iter / (ms * 1e-3) / 1e9}), flush=True)
    return out


def polish_timings():
    import jax
    import jax.numpy as jnp

    import osqp_tpu.polish as polish_mod
    from osqp_tpu.linalg import with_high_precision

    rows = []
    saved = polish_mod._SCHUR_KKT_DIM
    try:
        for dim in POLISH_KKT_DIMS:
            n = m = dim // 2
            for dt in ("float32", "float64"):
                dtype = jnp.dtype(dt)
                P = _spd(1, n, dtype, seed=1)
                key = jax.random.PRNGKey(2)
                MA = jax.random.normal(key, (1, m, n), dtype) / float(np.sqrt(n))
                rhs = jax.random.normal(key, (1, n + m), dtype)
                for path, thresh in (("lu", 1 << 30), ("schur", 0)):
                    polish_mod._SCHUR_KKT_DIM = thresh

                    def fs(P, MA, rhs):
                        solve = polish_mod._make_kkt_solver(
                            n, m, P, MA, jnp.asarray(1e-6, dtype), dtype)
                        return solve(rhs)

                    fn = jax.jit(with_high_precision(fs))
                    t = _time(fn, P, MA, rhs, reps=3)
                    rows.append(dict(kkt_dim=dim, dtype=dt, path=path,
                                     ms=t * 1e3))
                    print(json.dumps(rows[-1]), flush=True)
    finally:
        polish_mod._SCHUR_KKT_DIM = saved
    return rows


def trace_sparse(outdir):
    """Device busy / idle share of one warm solve_sparse from a trace."""
    import jax

    import osqp_tpu
    from bench import banded_qp

    P, q, A, l, u = banded_qp(SPARSE_N)
    run = lambda: osqp_tpu.solve_sparse(P, q, A, l, u, eps_abs=1e-3,
                                        eps_rel=1e-3, polish=True, verbose=False)
    jax.block_until_ready(run())
    tdir = os.path.join(outdir, "trace_sparse")
    t0 = time.perf_counter()
    with jax.profiler.trace(tdir):
        jax.block_until_ready(run())
    wall = time.perf_counter() - t0
    return dict(wall_s=wall, **reduce_trace(tdir))


def reduce_trace(tdir):
    """Busy = union of the device's kernel intervals (stream lines of
    the GPU planes) over the traced window."""
    import glob

    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    pd = ProfileData.from_file(path)
    lines = {}
    intervals = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = [(e.start_ns, e.start_ns + e.duration_ns) for e in line.events]
            lines[f"{plane.name}|{line.name}"] = len(evs)
            if line.name.startswith("Stream"):
                intervals += evs
    if not intervals:
        return dict(lines=lines, busy_share=None)
    intervals.sort()
    busy, cur_s, cur_e = 0, *intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = intervals[-1][1] - intervals[0][0]
    return dict(lines=lines, kernels=len(intervals), window_ms=window / 1e6,
                busy_ms=busy / 1e6, idle_share=1.0 - busy / window)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--out", default=os.path.join(REPO, "results",
                                                  "bringup_timings.json"))
    ap.add_argument("--only", default="factor,e2e,gemv,polish,trace")
    args = ap.parse_args()

    import jax

    from osqp_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    # f64 cases need x64; the f32 solves pass dtype="float32" explicitly.
    jax.config.update("jax_enable_x64", True)
    card = _card()
    print(card, jax.devices(), flush=True)
    only = set(args.only.split(","))
    res = dict(card=card, device_kind=jax.devices()[0].device_kind)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    if "factor" in only:
        res["factor"] = factor_timings(args.parent)
    if {"e2e", "gemv"} & only:
        data = _headline_data()
        if "e2e" in only:
            res["headline_e2e_s"] = headline_factor_e2e(args.parent, data)
        if "gemv" in only:
            res["gemv_ms_per_iter"] = gemv_timings(data)
        del data
    if "polish" in only:
        res["polish"] = polish_timings()
    if "trace" in only:
        res["trace_sparse"] = trace_sparse(os.path.dirname(args.out))
        print(json.dumps(res["trace_sparse"]), flush=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(f"-> {args.out}  [{card}]", flush=True)


if __name__ == "__main__":
    main()
