"""Throughput benchmark: batched small-QP solves per second per card.

Headline: random strictly-convex QPs of the n=100 / m=200 class, B=8192
instances on one GPU, solved to eps_abs = eps_rel = 1e-3 (reference
defaults, constants.h:61-62).  Prints ONE JSON line on stdout.

BENCH_CONFIGS=all additionally runs, in the same process, the portfolio
leg (n=500 with warm-started parametric updates), the MPC scenario batch
(1000 instances, horizon 30, block_tridiag and dense_inv backends) and
the ADMM loop's HBM-roofline leg, and prints their JSON lines to stderr.

Every line names the platform, device kind, device count and the card's
name and power limit.  Every timing ends in ``block_until_ready``.  The
benchmark needs a GPU: on any other platform it raises.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# Peak HBM bandwidth by JAX device_kind (bytes/s).  Source: NVIDIA H100
# Tensor Core GPU datasheet (SXM5 80 GB HBM3: 3.35 TB/s).  A device that
# is not in the table is an error, not a default.
PEAK_HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def gpu_identity() -> str:
    """``name, power.limit`` of the first card, from nvidia-smi in a
    child process that does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0].strip()


def device_fields() -> dict:
    """platform / device_kind / device count of this process, plus the
    card's name and power limit; raises unless the device is a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"bench.py measures a GPU; JAX's first device is {devs[0].platform}"
        )
    return dict(platform=devs[0].platform, device_kind=devs[0].device_kind,
                device_count=len(devs), card=gpu_identity())


def make_qps(B, n, m, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n)).astype(dtype)
    P = M @ np.swapaxes(M, 1, 2) / n + 0.1 * np.eye(n, dtype=dtype)
    q = rng.standard_normal((B, n)).astype(dtype)
    A = rng.standard_normal((B, m, n)).astype(dtype) / np.sqrt(n)
    xr = rng.standard_normal((B, n)).astype(dtype)
    Ax = (A @ xr[:, :, None])[:, :, 0]
    spread = np.abs(rng.standard_normal((B, m))).astype(dtype)
    l = Ax - spread - 0.1
    u = Ax + spread + 0.1
    return P, q, A, l, u


def make_portfolio(B, n=500, k=50, seed=0):
    """B factor-model portfolio QPs (n assets, k factors, nv = n + k),
    stacked (P, q, A, l, u) in f64."""
    from osqp_tpu.models import build_portfolio

    rng = np.random.default_rng(seed)
    probs = []
    for _ in range(B):
        mu = rng.standard_normal(n)
        F = rng.standard_normal((n, k)) / np.sqrt(k)
        D = np.abs(rng.standard_normal(n)) * np.sqrt(k)
        probs.append(build_portfolio(mu, F, D, gamma=1.0))
    return tuple(np.stack(v) for v in zip(*probs))


def make_mpc(B, nx=8, nu=4, N=30, seed=0):
    """MPC scenario batch: one horizon-N OCP (same dynamics) with a
    per-scenario initial state.  Returns (base MPCProblem, l, u); P, q
    and A are base's, shared by every scenario."""
    from osqp_tpu.models import build_mpc_qp

    rng = np.random.default_rng(seed)
    Ad = np.eye(nx) + 0.05 * rng.standard_normal((nx, nx)) / np.sqrt(nx)
    Bd = rng.standard_normal((nx, nu)) / np.sqrt(nx)
    base = build_mpc_qp(
        Ad, Bd, np.eye(nx), 0.1 * np.eye(nu), horizon=N,
        xmin=np.full(nx, -10.0), xmax=np.full(nx, 10.0),
        umin=np.full(nu, -1.0), umax=np.full(nu, 1.0),
    )
    xinits = rng.standard_normal((B, nx))
    l = np.broadcast_to(base.l, (B,) + base.l.shape).copy()
    u = np.broadcast_to(base.u, (B,) + base.u.shape).copy()
    l[:, :nx] = xinits
    u[:, :nx] = xinits
    return base, l, u


def banded_qp(n, seed=0):
    """Banded sparse QP with n = m (tridiagonal P, three-band A) — the
    large single-QP workload of chip_smoke.py and
    tools/bench_large_sparse.py."""
    import scipy.sparse as sp

    m = n
    main = 2.0 + (np.arange(n) % 5) * 0.3
    P = sp.diags([np.full(n - 1, -0.7), main, np.full(n - 1, -0.7)],
                 [-1, 0, 1], format="csc")
    rng = np.random.default_rng(seed)
    A = sp.diags([np.ones(m), -0.5 * np.ones(m - 1), 0.25 * np.ones(m - 2)],
                 [0, 1, 2], shape=(m, n), format="csc")
    q = rng.standard_normal(n)
    Ax = A @ rng.standard_normal(n)
    l = Ax - np.abs(rng.standard_normal(m)) - 0.1
    u = Ax + np.abs(rng.standard_normal(m)) + 0.1
    return P, q, A, l, u


def _ready(res):
    import jax

    return jax.block_until_ready(res)


def bench_portfolio(reps=3):
    """Portfolio family, n=500 assets (factor model,
    k=50 -> nv=550), B instances, K warm-started parametric re-solves
    with new expected returns (the reference's update/re-solve loop,
    osqp.c:765-795, at batch scale)."""
    import jax
    import jax.numpy as jnp

    from osqp_tpu.parametric import BatchedSolver

    B = int(os.environ.get("BENCH_PF_BATCH", "256"))
    K = int(os.environ.get("BENCH_PF_UPDATES", "8"))
    P, q, A, l, u = make_portfolio(B)
    nv = q.shape[1]
    bs = BatchedSolver(
        P, q, A, l, u, dtype="float32", eps_abs=1e-3, eps_rel=1e-3,
        polish=False, verbose=False,
    )
    res = _ready(bs.solve())  # compile + cold solve
    q_new = jnp.asarray(q, jnp.float32)

    # stage the K cost vectors on device up front (don't measure upload)
    q_news = [
        jax.device_put(q_new * (1.0 + 0.01 * (j + 1))) for j in range(K)
    ]
    _ready(bs.resolve(q=q_news[0]))  # compile the fused resolve program

    t0 = time.perf_counter()
    total_iters = 0
    for j in range(K):
        # new expected returns -> new linear cost, warm-started re-solve
        # (ONE fused device program per re-solve, parametric._resolve_jit)
        res = _ready(bs.resolve(q=q_news[j]))
        total_iters += int(np.asarray(res.iter).sum())
    dt = time.perf_counter() - t0
    solved = float(np.mean(np.asarray(res.status_val) == 1))
    qps = B * K / dt
    return {
        "metric": f"portfolio_parametric_n{nv}_B{B}",
        "value": qps,
        "unit": "QPs/s/card (warm-started re-solves)",
        "iters_per_sec": total_iters / dt,
        "solved": solved,
    }


def bench_roofline():
    """HBM-roofline share of the hot ADMM loop (the memory-bound analogue
    of MFU).  Two fixed-iteration runs (termination checks off) isolate
    the per-iteration slope.  Traffic model: each iteration streams
    Minv (n^2) + (Minv A')' (n m) + A (m n) f32 per instance, unpadded;
    the denominator is the device's peak HBM bandwidth
    (PEAK_HBM_BYTES_PER_S)."""
    import jax
    import jax.numpy as jnp

    from osqp_tpu.batch import solve_batch

    kind = jax.devices()[0].device_kind
    if kind not in PEAK_HBM_BYTES_PER_S:
        raise KeyError(f"no peak HBM bandwidth recorded for {kind!r}")
    peak = PEAK_HBM_BYTES_PER_S[kind]
    B, n, m = 8192, 100, 200
    data = [jax.device_put(jnp.asarray(v)) for v in make_qps(B, n, m)]
    kw = dict(dtype="float32", verbose=False, polish=False,
              check_termination=0, adaptive_rho=False)
    times = {}
    for it in (16, 64):
        _ready(solve_batch(*data, max_iter=it, **kw))  # compile
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            _ready(solve_batch(*data, max_iter=it, **kw))
            ts.append(time.perf_counter() - t0)
        times[it] = float(np.median(ts))
    slope = (times[64] - times[16]) / 48.0
    bytes_per_iter = (n * n + 2 * n * m) * 4 * B
    rate = bytes_per_iter / slope
    return {
        "metric": "admm_loop_hbm_roofline",
        "value": rate / peak,
        "unit": f"fraction of {peak / 1e12:.2f} TB/s peak HBM bandwidth",
        "ms_per_iter": slope * 1e3,
        "gb_per_s": rate / 1e9,
        "model": f"{bytes_per_iter // B} B/instance/iter (Minv+AMinvT+A, "
                 f"unpadded f32), B={B} n={n} m={m}",
    }


def bench_mpc(reps=2):
    """MPC scenario batch — 1000 OCP instances,
    horizon N=30, block-banded KKT via the block_tridiag backend
    (O(N b^3) factorization), vs the dense dense_inv backend."""
    import jax
    import jax.numpy as jnp

    from osqp_tpu.batch import solve_batch

    B = int(os.environ.get("BENCH_MPC_BATCH", "1000"))
    N = 30
    base, l, u = make_mpc(B, N=N)
    P = np.broadcast_to(base.P, (B,) + base.P.shape)
    q = np.broadcast_to(base.q, (B,) + base.q.shape)
    A = np.broadcast_to(base.A, (B,) + base.A.shape)

    out = {}
    stage = [jax.device_put(jnp.asarray(v, jnp.float32)) for v in (P, q, A, l, u)]
    for backend, kw in (
        ("block_tridiag", dict(block_size=base.block_size)),
        ("dense_inv", {}),
    ):
        kwargs = dict(
            dtype="float32", eps_abs=1e-3, eps_rel=1e-3, polish=False,
            verbose=False, linsys_solver=backend, **kw,
        )
        res = _ready(solve_batch(*stage, **kwargs))  # compile
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            res = _ready(solve_batch(*stage, **kwargs))
            ts.append(time.perf_counter() - t0)
        dt = min(ts)
        iters = np.asarray(res.iter)
        out[backend] = dict(
            time=dt,
            qps=B / dt,
            iters_per_sec=float(iters.sum()) / dt,
            solved=float(np.mean(np.asarray(res.status_val) == 1)),
            mean_iters=float(iters.mean()),
        )
    nv = base.P.shape[0]
    return {
        "metric": f"mpc_scenario_batch_B{B}_N{N}_nv{nv}",
        "value": out["block_tridiag"]["qps"],
        "unit": "QPs/s/card",
        "backends": out,
    }


def main():
    import jax

    from osqp_tpu.utils.cache import enable_compile_cache

    dev = device_fields()
    enable_compile_cache()
    # x64 so dense_inv's f64-residual refinement is available to the
    # portfolio leg; every leg passes dtype="float32" explicitly.
    jax.config.update("jax_enable_x64", True)

    B = int(os.environ.get("BENCH_BATCH", "8192"))
    n = int(os.environ.get("BENCH_N", "100"))
    m = int(os.environ.get("BENCH_M", "200"))
    reps = int(os.environ.get("BENCH_REPS", "5"))

    import jax.numpy as jnp

    from osqp_tpu.batch import solve_batch

    # Stage problem data on device once — the metric is solver throughput
    # per card, not host-link upload bandwidth.
    P, q, A, l, u = (
        jax.device_put(jnp.asarray(v, jnp.float32)) for v in make_qps(B, n, m)
    )
    kwargs = dict(dtype="float32", verbose=False, polish=False,
                  eps_abs=1e-3, eps_rel=1e-3)
    if os.environ.get("BENCH_COMPACT", "0") == "1":
        kwargs["compact"] = True
        kwargs["min_compact_batch"] = int(
            os.environ.get("BENCH_COMPACT_MIN", "512")
        )

    res = _ready(solve_batch(P, q, A, l, u, **kwargs))  # compile + warm up
    solved = float(np.mean(np.asarray(res.status_val) == 1))
    iters = np.asarray(res.iter)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _ready(solve_batch(P, q, A, l, u, **kwargs))
        times.append(time.perf_counter() - t0)
    qps_all = sorted(B / t for t in times)
    print(
        f"# {dev['card']} B={B} n={n} m={m} solved={solved:.3f} "
        f"mean_iters={iters.mean():.2f} max_iters={iters.max()} "
        f"time_min={min(times):.4f}s reps={reps}",
        file=sys.stderr,
    )
    headline = dict(
        metric=f"batched_qp_throughput_n{n}_m{m}",
        value=B / min(times),
        unit="QPs/s/card",
        median=float(np.median(qps_all)),
        reps=reps,
        qps_all=qps_all,
        solved=solved,
        mean_iters=float(iters.mean()),
        **dev,
    )

    if os.environ.get("BENCH_CONFIGS", "") == "all":
        for fn in (bench_portfolio, bench_mpc, bench_roofline):
            print("# " + json.dumps(dict(fn(), **dev)), file=sys.stderr,
                  flush=True)

    print(json.dumps(headline))


if __name__ == "__main__":
    main()
