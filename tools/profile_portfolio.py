"""Profile the portfolio parametric re-solve path on the card: per-resolve
wall, iteration distribution (stragglers), and a solve_core-only timing."""
import os, sys, time
sys.path.insert(0, "/root/repo")
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax, jax.numpy as jnp
from osqp_tpu.models import build_portfolio
from osqp_tpu.parametric import BatchedSolver
from osqp_tpu.utils.cache import enable_compile_cache

enable_compile_cache()
B = int(os.environ.get("B", "256"))
n, k = 500, 50
rng = np.random.default_rng(0)
Ps, qs, As, ls, us = [], [], [], [], []
for _ in range(B):
    mu = rng.standard_normal(n)
    F = rng.standard_normal((n, k)) / np.sqrt(k)
    D = np.abs(rng.standard_normal(n)) * np.sqrt(k)
    P, q, A, l, u = build_portfolio(mu, F, D, gamma=1.0)
    Ps.append(P), qs.append(q), As.append(A), ls.append(l), us.append(u)
t0 = time.perf_counter()
bs = BatchedSolver(
    np.stack(Ps), np.stack(qs), np.stack(As), np.stack(ls), np.stack(us),
    dtype="float32", eps_abs=1e-3, eps_rel=1e-3, polish=False, verbose=False,
)
print(f"setup {time.perf_counter()-t0:.2f}s", flush=True)
t0 = time.perf_counter()
res = bs.solve()
np.asarray(res.status_val)
it = np.asarray(res.iter)
print(f"cold solve {time.perf_counter()-t0:.2f}s iters mean={it.mean():.0f} max={it.max()} solved={np.mean(np.asarray(res.status_val)==1):.3f}", flush=True)
q_new = jnp.asarray(np.stack(qs), jnp.float32)
q_news = [jax.device_put(q_new * (1.0 + 0.01 * (j + 1))) for j in range(8)]
t0 = time.perf_counter()
res = bs.resolve(q=q_news[0]); np.asarray(res.status_val)
print(f"resolve compile+run {time.perf_counter()-t0:.2f}s", flush=True)
for j in range(8):
    t0 = time.perf_counter()
    res = bs.resolve(q=q_news[j])
    np.asarray(res.status_val)
    dt = time.perf_counter() - t0
    it = np.asarray(res.iter)
    st = np.asarray(res.status_val)
    print(f"resolve[{j}] {dt:.3f}s iters mean={it.mean():.0f} p50={np.percentile(it,50):.0f} p95={np.percentile(it,95):.0f} max={it.max()} solved={np.mean(st==1):.3f}", flush=True)
