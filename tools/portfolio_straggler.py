"""Diagnose portfolio-bench stragglers: solve each instance with the host
reference-parity oracle (tools/ref_osqp.py) and compare iteration counts
with the batched device path's per-instance counts."""
import sys
sys.path.insert(0, "/root/repo")
sys.path.insert(0, "/root/repo/tools")
import numpy as np
import scipy.sparse as sp
from osqp_tpu.models import build_portfolio
import ref_osqp

n, k = 500, 50
rng = np.random.default_rng(0)
iters = []
for b in range(32):
    mu = rng.standard_normal(n)
    F = rng.standard_normal((n, k)) / np.sqrt(k)
    D = np.abs(rng.standard_normal(n)) * np.sqrt(k)
    P, q, A, l, u = build_portfolio(mu, F, D, gamma=1.0)
    out = ref_osqp.ref_solve(sp.csc_matrix(P), q, sp.csc_matrix(A), l, u,
                             eps_abs=1e-3, eps_rel=1e-3, max_iter=4000,
                             do_polish=False, interval="fixed")
    it = out["iter"]
    st = out["status"]
    iters.append(it)
    print(f"inst {b}: ref iters={it} status={st}", flush=True)
iters = np.array(iters)
print("ref: mean", iters.mean(), "p50", np.percentile(iters, 50), "max", iters.max())
