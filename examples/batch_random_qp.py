"""Thousands of QPs in one compiled program — the batched headline.

The reference solves one QP per process; here a single jitted program
scales, classifies rho, factorizes, runs the masked ADMM loop, polishes
and unscales B instances at once (see SURVEY.md §2 'Parallelism')."""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax

from osqp_tpu.batch import solve_batch


def main():
    rng = np.random.default_rng(3)
    B, n, m = 2048, 50, 100
    M = rng.standard_normal((B, n, n)).astype(np.float32)
    P = np.einsum("bij,bkj->bik", M, M) / n + 0.1 * np.eye(n, dtype=np.float32)
    q = rng.standard_normal((B, n)).astype(np.float32)
    A = rng.standard_normal((B, m, n)).astype(np.float32) / np.sqrt(n)
    x0 = rng.standard_normal((B, n)).astype(np.float32)
    Ax = np.einsum("bmn,bn->bm", A, x0)
    l = Ax - np.abs(rng.standard_normal((B, m))).astype(np.float32) - 0.1
    u = Ax + np.abs(rng.standard_normal((B, m))).astype(np.float32) + 0.1

    res = solve_batch(P, q, A, l, u, dtype="float32", verbose=False)
    jax.block_until_ready(res.status_val)
    t0 = time.perf_counter()
    res = solve_batch(P, q, A, l, u, dtype="float32", verbose=False)
    jax.block_until_ready(res.status_val)
    dt = time.perf_counter() - t0

    status = np.asarray(res.status_val)
    print(f"solved {np.mean(status == 1):.3f} of {B} QPs in {dt:.3f}s "
          f"({B/dt:,.0f} QPs/s)")
    print(f"mean iters: {np.mean(np.asarray(res.iter)):.1f}")


if __name__ == "__main__":
    main()
