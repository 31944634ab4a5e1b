"""Locate the cg-vs-dense crossover in problem size n (docs/performance.md).

Sweeps banded QPs (nnz ~ 5/row) over n at small batch and times three
configurations of the same problems:

* ``dense_inv``  — dense operands, explicit-inverse backend (default);
* ``cg-dense``   — dense operands, matrix-free CG backend with the
  adaptive inexact tolerance schedule;
* ``cg-ell``     — ELL sparse operands through ``solve_sparse`` (never
  densifies; the large-n path).

Run on the card:  python tools/bench_cg_crossover.py [--out FILE]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import scipy.sparse as sp


def banded_qp(n, seed, band=2):
    """Banded SPD P (bandwidth 2), banded A with m = n rows + bounds."""
    rng = np.random.default_rng(seed)
    diags = [rng.standard_normal(n - abs(k)) * 0.3 for k in range(1, band + 1)]
    P = sp.diags(
        [np.abs(rng.standard_normal(n)) + 1.0]
        + diags
        + [d.copy() for d in diags],
        [0] + list(range(1, band + 1)) + [-k for k in range(1, band + 1)],
        format="csr",
    )
    P = (P + P.T) * 0.5
    # Make diagonally dominant => PD
    P = P + sp.diags(np.abs(P).sum(axis=1).A1 + 0.1)
    A = sp.diags(
        [np.ones(n), 0.5 * np.ones(n - 1)], [0, -1], shape=(n, n), format="csr"
    )
    q = rng.standard_normal(n)
    x0 = rng.standard_normal(n)
    Ax = A @ x0
    s = np.abs(rng.standard_normal(n)) + 0.1
    return P, q, A, Ax - s, Ax + s


def run_mode(mode, P, q, A, l, u, B, reps=2):
    import jax
    import jax.numpy as jnp

    from osqp_tpu import solve_sparse
    from osqp_tpu.batch import solve_batch

    kw = dict(eps_abs=1e-3, eps_rel=1e-3, polish=False, verbose=False,
              dtype="float32")
    qB = np.broadcast_to(q, (B,) + q.shape)
    lB = np.broadcast_to(l, (B,) + l.shape)
    uB = np.broadcast_to(u, (B,) + u.shape)

    if mode == "cg-ell":
        fn = lambda: jax.block_until_ready(solve_sparse(P, qB, A, lB, uB, **kw))
    else:
        Pd = jnp.asarray(
            np.broadcast_to(P.toarray(), (B,) + P.shape), jnp.float32
        )
        Ad = jnp.asarray(
            np.broadcast_to(A.toarray(), (B,) + A.shape), jnp.float32
        )
        args = [Pd, jnp.asarray(qB, jnp.float32), Ad,
                jnp.asarray(lB, jnp.float32), jnp.asarray(uB, jnp.float32)]
        backend = "dense_inv" if mode == "dense_inv" else "cg"
        fn = lambda: jax.block_until_ready(
            solve_batch(*args, linsys_solver=backend, **kw))

    res = fn()  # compile
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = fn()
        ts.append(time.perf_counter() - t0)
    solved = float(np.mean(np.isin(np.asarray(res.status_val), (1, 2))))
    return dict(time=float(np.median(ts)), solved=solved,
                mean_iters=float(np.asarray(res.iter).mean()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", default="128,256,512,1024,2048,4096")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dense-max", type=int, default=4096,
                    help="largest n to attempt with dense operands")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    rows = []
    for n in (int(d) for d in args.dims.split(",")):
        P, q, A, l, u = banded_qp(n, seed=n)
        row = {"n": n, "m": n, "B": args.batch}
        for mode in ("dense_inv", "cg-dense", "cg-ell"):
            if mode != "cg-ell" and n > args.dense_max:
                continue
            row[mode] = run_mode(mode, P, q, A, l, u, args.batch)
            print(f"n={n:<6} {mode:<10} {row[mode]}", flush=True)
        rows.append(row)

    d = jax.devices()[0]
    out = {"platform": d.platform, "device": d.device_kind, "rows": rows}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
