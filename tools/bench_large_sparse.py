"""Large-sparse scale benchmark: one banded QP at n = m in {30k, 100k}
solved end-to-end on the default device through the duration-adaptive
segmented driver, each result independently f64-KKT-verified on the
host (sparse checker).

The n = 1e5 size is the EXDATA/CONT-300 class the reference's sparse
LDL handles; dense layouts stop fitting device memory at a few
thousand, so this exercises the never-densifying ELL path
(osqp_tpu/large.py, sparse_ops.py) at the scale it exists for.
The problem is :func:`bench.banded_qp`, also chip_smoke.py's phase 7.

Usage: python tools/bench_large_sparse.py [--out results/scale.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=str,
                    default=os.path.join("results", "scale.json"))
    ap.add_argument("--sizes", type=str, default="30000,100000")
    args = ap.parse_args()

    import jax

    import osqp_tpu
    from bench import banded_qp
    from osqp_tpu.utils.cache import enable_compile_cache
    from osqp_tpu.verify import kkt_check

    enable_compile_cache()
    rows = []
    for n in (int(s) for s in args.sizes.split(",")):
        P, q, A, l, u = banded_qp(n)
        walls = []
        for rep in range(2):  # cold (compile+probe) then warm
            t0 = time.perf_counter()
            res = jax.block_until_ready(osqp_tpu.solve_sparse(
                P, q, A, l, u, eps_abs=1e-3, eps_rel=1e-3,
                max_iter=10000, polish=True, verbose=False,
            ))
            walls.append(time.perf_counter() - t0)
        x = np.asarray(res.x)[0]
        y = np.asarray(res.y)[0]
        chk = kkt_check(P, q, A, l, u, x, y, eps_abs=1e-3, eps_rel=1e-3)
        rows.append(dict(
            n=n, m=n,
            status=int(np.asarray(res.status_val)[0]),
            iter=int(np.asarray(res.iter)[0]),
            status_polish=int(np.asarray(res.status_polish)[0]),
            wall_s=walls[0],
            wall_warm_s=walls[1],
            compile_probe_s=walls[0] - walls[1],
            kkt_ok=bool(chk["ok"]),
            pri_res=float(chk["pri_res"]),
            dua_res=float(chk["dua_res"]),
        ))
        print(json.dumps(rows[-1]), flush=True)

    out = dict(
        platform=jax.devices()[0].platform,
        device=jax.devices()[0].device_kind,
        note="banded QP, eps=1e-3, duration-adaptive segmented driver; "
             "wall_s includes cold compiles; wall_warm_s is the cached re-run (device+host work only)",
        rows=rows,
        ok=all(r["status"] == 1 and r["kkt_ok"] for r in rows),
    )
    path = os.path.join(REPO, args.out)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"-> {args.out} ok={out['ok']}")


if __name__ == "__main__":
    main()
