"""Multi-card scaling-efficiency harness.

Weak-scaling measurement of batched solve throughput vs mesh size:
B = B0 * n_dev instances sharded over the first n_dev devices; perfect
scaling is flat time / linear QPs/s (the hot loop has zero cross-chip
traffic by construction — each instance is chip-local).

    efficiency(N) = QPs/s(N) / (N * QPs/s(1))

Runnable anywhere: on a multi-GPU host it produces the deliverable
numbers; on the virtual 8-device CPU mesh
(JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8)
it validates shape/sharding only (CPU "devices" share one machine, so
efficiency numbers are meaningless there — the harness says so).

    python tools/bench_scaling.py [--b0 1024] [--n 100] [--m 200]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--b0", type=int, default=1024, help="instances per device")
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--m", type=int, default=200)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true",
                    help="force the virtual 8-device CPU mesh "
                         "(shape/sharding validation)")
    args = ap.parse_args()

    if args.cpu:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from osqp_tpu.parallel import make_mesh, solve_batch_sharded

    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    from bench import make_qps

    devs = jax.devices()
    is_cpu = devs[0].platform == "cpu"
    # only mesh sizes that actually exist
    sizes = sorted(
        nd for nd in {1, 2, len(devs) // 2, len(devs)} if 1 <= nd <= len(devs)
    )
    rows = []
    base_qps = None
    for nd in sizes:
        B = args.b0 * nd
        data = make_qps(B, args.n, args.m)
        mesh = make_mesh(nd)
        kw = dict(
            mesh=mesh, dtype="float32", verbose=False, polish=False,
            eps_abs=1e-3, eps_rel=1e-3,
        )
        res = jax.block_until_ready(solve_batch_sharded(*data, **kw))
        ts = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            res = jax.block_until_ready(solve_batch_sharded(*data, **kw))
            ts.append(time.perf_counter() - t0)
        dt = float(np.median(ts))
        qps = B / dt
        if nd == 1:
            base_qps = qps
        eff = qps / (nd * base_qps)
        rows.append(dict(devices=nd, B=B, time=dt, qps=qps, efficiency=eff,
                         solved=float(np.mean(np.asarray(res.status_val) == 1))))
        print(rows[-1], flush=True)

    out = dict(
        platform=devs[0].platform,
        device_count=len(devs),
        device_kind=devs[0].device_kind,
        note=(
            "virtual CPU mesh: sharding/shape validation only, efficiency "
            "numbers are not meaningful (devices share one host)"
            if is_cpu
            else "weak scaling, hot loop has zero cross-chip collectives"
        ),
        rows=rows,
    )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
