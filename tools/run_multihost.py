"""Multi-process multi-host validation.

Launches ``--world`` CPU processes with ``jax.distributed.initialize``
(the bring-up a real multi-host cluster uses, the network playing the
coordinator role), then in every process:

1. builds the global batch mesh over all processes' devices
   (``parallel.multihost.global_batch_mesh``), shards a B-instance QP
   batch across it with ``host_local_array_to_global_array``, and runs
   the one-program batched solve under pjit — per-instance statuses
   come back via ``process_allgather``;
2. runs the Maros harness on a list-shard of the QPS fixture corpus
   (``run_maros(shard=(rank, world))``) and aggregates the per-host
   summaries with ``allreduce_summary`` — the framework's only
   cross-host collective;
3. process 0 writes ``results/multihost.json``.

Usage:
    python tools/run_multihost.py            # parent: spawns 2 workers
    python tools/run_multihost.py --world 4  # more processes

The parent waits and validates the artifact.  This is the runnable
proof behind SURVEY §5 "distributed communication backend" (the
reference has none).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "results", "multihost.json")


def child(rank: int, world: int, port: int, devs_per_proc: int, batch: int):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    # Share the test suite's persistent compile cache (atomic writes, so
    # concurrent workers compiling the same program cannot corrupt it).
    from osqp_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    from osqp_tpu.parallel.multihost import (
        allreduce_summary,
        global_batch_mesh,
        host_shard,
        initialize,
    )

    initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=world,
        process_id=rank,
        local_device_ids=list(range(devs_per_proc)),
    )
    rank_, world_ = host_shard()
    assert (rank_, world_) == (rank, world), (rank_, world_)
    n_dev = len(jax.devices())
    assert n_dev == world * devs_per_proc, n_dev

    import numpy as np
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    # ---- 1. globally-sharded batched solve (one program, all hosts) ----
    from osqp_tpu.batch import solve_batch_jit, make_config
    from osqp_tpu.solver import Settings
    from osqp_tpu.types import DynSettings

    B, n, m = batch, 24, 36
    rng = np.random.default_rng(0)  # same data in every process
    M = rng.standard_normal((B, n, n))
    Pm = np.einsum("bij,bkj->bik", M, M) / n + 0.1 * np.eye(n)
    q = rng.standard_normal((B, n))
    A = rng.standard_normal((B, m, n))
    xr = rng.standard_normal((B, n))
    Ax = np.einsum("bmn,bn->bm", A, xr)
    sp_ = np.abs(rng.standard_normal((B, m))) + 0.1
    l, u = Ax - sp_, Ax + sp_

    mesh = global_batch_mesh()
    sh = NamedSharding(mesh, P("batch"))
    shard_n = B // world

    def to_global(x):
        local = jnp.asarray(x[rank * shard_n : (rank + 1) * shard_n])
        return multihost_utils.host_local_array_to_global_array(
            np.asarray(local), mesh, P("batch")
        )

    Pg, qg, Ag, lg, ug = (to_global(v) for v in (Pm, q, A, l, u))

    s = Settings(max_iter=2000, verbose=False)
    cfg = make_config(n, m, s, jnp.float64)
    dyn = DynSettings.make(jnp.float64)
    rho0 = jnp.full((shard_n,), s.rho)
    rho0 = multihost_utils.host_local_array_to_global_array(
        np.asarray(rho0), mesh, P("batch")
    )

    t0 = time.perf_counter()
    with mesh:
        res = solve_batch_jit(
            cfg, 10, False, 3, Pg, qg, Ag, lg, ug, rho0, dyn, None, None
        )
        jax.block_until_ready(res.status_val)
    solve_t = time.perf_counter() - t0
    status_all = multihost_utils.process_allgather(res.status_val, tiled=True)
    solved = int((np.asarray(status_all) == 1).sum())

    # ---- 2. sharded Maros harness + summary allreduce ----
    from osqp_tpu.maros import run_maros

    paths = sorted(glob.glob(os.path.join(REPO, "tests/data/generated/*.qps")))
    paths = [p for p in paths if "10000" not in p][:12]  # small, fast subset
    rows, summary = run_maros(
        paths, eps=1e-3, polish=True, shard=(rank, world), verbose=False
    )
    global_summary = allreduce_summary(summary)

    if rank == 0:
        art = dict(
            world=world,
            devices=n_dev,
            devices_per_process=devs_per_proc,
            sharded_batch=dict(
                B=B,
                n=n,
                m=m,
                solved=solved,
                solve_time=round(solve_t, 3),
                sharding=str(res.status_val.sharding),
            ),
            maros_shard=dict(
                local_rows=len(rows),
                local_summary={k: v for k, v in summary.items()},
                global_summary={k: v for k, v in global_summary.items()},
            ),
            ok=bool(
                solved == B
                and global_summary["problems"] == len(paths)
                and global_summary["pass_rate"] == 1.0
            ),
        )
        os.makedirs(os.path.dirname(ART), exist_ok=True)
        with open(ART, "w") as f:
            json.dump(art, f, indent=1)
        print("WROTE", ART, json.dumps(art["sharded_batch"]))
    # every process must reach the same point (collectives are global)
    multihost_utils.sync_global_devices("done")


def parent(world: int, devs: int, batch: int):
    port = 12357
    procs = []
    for rank in range(world):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={devs}"
        )
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        procs.append(
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", str(rank),
                 "--world", str(world), "--port", str(port),
                 "--devs", str(devs), "--batch", str(batch)],
                env=env, cwd=REPO,
            )
        )
    rcs = [p.wait(timeout=1200) for p in procs]
    assert all(rc == 0 for rc in rcs), rcs
    with open(ART) as f:
        art = json.load(f)
    assert art["ok"], art
    print("MULTIHOST OK:", json.dumps(art, indent=1))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--devs", type=int, default=4)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=12357)
    args = ap.parse_args()
    if args.rank is None:
        parent(args.world, args.devs, args.batch)
    else:
        child(args.rank, args.world, args.port, args.devs, args.batch)


if __name__ == "__main__":
    main()
