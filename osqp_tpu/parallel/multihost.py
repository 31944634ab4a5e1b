"""Multi-host (DCN) scaling helpers.

The reference has no distributed layer at all (SURVEY.md §2); here the
multi-host story is: initialize the jax distributed runtime, build a
global mesh over all hosts' devices, shard the instance batch (the
network between hosts carries no hot-loop traffic — every op is
batch-parallel), and aggregate results host-side.

Typical Maros-Meszaros multi-host run (one process per host):

    from osqp_tpu.parallel.multihost import initialize, host_shard
    initialize()                      # jax.distributed.initialize()
    rank, world = host_shard()
    rows, summary = run_maros(paths, shard=(rank, world))
    # reduce summaries across hosts with your launcher (or psum below)
"""

from __future__ import annotations

import jax
import numpy as np


def initialize(**kwargs) -> None:
    """jax.distributed.initialize with env-based defaults; no-op when
    already initialized.  Genuine startup failures (bad coordinator
    address, unreachable hosts) propagate — swallowing them would leave
    every host silently solving the full workload alone."""
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        if "already" not in str(e).lower():
            raise


def host_shard() -> tuple[int, int]:
    """(process_index, process_count) for list-sharding work."""
    return jax.process_index(), jax.process_count()


def global_batch_mesh(axis_name: str = "batch"):
    """Mesh over every device in the job (all hosts)."""
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis_name,))


def allreduce_summary(summary: dict) -> dict:
    """Sum the *count* fields of a per-host summary dict across hosts
    using one tiny collective (the only cross-host communication in the
    framework), then recompute the derived ratios (pass_rate is
    sum(solved)/sum(problems), not a sum of per-host rates)."""
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    derived = {"pass_rate"}
    keys = sorted(
        k
        for k, v in summary.items()
        if isinstance(v, (int, float)) and k not in derived
    )
    vals = jnp.asarray([float(summary[k]) for k in keys])
    total = multihost_utils.process_allgather(vals).sum(axis=0)
    out = dict(summary)
    for k, v in zip(keys, np.asarray(total)):
        out[k] = type(summary[k])(v) if isinstance(summary[k], int) else float(v)
    if "problems" in out:
        # run_maros defines pass_rate as final/problems ("final" counts
        # solved plus correctly-certified infeasibility detections);
        # recompute from the same numerator, not from "solved".
        num = out.get("final", out.get("solved", 0))
        out["pass_rate"] = num / max(out["problems"], 1)
    return out
