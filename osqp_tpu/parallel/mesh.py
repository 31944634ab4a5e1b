"""Multi-card batch sharding.

The reference has no distributed backend at all (SURVEY §2: QDLDL is
single-threaded, qdldl_interface.c:216); scaling across cards comes from
sharding the *instance batch* over a 1-D ``jax.sharding.Mesh`` of all
devices.  Each QP stays card-local — zero collectives in the hot loop;
XLA inserts no NVLink traffic because every op is batch-parallel.  Only
host-side reductions (e.g. Maros-Meszaros aggregation) communicate.

Works identically on a multi-GPU host and on a virtual CPU mesh
(``--xla_force_host_platform_device_count=N``) used for testing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..batch import BatchSolveResults, solve_batch


def make_mesh(n_devices: int | None = None, axis_name: str = "batch") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def _shard_leading(mesh: Mesh, axis_name: str, tree):
    sharding = NamedSharding(mesh, P(axis_name))

    def put(x):
        return jax.device_put(jnp.asarray(x), sharding)

    return jax.tree_util.tree_map(put, tree)


def solve_batch_sharded(
    P_mat,
    q,
    A,
    l,
    u,
    mesh: Mesh | None = None,
    axis_name: str = "batch",
    **settings,
) -> BatchSolveResults:
    """Shard B instances over the mesh's devices and solve.

    B must be divisible by the number of mesh devices.  The jitted
    batched program is compiled once; XLA partitions every batched op by
    the leading axis, so each chip independently runs its shard of the
    ADMM loop (SPMD, no cross-chip traffic in the loop).
    """
    mesh = mesh or make_mesh(axis_name=axis_name)
    n_dev = mesh.devices.size
    B = jnp.asarray(q).shape[0]
    if B % n_dev != 0:
        raise ValueError(f"batch size {B} not divisible by mesh size {n_dev}")

    P_mat, q, A, l, u = _shard_leading(mesh, axis_name, (P_mat, q, A, l, u))
    return solve_batch(P_mat, q, A, l, u, **settings)
