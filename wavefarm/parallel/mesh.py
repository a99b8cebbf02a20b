"""Device mesh construction and sharding specs for the 3D grid."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

AXIS_NAMES = ("gx", "gy", "gz")


def make_mesh(shape: Tuple[int, int, int], devices: Optional[Sequence] = None) -> Mesh:
    """Build a 3D mesh over ``shape = (mx, my, mz)`` devices.

    The leading grid axis maps to the leading mesh axis.
    ``mx·my·mz`` must not exceed the available device count."""
    devices = list(devices if devices is not None else jax.devices())
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh {shape} needs {n} devices, have {len(devices)}")
    dev_array = np.array(devices[:n]).reshape(shape)
    return Mesh(dev_array, AXIS_NAMES)


def shard_spec() -> PartitionSpec:
    """Interior grid arrays shard block-wise over all three mesh axes."""
    return PartitionSpec(*AXIS_NAMES)


def grid_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, shard_spec())


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def assemble_blocks(ops, build_block, dtype):
    """Shared implementation of the drivers' ``put_blocks``: assemble a
    sharded interior array from per-shard blocks via
    ``jax.make_array_from_callback``.

    ``ops`` is a ShardedOps/ShardedSplitOps (supplies ``config``, ``mesh``,
    ``perm``/``inv_perm`` layout permutation and ``axis_names``).
    ``build_block(shape, offset)`` returns the global-interior block
    covering ``offset : offset + shape`` in NATURAL (x, y, z) axis order.
    Each process materialises only its addressable shards — O(shard) host
    memory instead of a host-global array sliced by ``put`` (the
    reference's indexed potential generation is embarrassingly local,
    src/potential.rs:46-62), and the only construction that still works
    when addressable shards are a strict subset (multi-host)."""
    import jax.numpy as jnp

    dims = ops.config.work_size()
    shape_p = tuple(dims[i] for i in ops.perm)
    sharding = NamedSharding(ops.mesh, PartitionSpec(*ops.axis_names))

    def _cb(idx):
        norm = tuple(idx[a].indices(shape_p[a]) for a in range(3))
        nat_shape = tuple(
            norm[ops.inv_perm[n]][1] - norm[ops.inv_perm[n]][0]
            for n in range(3)
        )
        nat_off = tuple(norm[ops.inv_perm[n]][0] for n in range(3))
        blk = jnp.asarray(build_block(nat_shape, nat_off), dtype=dtype)
        return jnp.transpose(blk, ops.perm)

    return jax.make_array_from_callback(shape_p, sharding, _cb)
