"""Ghost-cell (halo) exchange over the device mesh.

The ``ext``-wide zero shell of the reference (src/config.rs:597-622,
src/grid.rs:505-534) is exactly the ghost-zone structure the ancestral MPI
algorithm exchanges. Here each shard holds only its interior block; before a
stencil sweep the six faces are exchanged with mesh neighbours via
``lax.ppermute`` (neighbour transfers over the device interconnect).
``ppermute`` delivers zeros to devices with no source — which implements the
global Dirichlet boundary for free.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from wavefarm.parallel.mesh import AXIS_NAMES


def _pad_axis(block: jnp.ndarray, ext: int, axis: int, axis_name: str, axis_size: int):
    """Pad one axis with neighbour faces (or zeros at the global boundary)."""
    if axis_size == 1:
        # unsharded axis: plain zero (Dirichlet) padding
        pad = [(0, 0)] * block.ndim
        pad[axis] = (ext, ext)
        return jnp.pad(block, pad)
    n = block.shape[axis]
    if n < ext:
        raise ValueError(
            f"block of {n} cells along axis {axis} is narrower than the "
            f"stencil halo ({ext}); use a coarser mesh or a bigger grid"
        )
    hi_face = lax.slice_in_dim(block, n - ext, n, axis=axis)
    lo_face = lax.slice_in_dim(block, 0, ext, axis=axis)
    # my low halo = left neighbour's high face (shift right: i → i+1)
    from_left = lax.ppermute(
        hi_face, axis_name, [(i, i + 1) for i in range(axis_size - 1)]
    )
    # my high halo = right neighbour's low face (shift left: i+1 → i)
    from_right = lax.ppermute(
        lo_face, axis_name, [(i + 1, i) for i in range(axis_size - 1)]
    )
    return jnp.concatenate([from_left, block, from_right], axis=axis)


def exchange_halos(block: jnp.ndarray, ext: int, mesh_shape, axis_names=AXIS_NAMES) -> jnp.ndarray:
    """Return the local block padded to ``(+2·ext)³`` with neighbour data.

    Must be called inside ``shard_map`` over a mesh with axes
    ``('gx','gy','gz')``. ``axis_names[i]`` is the mesh axis partitioning
    local array axis ``i`` (permuted for transposed layouts). The result is
    ready for a width-``ext`` stencil."""
    out = block
    for axis in range(3):
        out = _pad_axis(out, ext, axis, axis_names[axis], mesh_shape[axis])
    return out
