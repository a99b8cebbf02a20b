"""Multi-device scaling: device meshes, halo exchange, sharded solver ops.

The reference is shared-memory-only (rayon; its own comment notes the absent
MPI path at src/grid.rs:551). This package supplies the distributed layer the
ancestral algorithm (Strickland & Yager-Elorriaga, JCP 2010: MPI Cartesian
decomposition with ghost-zone exchange) calls for: a 3D
``jax.sharding.Mesh``, ``ppermute`` face exchange between mesh neighbours,
and ``psum`` global reductions.
"""

from wavefarm.parallel.mesh import make_mesh, shard_spec  # noqa: F401
from wavefarm.parallel.halo import exchange_halos  # noqa: F401
