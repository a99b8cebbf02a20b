"""Sharded solver kernels: evolve + observables over a device mesh.

Layout: the sharded path stores *interior-only* arrays (N³ — the reference's
work area) block-partitioned over a 3D mesh. Halos are materialised per step
by :func:`wavefarm.parallel.halo.exchange_halos` (ppermute faces between
mesh neighbours; zeros at the global Dirichlet boundary), which reproduces
the single-device padded-array semantics exactly. Global reductions (energy,
norm², V∞, ⟨r²⟩, Gram-Schmidt overlaps) are block partials + ``psum``.

The per-state maths matches the single-device ops in wavefarm/ops (same
update rule as src/grid.rs:544-687 and reductions as src/grid.rs:303-445).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from wavefarm import geometry
from wavefarm.config import Config
from wavefarm.parallel.halo import exchange_halos
from wavefarm.parallel.mesh import AXIS_NAMES


def _abs2(w):
    if jnp.iscomplexobj(w):
        return jnp.real(w) ** 2 + jnp.imag(w) ** 2
    return w * w


def _psum(x):
    return lax.psum(x, AXIS_NAMES)


class ShardedOps:
    """Jitted sharded kernels for one (config, mesh, n_lower) combination.

    ``pot_sub`` mode is fixed at construction: ``pot_sub_scalar`` (constant
    V∞, folded into the reduction), a sharded pot_sub array (FullCornell), or
    neither.
    """

    def __init__(
        self,
        config: Config,
        mesh,
        n_lower: int,
        has_pot_sub_array: bool = False,
        pot_sub_scalar: Optional[float] = None,
    ):
        self.config = config
        self.mesh = mesh
        self.n_lower = n_lower
        self.has_pot_sub_array = has_pot_sub_array
        natural_shape = tuple(int(mesh.shape[a]) for a in AXIS_NAMES)

        order = config.central_difference.value
        ext = config.central_difference.ext
        dn, dt, mass = config.grid.dn, config.grid.dt, config.mass
        _offs, _coeffs, _center, k = geometry.stencil_coefficients(order)
        denom = k * dn * dn * mass
        screen_update = config.output.screen_update

        from wavefarm.ops.stencil import stencil_taps

        # Transposed layout: local blocks store the grid axes sorted by
        # shard count (ties keep the natural order), so a single-axis y or
        # z mesh shards the leading local axis. The stencil and the radial
        # and separable potentials are permutation-invariant once the grid
        # extents are permuted with the coordinates; the only cost is one
        # transpose at the host↔mesh boundaries (put/get).
        perm = tuple(sorted(range(3), key=lambda i: -natural_shape[i]))
        self.perm = perm
        self.inv_perm = tuple(int(i) for i in np.argsort(perm))
        axis_names = tuple(AXIS_NAMES[i] for i in perm)
        self.axis_names = axis_names
        # local view: mesh extent per local-array axis
        self.mesh_shape = tuple(natural_shape[i] for i in perm)
        mesh_shape = self.mesh_shape

        from wavefarm.ops.gram_schmidt import hybrid_sum

        def orthogonalise(phi, store):
            # overlaps accumulate like ops/gram_schmidt (hybrid_sum)
            for s in range(n_lower):
                lower = store[s]
                overlap = _psum(hybrid_sum(jnp.conj(lower) * phi))
                phi = phi - lower * overlap.astype(phi.dtype)
            return phi

        def _make_evolve_chunk_local(per_step_norm: bool):
            # per_step_norm: renormalise the ground state every step too —
            # required in f32 when the potential's offset drifts ψ's scale
            # out of range within one chunk (see ops/stencil.evolve_chunk).

            def step_local(phi, a, b, store):
                padded = exchange_halos(phi, ext, mesh_shape, axis_names)
                taps = stencil_taps(padded, order)
                phi = phi * a + b * (dt / denom) * taps
                if n_lower > 0 or per_step_norm:
                    norm2 = _psum(jnp.sum(_abs2(phi)))
                    phi = phi / jnp.sqrt(norm2).astype(phi.dtype)
                if n_lower > 0:
                    phi = orthogonalise(phi, store)
                return phi

            def evolve_chunk_local(phi, a, b, store):
                return lax.fori_loop(
                    0, screen_update,
                    lambda _i, p: step_local(p, a, b, store), phi,
                )

            return evolve_chunk_local

        def measure_local(phi, v, r2_grid, pot_sub, store):
            padded = exchange_halos(phi, ext, mesh_shape, axis_names)
            taps = stencil_taps(padded, order)
            wc = jnp.conj(phi) if jnp.iscomplexobj(phi) else phi
            abs2 = jnp.real(wc * phi)
            energy = _psum(hybrid_sum(v * wc * phi - wc * taps / denom))
            norm2 = _psum(hybrid_sum(abs2))
            if has_pot_sub_array:
                v_inf = _psum(hybrid_sum(abs2 * pot_sub))
            elif pot_sub_scalar is not None:
                v_inf = norm2 * pot_sub_scalar
            else:
                # norm2's dtype (f64 under x64 via hybrid_sum), matching
                # observables.py — an f32 zero here breaks the batched
                # scan's lax.cond branch typing at precision: f32
                v_inf = jnp.zeros((), dtype=norm2.dtype)
            r2 = _psum(hybrid_sum(abs2 * r2_grid))
            phi = phi / jnp.sqrt(norm2).astype(phi.dtype)
            phi = orthogonalise(phi, store)
            return (energy, norm2, v_inf, r2), phi

        grid = P(*axis_names)
        store_spec = P(None, *axis_names) if n_lower > 0 else P()
        sub_spec = grid if has_pot_sub_array else P()
        scalar = P()

        self.evolve_chunk = jax.jit(
            jax.shard_map(
                _make_evolve_chunk_local(False),
                mesh=mesh,
                in_specs=(grid, grid, grid, store_spec),
                out_specs=grid,
            )
        )
        # per-step-norm ground variant (jit is lazy — compiled only if used;
        # identical to evolve_chunk for excited states, which already
        # renormalise every step)
        self.evolve_chunk_psn = (
            jax.jit(
                jax.shard_map(
                    _make_evolve_chunk_local(True),
                    mesh=mesh,
                    in_specs=(grid, grid, grid, store_spec),
                    out_specs=grid,
                )
            )
            if n_lower == 0
            else self.evolve_chunk
        )
        self.measure = jax.jit(
            jax.shard_map(
                measure_local,
                mesh=mesh,
                in_specs=(grid, grid, grid, sub_spec, store_spec),
                out_specs=((scalar, scalar, scalar, scalar), grid),
            )
        )

    # ------------------------------------------------------------------ #

    def sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, P(*self.axis_names))

    def put(self, arr):
        """Place a global interior array onto the mesh, block-partitioned
        (transposed so the sharded axis leads, for single-axis y/z meshes)."""
        return jax.device_put(
            jnp.transpose(jnp.asarray(arr), self.perm), self.sharding()
        )

    def put_blocks(self, build_block, dtype=None):
        """Assemble a sharded interior array from per-shard blocks —
        O(shard) host memory; see :func:`parallel.mesh.assemble_blocks`."""
        from wavefarm.parallel.mesh import assemble_blocks

        return assemble_blocks(self, build_block, dtype or self.config.dtype)

    def get(self, arr) -> jnp.ndarray:
        """Gather a mesh array back to a host-global interior array in the
        natural (x, y, z) layout (inverse of :meth:`put`)."""
        return jnp.transpose(jnp.asarray(np.asarray(arr)), self.inv_perm)

    def put_replicated(self, arr):
        return jax.device_put(jnp.asarray(arr), NamedSharding(self.mesh, P()))

    def put_store(self, store):
        if self.n_lower == 0:
            return self.put_replicated(jnp.zeros((), dtype=self.config.dtype))
        return jax.device_put(
            jnp.transpose(jnp.asarray(store), (0,) + tuple(i + 1 for i in self.perm)),
            NamedSharding(self.mesh, P(None, *self.axis_names)),
        )

    def dummy_pot_sub(self):
        """Placeholder when no pot_sub array participates."""
        return self.put_replicated(jnp.zeros((), dtype=self.config.real_dtype))
