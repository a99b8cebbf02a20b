"""Multi-slice (inter-node) domain decomposition.

The ancestral algorithm is MPI Cartesian decomposition across *nodes*
(reference heritage: src/main.rs:10-14, and the explicit
single-node seam note at src/grid.rs:551 — "without mpi,
this is just update interior"). This module adds that hierarchy: the device
mesh is factorised ``(slice, gx, gy, gz)`` with the grid's x axis sharded
over BOTH ``slice`` and ``gx``. Under ``jax.distributed`` the slice axis
lands on process boundaries, so x-ring hops that cross a slice ride the
slower inter-node network while everything else stays within a node.

The slice-crossing exchange runs at a SLOWER cadence with DEEPER halos:
every ``slice_update`` steps, one x-ring exchange of
``slice_update·ext``-deep strips; in between, blocks sweep their padded x
extent blindly (validity shrinks by ``ext`` per step and the interior is
exact at the window end), while the y/z faces exchange every step as usual.
Exchange count on the slow axis drops from one per step to one per window,
at the cost of ``slice_update·ext`` rows of recompute per window.

The compute path is the XLA sweep; complex ψ works natively where the
backend has complex dtypes. Emulated tests run 2 slices × (2, 2, 1) on the
virtual 8-CPU mesh with equivalence asserts against the flat sharded path
(tests/test_multislice.py).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from wavefarm import errors, geometry
from wavefarm.config import Config
from wavefarm.ops.gram_schmidt import hybrid_sum
from wavefarm.ops.stencil import stencil_taps

SLICE_AXIS = "sl"
AXIS_NAMES_4 = (SLICE_AXIS, "gx", "gy", "gz")
# grid-axis → mesh-axis spec: x is sharded over (slice, gx) jointly
X_AXES = (SLICE_AXIS, "gx")
ALL_AXES = AXIS_NAMES_4


def make_multislice_mesh(shape, slices: int, devices=None):
    """Hierarchical ``(slices, mx, my, mz)`` mesh with axes
    ``('sl', 'gx', 'gy', 'gz')``.

    ``jax.devices()`` orders devices process-major, so with
    ``slices == jax.process_count()`` the slice axis coincides with
    process boundaries. Single-process (tests/emulation): the
    factorisation is logical only."""
    devices = list(devices if devices is not None else jax.devices())
    n = slices * int(np.prod(shape))
    if n > len(devices):
        raise ValueError(
            f"multi-slice mesh {slices}x{shape} needs {n} devices, "
            f"have {len(devices)}"
        )
    dev_array = np.array(devices[:n]).reshape((slices,) + tuple(shape))
    return jax.sharding.Mesh(dev_array, AXIS_NAMES_4)


def _psum4(x):
    return lax.psum(x, ALL_AXES)


def _abs2(w):
    if jnp.iscomplexobj(w):
        return jnp.real(w) ** 2 + jnp.imag(w) ** 2
    return w * w


def _pad_x_ring(block: jnp.ndarray, depth: int, n_ring: int) -> jnp.ndarray:
    """Pad the local x axis with ``depth`` neighbour rows over the COMBINED
    (slice, gx) ring — ppermute over the axis tuple linearises the ring, so
    one collective covers both the intra-slice and slice-crossing hops.
    Devices with no source receive zeros, which IS
    the global Dirichlet shell (reference: src/config.rs:597-622)."""
    n = block.shape[0]
    if n_ring == 1:
        return jnp.pad(block, ((depth, depth), (0, 0), (0, 0)))
    if n < depth:
        raise ValueError(
            f"block of {n} cells along x is narrower than the {depth}-deep "
            f"slice-window halo; lower slice_update or use a bigger grid"
        )
    hi_face = lax.slice_in_dim(block, n - depth, n, axis=0)
    lo_face = lax.slice_in_dim(block, 0, depth, axis=0)
    from_left = lax.ppermute(
        hi_face, X_AXES, [(i, i + 1) for i in range(n_ring - 1)]
    )
    from_right = lax.ppermute(
        lo_face, X_AXES, [(i + 1, i) for i in range(n_ring - 1)]
    )
    return jnp.concatenate([from_left, block, from_right], axis=0)


def _pad_yz(block: jnp.ndarray, ext: int, mesh_shape) -> jnp.ndarray:
    """Per-step y/z face exchange (reuses the flat-mesh helper)."""
    from wavefarm.parallel.halo import _pad_axis

    out = _pad_axis(block, ext, 1, "gy", mesh_shape[1])
    return _pad_axis(out, ext, 2, "gz", mesh_shape[2])


class MultiSliceOps:
    """Jitted multi-slice ops for one (config, mesh, n_lower) combination —
    the inter-node counterpart of parallel/sharded.ShardedOps with the same
    driver-facing interface (put/get/put_blocks/put_store/measure/
    evolve_chunk/evolve_chunk_psn)."""

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
        # driver-facing layout contract (assemble_blocks/put/put_store):
        # multi-slice always keeps the natural (x, y, z) layout
        self.perm = (0, 1, 2)
        self.inv_perm = (0, 1, 2)
        self.axis_names = (X_AXES, "gy", "gz")

        slices = int(mesh.shape[SLICE_AXIS])
        mx = int(mesh.shape["gx"])
        my = int(mesh.shape["gy"])
        mz = int(mesh.shape["gz"])
        self.mesh_shape = (slices * mx, my, mz)
        n_ring = slices * mx

        order = config.central_difference.value
        ext = config.central_difference.ext
        dn, dt, mass = config.grid.dn, config.grid.dt, config.mass
        _o, _c, _cc, k = geometry.stencil_coefficients(order)
        denom = k * dn * dn * mass
        screen_update = config.output.screen_update
        dims = config.work_size()
        for d, m, nm in zip(dims, (n_ring, my, mz), "xyz"):
            if d % m:
                raise ValueError(
                    f"grid axis {nm}={d} not divisible by its mesh factor {m}"
                )
        bx = dims[0] // n_ring
        if bx < ext:
            raise ValueError(
                f"block of {bx} cells along x is narrower than the stencil "
                f"halo ({ext}); use a coarser mesh or a bigger grid"
            )
        # slice-window depth: fewer/larger exchanges on the slow axis. The
        # deep pad must fit in the neighbour block (bx >= Hs) and the
        # window in the chunk.
        r_slice = max(1, min(config.mesh.slice_update, bx // ext,
                             screen_update))
        self.slice_steps = r_slice
        h_s = r_slice * ext

        def _lin_edges():
            lin = (
                lax.axis_index(SLICE_AXIS) * mx + lax.axis_index("gx")
            ).astype(jnp.int32)
            return lin == 0, lin == n_ring - 1

        def _zero_x_pads(p, at_lo, at_hi, depth):
            """Re-zero the deep x pads of global-edge blocks — rows outside
            the grid (the blind sweep writes them; the reference's
            Dirichlet shell is re-asserted per step)."""
            zl = jnp.where(at_lo, 0.0, 1.0).astype(p.dtype)
            zh = jnp.where(at_hi, 0.0, 1.0).astype(p.dtype)
            p = p.at[:depth].multiply(zl)
            return p.at[p.shape[0] - depth:].multiply(zh)

        def orthogonalise(phi, store, lo=None, hi=None):
            # overlaps count ONLY true-interior rows (pad rows are the
            # neighbour's interior — double-count — and go stale); the
            # correction applies to the whole padded block with the global
            # coefficients, exactly what the neighbour applies to the same
            # rows.
            for s in range(n_lower):
                lower = store[s]
                li = lower if lo is None else lower[lo:hi]
                pi = phi if lo is None else phi[lo:hi]
                overlap = _psum4(hybrid_sum(jnp.conj(li) * pi))
                phi = phi - lower * overlap.astype(phi.dtype)
            return phi

        def _make_chunk(per_step_norm: bool):
            def chunk_local(phi, a, b, store):
                # chunk-static deep pads: a/b rows are exact everywhere and
                # forever; stored states are exact for the whole chunk
                a_p = _pad_x_ring(a, h_s, n_ring)
                b_p = _pad_x_ring(b, h_s, n_ring)
                store_p = (
                    jnp.stack(
                        [_pad_x_ring(store[s], h_s, n_ring)
                         for s in range(n_lower)]
                    )
                    if n_lower > 0
                    else store
                )
                at_lo, at_hi = _lin_edges()

                def step_padded(p):
                    # per-step y/z exchange over the full padded block
                    # (pad-row y/z halos are the neighbours' identical
                    # stale-but-consistent copies — they evolve in
                    # lockstep); x context comes from the deep pad itself,
                    # zero beyond (those rows' validity is already spent)
                    q = jnp.pad(
                        _pad_yz(p, ext, (n_ring, my, mz)),
                        ((ext, ext), (0, 0), (0, 0)),
                    )
                    taps = stencil_taps(q, order)
                    p = p * a_p + b_p * (dt / denom) * taps
                    p = _zero_x_pads(p, at_lo, at_hi, h_s)
                    if n_lower > 0 or per_step_norm:
                        lo, hi = h_s, h_s + bx
                        norm2 = _psum4(jnp.sum(_abs2(p[lo:hi])))
                        p = p / jnp.sqrt(norm2).astype(p.dtype)
                    if n_lower > 0:
                        p = orthogonalise(p, store_p, h_s, h_s + bx)
                    return p

                def window(phi, steps):
                    p = _pad_x_ring(phi, h_s, n_ring)
                    p = _zero_x_pads(p, at_lo, at_hi, h_s)
                    p = lax.fori_loop(0, steps, lambda _i, q: step_padded(q), p)
                    return p[h_s : h_s + bx]

                n_win = screen_update // r_slice
                phi = lax.fori_loop(
                    0, n_win, lambda _i, q: window(q, r_slice), phi
                )
                rem = screen_update - n_win * r_slice
                if rem:
                    phi = window(phi, rem)
                return phi

            return chunk_local

        def measure_local(phi, v, r2_grid, pot_sub, store):
            padded = _pad_yz(
                _pad_x_ring(phi, ext, n_ring), ext, (n_ring, my, mz)
            )
            taps = stencil_taps(padded, order)
            wc = jnp.conj(phi) if jnp.iscomplexobj(phi) else phi
            abs2 = jnp.real(wc * phi)
            energy = _psum4(hybrid_sum(v * wc * phi - wc * taps / denom))
            norm2 = _psum4(hybrid_sum(abs2))
            if has_pot_sub_array:
                v_inf = _psum4(hybrid_sum(abs2 * pot_sub))
            elif pot_sub_scalar is not None:
                v_inf = norm2 * pot_sub_scalar
            else:
                v_inf = jnp.zeros((), dtype=norm2.dtype)
            r2 = _psum4(hybrid_sum(abs2 * r2_grid))
            phi = phi / jnp.sqrt(norm2).astype(phi.dtype)
            phi = orthogonalise(phi, store)
            return (energy, norm2, v_inf, r2), phi

        grid = P(*self.axis_names)
        store_spec = P(None, *self.axis_names) if n_lower > 0 else P()
        sub_spec = grid if has_pot_sub_array else P()
        scalar = P()

        self.evolve_chunk = jax.jit(
            jax.shard_map(
                _make_chunk(False), mesh=mesh,
                in_specs=(grid, grid, grid, store_spec), out_specs=grid,
            )
        )
        self.evolve_chunk_psn = (
            jax.jit(
                jax.shard_map(
                    _make_chunk(True), mesh=mesh,
                    in_specs=(grid, grid, grid, store_spec), out_specs=grid,
                )
            )
            if n_lower == 0
            else self.evolve_chunk
        )
        self.measure = jax.jit(
            jax.shard_map(
                measure_local, mesh=mesh,
                in_specs=(grid, grid, grid, sub_spec, store_spec),
                out_specs=((scalar, scalar, scalar, scalar), grid),
            )
        )

    # ------------------------------------------------------------------ #

    def sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, P(*self.axis_names))

    def put(self, arr):
        return jax.device_put(jnp.asarray(arr), self.sharding())

    def put_blocks(self, build_block, dtype=None):
        """Per-shard blocked assembly (O(shard) host memory) — see
        parallel/mesh.assemble_blocks."""
        from wavefarm.parallel.mesh import assemble_blocks

        return assemble_blocks(self, build_block, dtype or self.config.dtype)

    def get(self, arr) -> jnp.ndarray:
        return jnp.asarray(np.asarray(arr))

    def put_replicated(self, arr):
        return jax.device_put(jnp.asarray(arr), NamedSharding(self.mesh, P()))

    def put_store(self, store):
        if self.n_lower == 0:
            return self.put_replicated(jnp.zeros((), dtype=self.config.dtype))
        return jax.device_put(
            jnp.asarray(store),
            NamedSharding(self.mesh, P(None, *self.axis_names)),
        )

    def dummy_pot_sub(self):
        return self.put_replicated(jnp.zeros((), dtype=self.config.real_dtype))
