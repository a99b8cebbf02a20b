"""Sharded split-complex path: complex ψ as (re, im) real pairs over a mesh.

Backends without complex dtypes (see ops/split_complex.backend_supports_complex)
cannot run the native-complex sharded path, so this module re-expresses the
sharded evolve/measure (parallel/sharded.py) with the complex algebra
written out over real block-partitioned arrays — complex values exist only
host-side (file I/O). Same maths as ops/split_complex.py; same reference
semantics (update src/grid.rs:544-687, reductions src/grid.rs:303-445,
per-step normalise+GS src/grid.rs:674-681).
"""

from __future__ import annotations

import logging
import math
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from wavefarm import errors, geometry
from wavefarm.config import Config
from wavefarm.ops.observables import Observables
from wavefarm.parallel.halo import exchange_halos
from wavefarm.parallel.mesh import AXIS_NAMES, make_mesh


def _psum(x):
    return lax.psum(x, AXIS_NAMES)


class ShardedSplitOps:
    """Jitted sharded split-complex kernels for one (config, mesh, n_lower)."""

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
        natural_shape = tuple(int(mesh.shape[a]) for a in AXIS_NAMES)

        order = config.central_difference.value
        ext = config.central_difference.ext
        dn, dt, mass = config.grid.dn, config.grid.dt, config.mass
        _o, _c, _cc, k = geometry.stencil_coefficients(order)
        denom = k * dn * dn * mass
        s_ = dt / denom
        screen_update = config.output.screen_update

        from wavefarm.ops.stencil import stencil_taps

        # the layout permutation of ShardedOps: grid axes sorted by shard
        # count, so a single-axis y/z mesh shards the leading local axis
        perm = tuple(sorted(range(3), key=lambda i: -natural_shape[i]))
        self.perm = perm
        self.inv_perm = tuple(int(i) for i in np.argsort(perm))
        axis_names = tuple(AXIS_NAMES[i] for i in perm)
        self.axis_names = axis_names
        self.mesh_shape = tuple(natural_shape[i] for i in perm)
        mesh_shape = self.mesh_shape

        def norm2_g(pr, pi):
            return _psum(jnp.sum(pr * pr + pi * pi))

        def orthogonalise(pr, pi, sr, si):
            for j in range(n_lower):
                o_re = _psum(jnp.sum(sr[j] * pr + si[j] * pi))
                o_im = _psum(jnp.sum(sr[j] * pi - si[j] * pr))
                pr = pr - (sr[j] * o_re - si[j] * o_im)
                pi = pi - (sr[j] * o_im + si[j] * o_re)
            return pr, pi

        def _make_evolve_chunk_local(per_step_norm: bool):
            def step_local(pr, pi, ar, ai, br, bi, sr, si):
                tr = stencil_taps(
                    exchange_halos(pr, ext, mesh_shape, axis_names), order
                )
                ti = stencil_taps(
                    exchange_halos(pi, ext, mesh_shape, axis_names), order
                )
                new_r = ar * pr - ai * pi + s_ * (br * tr - bi * ti)
                new_i = ar * pi + ai * pr + s_ * (br * ti + bi * tr)
                pr, pi = new_r, new_i
                if n_lower > 0 or per_step_norm:
                    inv = (1.0 / jnp.sqrt(norm2_g(pr, pi))).astype(pr.dtype)
                    pr, pi = pr * inv, pi * inv
                if n_lower > 0:
                    pr, pi = orthogonalise(pr, pi, sr, si)
                return pr, pi

            def evolve_chunk_local(pr, pi, ar, ai, br, bi, sr, si):
                return lax.fori_loop(
                    0,
                    screen_update,
                    lambda _i, c: step_local(c[0], c[1], ar, ai, br, bi, sr, si),
                    (pr, pi),
                )

            return evolve_chunk_local

        # hybrid f32/f64 accumulation for the convergence-critical sums
        from wavefarm.ops.gram_schmidt import hybrid_sum as _sum_h

        def measure_local(pr, pi, vr, vi, r2_grid, pot_sub, sr, si):
            tr = stencil_taps(
                exchange_halos(pr, ext, mesh_shape, axis_names), order
            )
            ti = stencil_taps(
                exchange_halos(pi, ext, mesh_shape, axis_names), order
            )
            abs2 = pr * pr + pi * pi
            e_re = _psum(_sum_h(vr * abs2 - (pr * tr + pi * ti) / denom))
            e_im = _psum(_sum_h(vi * abs2 - (pr * ti - pi * tr) / denom))
            norm2 = _psum(_sum_h(abs2))
            if has_pot_sub_array:
                v_inf = _psum(_sum_h(abs2 * pot_sub))
            elif pot_sub_scalar is not None:
                v_inf = norm2 * pot_sub_scalar
            else:
                v_inf = jnp.zeros((), dtype=norm2.dtype)
            r2 = _psum(_sum_h(abs2 * r2_grid))
            inv = (1.0 / jnp.sqrt(norm2)).astype(pr.dtype)
            pr, pi = pr * inv, pi * inv
            pr, pi = orthogonalise(pr, pi, sr, si)
            return (e_re, e_im, norm2, v_inf, r2), (pr, pi)

        grid = P(*axis_names)
        store_spec = P(None, *axis_names) if n_lower > 0 else P()
        sub_spec = grid if has_pot_sub_array else P()
        scalar = P()
        pair_specs = (grid, grid, grid, grid, grid, grid, store_spec, store_spec)

        self.evolve_chunk = jax.jit(
            jax.shard_map(
                _make_evolve_chunk_local(False),
                mesh=mesh,
                in_specs=pair_specs,
                out_specs=(grid, grid),
            )
        )
        self.evolve_chunk_psn = (
            jax.jit(
                jax.shard_map(
                    _make_evolve_chunk_local(True),
                    mesh=mesh,
                    in_specs=pair_specs,
                    out_specs=(grid, grid),
                )
            )
            if n_lower == 0
            else self.evolve_chunk
        )
        self.measure = jax.jit(
            jax.shard_map(
                measure_local,
                mesh=mesh,
                in_specs=(grid, grid, grid, grid, grid, sub_spec, store_spec, store_spec),
                out_specs=(
                    (scalar, scalar, scalar, scalar, scalar),
                    (grid, grid),
                ),
            )
        )

    # ------------------------------------------------------------------ #

    def put(self, arr):
        """Place a global interior array onto the mesh, block-partitioned
        (transposed so the sharded axis leads — see the layout perm)."""
        return jax.device_put(
            jnp.transpose(jnp.asarray(arr), self.perm),
            NamedSharding(self.mesh, P(*self.axis_names)),
        )

    def put_blocks(self, build_block, dtype=None):
        """Assemble a sharded interior array from per-shard blocks —
        O(shard) host memory; see :func:`parallel.mesh.assemble_blocks`."""
        from wavefarm.parallel.mesh import assemble_blocks

        return assemble_blocks(
            self, build_block, dtype or self.config.real_dtype
        )

    def get(self, arr) -> jnp.ndarray:
        """Gather a mesh array back to the natural (x, y, z) host layout
        (inverse of :meth:`put`)."""
        return jnp.transpose(jnp.asarray(np.asarray(arr)), self.inv_perm)

    def put_store(self, store):
        if self.n_lower == 0:
            return jax.device_put(
                jnp.zeros((), dtype=self.config.real_dtype),
                NamedSharding(self.mesh, P()),
            )
        return jax.device_put(
            jnp.transpose(
                jnp.asarray(store), (0,) + tuple(i + 1 for i in self.perm)
            ),
            NamedSharding(self.mesh, P(None, *self.axis_names)),
        )

    def dummy_pot_sub(self):
        return jax.device_put(
            jnp.zeros((), dtype=self.config.real_dtype),
            NamedSharding(self.mesh, P()),
        )


def run_sharded_split(
    config: Config, log=None, seed=None, mesh=None, progress_factory=None,
    ic_overrides=None,
) -> List:
    """Sharded driver for complex potentials on complex-free backends:
    the split counterpart of parallel/solver_sharded.run_sharded.

    ``ic_overrides``: optional ``{wnum: (padded re, padded im)}`` explicit
    initial pairs (the multigrid coarse→fine hand-over, solver.py)."""
    from wavefarm.models import potentials as pmod
    from wavefarm.solver import SolveResult

    log = log or logging.getLogger("wafer")
    if seed is None:
        # honour config.seed like solver.solve (None reaches os.urandom
        # in the Gaussian IC — the config key must not be silently ignored)
        seed = config.seed
    if config.mesh.slices > 1 and mesh is None:
        # multi-slice tier on the split path: jax.devices() is
        # process-major, so a flat mesh with the slices folded into x keeps
        # the hierarchical (slice, gx) ring's device order; every exchange
        # runs at the per-step cadence
        gx, gy, gz = config.mesh.as_tuple()
        mesh = make_mesh((config.mesh.slices * gx, gy, gz))
        log.info(
            "Multi-slice split run: flat (%d, %d, %d) mesh, process-major",
            config.mesh.slices * gx, gy, gz,
        )
    mesh = mesh if mesh is not None else make_mesh(config.mesh.as_tuple())
    ext = config.central_difference.ext

    # Split potentials are analytic by construction (generate_split), so
    # every per-state array is assembled from per-shard blocks — O(shard)
    # host memory (see solver_sharded.run_sharded; reference:
    # src/potential.rs:46-62 is embarrassingly local). Only the scalar
    # side-channel (v_min slab scan, pole warning, pot_sub arbitration)
    # runs host-side here; the FullCornell pot_sub array defers to
    # per-shard generation too.
    import dataclasses

    real_cfg = dataclasses.replace(
        config, potential=config.potential.real_counterpart
    )
    v_min = pmod.scan_v_min(real_cfg)
    v_shift = pmod.v_shift_and_pole_warn(config, v_min, log)
    pot_sub_array, pot_sub_scalar = pmod.load_pot_sub(
        config, log, build_array=False
    )

    def interior(p):
        return geometry.work_area(p, ext)

    w_store: List = []  # (re, im) interior host pairs
    if config.wavenum > 0:
        from wavefarm.io import readers

        for w in readers.load_wavefunctions(config, log):
            w = np.asarray(w)
            w_store.append(
                (
                    jnp.asarray(np.real(interior(w)), dtype=config.real_dtype),
                    jnp.asarray(np.imag(interior(w)), dtype=config.real_dtype),
                )
            )

    log.info(
        "Starting split-complex calculation (sharded over mesh %s)", dict(mesh.shape)
    )
    results = []
    for wnum in range(config.wavenum, config.wavemax + 1):
        progress = progress_factory(wnum) if progress_factory is not None else None
        results.append(
            _solve_state_split(
                config, log, mesh, wnum, w_store,
                v_shift, seed, progress,
                ic_override=(
                    ic_overrides.get(wnum) if ic_overrides is not None else None
                ),
                pot_sub_array=pot_sub_array,
                pot_sub_scalar=pot_sub_scalar,
            )
        )
    return results


def _select_ic_split(config, log, wnum, w_store, seed):
    """Disk (current, incl. _partial) → previous state → generator — split
    host-side (reference preference: src/grid.rs:60-100).

    NOTE: this preference logic also lives in solver._select_initial_condition
    (native dtypes) and inline in solver._solve_split (single-device split) —
    lifecycle changes must be applied to all three."""
    import dataclasses

    from wavefarm.config import InitialCondition
    from wavefarm.io import readers
    from wavefarm.models import initial

    ext = config.central_difference.ext
    if wnum > 0:
        try:
            wfn = np.asarray(
                readers.wavefunction(
                    wnum,
                    config.padded_size(),
                    config.central_difference.bb,
                    config.output.file_type,
                    log,
                    input_dir=config.input_dir,
                )
            )
            log.info("Loaded (current) wavefunction %d from disk", wnum)
            if (
                config.init_condition is not InitialCondition.FROM_FILE
                and wnum > config.wavenum
            ):
                # contamination warning (reference: src/grid.rs:78-84)
                log.warning(
                    "Loaded a higher order wavefunction from disk although "
                    "Initial conditions are set to '%s'.",
                    config.init_condition.display(),
                )
            w = geometry.work_area(wfn, ext)
            return (
                jnp.asarray(np.real(w), dtype=config.real_dtype),
                jnp.asarray(np.imag(w), dtype=config.real_dtype),
            )
        except errors.WaferError:
            log.info("Loaded wavefunction %d from memory as initial condition", wnum - 1)
            # seeded perturbation: an exact clone can Gram-Schmidt-cancel
            # bitwise to zero in f32 (see initial.perturb_clone); the pair
            # draws the same noise fields as the single-device split driver
            pr_c, pi_c = w_store[wnum - 1]
            return (
                initial.perturb_clone(
                    config, pr_c, wnum, seed=seed, padded=False
                ),
                initial.perturb_clone(
                    config, pi_c, wnum, seed=seed, padded=False,
                    component=1, rms_from=pr_c,
                ),
            )
    real_cfg = dataclasses.replace(
        config, potential=config.potential.real_counterpart
    )
    pr = initial.set_initial_conditions(real_cfg, log, seed=seed)
    return (
        geometry.work_area(pr, ext),
        jnp.zeros_like(geometry.work_area(pr, ext)),
    )


def _solve_state_split(
    config, log, mesh, wnum, w_store,
    v_shift, seed, progress, ic_override=None,
    pot_sub_array=None, pot_sub_scalar=None,
):
    from wavefarm.io import writers
    from wavefarm.models import initial, potentials as pmod
    from wavefarm.solver import SolveResult, eta, stable_dt_bound
    from wavefarm.utils import terminal

    n_lower = wnum
    sub_deferred = pot_sub_array is None and config.potential.variable_pot_sub
    ops_kw = dict(
        has_pot_sub_array=pot_sub_array is not None or sub_deferred,
        pot_sub_scalar=pot_sub_scalar,
    )
    ops = ShardedSplitOps(config, mesh, n_lower, **ops_kw)
    if ic_override is not None:
        log.info(
            "Using explicit in-memory initial (re, im) pair for state %d "
            "(multigrid hand-over)", wnum,
        )
        ext_ = config.central_difference.ext
        pr0 = geometry.work_area(
            jnp.asarray(ic_override[0], dtype=config.real_dtype), ext_
        )
        pi0 = geometry.work_area(
            jnp.asarray(ic_override[1], dtype=config.real_dtype), ext_
        )
    else:
        pr0, pi0 = _select_ic_split(config, log, wnum, w_store, seed)
    pr, pi = ops.put(pr0), ops.put(pi0)
    # per-shard blocks: vr from coordinates, everything else derived
    # elementwise on the already-sharded array (stays sharded under jit)
    ext_b = config.central_difference.ext
    vr_d = ops.put_blocks(
        lambda shp, off: pmod.generate_split(
            config, shp, tuple(o + ext_b for o in off)
        )[0],
        dtype=config.real_dtype,
    )
    vi_d = jax.jit(lambda v: jnp.asarray(config.absorb, v.dtype) * v)(vr_d)
    ar_d, ai_d, br_d, bi_d = jax.jit(
        lambda r, i_: pmod.build_ab_split(r, i_, config.grid.dt, v_shift)
    )(vr_d, vi_d)
    r2_d = ops.put_blocks(
        lambda shp, off: geometry.r2_index_grid(
            shp, config.grid.size.as_tuple(), dtype=config.real_dtype,
            offset=off,
        ),
        dtype=config.real_dtype,
    )
    if pot_sub_array is not None:
        sub_d = ops.put(pot_sub_array)
    elif sub_deferred:
        sub_d = ops.put_blocks(
            lambda shp, off: pmod.potential_sub_array(config, shp, off),
            dtype=config.real_dtype,
        )
    else:
        sub_d = ops.dummy_pot_sub()
    sr_d = ops.put_store(
        jnp.stack([w[0] for w in w_store[:n_lower]]) if n_lower else None
    )
    si_d = ops.put_store(
        jnp.stack([w[1] for w in w_store[:n_lower]]) if n_lower else None
    )

    # Delayed re-orthogonalisation (solver.delayed_gram_gate; PARITY #12)
    # on the sharded split driver: delayed chunks run a ground
    # per-step-norm ShardedSplitOps instance (no stored-pair projections);
    # same sync_update exclusion as solver_sharded.
    from wavefarm.solver import DelayedGramState

    delayed_gs = False
    dgs_state = DelayedGramState()
    e_lowest = None
    ops_dgs = None
    if (
        n_lower > 0
        and config.delayed_gram
        and (config.sync_update or 1) == 1
    ):
        e_ls = []
        for wr_, wi_ in w_store[:n_lower]:
            (e_rl, _e_il, n2_l, _v_l, _r_l), _pp = ops.measure(
                ops.put(wr_), ops.put(wi_), vr_d, vi_d, r2_d, sub_d,
                sr_d, si_d,
            )
            e_ls.append(float(e_rl) / float(n2_l))
        ops_dgs = ShardedSplitOps(config, mesh, 0, **ops_kw)
        e_lowest = min(e_ls)
        dgs_store = ops_dgs.put_store(None)

    terminal.print_observable_header(wnum)
    ext = config.central_difference.ext
    step = 0
    converged = False
    last_energy = complex(float("inf"), 0.0)
    diff_old = float("inf")
    obs = None
    per_step_norm = False

    # Device-side convergence batching (sync_update), the same opt-in
    # cadence contract as the other three drivers (solver.solve,
    # solver._solve_split, solver_sharded — spec src/grid.rs:126-220).
    # Every device array threads through the env argument, never a jit
    # closure.
    from wavefarm.solver import make_batched_runner, pick_batch_k

    k_sync = config.sync_update or 1
    su = config.output.screen_update
    if k_sync > 1 and not jax.config.jax_enable_x64:
        log.warning(
            "sync_update=%d with jax_enable_x64 off: the on-device "
            "convergence verdict is f32 and may differ from the host check "
            "by an ulp at the tolerance edge",
            k_sync,
        )
    _batched_cache: dict = {}
    _batch_env = {
        "vr": vr_d, "vi": vi_d, "r2": r2_d, "sub": sub_d,
        "sr": sr_d, "si": si_d,
        "ar": ar_d, "ai": ai_d, "br": br_d, "bi": bi_d,
    }

    def _measure_env(p2, env):
        pr_, pi_ = p2
        return ops.measure(
            pr_, pi_, env["vr"], env["vi"], env["r2"], env["sub"],
            env["sr"], env["si"],
        )

    def _get_batched(k_chunks: int, psn: bool):
        key = (k_chunks, psn)
        if key not in _batched_cache:
            chunk_fn = ops.evolve_chunk_psn if psn else ops.evolve_chunk

            def _evolve_env(p2, env, _fn=chunk_fn):
                pr_, pi_ = p2
                return _fn(
                    pr_, pi_, env["ar"], env["ai"], env["br"], env["bi"],
                    env["sr"], env["si"],
                )

            _batched_cache[key] = make_batched_runner(
                _measure_env, _evolve_env, config.tolerance, True,
                k_chunks, split_pair=True,
            )
        return _batched_cache[key]

    rows_pending: list = []
    batch_phi_next = None
    batch_phi_conv = None

    while True:
        measured_delta = None
        dev_done = None
        if rows_pending:
            obs, dev_done = rows_pending.pop(0)
        else:
            k_batch = pick_batch_k(
                step, k_sync, su, config.output.snap_update, config.max_steps
            )
            if k_batch > 1:
                led = (
                    jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
                )
                le = jnp.asarray(
                    [last_energy.real, last_energy.imag], dtype=led
                )
                (pr_f, pi_f), (pr_c, pi_c), out_rows = _get_batched(
                    k_batch, per_step_norm
                )((pr, pi), le, _batch_env)
                ers, eis, n2s, vinfs, r2s_, execs, dones = (
                    np.asarray(x) for x in out_rows
                )
                for j in range(k_batch):
                    if not bool(execs[j]):
                        break
                    rows_pending.append((
                        Observables(
                            energy=complex(float(ers[j]), float(eis[j])),
                            norm2=float(n2s[j]),
                            v_infinity=float(vinfs[j]),
                            r2=float(r2s_[j]),
                        ),
                        bool(dones[j]),
                    ))
                batch_phi_next = (pr_f, pi_f)
                batch_phi_conv = (pr_c, pi_c)
                continue
            if delayed_gs and n_lower > 0:
                from wavefarm.solver import _max_rel_overlap_sc

                measured_delta = float(
                    _max_rel_overlap_sc(pr, pi, sr_d, si_d)
                )
            (e_re, e_im, n2, vinf, r2), (pr, pi) = ops.measure(
                pr, pi, vr_d, vi_d, r2_d, sub_d, sr_d, si_d
            )
            obs = Observables(
                energy=complex(float(e_re), float(e_im)),
                norm2=float(n2),
                v_infinity=float(vinf),
                r2=float(r2),
            )
        if not (math.isfinite(obs.norm2) and obs.norm2 > 0.0):
            raise errors.NonFiniteError("norm²", step)
        norm_energy = obs.energy / obs.norm2
        if (
            n_lower == 0
            and config.grid.dt
            <= stable_dt_bound(
                config.central_difference.value, config.grid.dn, config.mass
            )
        ):
            # re-evaluated per measure with hysteresis (solver.drift_guard):
            # a hot IC rides psn through the transient, then per-chunk
            # normalisation resumes; the batched cache is psn-keyed
            from wavefarm.solver import drift_guard

            _efold_limit = 60.0 if config.real_dtype == jnp.float32 else 600.0
            per_step_norm = drift_guard(
                per_step_norm, norm_energy.real, v_shift,
                config.grid.dt, config.output.screen_update,
                _efold_limit, log,
            )
        if n_lower > 0 and e_lowest is not None:
            # delayed re-orthogonalisation gate + flap cooldown (solve())
            delayed_gs = dgs_state.update(
                norm_energy.real, e_lowest, config.grid.dt,
                config.output.screen_update, config.tolerance, log,
                measured_delta=measured_delta,
            )
        tau = step * config.grid.dt

        # snapshot: symmetrisation persists (componentwise); the stale-norm
        # rescale is file-only (PARITY divergence 8); complex exists only in
        # the written file
        if config.output.snap_update is not None and step % config.output.snap_update == 0:
            sym_r = geometry.frame_with_halo(jnp.asarray(ops.get(pr)), ext)
            sym_i = geometry.frame_with_halo(jnp.asarray(ops.get(pi)), ext)
            sym_r = initial.symmetrise_wavefunction(config, sym_r)
            sym_i = initial.symmetrise_wavefunction(config, sym_i)
            pr = ops.put(geometry.work_area(sym_r, ext))
            pi = ops.put(geometry.work_area(sym_i, ext))
            inv_stale = 1.0 / math.sqrt(obs.norm2)
            log.info("Saving partially converged wavefunction %d to disk.", wnum)
            try:
                writers.wavefunction(
                    (
                        np.asarray(geometry.work_area(sym_r, ext))
                        + 1j * np.asarray(geometry.work_area(sym_i, ext))
                    )
                    * inv_stale,
                    wnum, False, config.project_name, config.output.file_type,
                    output_root=config.output_root,
                )
            except errors.WaferError as exc:
                log.warning("Could not output partial wavefunction: %s", exc)

        diff = abs(norm_energy - last_energy)
        # batched rows carry the device's convergence verdict (complex
        # modulus on the real pair — make_batched_runner split_pair mode)
        converged_now = (
            dev_done if dev_done is not None else diff < config.tolerance
        )
        if converged_now:
            if dev_done is not None:
                pr, pi = batch_phi_conv  # the measured ψ pair of this row
                rows_pending.clear()
                batch_phi_next = batch_phi_conv = None
            if progress is not None:
                progress.finish()
            print(terminal.print_measurements(tau, diff, obs))
            writers.finalise_measurement(
                obs, wnum, float(config.grid.size.x), config.project_name,
                config.output.file_type, output_root=config.output_root,
            )
            if config.output.snap_update is not None:
                try:
                    writers.remove_partial(
                        wnum, config.project_name, config.output.file_type,
                        output_root=config.output_root,
                    )
                except errors.WaferError:
                    pass
            converged = True
            break
        last_energy = norm_energy

        if progress is not None:
            estimate = eta(step, diff_old, float(diff), config)
            if estimate is not None:
                cycles = step / config.output.screen_update
                progress.set_position(
                    int(math.floor(100.0 - estimate / (cycles + estimate) * 100.0))
                )
            progress.set_message(terminal.print_measurements(tau, diff, obs))

        if config.max_steps is not None and step > config.max_steps:
            break

        if rows_pending:
            # more device-batch rows pending: advance the cadence only
            diff_old = float(diff)
            step += su
            continue
        if batch_phi_next is not None:
            # last row of a device batch: adopt the already-evolved ψ pair
            pr, pi = batch_phi_next
            batch_phi_next = batch_phi_conv = None
            diff_old = float(diff)
            step += su
            continue

        if delayed_gs and n_lower > 0:
            # delayed chunk: ground per-step-norm instance, no stores
            pr, pi = ops_dgs.evolve_chunk_psn(
                pr, pi, ar_d, ai_d, br_d, bi_d, dgs_store, dgs_store
            )
        else:
            chunk_fn = (
                ops.evolve_chunk_psn if per_step_norm else ops.evolve_chunk
            )
            pr, pi = chunk_fn(pr, pi, ar_d, ai_d, br_d, bi_d, sr_d, si_d)
        diff_old = float(diff)
        step += config.output.screen_update

    if config.output.save_wavefns:
        try:
            writers.wavefunction(
                np.asarray(ops.get(pr)) + 1j * np.asarray(ops.get(pi)),
                wnum, converged, config.project_name, config.output.file_type,
                output_root=config.output_root,
            )
        except errors.WaferError as exc:
            log.warning("Could not write wavefunction to disk: %s", exc)

    if not converged:
        raise errors.MaxStepError()
    dgs_state.log_converged(log, wnum, step)
    pair = (jnp.asarray(ops.get(pr)), jnp.asarray(ops.get(pi)))
    w_store.append(pair)
    return SolveResult(
        wnum=wnum, converged=True, observables=obs, steps=step, phi=(pr, pi)
    )
