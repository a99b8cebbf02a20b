"""Sharded convergence driver: the multi-chip counterpart of solver.run.

Same outer-loop semantics as the single-device driver (convergence every
``screen_update`` steps, snapshot/restart lifecycle, per-state Gram-Schmidt)
with interior-only arrays block-partitioned over the configured mesh.
"""

from __future__ import annotations

import logging
import math
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from wavefarm import errors, geometry
from wavefarm.config import Config
from wavefarm.models import initial, potentials as potentials_mod
from wavefarm.ops.observables import Observables
from wavefarm.parallel.mesh import make_mesh
from wavefarm.parallel.sharded import ShardedOps
from wavefarm.solver import DelayedGramState, SolveResult, eta


def _interior(config: Config, padded):
    return geometry.work_area(padded, config.central_difference.ext)


def run_sharded(
    config: Config,
    log=None,
    seed: Optional[int] = None,
    mesh=None,
    progress_factory=None,
    ic_overrides=None,
) -> List[SolveResult]:
    """Solve all requested states on a device mesh.

    ``ic_overrides``: optional ``{wnum: padded psi}`` explicit initial
    conditions (the multigrid coarse→fine hand-over, solver.py)."""
    log = log or logging.getLogger("wafer")
    if seed is None:
        # honour the config's reproducibility seed exactly like
        # solver.solve does (a None seed makes the Gaussian IC draw from
        # os.urandom — config.seed must not be silently ignored here)
        seed = config.seed
    from wavefarm.io import writers
    from wavefarm.utils import terminal

    if config.potential.is_complex:
        from wavefarm.ops import split_complex as sc

        if not sc.backend_supports_complex():
            from wavefarm.parallel.sharded_split import run_sharded_split

            log.info(
                "Backend lacks complex dtypes; using the sharded "
                "split-complex path"
            )
            return run_sharded_split(
                config, log, seed=seed, mesh=mesh,
                progress_factory=progress_factory, ic_overrides=ic_overrides,
            )

    if mesh is None:
        if config.mesh.slices > 1:
            # multi-slice tier: hierarchical (sl, gx, gy, gz) mesh, slice
            # axis on process boundaries (parallel/multislice.py)
            from wavefarm.parallel.multislice import make_multislice_mesh

            mesh = make_multislice_mesh(
                config.mesh.as_tuple(), config.mesh.slices
            )
        else:
            mesh = make_mesh(config.mesh.as_tuple())

    # Analytic potentials: build only per-shard blocks on each process
    # (O(shard) host memory via generate(shape, offset) — the reference's
    # indexed generation is embarrassingly local, src/potential.rs:46-62).
    # File/script potentials and save_potential need the global array.
    from wavefarm.config import PotentialType

    blocked = config.potential not in (
        PotentialType.FROM_FILE, PotentialType.FROM_SCRIPT
    ) and not config.output.save_potential
    if blocked:
        pots = potentials_mod.load_arrays_meta(config, log)
        v_int = a_int = b_int = r2_grid = None
    else:
        pots = potentials_mod.load_arrays(config, log)
        v_int = _interior(config, pots.v)
        a_int = _interior(config, pots.a)
        b_int = _interior(config, pots.b)
        r2_grid = geometry.r2_index_grid(
            config.work_size(), config.grid.size.as_tuple(),
            dtype=config.real_dtype,
        )

    w_store: List[jnp.ndarray] = []  # interior-only, host-global jax arrays
    if config.wavenum > 0:
        from wavefarm.io import readers

        for w in readers.load_wavefunctions(config, log):
            w_store.append(_interior(config, jnp.asarray(w, dtype=config.dtype)))

    log.info("Starting calculation (sharded over mesh %s)", dict(mesh.shape))
    results = []
    for wnum in range(config.wavenum, config.wavemax + 1):
        progress = progress_factory(wnum) if progress_factory is not None else None
        results.append(
            _solve_state(
                config, log, mesh, wnum, w_store,
                v_int, a_int, b_int, r2_grid, pots, seed, progress,
                ic_override=(
                    ic_overrides.get(wnum) if ic_overrides is not None else None
                ),
            )
        )
    return results


def _select_ic(config, log, wnum, w_store, seed, ic_override=None):
    from wavefarm.io import readers

    if ic_override is not None:
        log.info(
            "Using explicit in-memory initial condition for state %d "
            "(multigrid hand-over)", wnum,
        )
        return _interior(config, jnp.asarray(ic_override, dtype=config.dtype))
    if wnum > 0:
        try:
            wfn = readers.wavefunction(
                wnum,
                config.padded_size(),
                config.central_difference.bb,
                config.output.file_type,
                log,
                input_dir=config.input_dir,
            )
            log.info("Loaded (current) wavefunction %d from disk", wnum)
            return _interior(config, jnp.asarray(wfn, dtype=config.dtype))
        except errors.WaferError:
            log.info("Loaded wavefunction %d from memory as initial condition", wnum - 1)
            # seeded perturbation: an exact clone can Gram-Schmidt-cancel
            # bitwise to zero in f32 (see initial.perturb_clone); interior
            # arrays draw the same noise field as the padded drivers
            return initial.perturb_clone(
                config, w_store[wnum - 1], wnum, seed=seed, padded=False
            )
    return _interior(config, initial.set_initial_conditions(config, log, seed=seed))


def _solve_state(
    config, log, mesh, wnum, w_store, v_int, a_int, b_int, r2_grid, pots,
    seed, progress, ic_override=None,
):
    from wavefarm.io import writers
    from wavefarm.utils import terminal

    n_lower = wnum
    blocked = v_int is None  # per-shard generation (see run_sharded)
    sub_deferred = (
        blocked
        and pots.pot_sub_array is None
        and config.potential.variable_pot_sub
    )
    if len(mesh.shape) == 4:  # hierarchical multi-slice mesh
        from wavefarm.parallel.multislice import MultiSliceOps as ops_cls
    else:
        ops_cls = ShardedOps
    ops_kw = dict(
        has_pot_sub_array=pots.pot_sub_array is not None or sub_deferred,
        pot_sub_scalar=pots.pot_sub_scalar,
    )
    ops = ops_cls(config, mesh, n_lower, **ops_kw)
    phi = ops.put(_select_ic(config, log, wnum, w_store, seed, ic_override))
    ext = config.central_difference.ext
    if blocked:
        # interior block (i, j, k) sits at padded index (i+ext, j+ext, k+ext)
        v_d = ops.put_blocks(
            lambda shp, off: potentials_mod.generate(
                config, shp, tuple(o + ext for o in off)
            ),
            dtype=config.dtype,
        )
        a_d, b_d = jax.jit(
            lambda v: potentials_mod.build_ab(v, config.grid.dt, pots.v_shift)
        )(v_d)
        r2_d = ops.put_blocks(
            lambda shp, off: geometry.r2_index_grid(
                shp, config.grid.size.as_tuple(), dtype=config.real_dtype,
                offset=off,
            ),
            dtype=config.real_dtype,
        )
    else:
        v_d = ops.put(v_int)
        a_d = ops.put(a_int)
        b_d = ops.put(b_int)
        r2_d = ops.put(r2_grid)
    if pots.pot_sub_array is not None:
        sub_d = ops.put(pots.pot_sub_array)
    elif sub_deferred:
        # FullCornell's indexed V(∞) array, built per shard on work indices
        sub_d = ops.put_blocks(
            lambda shp, off: potentials_mod.potential_sub_array(
                config, shp, off
            ),
            dtype=config.real_dtype,
        )
    else:
        sub_d = ops.dummy_pot_sub()
    store_d = ops.put_store(jnp.stack(w_store[:n_lower]) if n_lower else None)

    # Delayed re-orthogonalisation (solver.delayed_gram_gate; PARITY #12)
    # on the sharded driver: delayed chunks run a ground (n_lower = 0)
    # per-step-norm ops instance — no stored-state projections on any
    # shard. Both instances share the mesh's layout permutation, so the
    # placed arrays transfer; inactive under sync_update batching like
    # solve().
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
        for w in w_store[:n_lower]:
            # pre-projection observables of each stored state (the
            # measure's energy/norm2 rows are computed before it
            # normalises/projects)
            (e_l, n2_l, _v_l, _r_l), _pp = ops.measure(
                ops.put(w), v_d, r2_d, sub_d, store_d
            )
            e_ls.append(float(jnp.asarray(e_l).real) / float(n2_l))
        ops_dgs = ops_cls(config, mesh, 0, **ops_kw)
        e_lowest = min(e_ls)
        dgs_store = ops_dgs.put_store(None)

    is_complex = jnp.iscomplexobj(phi)
    terminal.print_observable_header(wnum)

    step = 0
    converged = False
    last_energy = float("inf")
    diff_old = float("inf")
    obs = None
    per_step_norm = False

    # Device-side convergence batching (sync_update — the same opt-in
    # cadence contract as solver.solve: per-chunk observables, snapshot
    # and max_steps semantics replayed on the host from the batch's rows).
    # Spec: src/grid.rs:126-220. The shared runner threads every device
    # array through an env argument, never a jit closure.
    import jax as _jax
    from wavefarm.solver import make_batched_runner, pick_batch_k

    k_sync = config.sync_update or 1
    su = config.output.screen_update
    if k_sync > 1 and not _jax.config.jax_enable_x64:
        log.warning(
            "sync_update=%d with jax_enable_x64 off: the on-device "
            "convergence verdict is f32 and may differ from the host check "
            "by an ulp at the tolerance edge",
            k_sync,
        )
    _batched_cache: dict = {}
    _batch_env = {
        "v": v_d, "r2": r2_d, "sub": sub_d, "a": a_d, "b": b_d,
        "store": store_d,
    }

    def _measure_env(phi, env):
        return ops.measure(phi, env["v"], env["r2"], env["sub"], env["store"])

    def _get_batched(k_chunks: int, psn: bool):
        key = (k_chunks, psn)
        if key not in _batched_cache:
            chunk_fn = ops.evolve_chunk_psn if psn else ops.evolve_chunk

            def _evolve_env(phi, env, _fn=chunk_fn):
                return _fn(phi, env["a"], env["b"], env["store"])

            _batched_cache[key] = make_batched_runner(
                _measure_env, _evolve_env, config.tolerance, is_complex,
                k_chunks,
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
                if is_complex:
                    led = (
                        jnp.complex128
                        if _jax.config.jax_enable_x64
                        else jnp.complex64
                    )
                else:
                    led = (
                        jnp.float64
                        if _jax.config.jax_enable_x64
                        else jnp.float32
                    )
                phi_f, phi_conv, out_rows = _get_batched(k_batch, per_step_norm)(
                    phi, jnp.asarray(last_energy, dtype=led), _batch_env
                )
                es, n2s, vinfs, r2s_, execs, dones = (
                    np.asarray(x) for x in out_rows
                )
                for j in range(k_batch):
                    if not bool(execs[j]):
                        break
                    rows_pending.append((
                        Observables(
                            energy=(
                                complex(es[j]) if is_complex else float(es[j])
                            ),
                            norm2=float(n2s[j]),
                            v_infinity=float(vinfs[j]),
                            r2=float(r2s_[j]),
                        ),
                        bool(dones[j]),
                    ))
                batch_phi_next = phi_f
                batch_phi_conv = phi_conv
                continue
            if delayed_gs and n_lower > 0:
                from wavefarm.solver import _max_rel_overlap

                measured_delta = float(_max_rel_overlap(phi, store_d))
            (e, n2, vinf, r2), phi = ops.measure(phi, v_d, r2_d, sub_d, store_d)
            energy = complex(e) if is_complex else float(e)
            obs = Observables(
                energy=energy, norm2=float(n2), v_infinity=float(vinf),
                r2=float(r2),
            )
        if not (math.isfinite(obs.norm2) and obs.norm2 > 0.0):
            raise errors.NonFiniteError("norm²", step)
        norm_energy = obs.energy / obs.norm2
        from wavefarm.solver import stable_dt_bound

        if (
            n_lower == 0
            and config.grid.dt
            <= stable_dt_bound(
                config.central_difference.value, config.grid.dn, config.mass
            )
        ):
            # f32 scale-drift guard (see solver.drift_guard): re-evaluated
            # per measure with hysteresis — a hot IC engages psn for the
            # transient chunks, then per-chunk normalisation resumes
            from wavefarm.solver import drift_guard

            per_step_norm = drift_guard(
                per_step_norm,
                float(jnp.asarray(norm_energy).real), pots.v_shift,
                config.grid.dt, config.output.screen_update,
                60.0 if config.real_dtype == jnp.float32 else 600.0, log,
            )
        if n_lower > 0 and e_lowest is not None:
            # delayed re-orthogonalisation gate + flap cooldown (solve())
            delayed_gs = dgs_state.update(
                float(jnp.asarray(norm_energy).real), e_lowest,
                config.grid.dt, config.output.screen_update,
                config.tolerance, log, measured_delta=measured_delta,
            )
        tau = step * config.grid.dt

        if config.output.snap_update is not None and step % config.output.snap_update == 0:
            # gather → pad → symmetrise, then feed the symmetrised ψ back
            # onto the mesh: the reference's snapshot block operates on the
            # *live* wavefunction (src/grid.rs:137-141). The stale-norm²
            # rescale applies to the written file only (matches
            # solver.solve; PARITY divergence 8).
            sym = geometry.frame_with_halo(ops.get(phi), config.central_difference.ext)
            sym = initial.symmetrise_wavefunction(config, sym)
            phi = ops.put(geometry.work_area(sym, config.central_difference.ext))
            snap = sym / jnp.sqrt(obs.norm2).astype(sym.dtype)
            log.info("Saving partially converged wavefunction %d to disk.", wnum)
            try:
                writers.wavefunction(
                    np.asarray(geometry.work_area(snap, config.central_difference.ext)),
                    wnum, False, config.project_name, config.output.file_type,
                    output_root=config.output_root,
                )
            except errors.WaferError as exc:
                log.warning("Could not output partial wavefunction: %s", exc)

        diff = abs(norm_energy - last_energy)
        converged_now = (
            dev_done if dev_done is not None else diff < config.tolerance
        )
        if converged_now:
            if dev_done is not None:
                phi = batch_phi_conv  # the measured psi of this row
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
                cycles_done = step / config.output.screen_update
                pct = math.floor(100.0 - estimate / (cycles_done + estimate) * 100.0)
                progress.set_position(int(pct))
            progress.set_message(terminal.print_measurements(tau, diff, obs))

        if config.max_steps is not None and step > config.max_steps:
            break

        if rows_pending:
            # more device-batch rows pending: advance the cadence only
            diff_old = float(diff)
            step += su
            continue
        if batch_phi_next is not None:
            # last row of a device batch: adopt the already-evolved psi
            phi = batch_phi_next
            batch_phi_next = batch_phi_conv = None
            diff_old = float(diff)
            step += su
            continue

        if delayed_gs and n_lower > 0:
            # delayed chunk: the ground per-step-norm instance, no stores
            phi = ops_dgs.evolve_chunk_psn(phi, a_d, b_d, dgs_store)
        else:
            chunk_fn = ops.evolve_chunk_psn if per_step_norm else ops.evolve_chunk
            phi = chunk_fn(phi, a_d, b_d, store_d)
        diff_old = float(diff)
        step += config.output.screen_update

    if config.output.save_wavefns:
        try:
            writers.wavefunction(
                np.asarray(ops.get(phi)), wnum, converged, config.project_name,
                config.output.file_type, output_root=config.output_root,
            )
        except errors.WaferError as exc:
            log.warning("Could not write wavefunction to disk: %s", exc)

    if not converged:
        raise errors.MaxStepError()

    dgs_state.log_converged(log, wnum, step)
    w_store.append(ops.get(phi))
    return SolveResult(wnum=wnum, converged=True, observables=obs, steps=step, phi=phi)
