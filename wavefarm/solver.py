"""Convergence driver: per-state solve loop and multi-state orchestration.

Functional re-design of the reference's ``grid::run``/``solve``
(src/grid.rs:31-246): the hot path (evolve chunk + fused observables +
normalise + Gram-Schmidt) stays jit-compiled on device; the host loop only
syncs four scalars every ``screen_update`` steps to drive convergence checks,
snapshots and progress output — preserving the reference's exact cadence
(convergence is tested every ``screen_update`` steps and ``step`` advances by
that quantum, src/grid.rs:216-220).
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from wavefarm import errors, geometry
from wavefarm.config import Config
from wavefarm.models import initial, potentials as potentials_mod
from wavefarm.models.potentials import Potentials
from wavefarm.ops import gram_schmidt, stencil
from wavefarm.ops.observables import Observables, compute_observables_device


@dataclass
class SolveResult:
    """Outcome of one state's convergence loop."""

    wnum: int
    converged: bool
    observables: Observables
    steps: int
    phi: jnp.ndarray


# The overlaps below are contractions (dot_general). Without an explicit
# precision a GPU may run an f32 contraction in TF32 (~1e-3 relative),
# which would misreport the ~1e-4 admixtures the delayed-GS gate compares.
_HIGHEST = jax.lax.Precision.HIGHEST


@jax.jit
def _max_rel_overlap(phi, stacked):
    """max_s |⟨l_s|ψ⟩| / (‖l_s‖·‖ψ‖) — the measured lower-state admixture
    feeding the delayed-re-orthogonalisation gate's override."""
    wc = jnp.conj(phi) if jnp.iscomplexobj(phi) else phi
    pn = jnp.sqrt(jnp.sum(jnp.real(wc * phi)))
    sc_ = jnp.conj(stacked) if jnp.iscomplexobj(stacked) else stacked
    ln = jnp.sqrt(jnp.sum(jnp.real(sc_ * stacked), axis=(1, 2, 3)))
    ov = jnp.abs(jnp.tensordot(sc_, phi, axes=3, precision=_HIGHEST))
    return jnp.max(ov / (ln * pn))


@jax.jit
def _max_rel_overlap_sc(pr, pi, sr, si):
    """Split-complex counterpart of :func:`_max_rel_overlap`."""
    pn = jnp.sqrt(jnp.sum(pr * pr + pi * pi))
    ln = jnp.sqrt(jnp.sum(sr * sr + si * si, axis=(1, 2, 3)))

    def dot(x, y):
        return jnp.tensordot(x, y, axes=3, precision=_HIGHEST)

    o_re = dot(sr, pr) + dot(si, pi)
    o_im = dot(sr, pi) - dot(si, pr)
    return jnp.max(jnp.sqrt(o_re * o_re + o_im * o_im) / (ln * pn))


@partial(jax.jit, static_argnames=("order", "n_lower"))
def _measure_and_prepare(
    phi, v, r2_grid, pot_sub_array, pot_sub_scalar, w_store, order, dn, mass, n_lower
):
    """Fused: observables on current ψ, then normalise, then orthogonalise
    (reference loop head: src/grid.rs:127-135)."""
    e, n2, vinf, r2 = compute_observables_device(
        phi, v, r2_grid, pot_sub_array, pot_sub_scalar, order, dn, mass
    )
    phi = gram_schmidt.normalise_wavefunction(phi, n2)
    phi = gram_schmidt.orthogonalise_wavefunction(phi, w_store, n_lower)
    return (e, n2, vinf, r2), phi


def stable_dt_bound(order: str, dn: float, mass: float) -> float:
    """Largest dt for which the explicit kinetic update is non-amplifying:
    dt ≤ 2/λ_max with λ_max = (c₀ + 6Σ|cᵢ|)/(k·dn²·m), the worst-case 3D
    eigenvalue of the discrete −∇²/(2m) operator (c₀ is the 3D-summed center
    coefficient; the per-axis tap signs alternate so all taps align at the
    zone corner θ = π). For ThreePoint this reduces to the reference's
    dn²·m/3 rule (src/config.rs:362-365, m = 1); FivePoint/SevenPoint are
    tighter (0.25/≈0.22·dn²·m — the reference checks only the 3-point rule
    for all stencils)."""
    _offs, coeffs, center_c, k = geometry.stencil_coefficients(order)
    lam = (center_c + 6.0 * sum(abs(c) for c in coeffs)) / (k * dn * dn * mass)
    return 2.0 / lam


def pick_batch_k(
    step: int,
    k_sync: int,
    su: int,
    snap_update: Optional[int],
    max_steps: Optional[int],
) -> int:
    """Chunks the next device batch may run (sync_update batching).

    Starts after the first chunk (the per-step-norm decision is host-side), never crosses a snapshot step (its host IO needs ψ), and
    never exceeds the max_steps guard's horizon. On the max_steps tail the
    batch degrades through a small fixed ladder {k_sync, 4, 2, 1} instead of
    collapsing straight to per-chunk — each distinct k is a separate jit
    compile, so the ladder bounds graph count while keeping the batching
    win on long bounded runs (reference cadence: src/grid.rs:211-220)."""
    if k_sync <= 1 or step == 0:
        return 1
    k = k_sync
    if snap_update is not None:
        to_snap = (-step) % snap_update
        n_chunks = to_snap // su
        if n_chunks == 0:
            return 1  # this chunk writes the snapshot
        # a recurring snap-aligned k costs at most one extra compile
        k = min(k, n_chunks)
    if max_steps is not None:
        remaining = (max_steps - step) // su + 1
        if remaining < k:
            # short tail: largest ladder rung that still fits, so a long
            # bounded run keeps amortising instead of going per-chunk
            for cand in (4, 2):
                if cand <= remaining and cand < k:
                    return cand
            return 1
    return max(k, 1)


def make_batched_runner(measure_fn, evolve_fn, tolerance, is_complex,
                        k_chunks: int, split_pair: bool = False):
    """Jitted device-side convergence batch (``sync_update``): runs
    ``k_chunks`` measure → check → evolve iterations in one ``lax.scan``
    with the convergence verdict on-device, emitting every chunk's
    observables for host replay. Shared by the single-device, sharded and
    split-complex drivers (identical cadence contract, src/grid.rs:126-220).

    ``measure_fn(phi, env) -> ((e, n2, vinf, r2), phi)`` and
    ``evolve_fn(phi, env) -> phi`` must read every device array through
    ``env`` — the env pytree is a jit *argument*, never a closure: large
    arrays baked into the graph as constants bloat the program past what
    XLA will serialise (a 2 GiB limit).

    ``split_pair``: the split-complex variant (complex dtypes must never
    reach a device without complex support — see ops/split_complex.py):
    ``measure_fn`` returns ``((e_re, e_im, n2, vinf, r2), (pr, pi))`` with
    all-real scalars, ``last_e0`` is the (2,)-vector [Re, Im] of the
    previous normalised energy, and the on-device convergence test is the
    complex modulus |ΔE/N| < tolerance computed on the real pair (the host
    uses C ``hypot`` via ``abs(complex)``, whose rounding can differ from
    the device's sqrt-of-squares by an ulp at the tolerance edge — same
    caveat class as running without x64)."""

    def _batched(phi0, last_e0, env):
        def body(carry, _):
            phi_c, phi_conv, last_e, done = carry

            def work(args):
                phi_c, phi_conv, last_e = args
                if split_pair:
                    (e_re, e_im, n2, vinf, r2), phi_n = measure_fn(phi_c, env)
                    # convergence quotient in f64 when x64 is live (the CLI
                    # guarantees it): the same f64 arithmetic as the host
                    # check replaying this row
                    qdt = (
                        jnp.float64
                        if jax.config.jax_enable_x64
                        else e_re.dtype
                    )
                    norm_e = (
                        jnp.stack([e_re, e_im]).astype(qdt)
                        / n2.astype(qdt)
                    ).astype(last_e.dtype)
                    d = norm_e - last_e
                    done_now = (
                        jnp.sqrt(d[0] * d[0] + d[1] * d[1]) < tolerance
                    )
                    row = (e_re, e_im, n2, vinf, r2)
                else:
                    (e, n2, vinf, r2), phi_n = measure_fn(phi_c, env)
                    # convergence quotient in f64 when x64 is live (the CLI
                    # guarantees it): bit-identical to the host check
                    if jax.config.jax_enable_x64:
                        qdt = jnp.complex128 if is_complex else jnp.float64
                        norm_e = e.astype(qdt) / n2.astype(jnp.float64)
                    else:
                        norm_e = e / n2
                    norm_e = norm_e.astype(last_e.dtype)
                    done_now = jnp.abs(norm_e - last_e) < tolerance
                    row = (e, n2, vinf, r2)
                phi_next = jax.lax.cond(
                    done_now,
                    lambda p: p,
                    lambda p: evolve_fn(p, env),
                    phi_n,
                )
                phi_conv2 = jax.lax.cond(
                    done_now, lambda _: phi_n, lambda _: phi_conv, None
                )
                return (
                    (phi_next, phi_conv2, norm_e, done_now),
                    row + (jnp.bool_(True), done_now),
                )

            def idle(args):
                phi_c, phi_conv, last_e = args
                rdt = (
                    jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
                )
                one = jnp.ones((), rdt)
                zf = jnp.zeros((), rdt)
                if split_pair:
                    # split observables ride hybrid_sum: f64 under x64,
                    # else the ψ dtype (ops/split_complex.py)
                    mdt = (
                        jnp.float64
                        if jax.config.jax_enable_x64
                        else jax.tree_util.tree_leaves(phi_c)[0].dtype
                    )
                    zm = jnp.zeros((), mdt)
                    row = (zm, zm, jnp.ones((), mdt), zm, zm)
                else:
                    row = (jnp.zeros((), last_e.dtype), one, zf, zf)
                return (
                    (phi_c, phi_conv, last_e, jnp.bool_(True)),
                    row + (jnp.bool_(False), jnp.bool_(True)),
                )

            return jax.lax.cond(done, idle, work, (phi_c, phi_conv, last_e))

        init = (phi0, phi0, last_e0, jnp.bool_(False))
        (phi_f, phi_conv, _le, _done), rows = jax.lax.scan(
            body, init, None, length=k_chunks
        )
        return phi_f, phi_conv, rows

    return jax.jit(_batched)


def eta(step: int, diff_old: float, diff_new: float, config: Config) -> Optional[float]:
    """Estimated ``screen_update`` cycles to convergence via point-slope fit
    of log₁₀(diff) (reference: src/grid.rs:254-283)."""
    if diff_new <= 0.0 or diff_old <= 0.0:
        return None
    x1 = float(step)
    y1 = math.log10(diff_new)
    rise = y1 - math.log10(diff_old)
    run = float(config.output.screen_update)
    if run == 0.0:
        return None
    m = rise / run
    if m == 0.0:
        return None
    x = (math.log10(config.tolerance) - y1) / m + x1
    if math.isfinite(x):
        estimate = math.floor((x - x1) / run)
        if estimate > 0.0:
            return estimate
    return None


def _select_initial_condition(
    config: Config, log, wnum: int, w_store: List[jnp.ndarray], seed=None
) -> jnp.ndarray:
    """IC preference: disk (current state, incl. ``_partial``) → previous
    converged state → configured generator (reference: src/grid.rs:60-100)."""
    from wavefarm.config import InitialCondition
    from wavefarm.io import readers

    if wnum > 0:
        init_size = config.padded_size()
        try:
            wfn = readers.wavefunction(
                wnum,
                init_size,
                config.central_difference.bb,
                config.output.file_type,
                log,
                input_dir=config.input_dir,
            )
            log.info("Loaded (current) wavefunction %d from disk", wnum)
            if config.init_condition is not InitialCondition.FROM_FILE and wnum > config.wavenum:
                log.warning(
                    "Loaded a higher order wavefunction from disk although Initial "
                    "conditions are set to '%s'.",
                    config.init_condition.display(),
                )
            return jnp.asarray(wfn, dtype=config.dtype)
        except errors.WaferError:
            log.info("Loaded wavefunction %d from memory as initial condition", wnum - 1)
            # seeded perturbation: an exact clone can Gram-Schmidt-cancel
            # bitwise to zero in f32 (see initial.perturb_clone)
            return initial.perturb_clone(
                config, w_store[wnum - 1], wnum, seed=seed
            )
    return initial.set_initial_conditions(config, log, seed=seed)


def solve(
    config: Config,
    log,
    debug_level: int,
    pots: Potentials,
    wnum: int,
    w_store: List[jnp.ndarray],
    seed: Optional[int] = None,
    progress=None,
    ic_override=None,
) -> SolveResult:
    """Converge one state (reference ``solve``, src/grid.rs:50-246).

    ``ic_override``: explicit initial condition (a padded ψ array, or a
    (re, im) pair on the split-complex path), bypassing the disk/previous-
    state/generator preference — used by the multigrid driver to hand a
    coarse level's upsampled state to the next level."""
    from wavefarm.io import writers
    from wavefarm.utils import terminal

    if seed is None:
        seed = config.seed
    if config.potential.is_complex:
        from wavefarm.ops import split_complex as sc

        if not sc.backend_supports_complex():
            log.info(
                "Backend lacks complex dtypes; using the split-complex path "
                "for state %d",
                wnum,
            )
            return _solve_split(
                config, log, debug_level, pots, wnum, w_store, seed, progress,
                ic_override=ic_override,
            )
    if ic_override is not None:
        phi = ic_override
    else:
        phi = _select_initial_condition(config, log, wnum, w_store, seed=seed)

    order = config.central_difference.value
    ext = config.central_difference.ext
    dn, dt, mass = config.grid.dn, config.grid.dt, config.mass
    is_complex = jnp.iscomplexobj(phi)
    if config.precision == "f32" and config.tolerance < 1e-6:
        log.warning(
            "tolerance %.1e is below the f32 noise floor (~1e-6 relative; "
            "per-step normalisation injects rounding noise) — the run may "
            "never converge. Use precision: f64 for tighter tolerances.",
            config.tolerance,
        )

    r2_grid = geometry.r2_index_grid(
        config.work_size(), config.grid.size.as_tuple(), dtype=config.real_dtype
    )
    n_lower = wnum
    stacked = jnp.stack(w_store[:n_lower]) if n_lower > 0 else None

    # Delayed re-orthogonalisation (SURVEY §7 lever; gate:
    # delayed_gram_gate): needs the lowest stored-state energy to bound
    # the regrowth — one Rayleigh quotient per stored state, once per
    # solve.
    delayed_gs = False
    dgs_state = DelayedGramState()
    e_lowest = None
    if n_lower > 0 and config.delayed_gram and (config.sync_update or 1) > 1:
        log.info(
            "delayed_gram is inactive under sync_update batching: the "
            "gate re-evaluates per measure (and reads a per-boundary "
            "admixture), which the device-batched scan cannot replay "
            "without breaking its exact per-chunk-equivalence contract"
        )
    if n_lower > 0 and config.delayed_gram and (config.sync_update or 1) == 1:
        e_ls = []
        for w in w_store[:n_lower]:
            e_l, n2_l, _vi_l, _r2_l = compute_observables_device(
                w, pots.v, r2_grid, pots.pot_sub_array,
                pots.pot_sub_scalar, order, dn, mass,
            )
            e_ls.append(
                float(jnp.asarray(e_l).real) / float(jnp.asarray(n2_l))
            )
        e_lowest = min(e_ls)

    terminal.print_observable_header(wnum)

    step = 0
    converged = False
    last_energy = float("inf")
    diff_old = float("inf")
    obs = None
    # Ground-state per-step renormalisation guard: ψ's scale drifts by
    # exp(−(E − v_shift)·dt·screen_update) per chunk (E ≥ v_shift always —
    # variationally E₀ > min V — so the drift is pure decay). When the
    # e-fold count would push per-element ψ² below the f32 normal range
    # (accelerators may flush denormals), route the state through the
    # per-step-normalised sweep. Re-evaluated at every measure with
    # hysteresis (drift_guard): a hot IC engages it for the transient
    # chunks, then the per-chunk normalisation resumes once E settles
    # toward E₀.
    per_step_norm = False
    _efold_limit = 60.0 if config.real_dtype == jnp.float32 else 600.0
    import time as _time

    n_points = config.grid.size.x * config.grid.size.y * config.grid.size.z
    chunk_t0 = None
    su = config.output.screen_update

    def _evolve_dispatch(phi, env):
        """One ``screen_update`` chunk of the XLA sweep (the reference
        ``evolve`` call, src/grid.rs:216). ``env`` carries every device
        array the chunk reads, so the batched jit receives them as
        arguments instead of baking them into the graph as constants."""
        if delayed_gs and n_lower > 0:
            # delayed re-orthogonalisation: the chunk runs the ground
            # per-step-norm sweep with no stored-state projections
            # (projection happens at the measure boundary; gate:
            # delayed_gram_gate)
            return stencil.evolve_chunk(
                phi, env["a"], env["b"], None, order, dt, dn,
                mass, su, 0, per_step_norm=True,
            )
        return stencil.evolve_chunk(
            phi, env["a"], env["b"], env["stacked"], order, dt, dn,
            mass, su, n_lower, per_step_norm=per_step_norm,
        )

    # ---------------------------------------------------------------- #
    # Device-side convergence batching: run ``k_sync`` measure→evolve
    # chunk iterations in one jitted lax.scan with the convergence test
    # on-device, so the host pays one device round trip per batch instead
    # of per chunk. Per-chunk cadence, printed observable rows, snapshot
    # steps, and max_steps semantics are preserved: the device emits every
    # chunk's observables and its convergence flag; the host replays them
    # through the same code path. sync_update: 1 (the default) keeps the
    # reference's exact per-chunk host cadence (src/grid.rs:126-220); the
    # batched scan is a separate compile per batch length.
    # ---------------------------------------------------------------- #
    k_sync = config.sync_update or 1
    if k_sync > 1 and not jax.config.jax_enable_x64:
        # Without x64 the device convergence quotient is f32 and can differ
        # from the host check by an ulp at the tolerance edge, so batched
        # and per-chunk runs may stop at different steps (the CLI enables
        # x64, making the verdicts bit-identical — see _get_batched).
        log.warning(
            "sync_update=%d with jax_enable_x64 off: the on-device "
            "convergence verdict is f32 and may stop a step earlier/later "
            "than the per-chunk host check near the tolerance edge",
            k_sync,
        )
    _batched_cache: dict = {}

    def _measure_env(phi, env):
        return _measure_and_prepare(
            phi, env["v"], env["r2"], env["psa"], pots.pot_sub_scalar,
            env["stacked"], order, dn, mass, n_lower,
        )

    def _get_batched(k_chunks: int):
        # keyed on the drift-guard and delayed-GS flags: the runner's scan
        # traces _evolve_env once, baking the current dispatch in
        key = (k_chunks, per_step_norm, delayed_gs)
        if key not in _batched_cache:
            _batched_cache[key] = make_batched_runner(
                _measure_env, _evolve_dispatch, config.tolerance, is_complex,
                k_chunks,
            )
        return _batched_cache[key]

    def _pick_batch_k(step: int) -> int:
        return pick_batch_k(
            step, k_sync, su, config.output.snap_update, config.max_steps
        )

    _dispatch_env = {
        "a": pots.a,
        "b": pots.b,
        "stacked": stacked,
        "v": pots.v,
        "r2": r2_grid,
        "psa": pots.pot_sub_array,
    }

    rows_pending: list = []
    batch_phi_next = None
    batch_phi_conv = None

    while True:
        measured_delta = None
        if chunk_t0 is not None:
            # throughput counter: the BASELINE.md primary metric
            wall = _time.perf_counter() - chunk_t0
            if wall > 0:
                log.debug(
                    "state %d step %d: %.0f steps/s, %.3g grid-point updates/s",
                    wnum,
                    step,
                    config.output.screen_update / wall,
                    n_points * config.output.screen_update / wall,
                )
            chunk_t0 = None
        dev_done = None
        if rows_pending:
            obs, dev_done = rows_pending.pop(0)
        else:
            k_batch = _pick_batch_k(step)
            if k_batch > 1:
                t0b = _time.perf_counter()
                if is_complex:
                    led = (
                        jnp.complex128
                        if jax.config.jax_enable_x64
                        else jnp.complex64
                    )
                else:
                    led = (
                        jnp.float64
                        if jax.config.jax_enable_x64
                        else jnp.float32
                    )
                phi_f, phi_conv, out_rows = _get_batched(k_batch)(
                    phi, jnp.asarray(last_energy, dtype=led), _dispatch_env
                )
                es, n2s, vinfs, r2s, execs, dones = (
                    np.asarray(x) for x in out_rows
                )
                wall = _time.perf_counter() - t0b
                n_exec = int(execs.sum())
                if wall > 0 and n_exec:
                    log.debug(
                        "state %d step %d: device batch of %d chunks in "
                        "%.3fs — %.3g grid-point updates/s",
                        wnum, step, n_exec, wall,
                        n_points * su * n_exec / wall,
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
                            r2=float(r2s[j]),
                        ),
                        bool(dones[j]),
                    ))
                batch_phi_next = phi_f
                batch_phi_conv = phi_conv
                continue
            if delayed_gs and n_lower > 0:
                # gate override input: pre-projection admixture (ground
                # truth for the regrowth the a-priori bound models)
                measured_delta = float(_max_rel_overlap(phi, stacked))
            (e, n2, vinf, r2), phi = _measure_and_prepare(
                phi,
                pots.v,
                r2_grid,
                pots.pot_sub_array,
                pots.pot_sub_scalar,
                stacked,
                order,
                dn,
                mass,
                n_lower,
            )
            energy = complex(e) if is_complex else float(e)
            obs = Observables(
                energy=energy, norm2=float(n2), v_infinity=float(vinf), r2=float(r2)
            )
        if not (math.isfinite(obs.norm2) and obs.norm2 > 0.0):
            if obs.norm2 == 0.0:
                log.error(
                    "norm² is exactly zero at step %d: the state collapsed "
                    "to the zero array (a degenerate excited-state seed — "
                    "see models.initial.perturb_clone), not a dt "
                    "instability",
                    step,
                )
            raise errors.NonFiniteError("norm²", step)
        norm_energy = obs.energy / obs.norm2
        # Engage only in the stable-dt regime: renormalisation is a pure
        # rescaling there, but past the stencil's stability bound it would
        # mask a genuinely divergent evolution instead of letting the
        # NonFinite guard fire. |E − s|: E > s drifts toward underflow,
        # E < s (deep wells, e.g. Dodecahedron's −100) toward overflow.
        if n_lower == 0 and dt <= stable_dt_bound(order, dn, mass):
            per_step_norm = drift_guard(
                per_step_norm, float(jnp.asarray(norm_energy).real),
                pots.v_shift, dt, config.output.screen_update,
                _efold_limit, log,
            )
        if n_lower > 0 and e_lowest is not None:
            # delayed re-orthogonalisation gate, re-evaluated per measure
            # from the freshest energy estimate (like drift_guard) plus
            # the measured pre-projection admixture (batched rows replay
            # without one — a-priori bound only there). An admixture-
            # triggered release starts a short cooldown: the measured
            # value right after a per-step-GS chunk is always tiny, so
            # without it the gate would flap chunk-by-chunk while the
            # transient regrowth persists.
            delayed_gs = dgs_state.update(
                float(jnp.asarray(norm_energy).real), e_lowest, dt,
                config.output.screen_update, config.tolerance, log,
                measured_delta=measured_delta,
            )
        tau = step * dt

        # Snapshot lifecycle (reference: src/grid.rs:137-158). The reference
        # mutates the *live* ψ here (src/grid.rs:137-141 operates on &mut
        # phi): the symmetrisation — the only mechanism re-enforcing
        # init_symmetry during evolution — persists, and so does a
        # re-normalisation with the stale norm². We persist the
        # symmetrisation but apply the stale rescale only to the written
        # file (bit-identical file contents): a pure scale factor is
        # physically inert, and persisting it both corrupts later
        # Gram-Schmidt projections when a snapshot coincides with
        # convergence (the stored lower state ends up with norm 1/√norm²)
        # and stalls f32 convergence via period-2 scale oscillation — see
        # docs/PARITY.md divergence 8.
        if config.output.snap_update is not None and step % config.output.snap_update == 0:
            phi = initial.symmetrise_wavefunction(config, phi)
            snap = gram_schmidt.normalise_wavefunction(phi, obs.norm2)
            log.info("Saving partially converged wavefunction %d to disk.", wnum)
            try:
                writers.wavefunction(
                    np.asarray(geometry.work_area(snap, ext)),
                    wnum,
                    False,
                    config.project_name,
                    config.output.file_type,
                    output_root=config.output_root,
                )
            except errors.WaferError as exc:
                log.warning(
                    "Could not output partial wavefunction per snap_update request: %s", exc
                )

        diff = abs(norm_energy - last_energy)
        # Batched rows use the device's convergence verdict — computed in
        # f64 scalars (the same arithmetic as this host check when x64 is
        # live, which the CLI guarantees), so the decisions agree; without
        # x64 the device quotient is f32 and can differ by an ulp at the
        # tolerance edge.
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
                obs,
                wnum,
                float(config.grid.size.x),
                config.project_name,
                config.output.file_type,
                output_root=config.output_root,
            )
            if config.output.snap_update is not None:
                log.info("Removing partially converged wavefunction %d from disk.", wnum)
                try:
                    writers.remove_partial(
                        wnum,
                        config.project_name,
                        config.output.file_type,
                        output_root=config.output_root,
                    )
                except errors.WaferError as exc:
                    log.warning(
                        "The temporary wavefunction_%d_partial%s file could not be removed "
                        "from the output directory: %s",
                        wnum,
                        config.output.file_type.extension,
                        exc,
                    )
            converged = True
            break
        else:
            last_energy = norm_energy

        if progress is not None:
            estimate = eta(step, diff_old, float(diff), config)
            if estimate is not None:
                cycles_done = step / config.output.screen_update
                percent = math.floor(100.0 - (estimate / (cycles_done + estimate) * 100.0))
                if math.isfinite(percent):
                    progress.set_position(int(percent))
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

        chunk_t0 = _time.perf_counter()
        phi = _evolve_dispatch(phi, _dispatch_env)

        diff_old = float(diff)
        step += config.output.screen_update

    if config.output.save_wavefns:
        log.info("Saving wavefunction %d to disk", wnum)
        try:
            writers.wavefunction(
                np.asarray(geometry.work_area(phi, ext)),
                wnum,
                converged,
                config.project_name,
                config.output.file_type,
                output_root=config.output_root,
            )
        except errors.WaferError as exc:
            log.warning("Could not write wavefunction to disk: %s", exc)

    if not converged:
        raise errors.MaxStepError()

    dgs_state.log_converged(log, wnum, step)
    w_store.append(phi)
    return SolveResult(wnum=wnum, converged=converged, observables=obs, steps=step, phi=phi)


def _solve_split(
    config: Config,
    log,
    debug_level: int,
    pots: Potentials,
    wnum: int,
    w_store: List,
    seed: Optional[int],
    progress,
    ic_override=None,
) -> SolveResult:
    """Split-complex solve loop for backends without complex dtypes:
    ψ, V, A, B are carried as (re, im) real-array pairs, with identical
    cadence and semantics to :func:`solve` (see ops/split_complex.py).
    ``ic_override``: explicit (re, im) initial pair — see :func:`solve`."""
    import dataclasses

    from wavefarm.io import writers
    from wavefarm.models import potentials as pmod
    from wavefarm.ops import split_complex as sc
    from wavefarm.utils import terminal

    ext = config.central_difference.ext
    order = config.central_difference.value
    dn, dt, mass = config.grid.dn, config.grid.dt, config.mass

    # split potential + factors (complex arrays never touch the device)
    vr, vi = pmod.generate_split(config)
    v_min = float(jnp.min(jnp.where(jnp.isfinite(vr), vr, jnp.inf)))
    # positive part only — see models/potentials.load_arrays
    v_shift = max(v_min, 0.0) if math.isfinite(v_min) else 0.0
    ar, ai, br, bi = pmod.build_ab_split(vr, vi, dt, v_shift)

    # Initial condition (reference preference, src/grid.rs:60-100): disk
    # (current state, incl. ``_partial``) → previous converged state →
    # generator. w_store items are (re, im) pairs in this mode; disk loads
    # are split host-side — complex arrays must never reach the device.
    pr = pi = None
    if ic_override is not None:
        pr, pi = ic_override
    elif wnum > 0:
        from wavefarm.config import InitialCondition
        from wavefarm.io import readers

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
            if config.init_condition is not InitialCondition.FROM_FILE and wnum > config.wavenum:
                log.warning(
                    "Loaded a higher order wavefunction from disk although Initial "
                    "conditions are set to '%s'.",
                    config.init_condition.display(),
                )
            pr = jnp.asarray(np.real(wfn), dtype=config.real_dtype)
            pi = jnp.asarray(np.imag(wfn), dtype=config.real_dtype)
        except errors.WaferError:
            pr, pi = w_store[wnum - 1]
            # seeded perturbation: an exact clone can Gram-Schmidt-cancel
            # bitwise to zero in f32 (see initial.perturb_clone)
            pi = initial.perturb_clone(
                config, pi, wnum, seed=seed, component=1, rms_from=pr
            )
            pr = initial.perturb_clone(config, pr, wnum, seed=seed)
            log.info("Loaded wavefunction %d from memory as initial condition", wnum - 1)
    if pr is None:
        from wavefarm.config import InitialCondition

        if config.init_condition is InitialCondition.FROM_FILE:
            # host-side load + split, then the generator's composition:
            # Dirichlet shell → symmetrise (src/config.rs:577-627)
            from wavefarm.io import readers

            try:
                wfn = np.asarray(
                    readers.wavefunction(
                        config.wavenum,
                        config.padded_size(),
                        config.central_difference.bb,
                        config.output.file_type,
                        log,
                        input_dir=config.input_dir,
                    )
                )
            except errors.WaferError as exc:
                raise errors.LoadWavefunctionError(config.wavenum) from exc
            pr = jnp.asarray(np.real(wfn), dtype=config.real_dtype)
            pi = jnp.asarray(np.imag(wfn), dtype=config.real_dtype)
            pr = initial.symmetrise_wavefunction(config, geometry.zero_boundary(pr, ext))
            pi = initial.symmetrise_wavefunction(config, geometry.zero_boundary(pi, ext))
        else:
            real_cfg = dataclasses.replace(
                config, potential=config.potential.real_counterpart
            )
            pr = initial.set_initial_conditions(real_cfg, log, seed=seed)
            pi = jnp.zeros_like(pr)

    r2_grid = geometry.r2_index_grid(
        config.work_size(), config.grid.size.as_tuple(), dtype=config.real_dtype
    )
    n_lower = wnum
    store_r = jnp.stack([w[0] for w in w_store[:n_lower]]) if n_lower else None
    store_i = jnp.stack([w[1] for w in w_store[:n_lower]]) if n_lower else None

    # delayed re-orthogonalisation gate input (see solve()): lowest
    # stored-state energy by split Rayleigh quotient, once per solve
    delayed_gs = False
    dgs_state = DelayedGramState()
    e_lowest_sc = None
    # inactive under sync_update batching — see solve()
    if n_lower > 0 and config.delayed_gram and (config.sync_update or 1) == 1:
        e_ls = []
        for wr_, wi_ in w_store[:n_lower]:
            (e_r, _e_i, n2_l, _vi_l, _r2_l), _pp = sc.measure_and_prepare_sc(
                wr_, wi_, vr, vi, r2_grid, pots.pot_sub_array,
                pots.pot_sub_scalar, None, None, order, dn, mass, 0,
            )
            e_ls.append(float(e_r) / float(n2_l))
        e_lowest_sc = min(e_ls)

    terminal.print_observable_header(wnum)
    step = 0
    converged = False
    last_energy = complex(float("inf"), 0.0)
    diff_old = float("inf")
    obs = None
    # f32 scale-drift guard (see solve); the drift rate is Re(E) − v_shift
    per_step_norm = False
    _efold_limit = 60.0 if config.real_dtype == jnp.float32 else 600.0
    su = config.output.screen_update

    # Device-side convergence batching (sync_update), same opt-in and
    # cadence contract as solve() (the reference has no complex
    # propagation at all, src/potential.rs:222,271; cadence spec:
    # src/grid.rs:126-220).
    k_sync = config.sync_update or 1
    if k_sync > 1 and not jax.config.jax_enable_x64:
        log.warning(
            "sync_update=%d with jax_enable_x64 off: the on-device "
            "convergence verdict is f32 and may stop a step earlier/later "
            "than the per-chunk host check near the tolerance edge",
            k_sync,
        )
    _batched_cache: dict = {}

    def _measure_env_sc(pp, env):
        return sc.measure_and_prepare_sc(
            pp[0], pp[1], env["vr"], env["vi"], env["r2"],
            env["psa"], pots.pot_sub_scalar,
            env["store_r"], env["store_i"], order, dn, mass, n_lower,
        )

    def _evolve_env_sc(pp, env):
        # one screen_update chunk — the same dispatch for the
        # direct per-chunk path and the batched scan (the batched cache
        # is keyed on per_step_norm, which the drift guard may toggle
        # between chunks)
        pr_, pi_ = pp
        if delayed_gs and n_lower > 0:
            # delayed re-orthogonalisation (gate: delayed_gram_gate): the
            # chunk runs the ground per-step-norm sweep without the
            # stored-pair projections; projection at the measure boundary
            return sc.evolve_chunk_sc(
                pr_, pi_, env["ar"], env["ai"], env["br"], env["bi"],
                None, None, order, dt, dn, mass, su, 0,
                per_step_norm=True,
            )
        return sc.evolve_chunk_sc(
            pr_, pi_, env["ar"], env["ai"], env["br"], env["bi"],
            env["store_r"], env["store_i"],
            order, dt, dn, mass, su, n_lower,
            per_step_norm=per_step_norm,
        )

    def _get_batched_sc(k_chunks: int):
        # keyed on the drift-guard/delayed-GS flags (see solve())
        key = (k_chunks, per_step_norm, delayed_gs)
        if key not in _batched_cache:
            _batched_cache[key] = make_batched_runner(
                _measure_env_sc, _evolve_env_sc, config.tolerance, True,
                k_chunks, split_pair=True,
            )
        return _batched_cache[key]

    _dispatch_env_sc = {
        "vr": vr,
        "vi": vi,
        "r2": r2_grid,
        "psa": pots.pot_sub_array,
        "store_r": store_r,
        "store_i": store_i,
        "ar": ar,
        "ai": ai,
        "br": br,
        "bi": bi,
    }

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
                    jnp.float64
                    if jax.config.jax_enable_x64
                    else jnp.float32
                )
                le = jnp.asarray(
                    [last_energy.real, last_energy.imag], dtype=led
                )
                (pr_f, pi_f), (pr_c, pi_c), out_rows = _get_batched_sc(
                    k_batch
                )((pr, pi), le, _dispatch_env_sc)
                ers, eis, n2s, vinfs, r2s, execs, dones = (
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
                            r2=float(r2s[j]),
                        ),
                        bool(dones[j]),
                    ))
                batch_phi_next = (pr_f, pi_f)
                batch_phi_conv = (pr_c, pi_c)
                continue
            if delayed_gs and n_lower > 0:
                measured_delta = float(
                    _max_rel_overlap_sc(pr, pi, store_r, store_i)
                )
            (e_re, e_im, n2, vinf, r2), (pr, pi) = sc.measure_and_prepare_sc(
                pr, pi, vr, vi, r2_grid,
                pots.pot_sub_array, pots.pot_sub_scalar,
                store_r, store_i, order, dn, mass, n_lower,
            )
            obs = Observables(
                energy=complex(float(e_re), float(e_im)),
                norm2=float(n2),
                v_infinity=float(vinf),
                r2=float(r2),
            )
        if not (math.isfinite(obs.norm2) and obs.norm2 > 0.0):
            if obs.norm2 == 0.0:
                log.error(
                    "norm² is exactly zero at step %d: the state collapsed "
                    "to the zero array (a degenerate excited-state seed — "
                    "see models.initial.perturb_clone), not a dt "
                    "instability",
                    step,
                )
            raise errors.NonFiniteError("norm²", step)
        norm_energy = obs.energy / obs.norm2
        if n_lower == 0 and dt <= stable_dt_bound(order, dn, mass):
            per_step_norm = drift_guard(
                per_step_norm, norm_energy.real, v_shift, dt,
                config.output.screen_update, _efold_limit, log,
            )
        if n_lower > 0 and e_lowest_sc is not None:
            # cooldown after admixture-triggered releases — see solve()
            delayed_gs = dgs_state.update(
                norm_energy.real, e_lowest_sc, dt,
                config.output.screen_update, config.tolerance, log,
                measured_delta=measured_delta,
            )
        tau = step * dt

        # Snapshot lifecycle, matching solve(): the symmetrisation persists
        # in the live ψ (reference src/grid.rs:137-141); the stale-norm
        # rescale applies to the written file only (PARITY divergence 8).
        # (re, im) are symmetrised componentwise and fused host-side only
        # for the file write.
        if config.output.snap_update is not None and step % config.output.snap_update == 0:
            pr = initial.symmetrise_wavefunction(config, pr)
            pi = initial.symmetrise_wavefunction(config, pi)
            inv_stale = 1.0 / math.sqrt(obs.norm2)
            log.info("Saving partially converged wavefunction %d to disk.", wnum)
            try:
                writers.wavefunction(
                    (np.asarray(geometry.work_area(pr, ext))
                     + 1j * np.asarray(geometry.work_area(pi, ext))) * inv_stale,
                    wnum,
                    False,
                    config.project_name,
                    config.output.file_type,
                    output_root=config.output_root,
                )
            except errors.WaferError as exc:
                log.warning(
                    "Could not output partial wavefunction per snap_update request: %s", exc
                )

        diff = abs(norm_energy - last_energy)
        # Batched rows use the device's convergence verdict (see solve():
        # the f64 quotient arithmetic matches this host check when x64 is
        # live; the modulus may differ by an ulp — make_batched_runner)
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
                log.info("Removing partially converged wavefunction %d from disk.", wnum)
                try:
                    writers.remove_partial(
                        wnum,
                        config.project_name,
                        config.output.file_type,
                        output_root=config.output_root,
                    )
                except errors.WaferError as exc:
                    log.warning(
                        "The temporary wavefunction_%d_partial%s file could not be removed "
                        "from the output directory: %s",
                        wnum,
                        config.output.file_type.extension,
                        exc,
                    )
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

        pr, pi = _evolve_env_sc((pr, pi), _dispatch_env_sc)
        diff_old = float(diff)
        step += su

    if config.output.save_wavefns:
        try:
            wr = np.asarray(geometry.work_area(pr, ext))
            wi_ = np.asarray(geometry.work_area(pi, ext))
            from wavefarm.io import writers as w_

            w_.wavefunction(
                wr + 1j * wi_, wnum, converged, config.project_name,
                config.output.file_type, output_root=config.output_root,
            )
        except errors.WaferError as exc:
            log.warning("Could not write wavefunction to disk: %s", exc)

    if not converged:
        raise errors.MaxStepError()
    dgs_state.log_converged(log, wnum, step)
    w_store.append((pr, pi))
    return SolveResult(wnum=wnum, converged=True, observables=obs, steps=step, phi=(pr, pi))


def drift_guard(
    per_step_norm: bool,
    energy_real: float,
    v_shift: float,
    dt: float,
    su: int,
    efold_limit: float,
    log,
    what: str = "step",
) -> bool:
    """Re-evaluate the f32 scale-drift guard from the freshest measured
    energy (PARITY divergence 7). The drift is
    ``2·|E − v_shift|·dt·screen_update`` norm² e-folds per chunk; engage
    per-step renormalisation above ``efold_limit``, and DISENGAGE once the
    drift falls under half of it (hysteresis — no flapping near the
    threshold). Re-evaluating per measure matters because the IC's energy
    is a conservative upper bound on every later Rayleigh quotient: a
    wall-discontinuous Gaussian starts at the lattice-kinetic scale
    (≈3/dn², thousands of e-folds) but decays to E₀ within a few chunks,
    after which the per-chunk normalisation applies again.
    Renormalisation is a pure rescaling, so engaging/disengaging
    mid-run leaves the trajectory identical up to float rounding."""
    drift = 2.0 * abs(energy_real - v_shift) * dt * su
    if not per_step_norm and drift > efold_limit:
        log.info(
            "Large potential offset (≈%.0f norm² e-folds per chunk): "
            "renormalising the ground state every %s",
            drift, what,
        )
        return True
    if per_step_norm and drift < 0.5 * efold_limit:
        log.info(
            "Potential-offset drift fell to ≈%.0f norm² e-folds per "
            "chunk: resuming per-chunk normalisation",
            drift,
        )
        return False
    return per_step_norm


# Delayed re-orthogonalisation numerics constants, shared by the gate and
# the per-driver state machine: δ₀ is the rounding-level post-projection
# residual budget; a measured
# pre-projection admixture above 100·δ₀ force-releases the gate.
_DGS_DELTA0 = 1e-6
_DGS_RELEASE_DELTA = 100.0 * _DGS_DELTA0


class DelayedGramState:
    """Delayed-GS gate + release-cooldown state machine — one instance per
    solve loop, shared by all four drivers (solve(), the split path, and
    both sharded drivers).

    Wraps :func:`delayed_gram_gate` with the flap cooldown (an admixture-
    triggered release starts a short cooldown, because the measured value
    right after a per-step-GS chunk is always tiny) and with a LEARNED δ₀:
    the a-priori budget assumes the post-projection residual is
    rounding-level, but some workloads regrow far faster (measured: 256³
    finite-T quarkonium 2S reaches ~2.5e-2 per 500-step chunk — ~100×
    the model, identically on two different sweep implementations, so it
    is a property of the f32 evolution, not of the sweep). Each
    admixture-triggered release back-solves the effective
    ``δ₀ = measured/exp(ΔE·dt·su)`` and feeds it to the gate, which then
    stays released instead of probing every COOLDOWN+1 chunks; a slow
    multiplicative decay (×0.7 per released boundary) re-admits delayed
    mode if the regrowth was a transient (e.g. early-run contamination)."""

    COOLDOWN_CHUNKS = 4
    DELTA0_DECAY = 0.7

    def __init__(self) -> None:
        self.engaged = False
        self._cooldown = 0
        self.delta0 = _DGS_DELTA0
        # chunks that ran delayed (one update per measure boundary)
        self.delayed_chunks = 0

    def log_converged(self, log, wnum: int, steps: int) -> None:
        """The per-state convergence record; ``extra`` carries the numbers
        for programmatic readers of the log (chip_smoke.py)."""
        log.info(
            "Calculation Converged (state %d: %d steps, %d chunks with "
            "delayed re-orthogonalisation)",
            wnum, steps, self.delayed_chunks,
            extra={"wafer_state": wnum, "wafer_steps": steps,
                   "wafer_delayed_chunks": self.delayed_chunks},
        )

    def update(
        self,
        energy_now: float,
        e_lowest: float,
        dt: float,
        su: int,
        tolerance: float,
        log,
        measured_delta: Optional[float] = None,
    ) -> bool:
        was = self.engaged
        if not was and self.delta0 > _DGS_DELTA0:
            self.delta0 = max(_DGS_DELTA0, self.delta0 * self.DELTA0_DECAY)
        if self._cooldown > 0:
            self._cooldown -= 1
            self.engaged = False
        else:
            self.engaged = delayed_gram_gate(
                self.engaged, energy_now, e_lowest, dt, su, tolerance, log,
                measured_delta=measured_delta, delta0=self.delta0,
            )
        if (
            was and not self.engaged
            and measured_delta is not None
            and measured_delta > _DGS_RELEASE_DELTA
        ):
            self._cooldown = self.COOLDOWN_CHUNKS
            de = max(0.0, energy_now - e_lowest)
            amp = math.exp(min(de * dt * su, 700.0))
            learned = measured_delta / amp
            if learned > self.delta0:
                self.delta0 = learned
                log.info(
                    "Delayed re-orthogonalisation: learned per-chunk "
                    "regrowth seed %.2e (measured %.2e / amplification "
                    "%.3g) — the gate re-engages only when its projected "
                    "bias clears tolerance again",
                    learned, measured_delta, amp,
                )
        self.delayed_chunks += self.engaged
        return self.engaged


def delayed_gram_gate(
    engaged: bool,
    energy_now: float,
    e_lowest: float,
    dt: float,
    su: int,
    tolerance: float,
    log,
    measured_delta: Optional[float] = None,
    delta0: float = _DGS_DELTA0,
) -> bool:
    """Numerics gate for delayed re-orthogonalisation (SURVEY §7's named
    excited-state lever; reference per-step cadence: src/grid.rs:674-681).

    Between projections, the component of ψ along a lower state l regrows
    RELATIVE to the target as ``exp((E_t − E_l)·dt)`` per imaginary-time
    step (the sweep damps high energies fastest). Each measure boundary
    projects exactly, leaving a rounding-level residual δ₀ (budgeted 1e-6
    here), so after one ``screen_update`` chunk without in-chunk
    projections the admixture is
    ``δ = δ₀·exp(ΔE·dt·su)`` with ``ΔE = E_t − min(E_l)``, and the
    measured-energy bias at the next boundary is ``δ²·ΔE``. Delay is
    engaged only while that bias is far below the convergence tolerance
    (engage < tol/100, release > tol/10 — hysteresis like drift_guard),
    so the converged energies are tolerance-equivalent to per-step
    Gram-Schmidt while the chunk drops the per-step stored-state
    projections and runs the ground per-step-norm sweep (docs/PARITY.md
    divergence 12).
    """
    de = max(0.0, energy_now - e_lowest)
    bias = delta0 * delta0 * math.exp(min(2.0 * de * dt * su, 700.0)) * de
    # Measured-admixture override: the a-priori bound uses the energy
    # ESTIMATE for ΔE, which a contaminated state biases toward E_lower
    # (making the bound self-confirmingly optimistic). The pre-projection
    # overlap |⟨l|ψ⟩|/(‖l‖‖ψ‖) measured at the boundary is ground truth:
    # release whenever it exceeds 100× the δ₀ budget, regardless of the
    # model. The engagement-time estimate is sound (a freshly-projected
    # state's Rayleigh quotient sits ≥ the true E_target variationally),
    # so one chunk at most runs over-contaminated before this fires.
    if engaged and measured_delta is not None and measured_delta > _DGS_RELEASE_DELTA:
        log.info(
            "Delayed re-orthogonalisation released: measured lower-state "
            "admixture %.2e exceeds the %.0e budget — resuming per-step "
            "Gram-Schmidt",
            measured_delta, 100.0 * delta0,
        )
        return False
    if not engaged and bias < tolerance / 100.0:
        log.info(
            "Delayed re-orthogonalisation engaged: projected regrowth bias "
            "%.2e per chunk << tolerance %.1e (dE=%.3g); excited chunks run "
            "the per-step-norm ground sweep, projecting at measure "
            "boundaries",
            bias, tolerance, de,
        )
        return True
    if engaged and bias > tolerance / 10.0:
        log.info(
            "Delayed re-orthogonalisation released: regrowth bias %.2e "
            "approaches tolerance %.1e — resuming per-step Gram-Schmidt",
            bias, tolerance,
        )
        return False
    return engaged


def _warn_marginal_dt(config: Config, log) -> None:
    """Warn when dt sits at (or within 2% of) the explicit stability bound.

    The reference validates only ``dt ≤ dn²/3`` and allows equality
    (src/config.rs:362-370), but AT the bound the zone-corner
    (checkerboard) mode is exactly undamped: its Laplacian term satisfies
    ``scale·acc = −2`` so the update collapses to ``ψ' = B·0 − ψ = −ψ`` —
    amplification 1 for ANY potential, real or complex. Every physical
    mode decays like ``1 − E·dt < 1``, so a long imaginary-time run
    converges toward the lattice mode instead of the ground state
    whenever the IC (or f32 noise) excites it — measured: a 512³ run with
    a wall-discontinuous Gaussian "converged" to E ≈ 2·3/dn² (the
    checkerboard energy). A few-percent margin restores damping
    (|g| = |B·2(1 − dt/bound) − 1| < 1)."""
    bound = stable_dt_bound(
        config.central_difference.value, config.grid.dn, config.mass
    )
    if config.grid.dt > 0.98 * bound:
        log.warning(
            "dt=%g is at/near the explicit stability bound %.6g: the "
            "zone-corner (checkerboard) mode is undamped there "
            "(amplification 1 for any potential), so long imaginary-time "
            "runs drift toward the lattice mode instead of the ground "
            "state. Prefer dt <= %.6g (95%% of the bound).",
            config.grid.dt, bound, 0.95 * bound,
        )


def run(
    config: Config,
    log=None,
    debug_level: int = 3,
    seed: Optional[int] = None,
    progress_factory=None,
) -> List[SolveResult]:
    """Solve all requested states (reference ``run``, src/grid.rs:31-47).

    When the config declares a multi-device mesh, dispatches to the sharded
    driver (parallel/solver_sharded.py). A ``multigrid`` schedule runs the
    coarse→fine level ladder (see :func:`_run_multigrid`); with a mesh the
    coarse levels still solve single-device and only the final level runs
    sharded."""
    log = log or logging.getLogger("wafer")
    _warn_marginal_dt(config, log)
    if config.multigrid:
        return _run_multigrid(config, log, debug_level, seed, progress_factory)
    if config.mesh.n_devices > 1:
        from wavefarm.parallel.solver_sharded import run_sharded

        return run_sharded(config, log, seed=seed, progress_factory=progress_factory)
    return _run_single(config, log, debug_level, seed, progress_factory)


def _upsample_state(phi, cfg_to: Config):
    """Trilinearly resample a converged padded state (or split (re, im)
    pair) onto ``cfg_to``'s grid, re-framed with the zero Dirichlet shell
    and re-symmetrised — the in-memory counterpart of the reference's
    resolution-changing restart (src/input.rs:149-176,667-716;
    IC composition src/config.rs:577-627)."""
    from wavefarm.io.trilerp import trilerp_resize

    ext = cfg_to.central_difference.ext

    def up(w, dtype):
        wa = np.asarray(geometry.work_area(jnp.asarray(w), ext))
        out = trilerp_resize(wa, cfg_to.work_size())
        arr = jnp.asarray(np.pad(out, ext), dtype=dtype)
        return initial.symmetrise_wavefunction(cfg_to, arr)

    if isinstance(phi, tuple):
        return (up(phi[0], cfg_to.real_dtype), up(phi[1], cfg_to.real_dtype))
    return up(phi, cfg_to.dtype)


def _run_multigrid(
    config: Config,
    log,
    debug_level: int,
    seed: Optional[int],
    progress_factory,
) -> List[SolveResult]:
    """Coarse→fine multigrid driver: solve every state on each level of
    the divisor ladder, upsampling the converged states as the next
    level's initial conditions. The physical box is preserved (dn_ℓ =
    dn·d) and dt_ℓ = dt·d² keeps the stability margin exactly, so a
    coarse level advances imaginary time d²× faster per step — this
    automates the reference's documented manual coarse→fine restart
    workflow (src/config.rs:156-160) without file round trips.
    Intermediate levels write no wavefunction/potential/snapshot files;
    the final level runs the unmodified config. With a multi-device mesh
    the coarse levels solve on a single device (every level past the
    first divisor is >= 8x smaller than the target grid) and only the
    final full-resolution level runs the sharded driver, seeded with the
    upsampled states."""
    import dataclasses

    from wavefarm.config import Grid, Index3, MeshConfig

    divisors = list(config.multigrid) + [1]
    ic_overrides = None
    results: List[SolveResult] = []
    s = config.grid.size
    for li, d in enumerate(divisors):
        final = d == 1
        lvl_grid = Grid(
            size=Index3(s.x // d, s.y // d, s.z // d),
            dn=config.grid.dn * d,
            dt=config.grid.dt * d * d,
        )
        lvl_out = (
            config.output
            if final
            else dataclasses.replace(
                config.output,
                save_wavefns=False,
                save_potential=False,
                snap_update=None,
            )
        )
        lvl_cfg = dataclasses.replace(
            config,
            grid=lvl_grid,
            output=lvl_out,
            multigrid=None,
            multigrid_tolerance=None,
            # coarse levels always solve single-device; the mesh (if any)
            # engages at the final full resolution only
            mesh=(config.mesh if final else MeshConfig(1, 1, 1)),
            tolerance=(
                config.tolerance
                if final
                else (config.multigrid_tolerance or config.tolerance)
            ),
        )
        log.info(
            "Multigrid level %d/%d: %d x %d x %d (dn=%g, dt=%g, tol=%g)",
            li + 1, len(divisors),
            lvl_grid.size.x, lvl_grid.size.y, lvl_grid.size.z,
            lvl_grid.dn, lvl_grid.dt, lvl_cfg.tolerance,
        )
        if final and lvl_cfg.mesh.n_devices > 1:
            from wavefarm.parallel.solver_sharded import run_sharded

            results = run_sharded(
                lvl_cfg, log, seed=seed, progress_factory=progress_factory,
                ic_overrides=ic_overrides,
            )
        else:
            results = _run_single(
                lvl_cfg, log, debug_level, seed, progress_factory,
                ic_overrides=ic_overrides,
            )
        if not final:
            d_next = divisors[li + 1]
            nxt_cfg = dataclasses.replace(
                config,
                grid=Grid(
                    size=Index3(s.x // d_next, s.y // d_next, s.z // d_next),
                    dn=config.grid.dn * d_next,
                    dt=config.grid.dt * d_next * d_next,
                ),
            )
            ic_overrides = {
                r.wnum: _upsample_state(r.phi, nxt_cfg) for r in results
            }
    return results


def _run_single(
    config: Config,
    log,
    debug_level: int = 3,
    seed: Optional[int] = None,
    progress_factory=None,
    ic_overrides=None,
) -> List[SolveResult]:
    """One-resolution driver (the reference ``run`` body): load potentials,
    preload lower states when restarting, then solve each state in order.
    ``ic_overrides``: optional per-state explicit initial conditions
    (multigrid hand-over)."""
    load_cfg = config
    split_mode = False
    if config.potential.is_complex:
        from wavefarm.ops import split_complex as sc

        if not sc.backend_supports_complex():
            split_mode = True
            # Split-complex mode: complex arrays must never reach the device.
            # Load real-counterpart arrays for the side effects (pot_sub,
            # optional potential save — real part only); the split solve
            # rebuilds (re, im) pairs itself.
            import dataclasses

            load_cfg = dataclasses.replace(
                config, potential=config.potential.real_counterpart
            )
            if config.output.save_potential:
                log.warning(
                    "save_potential under the split-complex fallback stores "
                    "the real part only"
                )
    pots = potentials_mod.load_arrays(load_cfg, log)

    w_store: List[jnp.ndarray] = []
    if config.wavenum > 0:
        from wavefarm.io import readers

        loaded = readers.load_wavefunctions(config, log)
        if split_mode:
            # (re, im) real pairs, split host-side — complex arrays must
            # never reach a device without complex dtypes
            w_store.extend(
                (
                    jnp.asarray(np.real(np.asarray(w)), dtype=config.real_dtype),
                    jnp.asarray(np.imag(np.asarray(w)), dtype=config.real_dtype),
                )
                for w in loaded
            )
        else:
            w_store.extend(jnp.asarray(w, dtype=config.dtype) for w in loaded)

    log.info("Starting calculation")
    results = []
    for wnum in range(config.wavenum, config.wavemax + 1):
        progress = progress_factory(wnum) if progress_factory is not None else None
        results.append(
            solve(
                config, log, debug_level, pots, wnum, w_store, seed=seed,
                progress=progress,
                ic_override=(
                    ic_overrides.get(wnum) if ic_overrides is not None else None
                ),
            )
        )
    return results
