"""End-to-end physics oracles: analytic eigenvalues the reference lacks
automated tests for (SURVEY.md §4)."""

import os

import numpy as np
import pytest

from tests.conftest import base_config
from wavefarm import errors, solver
from wavefarm.io import run_dir


def _setup(cfg):
    run_dir.check_output_dir(cfg.project_name, cfg.output_root)


def test_harmonic_ground_state(tmp_run):
    """3D isotropic oscillator: V = r²/2 (k=1), m=1 → ω=1, E₀ = 3/2."""
    cfg = base_config(
        grid={"size": {"x": 32, "y": 32, "z": 32}, "dn": 0.2, "dt": 0.01},
        tolerance=1e-7,
        mass=1.0,
        potential="Harmonic",
        init_condition="Constant",
        output={"screen_update": 200, "file_type": "Json"},
        max_steps=100000,
    )
    _setup(cfg)
    results = solver.run(cfg)
    assert len(results) == 1
    res = results[0]
    assert res.converged
    e0 = res.observables.energy / res.observables.norm2
    assert abs(e0 - 1.5) < 0.01, e0


def test_harmonic_first_excited(tmp_run):
    """First excited multiplet: E₁ = 5/2 via per-step Gram-Schmidt."""
    cfg = base_config(
        grid={"size": {"x": 32, "y": 32, "z": 32}, "dn": 0.2, "dt": 0.01},
        tolerance=1e-7,
        mass=1.0,
        potential="Harmonic",
        init_condition="Gaussian",
        sig=1.0,
        wavemax=1,
        output={"screen_update": 200, "file_type": "Json"},
        max_steps=200000,
    )
    _setup(cfg)
    results = solver.run(cfg, seed=7)
    assert [r.wnum for r in results] == [0, 1]
    e0 = results[0].observables.energy / results[0].observables.norm2
    e1 = results[1].observables.energy / results[1].observables.norm2
    assert abs(e0 - 1.5) < 0.01, e0
    assert abs(e1 - 2.5) < 0.02, e1
    # converged states are orthogonal
    import jax.numpy as jnp

    overlap = float(jnp.sum(results[0].phi * results[1].phi))
    n0 = float(jnp.sum(results[0].phi ** 2))
    n1 = float(jnp.sum(results[1].phi ** 2))
    assert abs(overlap) / np.sqrt(n0 * n1) < 1e-4


def test_coulomb_ground_state(tmp_run):
    """Hydrogenic ground state: E₀ = −m/2 (natural units)."""
    cfg = base_config(
        grid={"size": {"x": 40, "y": 40, "z": 40}, "dn": 0.25, "dt": 0.02},
        tolerance=1e-8,
        mass=1.0,
        potential="Coulomb",
        init_condition="Coulomb",
        output={"screen_update": 200, "file_type": "Json"},
        max_steps=200000,
    )
    _setup(cfg)
    results = solver.run(cfg)
    e0 = results[0].observables.energy / results[0].observables.norm2
    # Coulomb singularity clamp costs accuracy; 3-point CD at dn=0.25
    assert abs(e0 - (-0.5)) < 0.05, e0


def test_max_steps_guard(tmp_run):
    """Non-convergent run raises MaxStepError (reference: src/grid.rs:211-213,244)."""
    cfg = base_config(
        grid={"size": {"x": 12, "y": 12, "z": 12}, "dn": 0.2, "dt": 0.01},
        tolerance=1e-30,
        output={"screen_update": 50, "file_type": "Json"},
        max_steps=100,
    )
    _setup(cfg)
    with pytest.raises(errors.MaxStepError):
        solver.run(cfg)


def test_marginal_dt_checkerboard_mode(tmp_run, caplog):
    """AT the explicit stability bound the zone-corner (checkerboard)
    mode is exactly undamped — ``scale·acc = −2`` collapses the update to
    ``ψ' = −ψ`` regardless of the potential factor B — while every
    physical mode decays, so a contaminated IC converges to the lattice
    mode (E ≈ the zone-corner kinetic energy). A 10% dt margin restores
    damping and the same IC reaches the true ground state. The solver
    warns at/near the bound (the reference's validation allows equality,
    src/config.rs:362-370)."""
    import logging

    import jax.numpy as jnp

    n, dn = 16, 0.2
    bound = solver.stable_dt_bound("ThreePoint", dn, 1.0)
    idx = np.arange(n)
    cb = (-1.0) ** (idx[:, None, None] + idx[None, :, None] + idx[None, None, :])
    x = (idx - (n - 1) / 2.0) * dn
    r2 = (x[:, None, None] ** 2 + x[None, :, None] ** 2
          + x[None, None, :] ** 2)
    gauss = np.exp(-r2 / 2.0)
    phi_int = (gauss + 1e-3 * cb).astype(np.float32)
    phi_int /= np.sqrt(np.sum(phi_int.astype(np.float64) ** 2)).astype(
        np.float32
    )
    phi_pad = jnp.asarray(np.pad(phi_int, 1))

    def run_at(dt):
        cfg = base_config(
            grid={"size": {"x": n, "y": n, "z": n}, "dn": dn, "dt": dt},
            tolerance=1e-6,
            potential="Harmonic",
            init_condition="Constant",
            precision="f32",
            output={"screen_update": 200, "file_type": "Json"},
            max_steps=60000,
        )
        _setup(cfg)
        res = solver._run_single(
            cfg, logging.getLogger("wafer"), ic_overrides={0: phi_pad}
        )[0]
        return res.observables.energy / res.observables.norm2

    # zone-corner kinetic energy at this dn: (c0 + 6)/(k·dn²) = 150
    e_bound = run_at(bound)
    assert e_bound > 50.0, e_bound  # lattice mode won
    e_margin = run_at(0.9 * bound)
    assert abs(e_margin - 1.5) < 0.5, e_margin  # true ground state

    # the warning rides solver.run (all drivers dispatch through it)
    def run_short(dt):
        cfg = base_config(
            grid={"size": {"x": 12, "y": 12, "z": 12}, "dn": dn, "dt": dt},
            tolerance=1e-30,
            output={"screen_update": 50, "file_type": "Json"},
            max_steps=100,
        )
        _setup(cfg)
        with pytest.raises(errors.MaxStepError):
            solver.run(cfg)

    with caplog.at_level(logging.WARNING, logger="wafer"):
        run_short(bound)
    assert any("stability bound" in r.message for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="wafer"):
        run_short(0.9 * bound)
    assert not any("stability bound" in r.message for r in caplog.records)


def test_drift_guard_disengages_after_transient(tmp_run, caplog):
    """The f32 scale-drift guard re-evaluates per measure: a hot IC (a
    dn-width Gaussian, kinetic ≈ 3/(4·dn²)) engages per-step
    renormalisation for the transient chunks, then the guard disengages
    (hysteresis at half the e-fold limit) once E settles toward E₀ and
    per-chunk normalisation resumes. The run still converges to
    the true ground state."""
    import logging

    import jax.numpy as jnp

    n, dn, dt = 16, 0.2, 0.012
    idx = np.arange(n)
    x = (idx - (n - 1) / 2.0) * dn
    r2 = (x[:, None, None] ** 2 + x[None, :, None] ** 2
          + x[None, None, :] ** 2)
    hot = np.exp(-r2 / (2.0 * dn * dn)).astype(np.float32)
    hot /= np.sqrt(np.sum(hot.astype(np.float64) ** 2)).astype(np.float32)
    cfg = base_config(
        grid={"size": {"x": n, "y": n, "z": n}, "dn": dn, "dt": dt},
        tolerance=1e-6,
        potential="Harmonic",
        init_condition="Constant",
        precision="f32",
        output={"screen_update": 200, "file_type": "Json"},
        max_steps=60000,
    )
    _setup(cfg)
    with caplog.at_level(logging.INFO, logger="wafer"):
        res = solver._run_single(
            cfg, logging.getLogger("wafer"),
            ic_overrides={0: jnp.asarray(np.pad(hot, 1))},
        )[0]
    msgs = [r.message for r in caplog.records]
    assert any("renormalising the ground state every step" in m for m in msgs)
    assert any("resuming per-chunk normalisation" in m for m in msgs)
    e0 = res.observables.energy / res.observables.norm2
    assert abs(e0 - 1.5) < 0.5, e0


def test_eta_estimator():
    """Exponential convergence → sensible cycle estimate (src/grid.rs:254-283)."""
    cfg = base_config(tolerance=1e-6, output={"screen_update": 100})
    # diff decaying one decade per cycle, currently at 1e-2 → 4 more cycles
    est = solver.eta(step=500, diff_old=1e-1, diff_new=1e-2, config=cfg)
    assert est == 4
    assert solver.eta(step=0, diff_old=float("inf"), diff_new=1e-2, config=cfg) is None


def test_sevenpoint_harmonic(tmp_run):
    """Higher-order CD reproduces the oracle too (ext=3 halo handling).

    Note: the explicit kinetic update is only stable for
    dt < 2·dn²/(3·|λ|max) ≈ 0.11·dn² with the 7-point stencil — tighter than
    the dn²/3 bound the reference checks (which is only valid for 3-point)."""
    cfg = base_config(
        central_difference="SevenPoint",
        grid={"size": {"x": 24, "y": 24, "z": 24}, "dn": 0.25, "dt": 0.006},
        tolerance=1e-7,
        mass=1.0,
        potential="Harmonic",
        init_condition="Constant",
        output={"screen_update": 200, "file_type": "Json"},
        max_steps=100000,
    )
    _setup(cfg)
    results = solver.run(cfg)
    e0 = results[0].observables.energy / results[0].observables.norm2
    assert abs(e0 - 1.5) < 0.01, e0


def test_backend_resolution():
    """auto and xla both parse and name the one XLA sweep; pallas, whose
    kernels were removed, is a typed config error (not a silent fallback)."""
    from wavefarm import errors

    assert base_config().backend == "auto"
    assert base_config(backend="xla").backend == "xla"
    with pytest.raises(errors.ConfigParseError, match="pallas"):
        base_config(precision="f32", backend="pallas")
    with pytest.raises(errors.ConfigParseError):
        base_config(backend="cuda")


def test_run_routes_to_sharded_mesh(tmp_run):
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    cfg = base_config(
        grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.02},
        tolerance=1e-6,
        init_condition="Constant",
        output={"screen_update": 100, "file_type": "Json"},
        max_steps=100000,
        mesh={"x": 2, "y": 2, "z": 2},
    )
    from wavefarm.io import run_dir

    run_dir.check_output_dir(cfg.project_name)
    results = solver.run(cfg)
    e0 = results[0].observables.energy / results[0].observables.norm2
    assert abs(e0 - 1.5) < 0.02


def test_nonfinite_guard(tmp_run):
    """Divergent evolution raises once the state overflows (noisy_float
    parity): an unstable dt for the 7-point stencil amplifies ~3.6×/step,
    overflowing f32 within one chunk. (In f64 the spurious fastest-growing
    mode "converges" to a constant Rayleigh quotient long before overflow —
    the reference behaves the same way.)"""
    cfg = base_config(
        central_difference="SevenPoint",
        precision="f32",
        # dt passes the reference's 3-point bound but is unstable for 7-point
        grid={"size": {"x": 12, "y": 12, "z": 12}, "dn": 0.3, "dt": 0.029},
        tolerance=1e-30,
        output={"screen_update": 200, "file_type": "Json"},
        max_steps=100000,
    )
    run_dir.check_output_dir(cfg.project_name)
    with pytest.raises(errors.NonFiniteError):
        solver.run(cfg)


def test_stable_dt_bound():
    """Worst-case amplification bound per stencil: ThreePoint reduces to the
    reference's dn²·m/3 rule (src/config.rs:362-365); higher orders are
    tighter (the reference checks only the 3-point rule for all stencils)."""
    dn = 0.3
    b3 = solver.stable_dt_bound("ThreePoint", dn, 1.0)
    assert abs(b3 - dn * dn / 3.0) < 1e-12
    b5 = solver.stable_dt_bound("FivePoint", dn, 1.0)
    b7 = solver.stable_dt_bound("SevenPoint", dn, 1.0)
    assert b7 < b5 < b3
    # mass scales the bound linearly
    assert abs(solver.stable_dt_bound("ThreePoint", dn, 2.0) - 2.0 * b3) < 1e-12


def test_deep_well_f32_overflow_guard(tmp_run):
    """Deep attractive wells (Dodecahedron: V = −100 inside) grow ψ by
    e^{2·100·dt·screen_update} per chunk — overflowing f32 — unless the
    drift guard engages per-step renormalisation. The |E − s| estimate must
    catch the growth direction (the gauge shift is 0 here: only positive
    offsets are removed). dt must stay below the semi-implicit pole
    1 + dt·V/2 = 0 (dt < 2/|V|min = 0.02), a reference constraint too."""
    cfg = base_config(
        precision="f32",
        potential="Dodecahedron",
        tolerance=1e-4,
        grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.01},
        init_condition="Constant",
        output={"screen_update": 200, "file_type": "Json"},
        max_steps=200000,
    )
    _setup(cfg)
    results = solver.run(cfg)
    e0 = results[0].observables.energy / results[0].observables.norm2
    assert results[0].converged and -101.0 < e0 < -10.0, e0


def test_sync_update_batching_matches_per_chunk(tmp_run):
    """sync_update > 1 batches chunks into a device-side scan with the
    convergence test on-device; the chunk sequence, energies, and step
    counts must match the per-chunk (reference-cadence) path."""
    common = dict(
        grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.25, "dt": 0.015},
        tolerance=1e-7,
        potential="Harmonic",
        init_condition="Gaussian",
        output={"screen_update": 100, "file_type": "Json"},
        max_steps=100000,
        wavemax=1,
        # pin the reference-cadence per-step projection on BOTH modes:
        # delayed_gram is per-measure-gated and inactive under batching,
        # so leaving it on would compare two different dispatches
        delayed_gram=False,
    )
    run_dir.check_output_dir("test")
    cfg1 = base_config(**common)
    cfg1.sync_update = 1
    ref = solver.run(cfg1, seed=9)
    cfg8 = base_config(**common)
    cfg8.sync_update = 8
    out = solver.run(cfg8, seed=9)
    for r_ref, r_out in zip(ref, out):
        assert r_out.steps == r_ref.steps, (r_ref.wnum, r_ref.steps, r_out.steps)
        e_ref = r_ref.observables.energy / r_ref.observables.norm2
        e_out = r_out.observables.energy / r_out.observables.norm2
        # f64 run on CPU: the device quotient equals the host quotient, so
        # the batched trajectory is identical
        assert abs(e_ref - e_out) < 1e-12, (r_ref.wnum, e_ref, e_out)
        import numpy as _np

        assert _np.allclose(
            _np.asarray(r_ref.phi), _np.asarray(r_out.phi), rtol=0, atol=0
        )


def test_sync_update_batching_max_steps_and_snapshots(tmp_run):
    """The batch planner respects the max_steps horizon (MaxStepError at
    the same step) and never crosses a snapshot step (partial files still
    written at the same cadence)."""
    import glob

    common = dict(
        grid={"size": {"x": 12, "y": 12, "z": 12}, "dn": 0.25, "dt": 0.015},
        tolerance=1e-30,
        potential="Harmonic",
        init_condition="Gaussian",
        output={
            "screen_update": 50,
            "snap_update": 150,
            "file_type": "Json",
            "save_wavefns": False,
        },
        max_steps=700,
    )
    run_dir.check_output_dir("test")
    cfg = base_config(**common)
    cfg.sync_update = 8
    with pytest.raises(errors.MaxStepError):
        solver.run(cfg, seed=4)
    d = run_dir.get_project_dir(cfg.project_name)
    assert glob.glob(d + "/wavefunction_0_partial.*"), os.listdir(d)


def test_pick_batch_k_max_steps_tail_ladder():
    """The max_steps tail degrades through the {k_sync, 4, 2, 1} ladder
    instead of collapsing to per-chunk for the whole tail (VERDICT r2 #10)."""
    su, k_sync, max_steps = 100, 8, 1000
    sched = [
        solver.pick_batch_k(step, k_sync, su, None, max_steps)
        for step in range(0, max_steps + su, su)
    ]
    # step 0 is always host-side; the tail (remaining<8 chunks) uses 4 then 2
    assert sched[0] == 1
    # remaining chunks at step s: (1000-s)//100 + 1
    for step, k in zip(range(0, max_steps + su, su), sched):
        if step == 0:
            continue
        remaining = (max_steps - step) // su + 1
        assert k <= max(remaining, 1)
        if remaining >= k_sync:
            assert k == k_sync
        elif remaining >= 4:
            assert k == 4, (step, k)
        elif remaining >= 2:
            assert k == 2, (step, k)
        else:
            assert k == 1
    # only ladder values ever appear (bounded compile count)
    assert set(sched) <= {1, 2, 4, k_sync}


def test_pick_batch_k_snapshot_alignment():
    """Batches never cross a snapshot step and a snap-aligned recurring k
    is chosen (one extra compile at most)."""
    su, k_sync, snap = 50, 8, 150
    for step in range(50, 2000, su):
        k = solver.pick_batch_k(step, k_sync, su, snap, None)
        to_snap = (-step) % snap
        if to_snap == 0:
            assert k == 1
        else:
            assert k * su <= to_snap


def test_delayed_gram_gate_hysteresis():
    """Numerics gate for delayed re-orthogonalisation: engages when the
    projected regrowth bias is far below tolerance, releases with
    hysteresis when it approaches it (SURVEY §7 lever; PARITY #12)."""
    import logging

    log = logging.getLogger("test")
    # small dE·dt·su: bias ~1e-12·ΔE << 1e-8 → engage
    assert solver.delayed_gram_gate(False, 2.5, 1.5, 0.01, 100, 1e-6, log)
    # huge regrowth (dE·dt·su = 40 → exp(80)): must refuse / release
    assert not solver.delayed_gram_gate(False, 41.5, 1.5, 0.01, 100, 1e-6, log)
    assert not solver.delayed_gram_gate(True, 41.5, 1.5, 0.01, 100, 1e-6, log)
    # hysteresis band: engaged stays engaged, disengaged stays out
    # (pick dE so bias sits between tol/100 and tol/10)
    import math

    for de in np.linspace(0.1, 20.0, 200):
        bias = 1e-12 * math.exp(min(2 * de * 0.01 * 100, 700.0)) * de
        if 1e-8 < bias < 1e-7:
            assert solver.delayed_gram_gate(True, 1.5 + de, 1.5, 0.01, 100, 1e-6, log)
            assert not solver.delayed_gram_gate(False, 1.5 + de, 1.5, 0.01, 100, 1e-6, log)
            break
    else:
        raise AssertionError("no dE found inside the hysteresis band")


def test_delayed_gram_state_learns_regrowth():
    """Fast-regrowth workloads (measured: the 256³ finite-T quarkonium 2S
    reaches ~2.5e-2 admixture per chunk, ~100× the rounding-level model)
    must not flap the gate every COOLDOWN+1 chunks: an admixture-triggered
    release back-solves the effective per-chunk seed δ₀ and the gate stays
    released until the slow decay re-admits a probe."""
    import logging

    log = logging.getLogger("test")
    st = solver.DelayedGramState()
    # quark-like numbers: dE=0.523, dt=0.003, su=500 → amplification ≈ 2.2
    kw = dict(dt=0.003, su=500, tolerance=1e-6, log=log)
    assert st.update(2.023, 1.5, **kw)          # a-priori model engages
    # boundary after one delayed chunk measures a huge admixture → release
    assert not st.update(2.023, 1.5, measured_delta=2.5e-2, **kw)
    assert st.delta0 > 1e-3                      # learned ≈ 2.5e-2 / 2.19
    # cooldown, then the LEARNED δ₀ keeps the gate released (pre-fix it
    # would re-engage right here and flap forever)
    released = 0
    for _ in range(10):
        if not st.update(2.023, 1.5, measured_delta=1e-7, **kw):
            released += 1
    assert released == 10, "gate must stay released on the learned seed"
    # the decay eventually re-admits a probe (transient contamination)
    for _ in range(40):
        st.update(2.023, 1.5, measured_delta=1e-7, **kw)
    assert st.engaged, "decayed δ₀ must re-admit delayed mode"


def test_delayed_gram_equivalence(tmp_run):
    """Delayed re-orthogonalisation (default) vs the reference's per-step
    projection (delayed_gram: false): converged excited energies agree
    within the convergence tolerance and the states stay orthogonal
    (SURVEY §7: "delayed re-orthogonalisation (with a numerics test
    proving equivalence)"; reference cadence src/grid.rs:674-681)."""
    common = dict(
        grid={"size": {"x": 24, "y": 24, "z": 24}, "dn": 0.25, "dt": 0.015},
        tolerance=1e-8,
        mass=1.0,
        potential="Harmonic",
        init_condition="Gaussian",
        sig=1.0,
        wavemax=1,
        output={"screen_update": 100, "file_type": "Json"},
        max_steps=300000,
    )
    _setup(base_config(**common))
    res_ref = solver.run(base_config(delayed_gram=False, **common), seed=11)
    run_dir.reset_proj_date()
    cfg_dgs = base_config(delayed_gram=True, **common)
    _setup(cfg_dgs)
    res_dgs = solver.run(cfg_dgs, seed=11)
    e1_ref = res_ref[1].observables.energy / res_ref[1].observables.norm2
    e1_dgs = res_dgs[1].observables.energy / res_dgs[1].observables.norm2
    # oracle sanity + mutual agreement at tolerance scale
    assert abs(e1_ref - 2.5) < 0.03
    assert abs(e1_dgs - e1_ref) < 100 * 1e-8, (e1_dgs, e1_ref)
    import jax.numpy as jnp

    ov = float(jnp.sum(res_dgs[0].phi * res_dgs[1].phi))
    n0 = float(jnp.sum(res_dgs[0].phi ** 2))
    n1 = float(jnp.sum(res_dgs[1].phi ** 2))
    assert abs(ov) / np.sqrt(n0 * n1) < 1e-6
