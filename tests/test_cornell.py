"""Cornell quarkonium paths: pot_sub array observables and binding energy.

BASELINE.md config 3 (scaled down for CI): Cornell potential, multiple
states, restart-from-snapshot. GeV units: mass in GeV, sig = string tension
in GeV² (reference: src/potential.rs:241-269)."""

import numpy as np

from tests.conftest import base_config
from wavefarm import geometry, solver
from wavefarm.io import run_dir
from wavefarm.models import potentials as pmod
from wavefarm.ops import observables as obs_mod


def _cornell_cfg(pot, **over):
    base = dict(
        potential=pot,
        mass=4.65,  # b-quark mass, GeV
        sig=0.223,  # string tension, GeV²
        grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.5, "dt": 0.05},
        tolerance=1e-6,
        init_condition="Gaussian",
        output={"screen_update": 100, "file_type": "Json"},
        max_steps=200000,
    )
    base.update(over)
    return base_config(**base)


def test_full_cornell_observables_array_pot_sub():
    """v_infinity uses the per-cell pot_sub array for FullCornell
    (reference: src/grid.rs:408-427)."""
    cfg = _cornell_cfg("FullCornell")
    import jax.numpy as jnp

    from wavefarm.models.potentials import Potentials

    v = pmod.generate(cfg)
    sub = pmod.potential_sub_array(cfg)
    phi = geometry.zero_boundary(jnp.full(cfg.padded_size(), 0.1), 1)
    pots = Potentials(v=v, a=v, b=v, pot_sub_array=sub, pot_sub_scalar=None)
    obs = obs_mod.compute_observables(cfg, pots, phi)

    pw = np.asarray(geometry.work_area(phi, 1))
    expected = np.sum(pw * pw * np.asarray(sub))
    assert abs(obs.v_infinity - expected) < 1e-10 * abs(expected)


def test_simple_cornell_converges_with_binding_energy(tmp_run):
    cfg = _cornell_cfg("SimpleCornell")
    run_dir.check_output_dir(cfg.project_name)
    results = solver.run(cfg, seed=11)
    obs = results[0].observables
    e = obs.energy / obs.norm2
    binding = (obs.energy - obs.v_infinity) / obs.norm2
    # V(∞) offset = 4m: binding = E − 4m (pot_sub scalar path)
    assert abs(binding - (e - 4.0 * cfg.mass)) < 1e-8
    # bottomonium-like ground state sits below the continuum threshold
    assert binding < 0.0


def test_full_cornell_converges(tmp_run):
    cfg = _cornell_cfg("FullCornell")
    run_dir.check_output_dir(cfg.project_name)
    results = solver.run(cfg, seed=12)
    obs = results[0].observables
    assert results[0].converged
    binding = (obs.energy - obs.v_infinity) / obs.norm2
    assert np.isfinite(binding)


def test_cornell_restart_from_snapshot(tmp_run):
    """Kill-and-resume via the ``_partial`` snapshot (BASELINE config 3's
    restart-from-snapshot requirement; reference: src/grid.rs:70-85)."""
    import glob
    import shutil

    cfg = _cornell_cfg(
        "SimpleCornell",
        output={
            "screen_update": 100,
            "snap_update": 100,
            "file_type": "Json",
            "save_wavefns": False,
            "save_potential": False,
        },
        max_steps=200,  # force an early abort mid-convergence
    )
    run_dir.check_output_dir(cfg.project_name)
    from wavefarm import errors

    import pytest

    with pytest.raises(errors.MaxStepError):
        solver.run(cfg, seed=13)
    # a partial snapshot exists
    partials = glob.glob(run_dir.get_project_dir(cfg.project_name) + "/*_partial.json")
    assert partials
    shutil.copy(partials[0], "input/" + partials[0].split("/")[-1])

    # resume: the solver prefers the on-disk partial for excited states; for
    # the ground state it flows through InitialCondition FromFile
    run_dir.reset_proj_date()
    cfg2 = _cornell_cfg(
        "SimpleCornell",
        init_condition="FromFile",
        output={"screen_update": 100, "file_type": "Json"},
        max_steps=200000,
    )
    run_dir.check_output_dir(cfg2.project_name)
    results = solver.run(cfg2)
    assert results[0].converged


def test_simple_cornell_f32_per_step_norm(tmp_run):
    """f32 scale-drift guard: SimpleCornell's +4m offset (V ≈ 17–27 GeV
    everywhere) decays ψ by hundreds of e-folds per screen_update chunk,
    flushing f32 to zero without per-step renormalisation. The solver must
    detect this from the IC's measured energy and converge anyway (the
    f64-only reference never hits this, src/config.rs:19-22)."""
    cfg = _cornell_cfg(
        "SimpleCornell",
        precision="f32",
        tolerance=1e-5,
        grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.35, "dt": 0.04},
        output={"screen_update": 500, "file_type": "Json"},
    )
    run_dir.check_output_dir(cfg.project_name)
    results = solver.run(cfg, seed=11)
    obs = results[0].observables
    e64 = obs.energy / obs.norm2
    # the energy must be finite and near the continuum threshold 4m, not a
    # NonFinite abort
    assert np.isfinite(e64)
    assert 15.0 < e64 < 25.0
