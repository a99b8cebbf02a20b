"""Run-level integration: snapshots, restart paths, save flags, CLI.

Covers the three checkpoint/resume mechanisms (SURVEY.md §5): ``_partial``
snapshots, excited-state restart from ./input/, and resolution upscaling."""

import glob
import logging
import os
import shutil
import stat

import numpy as np
import pytest

from tests.conftest import base_config
from wavefarm import solver
from wavefarm.config import FileType
from wavefarm.io import readers, run_dir, writers

LOG = logging.getLogger("test")


def _small_harmonic(**over):
    base = dict(
        grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.02},
        tolerance=1e-6,
        mass=1.0,
        potential="Harmonic",
        init_condition="Constant",
        output={"screen_update": 100, "file_type": "Json"},
        max_steps=100000,
    )
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            base[k].update(v)
        else:
            base[k] = v
    return base_config(**base)


def test_save_wavefns_and_potential(tmp_run):
    cfg = _small_harmonic(
        output={"save_wavefns": True, "save_potential": True, "file_type": "Csv"}
    )
    run_dir.check_output_dir(cfg.project_name)
    solver.run(cfg)
    d = run_dir.get_project_dir(cfg.project_name)
    assert os.path.exists(d + "/wavefunction_0.csv")
    assert os.path.exists(d + "/potential.csv")
    assert os.path.exists(d + "/observables_0.csv")
    # saved wavefunction is the work area (16³)
    from wavefarm.io import formats

    with open(d + "/wavefunction_0.csv") as fh:
        w = formats.array_from_csv(fh.read())
    assert w.shape == (16, 16, 16)


def test_snapshot_lifecycle(tmp_run):
    """_partial written during run and removed on convergence
    (reference: src/grid.rs:137-158,174-190)."""
    cfg = _small_harmonic(output={"snap_update": 100, "save_wavefns": False})
    run_dir.check_output_dir(cfg.project_name)
    solver.run(cfg)
    d = run_dir.get_project_dir(cfg.project_name)
    assert not glob.glob(d + "/wavefunction_0_partial.*")
    assert os.path.exists(d + "/observables_0.json")


def test_excited_state_restart_from_disk(tmp_run):
    """wavenum > 0 loads converged lower states from ./input/
    (reference: src/grid.rs:35-39, src/input.rs:487-505)."""
    cfg = _small_harmonic(wavemax=1, output={"save_wavefns": True})
    run_dir.check_output_dir(cfg.project_name)
    results = solver.run(cfg)
    e1_first = results[1].observables.energy / results[1].observables.norm2

    # stage outputs as inputs
    d = run_dir.get_project_dir(cfg.project_name)
    shutil.copy(d + "/wavefunction_0.json", "input/wavefunction_0.json")

    run_dir.reset_proj_date()
    cfg2 = _small_harmonic(wavenum=1, wavemax=1, output={"save_wavefns": False})
    run_dir.check_output_dir(cfg2.project_name)
    results2 = solver.run(cfg2)
    assert [r.wnum for r in results2] == [1]
    e1_restart = results2[0].observables.energy / results2[0].observables.norm2
    assert abs(e1_first - e1_restart) < 5e-3


def test_restart_missing_lower_state_errors(tmp_run):
    from wavefarm import errors

    cfg = _small_harmonic(wavenum=1, wavemax=1)
    run_dir.check_output_dir(cfg.project_name)
    with pytest.raises(errors.LoadWavefunctionError):
        solver.run(cfg)


def test_from_file_potential(tmp_run):
    """FromFile potential path (reference: src/potential.rs:79-86)."""
    from wavefarm.io import formats
    from wavefarm.models import potentials as pmod

    # write a harmonic potential (work size) to input/, then solve FromFile
    cfg_gen = _small_harmonic()
    v_full = np.asarray(pmod.generate(cfg_gen))
    with open("input/potential.json", "w") as fh:
        fh.write(formats.array_to_json(v_full[1:-1, 1:-1, 1:-1]))

    cfg = _small_harmonic(potential="FromFile")
    run_dir.check_output_dir(cfg.project_name)
    results = solver.run(cfg)
    e0 = results[0].observables.energy / results[0].observables.norm2
    assert abs(e0 - 1.5) < 0.02, e0


def test_from_script_potential(tmp_run):
    """FromScript end-to-end with the JSON/lines contract
    (reference: src/input.rs:186-248)."""
    script = tmp_run / "gen.py"
    # harmonic potential in script form, padded-centre convention
    script.write_text(
        "#!/usr/bin/env python\n"
        "import json, sys\n"
        "g = json.load(sys.stdin)['grid']\n"
        "n, dn = g['x'], g['dn']\n"
        "for i in range(g['x']):\n"
        "    for j in range(g['y']):\n"
        "        for k in range(g['z']):\n"
        "            r2 = sum((q + 1 - (n + 1) / 2) ** 2 for q in (i, j, k))\n"
        "            print(dn * dn * r2 / 2)\n"
    )
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    cfg = _small_harmonic(potential="FromScript")
    cfg.script_location = str(script)
    run_dir.check_output_dir(cfg.project_name)
    results = solver.run(cfg)
    e0 = results[0].observables.energy / results[0].observables.norm2
    assert abs(e0 - 1.5) < 0.02, e0


def test_cli_end_to_end(tmp_run, capsys):
    """Full CLI run from a YAML config (reference: src/main.rs:94-240)."""
    import yaml

    raw = {
        "project_name": "cli test",
        "grid": {"size": {"x": 12, "y": 12, "z": 12}, "dn": 0.3, "dt": 0.02},
        "tolerance": 1e-5,
        "central_difference": "ThreePoint",
        "wavenum": 0,
        "wavemax": 0,
        "output": {
            "screen_update": 100,
            "file_type": "Yaml",
            "save_wavefns": True,
            "save_potential": True,
        },
        "potential": "Harmonic",
        "mass": 1.0,
        "init_condition": "Constant",
        "sig": 1.0,
        "init_symmetry": "NotConstrained",
        "max_steps": 100000,
    }
    with open("test.yaml", "w") as fh:
        yaml.safe_dump(raw, fh)

    from wavefarm import cli

    rc = cli.main(["-c", "test.yaml"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Ground state energy" in out
    assert "Simulation complete" in out
    d = run_dir.get_project_dir("cli test")
    assert os.path.exists(d + "/simulation.log")
    assert os.path.exists(d + "/test.yaml")  # config provenance copy
    assert os.path.exists(d + "/wavefunction_0.yaml")
    assert os.path.exists(d + "/observables_0.yaml")


def test_cli_mesh_multigrid_dispatch(tmp_run, capsys):
    """The CLI must route through solver.run so a multigrid schedule
    engages even with a multi-device mesh (regression: the CLI used to
    shortcut straight to run_sharded, silently skipping the ladder)."""
    import yaml

    raw = {
        "project_name": "cli mg",
        "grid": {"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.02},
        "tolerance": 1e-5,
        "central_difference": "ThreePoint",
        "wavenum": 0,
        "wavemax": 0,
        "output": {
            "screen_update": 100,
            "file_type": "Json",
            "save_wavefns": False,
            "save_potential": False,
        },
        "potential": "Harmonic",
        "mass": 1.0,
        "init_condition": "Gaussian",
        "sig": 1.0,
        "init_symmetry": "NotConstrained",
        "max_steps": 100000,
        "multigrid": [2],
        "mesh": {"x": 2, "y": 1, "z": 1},
    }
    with open("test.yaml", "w") as fh:
        yaml.safe_dump(raw, fh)

    from wavefarm import cli

    rc = cli.main(["-c", "test.yaml", "-d"])
    assert rc == 0
    assert "Ground state energy" in capsys.readouterr().out
    d = run_dir.get_project_dir("cli mg")
    log_text = open(d + "/simulation.log").read()
    assert "Multigrid level 1/2" in log_text
    assert "sharded over mesh" in log_text
    assert "multigrid hand-over" in log_text


def test_cli_bad_config(tmp_run, capsys):
    with open("bad.yaml", "w") as fh:
        fh.write("project_name: x\n")  # missing everything else
    from wavefarm import cli

    rc = cli.main(["-c", "bad.yaml"])
    assert rc == 1
    assert "Error loading configuration" in capsys.readouterr().out


def test_snapshot_keeps_live_psi_normalised(tmp_run):
    """PARITY divergence 8: the stale-norm² rescale of the reference's
    snapshot block applies to the written file only — the live (and stored)
    ψ keeps unit norm, so later Gram-Schmidt projections stay exact and f32
    convergence is free of scale oscillation. The written ``_partial`` file
    carries the reference's rescale (checked via the spy below)."""
    from wavefarm.io import writers

    written = {}
    orig = writers.wavefunction

    def spy(data, wnum, converged, *a, **k):
        if not converged:
            written["norm2"] = float(np.sum(np.asarray(data, np.float64) ** 2))
        return orig(data, wnum, converged, *a, **k)

    import unittest.mock as mock

    cfg = _small_harmonic(output={"snap_update": 100})
    run_dir.check_output_dir(cfg.project_name)
    with mock.patch.object(writers, "wavefunction", spy):
        res = solver.run(cfg)[0]
    # live ψ normalised regardless of snapshots
    n2_phi = float(np.sum(np.asarray(res.phi, dtype=np.float64) ** 2))
    assert abs(n2_phi - 1.0) < 1e-3, n2_phi
    # the file copy is ψ/√(stale norm²): its norm² == 1/norm2_stale
    assert abs(written["norm2"] * res.observables.norm2 - 1.0) < 1e-2

    # snap cadence spanning several chunks must still converge in f32
    # (period-2 scale oscillation regression)
    run_dir.reset_proj_date()
    cfg2 = _small_harmonic(output={"snap_update": 200})
    run_dir.check_output_dir(cfg2.project_name)
    res2 = solver.run(cfg2)[0]
    e1 = res.observables.energy / res.observables.norm2
    e2 = res2.observables.energy / res2.observables.norm2
    assert abs(e1 - e2) < 1e-4


def test_snapshot_symmetrisation_reenforced_during_evolution(tmp_run):
    """With a symmetry constraint plus snap_update, the in-place snapshot
    symmetrisation is the only mechanism re-enforcing init_symmetry during
    evolution (reference src/grid.rs:137-139). Verify the converged ψ is
    antisymmetric about the z mid-plane — i.e. the run stays in the
    requested parity sector and lands on the odd-z state."""
    cfg = _small_harmonic(
        init_condition="Gaussian",
        init_symmetry="AntisymAboutZ",
        output={"snap_update": 100},
    )
    run_dir.check_output_dir(cfg.project_name)
    res = solver.run(cfg, seed=7)[0]
    e0 = res.observables.energy / res.observables.norm2
    # The reference's mirror plane (padded (ext+N+1)/2 = 9) is half a cell
    # off the potential centre ((N+1)/2 = 8.5), so the constraint does not
    # commute with H: the run converges to the fixed point of
    # (evolve chunk → project), with E strictly above the E₀ = 1.5 ground
    # state. Without the in-place re-projection the antisym IC decays to
    # the symmetric ground state — E > 1.6 proves the mutation persists.
    assert e0 > 1.6, e0
    w = np.asarray(res.phi, dtype=np.float64)
    # at the break ψ was just symmetrised; the antisym projector flips the
    # overall sign of an already-antisymmetric state (P∘P = −P), so the
    # fixed point satisfies symmetrise(ψ) = −ψ
    from wavefarm.models import initial as init_mod

    sym = np.asarray(init_mod.symmetrise_wavefunction(cfg, res.phi))
    assert np.allclose(w, -sym, atol=2e-5 * np.abs(w).max())
