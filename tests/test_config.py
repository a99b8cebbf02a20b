"""Config schema, validation and enum semantics."""

import os

import pytest

from tests.conftest import base_config
from wavefarm import errors
from wavefarm.config import (
    CentralDifference,
    Config,
    FileType,
    InitialCondition,
    PotentialType,
    SymmetryConstraint,
)


def test_load_reference_schema(tmp_path):
    """Our example wafer.yaml (same schema as the reference's) parses."""
    import shutil

    src = os.path.join(os.path.dirname(__file__), os.pardir, "wafer.yaml")
    dst = tmp_path / "wafer.yaml"
    shutil.copy(src, dst)
    cfg = Config.load(str(dst), setup_output=False)
    assert cfg.project_name == "develop"
    assert cfg.grid.size.as_tuple() == (50, 50, 50)
    assert cfg.grid.dn == 0.01
    assert cfg.grid.dt == 3e-5
    assert cfg.tolerance == 1e-4
    assert cfg.central_difference is CentralDifference.THREE_POINT
    assert cfg.max_steps is None
    assert cfg.wavenum == 0 and cfg.wavemax == 1
    assert cfg.potential is PotentialType.HARMONIC
    assert cfg.mass == 15.9994
    assert cfg.init_condition is InitialCondition.BOOLEAN
    assert cfg.sig == 1.0
    assert cfg.init_symmetry is SymmetryConstraint.NOT_CONSTRAINED
    assert cfg.output.screen_update == 1000
    assert cfg.output.snap_update is None
    assert cfg.output.file_type is FileType.RON
    assert cfg.output.save_wavefns and cfg.output.save_potential
    assert cfg.script_location is None


def test_dt_stability_guard():
    """dt ≤ dn²/3 hard error (reference: src/config.rs:362-365)."""
    with pytest.raises(errors.LargeDtError):
        base_config(grid={"dn": 0.01, "dt": 1.0})


def test_dt_boundary_ok():
    cfg = base_config(grid={"dn": 0.3, "dt": 0.03})
    assert cfg.grid.dt <= cfg.grid.dn ** 2 / 3


def test_wavenum_guard():
    with pytest.raises(errors.LargeWavenumError):
        base_config(wavenum=3, wavemax=1)


def test_central_difference_bb_ext():
    """bb/ext padding model (reference: src/config.rs:222-239)."""
    assert CentralDifference.THREE_POINT.bb == 2
    assert CentralDifference.FIVE_POINT.bb == 4
    assert CentralDifference.SEVEN_POINT.bb == 6
    assert CentralDifference.THREE_POINT.ext == 1
    assert CentralDifference.FIVE_POINT.ext == 2
    assert CentralDifference.SEVEN_POINT.ext == 3


def test_file_type_extensions():
    assert FileType.MESSAGEPACK.extension == ".mpk"
    assert FileType.CSV.extension == ".csv"
    assert FileType.JSON.extension == ".json"
    assert FileType.YAML.extension == ".yaml"
    assert FileType.RON.extension == ".ron"


def test_variable_pot_sub():
    """Only the FullCornell family has an array pot_sub (reference:
    src/config.rs:106-126; the absorptive ComplexFullCornell extension
    shares the real part's V(∞) array)."""
    for pt in PotentialType:
        assert pt.variable_pot_sub == (
            pt in (
                PotentialType.FULL_CORNELL,
                PotentialType.COMPLEX_FULL_CORNELL,
            )
        )


def test_script_location_set_only_for_from_script():
    cfg = base_config(potential="FromScript", output={"save_potential": False})
    assert cfg.script_location == "./gen_potential.py"
    cfg2 = base_config()
    assert cfg2.script_location is None


def test_padded_size():
    cfg = base_config(central_difference="SevenPoint")
    assert cfg.padded_size() == (22, 22, 22)
    assert cfg.work_size() == (16, 16, 16)


def test_pretty_print_both_layouts():
    cfg = base_config()
    wide = cfg.pretty(100)
    narrow = cfg.pretty(70)
    assert "test - Configuration" in wide
    assert "Grid { x: 16, y: 16, z: 16 }" in wide
    assert "Harmonic oscillator" in wide
    assert len(narrow.splitlines()) > len(wide.splitlines())


def test_unknown_extension_fields_ignored():
    cfg = base_config(some_future_field=42)
    assert cfg.project_name == "test"


def test_precision_validation():
    with pytest.raises(errors.ConfigParseError):
        base_config(precision="f16")
    assert base_config(precision="f32").precision == "f32"
