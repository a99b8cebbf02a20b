"""Error-path coverage: typed failures matching the reference's error chain
(src/errors.rs:1-140)."""

import logging

import numpy as np
import pytest

from tests.conftest import base_config
from wavefarm import errors
from wavefarm.config import Config, FileType
from wavefarm.io import formats, readers
from wavefarm.models import potentials as pmod

LOG = logging.getLogger("test")


def test_config_file_missing():
    with pytest.raises(errors.ConfigLoadError):
        Config.load("/nonexistent/wafer.yaml", setup_output=False)


def test_config_not_yaml(tmp_path):
    p = tmp_path / "bad.yaml"
    p.write_text("]]]]: [")
    with pytest.raises(errors.DeserializeError):
        Config.load(str(p), setup_output=False)


def test_config_scalar_yaml(tmp_path):
    p = tmp_path / "scalar.yaml"
    p.write_text("42")
    with pytest.raises(errors.DeserializeError):
        Config.load(str(p), setup_output=False)


def test_bad_enum_value():
    with pytest.raises(errors.ConfigParseError):
        base_config(potential="Hydrogen")
    with pytest.raises(errors.ConfigParseError):
        base_config(central_difference="NinePoint")
    with pytest.raises(errors.ConfigParseError):
        base_config(output={"file_type": "Xml"})


def test_pot_sub_type_mismatch_scalar_for_cornell(tmp_run):
    """Scalar pot_sub file + FullCornell → WrongPotentialSubDims
    (reference: src/potential.rs:115-129)."""
    with open("input/potential_sub.csv", "w") as fh:
        fh.write("3.5\n")
    cfg = base_config(potential="FullCornell", output={"file_type": "Csv"})
    with pytest.raises(errors.WrongPotentialSubDimsError):
        pmod.load_arrays(cfg, LOG)


def test_pot_sub_type_mismatch_array_for_non_cornell(tmp_run):
    with open("input/potential_sub.json", "w") as fh:
        fh.write(formats.array_to_json(np.ones((16, 16, 16))))
    cfg = base_config(potential="Harmonic", output={"file_type": "Json"})
    with pytest.raises(errors.WrongPotentialSubDimsError):
        pmod.load_arrays(cfg, LOG)


def test_array_shape_error():
    text = "0,0,0,1.0\n0,0,2,2.0\n"  # gap → 3 cells expected, 2 given
    with pytest.raises(errors.ArrayShapeError):
        formats.array_from_csv(text)


def test_plain_record_parse_error():
    with pytest.raises(errors.ParsePlainRecordError):
        formats.array_from_csv("a,b,c,d\n")


def test_script_missing_location():
    cfg = base_config(potential="FromScript")
    cfg.script_location = None
    with pytest.raises(errors.ScriptNotFoundError):
        pmod.load_arrays(cfg, LOG)


def test_script_spawn_failure(tmp_run):
    from wavefarm.config import Grid, Index3
    from wavefarm.io import script as script_io

    grid = Grid(size=Index3(2, 2, 2), dn=0.1, dt=1e-3)
    with pytest.raises(errors.SpawnScriptError):
        script_io.script_potential("./does_not_exist.py", grid, 2, LOG)


def test_load_potential_error_wraps(tmp_run):
    cfg = base_config(potential="FromFile")
    with pytest.raises(errors.LoadPotentialError):
        pmod.load_arrays(cfg, LOG)


def test_mesh_validation():
    with pytest.raises(errors.ConfigParseError):
        base_config(mesh={"x": 0})


def test_halo_narrower_than_block():
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from wavefarm.parallel.mesh import make_mesh
    from wavefarm.parallel.sharded import ShardedOps

    cfg = base_config(
        central_difference="SevenPoint",
        grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.002},
    )
    mesh = make_mesh((8, 1, 1))
    ops = ShardedOps(cfg, mesh, 0)
    with pytest.raises(ValueError, match="narrower than the stencil halo"):
        ops.evolve_chunk(
            ops.put(np.zeros(cfg.work_size())),
            ops.put(np.zeros(cfg.work_size())),
            ops.put(np.zeros(cfg.work_size())),
            ops.put_store(None),
        )
