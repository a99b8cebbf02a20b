"""I/O: five formats, trilerp golden, run dirs, script potential, restarts."""

import logging
import os
import stat
import subprocess
import sys

import numpy as np
import pytest

from tests.conftest import base_config
from wavefarm import errors
from wavefarm.config import FileType
from wavefarm.io import formats, readers, run_dir, script as script_io, writers
from wavefarm.io.trilerp import trilerp_resize

LOG = logging.getLogger("test")


# --------------------------------------------------------------------------- #
# codecs
# --------------------------------------------------------------------------- #

ARR = np.linspace(-2.0, 2.0, 24).reshape(2, 3, 4)
CARR = ARR + 1j * ARR[::-1]


@pytest.mark.parametrize(
    "to_fn,from_fn",
    [
        (formats.array_to_json, formats.array_from_json),
        (formats.array_to_yaml, formats.array_from_yaml),
        (formats.array_to_mpk, formats.array_from_mpk),
        (formats.array_to_ron, formats.array_from_ron),
        (formats.array_to_csv, formats.array_from_csv),
    ],
)
def test_array_roundtrip(to_fn, from_fn):
    out = from_fn(to_fn(ARR))
    np.testing.assert_allclose(out, ARR, rtol=0, atol=0)


@pytest.mark.parametrize(
    "to_fn,from_fn",
    [
        (formats.array_to_json, formats.array_from_json),
        (formats.array_to_mpk, formats.array_from_mpk),
        (formats.array_to_csv, formats.array_from_csv),
    ],
)
def test_complex_array_roundtrip(to_fn, from_fn):
    out = from_fn(to_fn(CARR))
    np.testing.assert_allclose(out, CARR, rtol=0, atol=0)


def test_csv_plain_record_layout():
    """Headerless i,j,k,data rows (reference: src/output.rs:148-165)."""
    text = formats.array_to_csv(np.array([[[1.5, 2.5]]]))
    assert text.splitlines() == ["0,0,0,1.5", "0,0,1,2.5"]


def test_json_serde_layout():
    """ndarray-serde compatible {v, dim, data} mapping."""
    import json

    obj = json.loads(formats.array_to_json(np.zeros((1, 2, 1))))
    assert obj["v"] == 1 and obj["dim"] == [1, 2, 1] and obj["data"] == [0.0, 0.0]


def test_mpk_serde_layout():
    """rmp-serde compact struct = [v, dim, data] tuple."""
    import msgpack

    obj = msgpack.unpackb(formats.array_to_mpk(np.zeros((1, 1, 2))))
    assert obj == [1, [1, 1, 2], [0.0, 0.0]]


def test_ron_parser_handles_struct():
    text = "(\n  v: 1,\n  dim: (2, 1, 1),\n  data: [1.0, -2.5],\n)"
    out = formats.array_from_ron(text)
    np.testing.assert_allclose(out, np.array([1.0, -2.5]).reshape(2, 1, 1))


def test_sub_single_roundtrip():
    for ft in ("Json", "Yaml", "Ron", "Csv", "Messagepack"):
        payload = formats.sub_single_to(ft, 3.25)
        arr, scalar = formats.sub_from_text(ft, payload)
        assert arr is None and scalar == 3.25, ft


def test_sub_array_roundtrip():
    for ft, to_fn in [
        ("Json", formats.array_to_json),
        ("Yaml", formats.array_to_yaml),
        ("Ron", formats.array_to_ron),
        ("Csv", formats.array_to_csv),
        ("Messagepack", formats.array_to_mpk),
    ]:
        arr, scalar = formats.sub_from_text(ft, to_fn(ARR))
        assert scalar is None, ft
        np.testing.assert_allclose(arr, ARR)


def test_observables_roundtrip():
    obs = {"state": 2, "energy": 1.5, "binding_energy": -0.25, "r": 3.1, "l_r": 10.2}
    for ft in ("Json", "Yaml", "Ron", "Csv", "Messagepack"):
        out = formats.observables_from(ft, formats.observables_to(ft, obs))
        assert out["state"] == 2 and out["energy"] == 1.5, ft
        assert out["binding_energy"] == -0.25 and out["l_r"] == 10.2


def test_observables_csv_has_header():
    text = formats.observables_to(
        "Csv", {"state": 0, "energy": 1.0, "binding_energy": 0.0, "r": 1.0, "l_r": 1.0}
    )
    assert text.splitlines()[0] == "state,energy,binding_energy,r,l_r"


# --------------------------------------------------------------------------- #
# trilerp
# --------------------------------------------------------------------------- #


def test_trilerp_golden():
    """Golden 2³→4³ values (reference test: src/input.rs:732-824)."""
    src = np.arange(1.0, 9.0).reshape(2, 2, 2)
    out = trilerp_resize(src, (4, 4, 4))
    t = 1.0 / 3.0
    expected_first_plane = np.array(
        [
            [1.0, 1 + t, 1 + 2 * t, 2.0],
            [1 + 2 * t / 1, 2.0 + 0 * t, 2 + t, 2 + 2 * t],
            [2 + t, 2 + 2 * t, 3.0, 3 + t],
            [3.0, 3 + t, 3 + 2 * t, 4.0],
        ]
    )
    # spot-check the exact golden values from the reference test
    golden = [
        ((0, 0, 0), 1.0),
        ((0, 0, 1), 1.3333333333333335),
        ((0, 1, 0), 1.6666666666666667),
        ((0, 3, 3), 4.0),
        ((1, 0, 0), 2.333333333333333),
        ((2, 1, 2), 5.0),
        ((3, 3, 3), 8.0),
        ((3, 0, 1), 5.333333333333334),
    ]
    for idx, val in golden:
        assert abs(out[idx] - val) < 1e-12, (idx, out[idx], val)


def test_trilerp_identity_when_same_size():
    src = np.random.default_rng(0).normal(size=(5, 5, 5))
    out = trilerp_resize(src, (5, 5, 5))
    np.testing.assert_allclose(out, src, atol=1e-14)


# --------------------------------------------------------------------------- #
# run dirs & provenance
# --------------------------------------------------------------------------- #


def test_sanitize_string_golden():
    """(reference test: src/output.rs:758-762)"""
    assert run_dir.sanitize_string(" $//Project*\\") == "_,36,,47,,47,Project,42,,92,"


def test_project_dir_layout(tmp_run):
    d = run_dir.get_project_dir("my proj")
    assert d.startswith("./output/my_proj_")
    run_dir.check_output_dir("my proj")
    assert os.path.isdir(d)


def test_copy_config(tmp_run):
    with open("wafer.yaml", "w") as fh:
        fh.write("project_name: x\n")
    run_dir.check_output_dir("x")
    run_dir.copy_config("x", "wafer.yaml")
    assert os.path.exists(run_dir.get_project_dir("x") + "/wafer.yaml")


# --------------------------------------------------------------------------- #
# writers/readers end-to-end
# --------------------------------------------------------------------------- #


def _move_outputs_to_input(project):
    """Simulate the restart workflow: output files → ./input/."""
    import glob
    import shutil

    for f in glob.glob(run_dir.get_project_dir(project) + "/*"):
        shutil.copy(f, "./input/" + os.path.basename(f))


@pytest.mark.parametrize("ft", list(FileType))
def test_wavefunction_write_read_cycle(tmp_run, ft):
    project = "cycle"
    run_dir.check_output_dir(project)
    data = np.random.default_rng(1).normal(size=(6, 6, 6))
    writers.wavefunction(data, 0, True, project, ft)
    _move_outputs_to_input(project)
    loaded = readers.wavefunction(0, (8, 8, 8), 2, ft, LOG)
    np.testing.assert_allclose(loaded[1:-1, 1:-1, 1:-1], data, rtol=1e-12)
    assert np.all(loaded[0] == 0)


def test_partial_fallback(tmp_run):
    """_partial snapshots load when no converged file exists
    (reference: src/input.rs:513-523)."""
    project = "partial"
    run_dir.check_output_dir(project)
    data = np.random.default_rng(2).normal(size=(4, 4, 4))
    writers.wavefunction(data, 1, False, project, FileType.CSV)
    _move_outputs_to_input(project)
    loaded = readers.wavefunction(1, (6, 6, 6), 2, FileType.CSV, LOG)
    np.testing.assert_allclose(loaded[1:-1, 1:-1, 1:-1], data, rtol=1e-12)


def test_remove_partial(tmp_run):
    project = "rm"
    run_dir.check_output_dir(project)
    writers.wavefunction(np.zeros((2, 2, 2)), 0, False, project, FileType.JSON)
    path = run_dir.get_project_dir(project) + "/wavefunction_0_partial.json"
    assert os.path.exists(path)
    writers.remove_partial(0, project, FileType.JSON)
    assert not os.path.exists(path)
    with pytest.raises(errors.DeletePartialError):
        writers.remove_partial(0, project, FileType.JSON)


def test_missing_files_raise(tmp_run):
    with pytest.raises(errors.FileNotFoundWaferError):
        readers.potential((4, 4, 4), 2, FileType.CSV, LOG)
    with pytest.raises(errors.FileNotFoundWaferError):
        readers.wavefunction(3, (4, 4, 4), 2, FileType.CSV, LOG)


def test_coarse_to_fine_restart(tmp_run):
    """Low-res file upscales onto the requested grid
    (reference: src/config.rs:156-160, src/input.rs:667-716)."""
    project = "upscale"
    run_dir.check_output_dir(project)
    coarse = np.fromfunction(lambda i, j, k: i + j + k, (4, 4, 4))
    writers.wavefunction(coarse, 0, True, project, FileType.JSON)
    _move_outputs_to_input(project)
    loaded = readers.wavefunction(0, (10, 10, 10), 2, FileType.JSON, LOG)
    assert loaded.shape == (10, 10, 10)
    # corners of the interior map to corners of the coarse data
    assert abs(loaded[1, 1, 1] - coarse[0, 0, 0]) < 1e-12
    assert abs(loaded[8, 8, 8] - coarse[3, 3, 3]) < 1e-12


def test_potential_sub_reader_scalar_and_array(tmp_run):
    with open("input/potential_sub.csv", "w") as fh:
        fh.write("7.25\n")
    arr, scalar = readers.potential_sub((4, 4, 4), FileType.CSV, LOG)
    assert arr is None and scalar == 7.25
    os.remove("input/potential_sub.csv")
    with open("input/potential_sub.json", "w") as fh:
        fh.write(formats.array_to_json(np.ones((4, 4, 4))))
    arr, scalar = readers.potential_sub((4, 4, 4), FileType.JSON, LOG)
    assert scalar is None
    np.testing.assert_allclose(arr, 1.0)


def test_multi_file_arbitration(tmp_run, caplog):
    """Configured file_type wins when several formats exist
    (reference: src/input.rs:81-110)."""
    np.random.seed(0)
    a_csv = np.full((3, 3, 3), 1.0)
    a_json = np.full((3, 3, 3), 2.0)
    with open("input/potential.csv", "w") as fh:
        fh.write(formats.array_to_csv(a_csv))
    with open("input/potential.json", "w") as fh:
        fh.write(formats.array_to_json(a_json))
    with caplog.at_level(logging.WARNING, logger="test"):
        loaded = readers.potential((5, 5, 5), 2, FileType.JSON, LOG)
    assert loaded[2, 2, 2] == 2.0
    assert any("Multiple potential files" in r.message for r in caplog.records)


# --------------------------------------------------------------------------- #
# script potential
# --------------------------------------------------------------------------- #


def test_script_potential_contract(tmp_run):
    """JSON in on stdin, newline floats out, x-major order
    (reference: src/input.rs:186-248)."""
    script = tmp_run / "gen.py"
    script.write_text(
        "#!/usr/bin/env python\n"
        "import json, sys\n"
        "g = json.load(sys.stdin)['grid']\n"
        "assert set(g) == {'x', 'y', 'z', 'dn'}\n"
        "for i in range(g['x']):\n"
        "    for j in range(g['y']):\n"
        "        for k in range(g['z']):\n"
        "            print(i * 100 + j * 10 + k)\n"
    )
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    from wavefarm.config import Grid, Index3

    grid = Grid(size=Index3(3, 3, 3), dn=0.1, dt=1e-3)
    v = script_io.script_potential(str(script), grid, 2, LOG)
    assert v.shape == (5, 5, 5)
    assert v[1, 1, 1] == 0.0
    assert v[3, 2, 1] == 2 * 100 + 1 * 10 + 0
    assert np.all(v[0] == 0)


def test_script_potential_bad_output(tmp_run):
    script = tmp_run / "bad.py"
    script.write_text("#!/usr/bin/env python\nprint('not-a-float')\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    from wavefarm.config import Grid, Index3

    grid = Grid(size=Index3(2, 2, 2), dn=0.1, dt=1e-3)
    with pytest.raises(errors.ParseFloatError):
        script_io.script_potential(str(script), grid, 2, LOG)


_NO_PACKAGES = r"""
import sys
sys.modules["yaml"] = None
sys.modules["msgpack"] = None
import glob
import numpy as np
from wavefarm.config import Config
from wavefarm.io import formats

for path in ["wafer.yaml"] + sorted(glob.glob("examples/*.yaml")):
    Config.load(path, setup_output=False)
arr = np.linspace(-1.0, 1.0, 24).reshape(2, 3, 4)
for to, frm in [(formats.array_to_json, formats.array_from_json),
                (formats.array_to_yaml, formats.array_from_yaml),
                (formats.array_to_mpk, formats.array_from_mpk),
                (formats.array_to_ron, formats.array_from_ron),
                (formats.array_to_csv, formats.array_from_csv)]:
    assert np.array_equal(frm(to(arr)), arr), to.__name__
    assert np.array_equal(frm(to(arr * 1j)), arr * 1j), to.__name__
obs = {"state": 0, "energy": 1.5, "binding_energy": 1.5, "r": 3.0, "l_r": 5.0}
for ft in ("Json", "Yaml", "Ron", "Csv", "Messagepack"):
    assert formats.observables_from(ft, formats.observables_to(ft, obs)) == obs, ft
    assert formats.sub_from_text(ft, formats.sub_single_to(ft, 2.5))[1] == 2.5, ft
print("ok")
"""


def test_main_path_without_pyyaml_or_msgpack():
    """With yaml and msgpack unimportable, every shipped config loads and
    the five output formats round-trip."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", _NO_PACKAGES], cwd=root, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
