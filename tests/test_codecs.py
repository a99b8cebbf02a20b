"""The in-repo YAML subset and MessagePack codecs against PyYAML and
msgpack, where those packages are installed (the program itself needs
neither; tests/test_io.py runs the main path without them)."""

import glob
import os

import numpy as np
import pytest

from wavefarm.io import formats, msgpack_codec, yaml_subset

yaml = pytest.importorskip("yaml")
msgpack = pytest.importorskip("msgpack")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [os.path.join(ROOT, "wafer.yaml")] + sorted(
    glob.glob(os.path.join(ROOT, "examples", "*.yaml"))
)

OBS = {"state": 2, "energy": -0.125, "binding_energy": -0.125, "r": 9.5,
       "l_r": 13.4}
# serde_yaml's block layout (the reference's writer) and the flow layout
# PyYAML's old default_flow_style dumps wrapped at 80 columns
SERDE_ARRAY = "---\nv: 1\ndim:\n  - 2\n  - 1\n  - 1\ndata:\n  - 0.5\n  - -1.0e-3\n"
PAYLOADS = {
    "serde_array": SERDE_ARRAY,
    "wrapped_flow_array": yaml.safe_dump(
        {"v": 1, "dim": [3, 2, 2], "data": [float(x) for x in
                                            np.linspace(-1, 1, 12)]},
        default_flow_style=True, sort_keys=False,
    ),
    "complex_array": formats.array_to_yaml(
        np.arange(8.0).reshape(2, 2, 2) * (1 - 0.5j)
    ),
    "observables": formats.observables_to("Yaml", OBS),
    "observables_complex": formats.observables_to(
        "Yaml", dict(OBS, energy_im=0.25)
    ),
    "pot_sub": formats.sub_single_to("Yaml", 18.6),
    "quoted_and_comments": (
        "a: 'it''s' # trailing\nb: \"x: #y\\n\"\n# full line\nc: [1, "
        "{d: yes, e: ~}]\nf:\n- 1.5\n- -2\ng: 1e-4\n"
    ),
}


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_yaml_reader_matches_pyyaml_on_configs(path):
    with open(path) as fh:
        text = fh.read()
    got = yaml_subset.loads(text)
    assert got == yaml.safe_load(text)
    # the flow writer round-trips through both readers
    assert yaml_subset.loads(yaml_subset.dumps(got)) == got
    assert yaml.safe_load(yaml_subset.dumps(got)) == got


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_yaml_reader_matches_pyyaml_on_payloads(name):
    text = PAYLOADS[name]
    assert yaml_subset.loads(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a: &x 1\n", "a: |\n  text\n",
                                  "--- 1\n--- 2\n", "a: [1, 2\n"])
def test_yaml_reader_rejects_outside_subset(text):
    with pytest.raises(yaml_subset.YamlError):
        yaml_subset.loads(text)


MPK_OBJECTS = {
    "array3": [1, [2, 3, 4], [float(x) for x in np.linspace(-3, 3, 24)]],
    "array3_complex": [1, [2, 1, 1], [[0.5, -1.5], [2.0, 0.25]]],
    "pot_sub": [18.6],
    "observables": [0, -0.5, -0.5, 2.25, 7.1],
    "ints_and_strings": {"neg": [-1, -32, -33, -129, -40000, -2 ** 40],
                         "pos": [0, 127, 128, 255, 256, 65536, 2 ** 40],
                         "s": ["", "x" * 31, "y" * 40, "z" * 300],
                         "flags": [True, False, None]},
}


@pytest.mark.parametrize("name", sorted(MPK_OBJECTS))
def test_msgpack_codec_matches_msgpack(name):
    obj = MPK_OBJECTS[name]
    packed = msgpack_codec.packb(obj)
    assert packed == msgpack.packb(obj)
    assert msgpack_codec.unpackb(packed) == msgpack.unpackb(
        packed, strict_map_key=False
    )


def test_msgpack_codec_reads_float32_and_rejects_truncation():
    blob = msgpack.packb([1, [1, 1, 2], [1.5, 2.5]], use_single_float=True)
    assert msgpack_codec.unpackb(blob) == [1, [1, 1, 2], [1.5, 2.5]]
    with pytest.raises(msgpack_codec.MsgpackError):
        msgpack_codec.unpackb(blob[:-2])
