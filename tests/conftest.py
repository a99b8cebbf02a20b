"""Test harness: force an 8-virtual-device CPU platform and f64.

Sharding/halo-exchange tests run on a virtual CPU mesh
(``xla_force_host_platform_device_count=8``) so multi-device paths are
testable without accelerators. Must run before jax is imported anywhere.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# Pin the platform in the config as well: a JAX_PLATFORMS set before this
# module ran (or a GPU on the machine) must not move the tests off the CPU.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture
def tmp_run(tmp_path, monkeypatch):
    """Isolated input/output roots and a fresh run-dir timestamp."""
    from wavefarm.io import run_dir

    monkeypatch.chdir(tmp_path)
    (tmp_path / "input").mkdir()
    (tmp_path / "output").mkdir()
    run_dir.reset_proj_date()
    return tmp_path


def base_config(**overrides):
    """Small harmonic config for tests."""
    raw = {
        "project_name": "test",
        "grid": {"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.1, "dt": 3e-3},
        "tolerance": 1e-6,
        "central_difference": "ThreePoint",
        "max_steps": None,
        "wavenum": 0,
        "wavemax": 0,
        "output": {
            "screen_update": 100,
            "snap_update": None,
            "file_type": "Csv",
            "save_wavefns": False,
            "save_potential": False,
        },
        "potential": "Harmonic",
        "mass": 1.0,
        "init_condition": "Constant",
        "sig": 1.0,
        "init_symmetry": "NotConstrained",
    }

    def deep_update(dst, src):
        for k, v in src.items():
            if isinstance(v, dict) and isinstance(dst.get(k), dict):
                deep_update(dst[k], v)
            else:
                dst[k] = v

    deep_update(raw, overrides)
    from wavefarm.config import Config

    return Config.from_dict(raw)
