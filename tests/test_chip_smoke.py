"""chip_smoke.py's contract on the CPU: it refuses to run without a GPU,
and its phase functions run end to end at 16³. Also the launch helpers it
shares with the CLI and bench.py (compile cache, platform checks)."""

import json
import subprocess

import jax
import pytest

import chip_smoke
from wavefarm.ops import split_complex
from wavefarm.utils import runtime


@pytest.mark.parametrize("argv", [[], ["--four-cards"]], ids=["one", "four"])
def test_refuses_cpu_platform(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(argv)
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


@pytest.fixture
def scratch(tmp_run, monkeypatch):
    monkeypatch.setattr(chip_smoke, "SCRATCH", str(tmp_run / "scratch"))
    return tmp_run


def test_phase_a_at_16(scratch, capsys):
    rec = chip_smoke.phase_a(shape=(16, 16, 16), dn=0.1)
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert rec == {"phase": "A", "ok": True}
    assert len(lines) == 10 and all(l["ok"] for l in lines)
    probe = [l for l in lines if l.get("case") == "tf32_probe"]
    assert len(probe) == 1 and probe[0]["shape"] == [16, 16, 16]
    steps = [l for l in lines if "order" in l]
    assert {(l["order"], l["dtype"]) for l in steps} == {
        (o, d) for o in chip_smoke.ORDERS for d in chip_smoke.DTYPES
    }


def test_phase_b_at_16(scratch):
    """The north-star pipeline (3 states through the CLI, wavefunctions
    written and read back, convergence records) on a coarse grid: it runs
    and reports, though the coarse energies miss the 256³ targets."""
    rec = chip_smoke.phase_b(n=16, dn=1.0, dt=0.3, tolerance=1e-4,
                             max_steps=20000, screen_update=50)
    assert rec["rc"] == 0
    assert sorted(rec["energies"]) == ["0", "1", "2"]
    assert rec["energies"]["0"] < min(rec["energies"]["1"], rec["energies"]["2"])
    assert [s["state"] for s in rec["states"]] == [0, 1, 2]
    assert rec["total_steps"] > 0 and rec["max_state_overlap"] < 1e-4
    assert rec["sustained_updates_per_s"] > 0


def test_phase_c_at_16(scratch):
    rec = chip_smoke.phase_c(n=16, dn=0.5, dt=0.05, tolerance=1e-5)
    assert rec["rc"] == 0
    assert rec["rel_err"] is not None and rec["rel_err"] < 0.05
    assert rec["e0"][1] > 0  # absorptive: Im E > 0


def test_phase_four_cards_at_16(scratch):
    """The sharded-vs-single comparison on 4 virtual CPU devices."""
    rec = chip_smoke.phase_four_cards(n=16, n_cards=4)
    assert rec["ok"], rec
    assert rec["first_chunk_field_err"] < 1e-6


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "default"])
def test_compile_cache_dir_rule(env_set, monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is set; otherwise the
    cache is the fixed <checkout>/.jax_cache."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert runtime.setup_compile_cache() == str(tmp_path)
        assert calls == []
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = runtime.setup_compile_cache()
        assert path == f"{runtime.REPO_ROOT}/.jax_cache"
        assert calls == [("jax_compilation_cache_dir", path)]


@pytest.mark.parametrize("platform,expected", [("gpu", True), ("cpu", True),
                                               ("other", False)])
def test_backend_supports_complex_from_platform(platform, expected,
                                                monkeypatch):
    """Answered from the platform name alone — no probe process."""

    class Dev:
        pass

    dev = Dev()
    dev.platform = platform
    monkeypatch.setattr(jax, "devices", lambda *a: [dev])

    def no_subprocess(*a, **k):
        raise AssertionError("backend_supports_complex spawned a process")

    monkeypatch.setattr(subprocess, "run", no_subprocess)
    monkeypatch.setattr(subprocess, "Popen", no_subprocess)
    assert split_complex.backend_supports_complex() is expected


def _rounded_overlap(phi, stacked):
    """``solver._max_rel_overlap`` with the contraction's inputs rounded to
    bf16: on the CPU, a stand-in for a GPU running it in TF32."""
    import jax.numpy as jnp

    def r(x):
        return x.astype(jnp.bfloat16).astype(x.dtype)

    pn = jnp.sqrt(jnp.sum(phi * phi))
    ln = jnp.sqrt(jnp.sum(stacked * stacked, axis=(1, 2, 3)))
    ov = jnp.abs(jnp.tensordot(r(stacked), r(phi), axes=3))
    return jnp.max(ov / (ln * pn))


@pytest.mark.parametrize("rounded", [False, True], ids=["solver", "rounded"])
def test_tf32_probe(rounded, monkeypatch):
    """The probe passes on the solver's overlap and fails when the
    contraction drops mantissa bits."""
    from wavefarm import solver

    if rounded:
        monkeypatch.setattr(solver, "_max_rel_overlap", _rounded_overlap)
    rec = chip_smoke.tf32_probe((16, 16, 16))
    assert rec["ok"] is not rounded, rec


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit):
        runtime.require_gpu()
