"""Benchmark: sustained grid-point updates/s of the XLA stencil sweep on
one GPU, against the same sweep on this host's CPU.

The reference publishes no numbers (BASELINE.md), so the primary metric is
grid-point updates per second of the ground-state sweep: warm
``screen_update``-step chunks of ``ops/stencil.evolve_chunk``, timed on the
host clock around ``block_until_ready``. The default grid is 512³ f32
(512 MiB per field, ten times the card's 50 MB L2, so the sweep streams
from HBM); 256³ fields are about the size of L2. ``vs_baseline`` divides by
the host-CPU XLA rate of the same sweep on the same grid, timed over
shorter chunks. 64-bit types are enabled, as in the CLI.

Run on the GPU: ``python bench.py``. It exits non-zero without a GPU.
Prints the device identity, then ONE JSON line.
"""

from __future__ import annotations

import json
import os
import statistics
import time

# a CPU platform with one device for the baseline leg, beside the GPU
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=1"
    ).strip()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from wavefarm.config import Config  # noqa: E402
from wavefarm.models import initial, potentials as pmod  # noqa: E402
from wavefarm.ops.stencil import evolve_chunk  # noqa: E402
from wavefarm.utils.runtime import (  # noqa: E402
    card_identity,
    require_gpu,
    setup_compile_cache,
)

N = int(os.environ.get("WAFER_BENCH_N", "512"))
STEPS = int(os.environ.get("WAFER_BENCH_STEPS", "200"))
STEPS_CPU = 4  # the CPU sweeps 512³ at ~0.5 s/step
REPEATS = 5

# Published HBM bandwidth by JAX device_kind (NVIDIA H100 SXM5 data sheet:
# 3.35 TB/s). A device missing here is an error: no peak is assumed.
PEAK_HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def bytes_per_update(itemsize: int) -> int:
    """HBM bytes one sweep update must move at least: read ψ, A and B and
    write ψ (ops/stencil.evolve_step)."""
    return 4 * itemsize


def peak_hbm(device_kind: str) -> float:
    if device_kind not in PEAK_HBM_BYTES_PER_S:
        raise KeyError(
            f"no published HBM bandwidth for {device_kind!r}; add it to "
            "PEAK_HBM_BYTES_PER_S with its source"
        )
    return PEAK_HBM_BYTES_PER_S[device_kind]


def _make_config(n: int, steps: int) -> Config:
    return Config.from_dict(
        {
            "project_name": "bench",
            "grid": {"size": {"x": n, "y": n, "z": n}, "dn": 0.01, "dt": 3e-5},
            "tolerance": 1e-6,
            "central_difference": "ThreePoint",
            "wavenum": 0,
            "wavemax": 0,
            "output": {
                "screen_update": steps,
                "file_type": "Json",
                "save_wavefns": False,
                "save_potential": False,
            },
            "potential": "Harmonic",
            "mass": 1.0,
            "init_condition": "Boolean",  # the reference's benchmark IC
            "sig": 1.0,
            "init_symmetry": "NotConstrained",
            "precision": "f32",
        }
    )


def sweep_rate(device, n: int, steps: int, repeats: int):
    """(compile seconds, median updates/s) of warm ground-state chunks of
    ``steps`` steps."""
    cfg = _make_config(n, steps)
    order = cfg.central_difference.value
    dn, dt, mass = cfg.grid.dn, cfg.grid.dt, cfg.mass
    with jax.default_device(device):
        v = pmod.generate(cfg).astype(jnp.float32)
        a, b = pmod.build_ab(v, dt)
        del v
        phi = initial.set_initial_conditions(cfg).astype(jnp.float32)

        def chunk(p):
            return evolve_chunk(p, a, b, None, order, dt, dn, mass, steps, 0)

        t0 = time.perf_counter()
        phi = chunk(phi).block_until_ready()  # compile + first run
        compile_s = time.perf_counter() - t0
        rates = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            phi = chunk(phi).block_until_ready()
            rates.append(n ** 3 * steps / (time.perf_counter() - t0))
    return compile_s, statistics.median(rates)


def main() -> None:
    setup_compile_cache()
    gpu = require_gpu()
    jax.config.update("jax_enable_x64", True)
    print(
        f"device: {gpu.platform} {gpu.device_kind} x{len(jax.devices())}; "
        f"card: {card_identity()}",
        flush=True,
    )
    compile_s, value = sweep_rate(gpu, N, STEPS, REPEATS)
    _cpu_compile, baseline = sweep_rate(jax.devices("cpu")[0], N, STEPS_CPU, 3)
    bound = peak_hbm(gpu.device_kind) / bytes_per_update(4)
    print(json.dumps({
        "metric": f"XLA stencil sweep grid-point updates/s at {N}^3 "
                  "(f32, ThreePoint, ground state)",
        "value": value,
        "unit": "updates/s",
        "compile_s": compile_s,
        "hbm_roofline_share": value / bound,
        "bytes_per_update_model": bytes_per_update(4),
        "vs_baseline": value / baseline,
        "baseline": f"host-CPU XLA sweep at {N}^3: {baseline} updates/s",
        "device": {
            "platform": gpu.platform,
            "kind": gpu.device_kind,
            "count": len(jax.devices()),
        },
    }))


if __name__ == "__main__":
    main()
