"""End-to-end validation runs and the f64 sweep rate.

Subcommands (run from the repo root: python benchmarks/r2_validate.py <cmd>):

  f64_bench     f64 XLA sweep updates/s at 128^3 (warm chunks,
                block_until_ready) — the dtype-policy row: below the f32
                1e-6 noise floor users switch to precision: f64
  complex_e2e   absorptive oscillator at 64x64x128 through the solver:
                E0 vs 1.5*sqrt(1+0.2i)
  sync_bench    256^3 harmonic ground, 40 chunks, sync_update 1 vs 8
  northstar     256^3 Coulomb, ground + 2 excited states to 1e-6
  cornell4      BASELINE config 3: SimpleCornell 128^3, 4 states, with a
                restart-from-snapshot mid-run (phase 1 interrupts during
                state 1; phase 2 resumes from the partial)
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def _harmonic_cfg(nx, ny, nz, steps, **over):
    from wavefarm.config import Config

    raw = {
        "project_name": "r2v",
        "grid": {"size": {"x": nx, "y": ny, "z": nz}, "dn": 0.01, "dt": 3e-5},
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
        "init_condition": "Boolean",
        "sig": 1.0,
        "init_symmetry": "NotConstrained",
        "precision": "f32",
    }
    for k, v in over.items():
        if isinstance(v, dict):
            raw[k].update(v)
        else:
            raw[k] = v
    return Config.from_dict(raw)


def f64_bench():
    """f64 sweep throughput (XLA path) — the BASELINE.md dtype-policy row."""
    import jax.numpy as jnp

    from wavefarm.models import initial, potentials as pmod
    from wavefarm.ops.stencil import evolve_chunk

    jax.config.update("jax_enable_x64", True)
    n, steps = 128, 100
    cfg = _harmonic_cfg(n, n, n, steps, precision="f64")
    order = cfg.central_difference.value
    dn, dt, mass = cfg.grid.dn, cfg.grid.dt, cfg.mass
    v = pmod.generate(cfg).astype(jnp.float64)
    a, b = pmod.build_ab(v, dt)
    phi = initial.set_initial_conditions(cfg).astype(jnp.float64)

    def chunk(p):
        return evolve_chunk(p, a, b, None, order, dt, dn, mass, steps, 0)

    phi = chunk(phi).block_until_ready()  # compile + warm
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        phi = chunk(phi).block_until_ready()
        walls.append(time.perf_counter() - t0)
    print(json.dumps({
        "bench": f"f64 XLA sweep {n}^3",
        "updates_per_s": n ** 3 * steps / float(np.median(walls)),
    }))


def complex_e2e():
    """Absorptive oscillator V = (1+0.2i)·r²/2 at 64×64×128 through the
    solver (native complex64 on CPU and GPU). Oracle:
    E = 1.5·√(1+0.2i) = 1.50741 + 0.14926i (BASELINE recorded
    1.50522 + 0.14923i for the discretised operator)."""
    import os
    import tempfile

    d = tempfile.mkdtemp()
    os.chdir(d)
    os.makedirs("input", exist_ok=True)
    from wavefarm import solver
    from wavefarm.io import run_dir

    cfg = _harmonic_cfg(
        64, 64, 128, 200,
        grid={"dn": 0.15, "dt": 0.004},
        potential="ComplexHarmonic",
        absorb=0.2,
        max_steps=200000,
        init_condition="Gaussian",
    )
    run_dir.check_output_dir(cfg.project_name)
    t0 = time.perf_counter()
    results = solver.run(cfg, seed=3)
    wall = time.perf_counter() - t0
    e = results[0].observables.energy / results[0].observables.norm2
    e = complex(e)
    print(json.dumps({
        "bench": "complex_e2e absorptive oscillator 64x64x128",
        "E0": [round(e.real, 5), round(e.imag, 5)],
        "oracle": [1.50741, 0.14926],
        "steps": results[0].steps, "wall_s": round(wall, 1),
    }))
    assert abs(e.real - 1.507) < 0.02 and abs(e.imag - 0.1493) < 0.005, e


def sync_bench():
    """Steady-state host-sync cost: 256³ harmonic ground, fixed 40 chunks
    (tolerance unreachable), sync_update 1 vs 8, with the solver's
    per-chunk/per-batch debug timings printed. The first line of each run
    includes the compile; later lines are steady state."""
    import logging as _logging
    import os
    import tempfile

    d = tempfile.mkdtemp()
    os.chdir(d)
    os.makedirs("input", exist_ok=True)
    from wavefarm import errors, solver
    from wavefarm.io import run_dir

    lg = _logging.getLogger("wafer")
    lg.setLevel(_logging.DEBUG)
    h = _logging.StreamHandler()
    h.setLevel(_logging.DEBUG)
    h.addFilter(lambda r: "updates/s" in r.getMessage())
    lg.addHandler(h)

    for sync in (8, 1):
        cfg = _harmonic_cfg(
            256, 256, 256, 500,
            grid={"dn": 0.0625, "dt": 1.3e-3},
            tolerance=1e-30,
            max_steps=20000,
        )
        cfg.sync_update = sync
        run_dir.check_output_dir(cfg.project_name)
        t0 = time.perf_counter()
        try:
            solver.run(cfg, seed=2)
        except errors.MaxStepError:
            pass
        wall = time.perf_counter() - t0
        print(json.dumps({
            "bench": f"sync_bench 256^3 ground, sync_update={sync}",
            "chunks": 41, "wall_s": round(wall, 1),
            "per_chunk_s": round(wall / 41, 3),
        }), flush=True)


def northstar():
    """BASELINE north star: 256³ Coulomb, ground + two excited states to
    1e-6 on one device (chip_smoke.py phase B runs the same problem
    through the CLI)."""
    import os
    import tempfile

    d = tempfile.mkdtemp()
    os.chdir(d)
    os.makedirs("input", exist_ok=True)
    from wavefarm import solver
    from wavefarm.config import Config
    from wavefarm.io import run_dir

    cfg = Config.from_dict({
        "project_name": "northstar",
        "grid": {"size": {"x": 256, "y": 256, "z": 256}, "dn": 0.0625,
                 "dt": 1.3e-3},
        "tolerance": 1e-6,
        "central_difference": "ThreePoint",
        "wavenum": 0,
        "wavemax": 2,
        "max_steps": 500000,
        "output": {
            "screen_update": 500,
            "file_type": "Json",
            "save_wavefns": False,
            "save_potential": False,
        },
        "potential": "Coulomb",
        "mass": 1.0,
        "init_condition": "Coulomb",
        "sig": 1.0,
        "init_symmetry": "NotConstrained",
        "precision": "f32",
    })
    run_dir.check_output_dir(cfg.project_name)
    t0 = time.perf_counter()
    results = solver.run(cfg, seed=1)
    wall = time.perf_counter() - t0
    total_steps = sum(r.steps for r in results)
    for r in results:
        e = float(np.real(r.observables.energy / r.observables.norm2))
        print(json.dumps({"state": r.wnum, "E": round(e, 6), "steps": r.steps}))
    print(json.dumps({
        "bench": "northstar 256^3 Coulomb 3 states 1e-6",
        "wall_s": round(wall, 1), "total_steps": total_steps,
        "sustained_updates_per_s": f"{256**3 * total_steps / wall:.3e}",
    }))


def cornell4():
    import os
    import shutil
    import tempfile

    d = tempfile.mkdtemp()
    os.chdir(d)
    os.makedirs("input", exist_ok=True)
    from wavefarm import errors, solver
    from wavefarm.config import Config
    from wavefarm.io import run_dir

    def cfg_raw(wavenum, wavemax, max_steps):
        return Config.from_dict(
            {
                "project_name": "cornell4",
                "grid": {"size": {"x": 128, "y": 128, "z": 128}, "dn": 0.35, "dt": 0.04},
                "tolerance": 1e-6,
                "central_difference": "ThreePoint",
                "wavenum": wavenum,
                "wavemax": wavemax,
                "max_steps": max_steps,
                "output": {
                    "screen_update": 500,
                    "snap_update": 2000,
                    "file_type": "Json",
                    "save_wavefns": True,
                    "save_potential": False,
                },
                "potential": "SimpleCornell",
                "mass": 4.65,
                "sig": 0.223,
                "init_condition": "Gaussian",
                "init_symmetry": "NotConstrained",
                "precision": "f32",
                "seed": 11,
            }
        )

    # Phase 1a: converge the ground state; 1b: start state 1 and interrupt
    # it mid-flight (max_steps), leaving its _partial snapshot on disk
    t0 = time.perf_counter()
    cfg1 = cfg_raw(0, 0, 400000)
    run_dir.check_output_dir(cfg1.project_name)
    solver.run(cfg1, seed=11)
    out_dir = run_dir.get_project_dir(cfg1.project_name)
    shutil.copy(
        os.path.join(out_dir, "wavefunction_0.json"), "input/wavefunction_0.json"
    )
    run_dir.reset_proj_date()
    cfg1b = cfg_raw(1, 1, 1500)
    cfg1b.output.snap_update = 500
    run_dir.check_output_dir(cfg1b.project_name)
    interrupted = False
    try:
        solver.run(cfg1b, seed=11)
    except errors.MaxStepError:
        interrupted = True
    wall1 = time.perf_counter() - t0
    print(json.dumps({"phase": 1, "interrupted": interrupted, "wall_s": round(wall1, 1)}))

    # Stage the interrupted state 1's partial snapshot as input
    out_dir1b = run_dir.get_project_dir(cfg1b.project_name)
    for f in os.listdir(out_dir1b):
        if f.startswith("wavefunction_"):
            shutil.copy(os.path.join(out_dir1b, f), os.path.join("input", f))
            print(json.dumps({"staged": f}))

    # Phase 2: resume state 1 from its _partial, converge states 1..3
    run_dir.reset_proj_date()
    cfg2 = cfg_raw(1, 3, 400000)
    run_dir.check_output_dir(cfg2.project_name)
    t0 = time.perf_counter()
    results = solver.run(cfg2, seed=11)
    wall2 = time.perf_counter() - t0
    n_pts = 128 ** 3
    tot_steps = sum(r.steps for r in results)
    for r in results:
        e = float(np.real(r.observables.energy / r.observables.norm2))
        vinf = r.observables.v_infinity / r.observables.norm2
        print(json.dumps({
            "state": r.wnum, "E_GeV": round(e, 6),
            "binding_GeV": round(e - float(vinf), 6), "steps": r.steps,
        }))
    print(json.dumps({
        "phase": 2, "wall_s": round(wall2, 1),
        "updates_per_s": f"{n_pts * tot_steps / wall2:.3e}",
    }))


if __name__ == "__main__":
    cmd = sys.argv[1] if len(sys.argv) > 1 else "northstar"
    # CLI parity: the wafer CLI always enables x64 (f64 observables
    # accumulation and f64 convergence quotients; f32 arrays stay f32) —
    # without it |E| > ~2 loses the 1e-6 tolerance signal to f32 ulps.
    if cmd.endswith("_e2e") or cmd in ("northstar", "cornell4", "sync_bench"):
        jax.config.update("jax_enable_x64", True)
    dev = jax.devices()[0]
    print(f"device: {dev.platform} {getattr(dev, 'device_kind', '?')}  cmd={cmd}")
    {
        "f64_bench": f64_bench,
        "sync_bench": sync_bench,
        "complex_e2e": complex_e2e,
        "northstar": northstar,
        "cornell4": cornell4,
    }[cmd]()
