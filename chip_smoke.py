"""Smoke test of the solver's main path on one NVIDIA GPU.

    python chip_smoke.py               # phases A, B, C on the first GPU
    python chip_smoke.py --four-cards  # the 4-GPU sharded run and its
                                       # single-GPU comparison, nothing else

Phases (each prints one JSON line with its numbers, tolerances and verdict):

A. One ``stencil.evolve_step``, then the fused observables, normalisation
   and projection against 2 stored states (``solver._measure_and_prepare``)
   at 256³ for every stencil order in f32, f64 and complex64, against the
   plain NumPy float64 reference (``wavefarm/reference.py``); and a probe
   that the overlap contraction is not run in TF32.
B. The north-star run through the ``wafer`` CLI: 256³ Coulomb, ground plus
   2 excited states to 1e-6, checked against the recorded energies.
C. Native complex64 through the CLI: the absorptive oscillator at 256³
   against the analytic E₀ = 1.5·√(1 + 0.2i).

The script refuses to run (non-zero exit, no result line) unless JAX's first
device is a GPU. Every phase runs in this one process. The last line is
``{"ok": true, "device": {...}}`` only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import sys
import time

ORDERS = ("ThreePoint", "FivePoint", "SevenPoint")
DTYPES = ("f32", "f64", "complex64")
# field tolerance relative to max|ψ|, by dtype
FIELD_TOL = {"f32": 1e-5, "complex64": 1e-5, "f64": 1e-12}
OBS_TOL = 1e-6  # relative, f64 accumulation
OVERLAP_TOL = 1e-6

# recorded north-star energies (BASELINE.md, "North star re-run")
NORTH_STAR_E0 = -0.498149
NORTH_STAR_E0_TOL = 5e-5
N2_MULTIPLET = (-0.1160, -0.1040)
ORTHO_TOL = 1e-4
COMPLEX_TOL = 2e-3  # relative; covers the O(dn²) discretisation offset

SCRATCH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "scratch_runs")


def emit(record: dict) -> dict:
    print(json.dumps(record), flush=True)
    return record


def _config(raw_over: dict):
    from wavefarm.config import Config

    raw = {
        "project_name": "smoke",
        "grid": {"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.1, "dt": 3e-3},
        "tolerance": 1e-6,
        "central_difference": "ThreePoint",
        "wavenum": 0,
        "wavemax": 0,
        "output": {"screen_update": 100, "file_type": "Json",
                   "save_wavefns": False, "save_potential": False},
        "potential": "Harmonic",
        "mass": 1.0,
        "init_condition": "Constant",
        "sig": 1.0,
        "init_symmetry": "NotConstrained",
    }
    raw.update(raw_over)
    return Config.from_dict(raw)


# --------------------------------------------------------------------------- #
# Phase A: one step + observables + projection against the NumPy reference
# --------------------------------------------------------------------------- #


def step_case(order: str, dtype: str, potential: str = "Harmonic",
              shape=(256, 256, 256), dn: float = 0.05, seed: int = 0) -> dict:
    """Compare one device step, measure and projection with
    ``wavefarm.reference`` on a random smooth-plus-noise ψ and 2 stored
    orthonormal states. ``dtype`` is f32, f64 or complex64; a complex64
    case scales the potential by (1 + 0.2i)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from wavefarm import geometry, reference, solver
    from wavefarm.models import potentials as pmod
    from wavefarm.ops import stencil

    cfg = _config({
        "grid": {"size": dict(zip("xyz", shape)), "dn": dn,
                 "dt": 0.9 * min(dn * dn / 3.0,
                                 solver.stable_dt_bound(order, dn, 1.0))},
        "central_difference": order,
        "potential": potential,
        "precision": "f64" if dtype == "f64" else "f32",
    })
    ext = cfg.central_difference.ext
    dt, mass = cfg.grid.dt, cfg.mass
    cplx = dtype == "complex64"
    jdt = {"f32": jnp.float32, "f64": jnp.float64,
           "complex64": jnp.complex64}[dtype]
    pots = pmod.load_arrays(cfg)
    v = pots.v * (1.0 + 0.2j) if cplx else pots.v
    a, b = pmod.build_ab(v, dt, pots.v_shift)
    r2 = geometry.r2_index_grid(shape, shape, dtype=cfg.real_dtype)

    rng = np.random.default_rng(seed)
    pad = cfg.padded_size()

    def field():
        x = [np.linspace(-1.0, 1.0, n) for n in pad]
        env = np.exp(-2.0 * (x[0][:, None, None] ** 2 + x[1][None, :, None] ** 2
                             + x[2][None, None, :] ** 2))
        f = env * (1.0 + 0.1 * rng.standard_normal(pad))
        if cplx:
            f = f + 1j * env * rng.standard_normal(pad)
        return np.asarray(geometry.zero_boundary(jnp.asarray(f), ext))

    stored = []
    for _ in range(2):  # orthonormal in float64, then rounded to dtype
        s = field()
        for l in stored:
            s = s - l * np.sum(np.conj(l) * s)
        stored.append(s / np.sqrt(np.sum(np.abs(s) ** 2)))
    stored = [np.asarray(jnp.asarray(s, jdt)) for s in stored]
    psi = jnp.asarray(field(), jdt)
    stacked = jnp.asarray(np.stack(stored))

    step = jax.jit(stencil.evolve_step, static_argnums=(3,))
    phi1 = step(psi, a.astype(jdt), b.astype(jdt), order, dt, dn, mass)
    (e, n2, vinf, r2s), phi2 = solver._measure_and_prepare(
        phi1, v.astype(jdt), r2, pots.pot_sub_array, pots.pot_sub_scalar,
        stacked, order, dn, mass, 2,
    )
    ov_dev = float(solver._max_rel_overlap(phi2, stacked))

    psi_np = np.asarray(psi)
    v_np = np.asarray(v)
    r1 = reference.evolve_step(psi_np, v_np, order, dt, dn, mass, pots.v_shift)
    pot_sub = (np.asarray(pots.pot_sub_array) if pots.pot_sub_array is not None
               else pots.pot_sub_scalar)
    e_r, n2_r, vinf_r, r2_r = reference.observables(r1, v_np, order, dn, mass,
                                                    pot_sub)
    r_proj = reference.normalise_project(r1, n2_r, stored)
    phi2_np = np.asarray(phi2)
    ov_true = reference.max_rel_overlap(phi2_np, stored)

    def rel(x, y):
        return abs(complex(x) - complex(y)) / max(abs(complex(y)), 1e-300)

    err_step = float(np.max(np.abs(np.asarray(phi1) - r1)) / np.max(np.abs(r1)))
    err_proj = float(np.max(np.abs(phi2_np - r_proj)) / np.max(np.abs(r_proj)))
    err_obs = {
        "energy": rel(e, e_r), "norm2": rel(n2, n2_r), "r2": rel(r2s, r2_r),
        "v_inf": rel(vinf, vinf_r) if vinf_r else abs(float(vinf)),
    }
    ftol = FIELD_TOL[dtype]
    ok = (
        err_step <= ftol and err_proj <= ftol
        and max(err_obs.values()) <= OBS_TOL
        and ov_true <= OVERLAP_TOL and abs(ov_dev - ov_true) <= OVERLAP_TOL
    )
    return {
        "order": order, "dtype": dtype, "potential": potential,
        "shape": list(shape), "field_err_step": err_step,
        "field_err_projected": err_proj, "field_tol": ftol,
        "obs_rel_err": err_obs, "obs_tol": OBS_TOL,
        "overlap_after_projection": ov_true,
        "overlap_device_measured": ov_dev, "overlap_tol": OVERLAP_TOL,
        "overlap_precision": "HIGHEST", "ok": bool(ok),
    }


def tf32_probe(shape=(256, 256, 256)) -> dict:
    """The delayed-GS gate's overlap of a field with 2 copies of itself,
    every value 1 + 2⁻¹³: exact in f32, but 1 in TF32 (10 mantissa bits).
    An f32 contraction run in TF32 reads 1 − 2.4e-4 here where the answer
    is 1; the spread random fields of ``step_case`` would hide it (random
    rounding errors cancel to ~2⁻¹¹/√N)."""
    import jax.numpy as jnp

    from wavefarm import solver

    c = jnp.full(shape, 1.0 + 2.0 ** -13, jnp.float32)
    ov = float(solver._max_rel_overlap(c, jnp.stack([c, c])))
    err = abs(ov - 1.0)
    return {"case": "tf32_probe", "shape": list(shape), "overlap": ov,
            "err": err, "tol": OVERLAP_TOL, "tf32_would_read": 1 - 2.0 ** -12,
            "ok": bool(err <= OVERLAP_TOL)}


def phase_a(shape=(256, 256, 256), dn: float = 0.05) -> dict:
    cases = []
    for dtype in DTYPES:
        for order in ORDERS:
            cases.append(emit(dict(phase="A", **step_case(order, dtype,
                                                           shape=shape, dn=dn))))
    cases.append(emit(dict(phase="A", **tf32_probe(shape))))
    return {"phase": "A", "ok": all(c["ok"] for c in cases)}


# --------------------------------------------------------------------------- #
# CLI runs (phases B, C and the four-card phase)
# --------------------------------------------------------------------------- #


class _ConvergedRecords(logging.Handler):
    """Collects the solver's per-state convergence records."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.states = []

    def emit(self, record):
        if hasattr(record, "wafer_steps"):
            self.states.append({
                "state": record.wafer_state, "steps": record.wafer_steps,
                "delayed_chunks": record.wafer_delayed_chunks,
            })


class _CompileClock:
    """Seconds JAX spends tracing, lowering and compiling in a window."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        self.seconds = 0.0

    def __call__(self, event, duration, **_kw):
        if event in self.EVENTS:
            self.seconds += duration

    def __enter__(self):
        import jax.monitoring

        jax.monitoring.register_event_duration_secs_listener(self)
        return self

    def __exit__(self, *exc):
        import jax.monitoring

        jax.monitoring.unregister_event_duration_listener(self)


def run_cli(name: str, raw: dict) -> dict:
    """Write ``raw`` as a YAML config under scratch_runs/<name>, run the
    ``wafer`` CLI on it there, and return the observables files, the
    convergence records, the wall and the compile seconds."""
    from wavefarm import cli
    from wavefarm.config import FileType
    from wavefarm.io import formats, run_dir, yaml_subset

    work = os.path.join(SCRATCH, name)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    with open(os.path.join(work, "run.yaml"), "w") as fh:
        fh.write(yaml_subset.dumps(raw))
    records = _ConvergedRecords()
    root = logging.getLogger()
    root.addHandler(records)
    cwd = os.getcwd()
    os.chdir(work)
    run_dir.reset_proj_date()
    try:
        with _CompileClock() as clock:
            t0 = time.perf_counter()
            rc = cli.main(["-c", "run.yaml", "-d"])
            wall = time.perf_counter() - t0
        proj = run_dir.get_project_dir(raw["project_name"])
        ft = FileType(raw["output"]["file_type"])
        energies = {}
        for st in range(raw["wavenum"], raw["wavemax"] + 1):
            path = os.path.join(proj, f"observables_{st}{ft.extension}")
            if os.path.exists(path):
                with open(path, "rb") as fh:
                    blob = fh.read()
                if ft is not FileType.MESSAGEPACK:
                    blob = blob.decode()
                obs = formats.observables_from(ft.value, blob)
                energies[st] = complex(obs["energy"], obs.get("energy_im", 0.0))
        return {"rc": rc, "wall_s": wall, "compile_s": clock.seconds,
                "energies": energies, "states": records.states,
                "project_dir": os.path.join(work, proj)}
    finally:
        os.chdir(cwd)
        root.removeHandler(records)


def _north_star_raw(n: int, dn: float, dt: float, tolerance: float,
                    max_steps: int, screen_update: int) -> dict:
    return {
        "project_name": "northstar",
        "grid": {"size": {"x": n, "y": n, "z": n}, "dn": dn, "dt": dt},
        "tolerance": tolerance,
        "central_difference": "ThreePoint",
        "wavenum": 0,
        "wavemax": 2,
        "max_steps": max_steps,
        "output": {"screen_update": screen_update, "file_type": "Messagepack",
                   "save_wavefns": True, "save_potential": False},
        "potential": "Coulomb",
        "mass": 1.0,
        "init_condition": "Coulomb",
        "sig": 1.0,
        "init_symmetry": "NotConstrained",
        "precision": "f32",
        "seed": 1,
    }


def _sustained(n_points: int, run: dict) -> float:
    steps = sum(s["steps"] for s in run["states"])
    return n_points * steps / max(run["wall_s"] - run["compile_s"], 1e-9)


def phase_b(n: int = 256, dn: float = 0.0625, dt: float = 1.3e-3,
            tolerance: float = 1e-6, max_steps: int = 500000,
            screen_update: int = 500) -> dict:
    """North star through the CLI (benchmarks/r2_validate.py northstar)."""
    import numpy as np

    from wavefarm.io import formats

    run = run_cli("northstar", _north_star_raw(n, dn, dt, tolerance,
                                               max_steps, screen_update))
    e = {k: v.real for k, v in run["energies"].items()}
    fields = []
    for st in range(3):
        path = os.path.join(run["project_dir"], f"wavefunction_{st}.mpk")
        if os.path.exists(path):
            with open(path, "rb") as fh:
                fields.append(formats.array_from_mpk(fh.read()))
    ortho = None
    if len(fields) == 3:
        norms = [np.sqrt(np.sum(f * f)) for f in fields]
        ortho = max(
            abs(float(np.sum(fields[i] * fields[j]))) / (norms[i] * norms[j])
            for i in range(3) for j in range(i + 1, 3)
        )
    shutil.rmtree(os.path.join(SCRATCH, "northstar"), ignore_errors=True)
    lo, hi = N2_MULTIPLET
    ok = (
        run["rc"] == 0 and len(e) == 3
        and abs(e[0] - NORTH_STAR_E0) <= NORTH_STAR_E0_TOL
        and all(lo <= e[s] <= hi for s in (1, 2))
        and ortho is not None and ortho <= ORTHO_TOL
    )
    return emit({
        "phase": "B", "grid": n, "rc": run["rc"],
        "energies": {str(k): v for k, v in e.items()},
        "e0_expected": NORTH_STAR_E0, "e0_tol": NORTH_STAR_E0_TOL,
        "n2_multiplet": list(N2_MULTIPLET),
        "max_state_overlap": ortho, "ortho_tol": ORTHO_TOL,
        "wall_s": run["wall_s"], "compile_s": run["compile_s"],
        "total_steps": sum(s["steps"] for s in run["states"]),
        "states": run["states"],
        "sustained_updates_per_s": _sustained(n ** 3, run),
        "ok": bool(ok),
    })


def phase_c(n: int = 256, dn: float = 0.05, dt: float = 8e-4,
            tolerance: float = 1e-6) -> dict:
    """Native complex64 through the CLI: ComplexHarmonic, absorb 0.2."""
    import cmath

    raw = {
        "project_name": "complex harmonic",
        "grid": {"size": {"x": n, "y": n, "z": n}, "dn": dn, "dt": dt},
        "tolerance": tolerance,
        "central_difference": "ThreePoint",
        "wavenum": 0,
        "wavemax": 0,
        "max_steps": 400000,
        "output": {"screen_update": 500, "file_type": "Json",
                   "save_wavefns": False, "save_potential": False},
        "potential": "ComplexHarmonic",
        "absorb": 0.2,
        "mass": 1.0,
        "init_condition": "Constant",
        "sig": 1.0,
        "init_symmetry": "NotConstrained",
        "precision": "f32",
    }
    run = run_cli("complex", raw)
    exact = 1.5 * cmath.sqrt(1 + 0.2j)
    e0 = run["energies"].get(0)
    err = abs(e0 - exact) / abs(exact) if e0 is not None else None
    shutil.rmtree(os.path.join(SCRATCH, "complex"), ignore_errors=True)
    return emit({
        "phase": "C", "grid": n, "rc": run["rc"],
        "e0": [e0.real, e0.imag] if e0 is not None else None,
        "e0_exact": [exact.real, exact.imag], "rel_err": err,
        "tol": COMPLEX_TOL, "wall_s": run["wall_s"],
        "compile_s": run["compile_s"], "states": run["states"],
        "sustained_updates_per_s": _sustained(n ** 3, run),
        "ok": bool(run["rc"] == 0 and err is not None and err <= COMPLEX_TOL),
    })


# --------------------------------------------------------------------------- #
# four cards
# --------------------------------------------------------------------------- #


def _sharded_512_raw(path: str, n: int, mesh_x: int):
    from wavefarm.io import yaml_subset

    with open(path) as fh:
        raw = yaml_subset.loads(fh.read())
    raw["grid"]["size"] = {"x": n, "y": n, "z": n}
    raw["output"]["save_wavefns"] = False
    raw.pop("mesh", None)
    if mesh_x > 1:
        raw["mesh"] = {"x": mesh_x, "y": 1, "z": 1}
    return raw


def first_chunk_agreement(raw: dict, n_cards: int) -> float:
    """Max |sharded − single| / max|single| of ψ after one chunk, the same
    initial condition on both."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from wavefarm import geometry
    from wavefarm.config import Config
    from wavefarm.models import initial, potentials as pmod
    from wavefarm.ops import stencil
    from wavefarm.parallel.mesh import make_mesh
    from wavefarm.parallel.sharded import ShardedOps

    cfg = Config.from_dict(raw)
    ext = cfg.central_difference.ext
    g = cfg.grid
    with jax.default_device(jax.devices()[0]):
        pots = pmod.load_arrays(cfg)
        phi = initial.set_initial_conditions(cfg, seed=cfg.seed)
        single = stencil.evolve_chunk(
            phi, pots.a, pots.b, None, cfg.central_difference.value, g.dt,
            g.dn, cfg.mass, cfg.output.screen_update, 0,
        )
        single = np.asarray(geometry.work_area(single, ext))
    ops = ShardedOps(cfg, make_mesh((n_cards, 1, 1)), 0)
    out = ops.evolve_chunk(
        ops.put(geometry.work_area(phi, ext)),
        ops.put(geometry.work_area(pots.a, ext)),
        ops.put(geometry.work_area(pots.b, ext)),
        ops.put_store(None),
    )
    sharded = np.asarray(ops.get(out))
    del pots, phi, out
    return float(np.max(np.abs(sharded - single)) / np.max(np.abs(single)))


def phase_four_cards(n: int = 512, n_cards: int = 4) -> dict:
    example = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "examples", "sharded_512.yaml")
    raw_mesh = _sharded_512_raw(example, n, n_cards)
    raw_one = _sharded_512_raw(example, n, 1)
    raw_one["project_name"] += " single"
    field_err = first_chunk_agreement(raw_one, n_cards)
    sharded = run_cli("sharded", raw_mesh)
    single = run_cli("single", raw_one)
    e_s, e_1 = sharded["energies"].get(0), single["energies"].get(0)
    e_rel = abs(e_s - e_1) / abs(e_1) if None not in (e_s, e_1) else None
    for d in ("sharded", "single"):
        shutil.rmtree(os.path.join(SCRATCH, d), ignore_errors=True)
    field_tol = 1e-5
    return emit({
        "phase": "four_cards", "grid": n, "cards": n_cards,
        "e0_sharded": e_s.real if e_s is not None else None,
        "e0_single": e_1.real if e_1 is not None else None,
        "e0_rel_diff": e_rel, "e0_tol": 1e-6,
        "first_chunk_field_err": field_err, "field_tol": field_tol,
        "wall_s": {"sharded": sharded["wall_s"], "single": single["wall_s"]},
        "compile_s": {"sharded": sharded["compile_s"],
                      "single": single["compile_s"]},
        "steps": {"sharded": sharded["states"], "single": single["states"]},
        "updates_per_s_per_card": {
            "sharded": _sustained(n ** 3, sharded) / n_cards,
            "single": _sustained(n ** 3, single),
        },
        "ok": bool(
            sharded["rc"] == 0 and single["rc"] == 0 and e_rel is not None
            and e_rel <= 1e-6 and field_err <= field_tol
        ),
    })


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the 4-GPU sharded phase")
    args = parser.parse_args(argv)

    import jax

    from wavefarm.utils.runtime import (
        card_identity,
        require_gpu,
        setup_compile_cache,
    )

    dev = require_gpu()
    cache = setup_compile_cache()
    jax.config.update("jax_enable_x64", True)
    n_dev = len(jax.devices())
    print(f"platform={dev.platform} device_kind={dev.device_kind} "
          f"count={n_dev}", flush=True)
    print(card_identity(), flush=True)
    print(f"jax {jax.__version__}; compile cache {cache}", flush=True)

    if args.four_cards:
        if n_dev < 4:
            print(f"chip_smoke: --four-cards needs 4 GPUs, have {n_dev}",
                  file=sys.stderr)
            return 2
        phases = [phase_four_cards()]
        count = 4
    else:
        phases = [phase_a(), phase_b(), phase_c()]
        count = 1
    if not all(p["ok"] for p in phases):
        print("chip_smoke: FAILED phases: "
              + ", ".join(p["phase"] for p in phases if not p["ok"]),
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
