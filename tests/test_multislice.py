"""Multi-slice (inter-node) decomposition on the virtual 8-CPU mesh.

Emulates the multi-slice tier as 2 slices × (2, 2, 1) (and 2 × (1, 2, 2))
and asserts equivalence against the flat single-slice sharded path — the
deep-window slice cadence must be trajectory-equivalent to per-step
exchange (the blind ghost-zone argument, at the slice level)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.conftest import base_config
from wavefarm import geometry
from wavefarm.io import run_dir
from wavefarm.models import potentials as pmod
from wavefarm.parallel import make_mesh
from wavefarm.parallel.multislice import MultiSliceOps, make_multislice_mesh
from wavefarm.parallel.sharded import ShardedOps

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _setup(order="ThreePoint", n=32, su=7, slice_update=2, **kw):
    cfg = base_config(
        central_difference=order,
        grid={"size": {"x": n, "y": 16, "z": 16}, "dn": 0.2, "dt": 0.01},
        output={"screen_update": su},
        mesh={"x": 2, "y": 2, "z": 1, "slices": 2,
              "slice_update": slice_update},
        **kw,
    )
    ext = cfg.central_difference.ext
    rng = np.random.default_rng(71)
    phi_int = rng.normal(size=cfg.work_size())
    v = pmod.generate(cfg)
    a, b = pmod.build_ab(v, cfg.grid.dt)
    return cfg, ext, phi_int, v, a, b


@pytest.mark.parametrize("order", ["ThreePoint", "FivePoint", "SevenPoint"])
def test_multislice_evolve_matches_flat_sharded(order):
    """2 slices × (2,2,1) deep-window cadence == the flat (4,2,1) sharded
    sweep, at every halo width (the slice window carries
    slice_update·ext-deep pads)."""
    cfg, ext, phi_int, v, a, b = _setup(order=order, n=48 if order != "ThreePoint" else 32)
    a_int = geometry.work_area(a, ext)
    b_int = geometry.work_area(b, ext)

    flat = ShardedOps(cfg, make_mesh((4, 2, 1)), 0)
    ref = np.asarray(flat.get(flat.evolve_chunk(
        flat.put(phi_int), flat.put(a_int), flat.put(b_int),
        flat.put_store(None),
    )))

    ms_mesh = make_multislice_mesh((2, 2, 1), 2)
    ops = MultiSliceOps(cfg, ms_mesh, 0)
    assert ops.slice_steps == 2
    out = np.asarray(ops.get(ops.evolve_chunk(
        ops.put(phi_int), ops.put(a_int), ops.put(b_int),
        ops.put_store(None),
    )))
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-13)


def test_multislice_remainder_and_deeper_window():
    """screen_update not a multiple of slice_update (7 = 2 windows of 3 +
    remainder 1) and a deeper window both stay exact."""
    cfg, ext, phi_int, v, a, b = _setup(su=7, slice_update=3)
    a_int = geometry.work_area(a, ext)
    b_int = geometry.work_area(b, ext)
    flat = ShardedOps(cfg, make_mesh((4, 2, 1)), 0)
    ref = np.asarray(flat.get(flat.evolve_chunk(
        flat.put(phi_int), flat.put(a_int), flat.put(b_int),
        flat.put_store(None),
    )))
    ops = MultiSliceOps(cfg, make_multislice_mesh((2, 2, 1), 2), 0)
    assert ops.slice_steps == 3
    out = np.asarray(ops.get(ops.evolve_chunk(
        ops.put(phi_int), ops.put(a_int), ops.put(b_int),
        ops.put_store(None),
    )))
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-13)


def test_multislice_measure_matches_flat():
    cfg, ext, phi_int, v, a, b = _setup()
    v_int = geometry.work_area(v, ext)
    r2 = geometry.r2_index_grid(cfg.work_size(), cfg.grid.size.as_tuple())
    flat = ShardedOps(cfg, make_mesh((4, 2, 1)), 0,
                      pot_sub_scalar=2.5)
    (e_r, n_r, vi_r, r2_r), _ = flat.measure(
        flat.put(phi_int), flat.put(v_int), flat.put(r2),
        flat.dummy_pot_sub(), flat.put_store(None),
    )
    ops = MultiSliceOps(cfg, make_multislice_mesh((2, 2, 1), 2), 0,
                        pot_sub_scalar=2.5)
    (e, n2, vinf, r2s), _ = ops.measure(
        ops.put(phi_int), ops.put(v_int), ops.put(r2),
        ops.dummy_pot_sub(), ops.put_store(None),
    )
    for got, want in ((e, e_r), (n2, n_r), (vinf, vi_r), (r2s, r2_r)):
        assert abs(float(got) - float(want)) < 1e-9 * max(1.0, abs(float(want)))


def test_multislice_excited_matches_flat():
    """Per-step normalise + Gram-Schmidt inside the blind slice window:
    global coefficients from interior-only reductions, correction applied
    to the pads too — must equal the flat per-step-exchange path."""
    cfg, ext, phi_int, v, a, b = _setup(su=4, slice_update=2)
    a_int = geometry.work_area(a, ext)
    b_int = geometry.work_area(b, ext)
    rng = np.random.default_rng(72)
    lower = rng.normal(size=cfg.work_size())
    lower /= np.sqrt(np.sum(lower ** 2))
    store = jnp.stack([jnp.asarray(lower)])

    flat = ShardedOps(cfg, make_mesh((4, 2, 1)), 1)
    ref = np.asarray(flat.get(flat.evolve_chunk(
        flat.put(phi_int), flat.put(a_int), flat.put(b_int),
        flat.put_store(store),
    )))
    ops = MultiSliceOps(cfg, make_multislice_mesh((2, 2, 1), 2), 1)
    out = np.asarray(ops.get(ops.evolve_chunk(
        ops.put(phi_int), ops.put(a_int), ops.put(b_int),
        ops.put_store(store),
    )))
    np.testing.assert_allclose(out, ref, rtol=1e-10, atol=1e-12)
    overlap = float(np.sum(lower * out))
    assert abs(overlap) < 1e-9


def test_multislice_yz_slice_factor():
    """A 2 × (1, 2, 2) factorisation (x sharded by slices only) also
    matches the flat (2, 2, 2) mesh."""
    cfg, ext, phi_int, v, a, b = _setup()
    a_int = geometry.work_area(a, ext)
    b_int = geometry.work_area(b, ext)
    flat = ShardedOps(cfg, make_mesh((2, 2, 2)), 0)
    ref = np.asarray(flat.get(flat.evolve_chunk(
        flat.put(phi_int), flat.put(a_int), flat.put(b_int),
        flat.put_store(None),
    )))
    ops = MultiSliceOps(cfg, make_multislice_mesh((1, 2, 2), 2), 0)
    out = np.asarray(ops.get(ops.evolve_chunk(
        ops.put(phi_int), ops.put(a_int), ops.put(b_int),
        ops.put_store(None),
    )))
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-13)


def test_multislice_driver_end_to_end(tmp_run):
    """run_sharded with mesh.slices=2 converges to the harmonic oracle
    through the MultiSliceOps dispatch (blocked per-shard potentials)."""
    from wavefarm.parallel.solver_sharded import run_sharded

    cfg = base_config(
        grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.02},
        tolerance=1e-6,
        potential="Harmonic",
        init_condition="Constant",
        output={"screen_update": 100, "file_type": "Json"},
        max_steps=100000,
        mesh={"x": 2, "y": 2, "z": 1, "slices": 2},
    )
    run_dir.check_output_dir(cfg.project_name)
    results = run_sharded(cfg)
    e0 = results[0].observables.energy / results[0].observables.norm2
    assert abs(e0 - 1.5) < 0.02, e0


def test_multislice_config_validation():
    from wavefarm import errors

    with pytest.raises(errors.ConfigParseError):
        base_config(mesh={"x": 1, "y": 1, "z": 1, "slices": 0})
    with pytest.raises(errors.ConfigParseError):
        base_config(mesh={"x": 1, "y": 1, "z": 1, "slice_update": 0})
    cfg = base_config(mesh={"x": 2, "y": 2, "z": 1, "slices": 2})
    assert cfg.mesh.n_devices == 8 and cfg.mesh.slice_update == 4


def test_multislice_split_driver_end_to_end(tmp_run, monkeypatch):
    """run_sharded_split with mesh.slices=2 folds the slices into a flat
    process-major mesh and converges to the complex absorptive-harmonic
    oracle, for an x-only and a y-sharded slice factorisation."""
    from wavefarm.ops import split_complex as sc
    from wavefarm.parallel.sharded_split import run_sharded_split

    monkeypatch.setattr(sc, "backend_supports_complex", lambda: False)
    common = dict(
        potential="ComplexHarmonic",
        absorb=0.2,
        grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.02},
        tolerance=1e-6,
        init_condition="Constant",
        output={"screen_update": 100, "file_type": "Json"},
        max_steps=100000,
    )
    run_dir.check_output_dir("test")
    for mesh in ({"x": 2, "y": 1, "z": 1, "slices": 2, "slice_update": 4},
                 {"x": 1, "y": 2, "z": 1, "slices": 2}):
        results = run_sharded_split(base_config(mesh=mesh, **common))
        e0 = results[0].observables.energy / results[0].observables.norm2
        assert abs(e0 - (1.5 * (1 + 0.2j) ** 0.5)) < 0.05, (mesh, e0)


def test_distributed_initialize_noop(monkeypatch):
    """Without coordinator env the jax.distributed entry is a no-op (the
    single-process path tests can exercise)."""
    from wavefarm.parallel.distributed import maybe_initialize_distributed

    monkeypatch.delenv("WAFER_COORDINATOR", raising=False)
    assert maybe_initialize_distributed() is False


def test_distributed_initialize_env_wiring(monkeypatch):
    """With coordinator env set, the entry passes the exact
    coordinator/num/pid trio to jax.distributed.initialize (the
    multi-process launch contract for the multi-slice tier)."""
    import jax

    from wavefarm.parallel import distributed

    calls = {}

    def fake_init(**kw):
        calls.update(kw)

    monkeypatch.setattr(jax.distributed, "initialize", fake_init)
    monkeypatch.setenv("WAFER_COORDINATOR", "10.0.0.1:8476")
    monkeypatch.setenv("WAFER_NUM_PROCESSES", "2")
    monkeypatch.setenv("WAFER_PROCESS_ID", "1")
    assert distributed.maybe_initialize_distributed() is True
    assert calls == {
        "coordinator_address": "10.0.0.1:8476",
        "num_processes": 2,
        "process_id": 1,
    }
