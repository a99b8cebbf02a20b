"""Stencil, normalisation, Gram-Schmidt, observables kernels."""

import jax.numpy as jnp
import numpy as np

from tests.conftest import base_config
from wavefarm import geometry
from wavefarm.models import potentials as pmod
from wavefarm.ops import gram_schmidt, observables as obs_mod, stencil


def test_gram_schmidt_golden():
    """Analytic 2×2×2 case (reference test: src/grid.rs:721-746)."""
    ground = jnp.asarray(
        np.fromfunction(lambda i, j, k: i + j + k, (2, 2, 2), dtype=float)
    )
    test = jnp.asarray(
        np.fromfunction(lambda i, j, k: -i - j - k, (2, 2, 2), dtype=float)
    )
    result = gram_schmidt.orthogonalise_wavefunction(test, jnp.stack([ground]), 1)
    expected = np.array([0.0, 23.0, 23.0, 46.0, 23.0, 46.0, 46.0, 69.0]).reshape(2, 2, 2)
    np.testing.assert_allclose(np.asarray(result), expected, atol=0.01)


def test_norm_squared_golden():
    """(reference test: src/grid.rs:780-786)"""
    arr = jnp.asarray(np.fromfunction(lambda i, j, k: i * j * k, (5, 8, 7), dtype=float))
    work = geometry.work_area(arr, 1)
    assert abs(float(gram_schmidt.get_norm_squared(work)) - 70070.0) < 1e-6


def test_normalise_golden():
    """(reference test: src/grid.rs:788-799)"""
    arr = jnp.asarray(np.fromfunction(lambda i, j, k: i * j * k, (3, 2, 5), dtype=float))
    out = gram_schmidt.normalise_wavefunction(arr, 1.23)
    np.testing.assert_allclose(np.asarray(out), np.asarray(arr) / np.sqrt(1.23), atol=0.01)


def test_norm_squared_complex():
    arr = jnp.asarray(np.array([1 + 1j, 2 - 2j]).reshape(1, 1, 2))
    assert abs(float(gram_schmidt.get_norm_squared(arr)) - 10.0) < 1e-12


def _brute_force_taps(phi, order):
    """Direct per-cell window evaluation of the stencil numerator — the
    reference's formulation (src/grid.rs:567-664)."""
    offsets, coeffs, center, _k = geometry.stencil_coefficients(order)
    ext = {"ThreePoint": 1, "FivePoint": 2, "SevenPoint": 3}[order]
    p = np.asarray(phi)
    nx, ny, nz = (s - 2 * ext for s in p.shape)
    out = np.zeros((nx, ny, nz))
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                ci, cj, ck = i + ext, j + ext, k + ext
                acc = -center * p[ci, cj, ck]
                for off, c in zip(offsets, coeffs):
                    acc += c * (p[ci + off, cj, ck] + p[ci - off, cj, ck])
                    acc += c * (p[ci, cj + off, ck] + p[ci, cj - off, ck])
                    acc += c * (p[ci, cj, ck + off] + p[ci, cj, ck - off])
                out[i, j, k] = acc
    return out


def test_stencil_taps_matches_brute_force():
    rng = np.random.default_rng(0)
    for order in ("ThreePoint", "FivePoint", "SevenPoint"):
        ext = {"ThreePoint": 1, "FivePoint": 2, "SevenPoint": 3}[order]
        phi = jnp.asarray(rng.normal(size=(8 + 2 * ext, 6 + 2 * ext, 7 + 2 * ext)))
        taps = np.asarray(stencil.stencil_taps(phi, order))
        np.testing.assert_allclose(taps, _brute_force_taps(phi, order), rtol=1e-12)


def test_evolve_step_matches_reference_rule():
    """ψ' = A∘ψ + B·dt·taps/(k·dn²·m) on the interior; halo untouched."""
    rng = np.random.default_rng(1)
    cfg = base_config(grid={"size": {"x": 6, "y": 6, "z": 6}})
    shape = cfg.padded_size()
    phi = jnp.asarray(rng.normal(size=shape))
    v = pmod.generate(cfg)
    a, b = pmod.build_ab(v, cfg.grid.dt)
    out = stencil.evolve_step(
        phi, a, b, "ThreePoint", cfg.grid.dt, cfg.grid.dn, cfg.mass
    )
    taps = _brute_force_taps(phi, "ThreePoint")
    denom = 2.0 * cfg.grid.dn ** 2 * cfg.mass
    pw = np.asarray(phi)[1:-1, 1:-1, 1:-1]
    aw = np.asarray(a)[1:-1, 1:-1, 1:-1]
    bw = np.asarray(b)[1:-1, 1:-1, 1:-1]
    expected = pw * aw + bw * cfg.grid.dt * taps / denom
    np.testing.assert_allclose(np.asarray(out)[1:-1, 1:-1, 1:-1], expected, rtol=1e-12)
    # halo untouched
    np.testing.assert_allclose(np.asarray(out)[0], np.asarray(phi)[0])


def test_evolve_chunk_excited_keeps_orthogonality():
    rng = np.random.default_rng(2)
    cfg = base_config(grid={"size": {"x": 8, "y": 8, "z": 8}})
    shape = cfg.padded_size()
    v = pmod.generate(cfg)
    a, b = pmod.build_ab(v, cfg.grid.dt)
    lower = jnp.asarray(rng.normal(size=shape))
    lower = geometry.zero_boundary(lower, 1)
    lower = lower / jnp.sqrt(gram_schmidt.get_norm_squared(lower))
    phi = geometry.zero_boundary(jnp.asarray(rng.normal(size=shape)), 1)
    store = jnp.stack([lower])
    out = stencil.evolve_chunk(
        phi, a, b, store, "ThreePoint", cfg.grid.dt, cfg.grid.dn, cfg.mass, 5, 1
    )
    overlap = float(jnp.sum(lower * out))
    assert abs(overlap) < 1e-10


def test_observables_harmonic_constant_field():
    """Energy of a constant interior field under V: laplacian term vanishes
    in the deep interior; check against a direct sum."""
    cfg = base_config(grid={"size": {"x": 6, "y": 6, "z": 6}})
    pots = type("P", (), {})()
    v = pmod.generate(cfg)
    phi = geometry.zero_boundary(jnp.full(cfg.padded_size(), 0.1), 1)

    from wavefarm.models.potentials import Potentials

    pots = Potentials(v=v, a=v, b=v, pot_sub_array=None, pot_sub_scalar=None)
    obs = obs_mod.compute_observables(cfg, pots, phi)

    # brute-force reference computation
    p = np.asarray(phi)
    vv = np.asarray(v)
    taps = _brute_force_taps(phi, "ThreePoint")
    denom = 2.0 * cfg.grid.dn ** 2 * cfg.mass
    pw = p[1:-1, 1:-1, 1:-1]
    vw = vv[1:-1, 1:-1, 1:-1]
    energy = np.sum(vw * pw * pw - pw * taps / denom)
    norm2 = np.sum(pw * pw)
    r2g = np.asarray(
        geometry.r2_index_grid(cfg.work_size(), cfg.grid.size.as_tuple())
    )
    r2 = np.sum(pw * pw * r2g)
    assert abs(obs.energy - energy) < 1e-12
    assert abs(obs.norm2 - norm2) < 1e-12
    assert abs(obs.r2 - r2) < 1e-10
    assert obs.v_infinity == 0.0


def test_observables_pot_sub_scalar():
    cfg = base_config(potential="SimpleCornell", mass=2.0)
    from wavefarm.models.potentials import Potentials

    v = pmod.generate(cfg)
    phi = geometry.zero_boundary(jnp.full(cfg.padded_size(), 0.1), 1)
    pots = Potentials(v=v, a=v, b=v, pot_sub_array=None, pot_sub_scalar=8.0)
    obs = obs_mod.compute_observables(cfg, pots, phi)
    assert abs(obs.v_infinity - 8.0 * obs.norm2) < 1e-10


def test_hybrid_sum_cancellation_bound():
    """hybrid_sum's f32 lane-row partials stay within the documented bound
    even when rows cancel across the sum: relative error vs a full-f64
    reference is ≤ ~log2(nz)·eps_f32 amplified by the condition number
    sum|x|/|sum x| (ADVICE r2: kinetic-vs-potential cancellation)."""
    import jax

    if not jax.config.jax_enable_x64:
        import pytest

        pytest.skip("hybrid path engages under x64 only")
    rng = np.random.default_rng(7)
    nx, ny, nz = 32, 8, 256
    x = rng.normal(size=(nx, ny, nz)).astype(np.float32)
    # cancellation-prone: make the total ~1e-4 of sum|x| by an offset pair
    x[: nx // 2] += 1.0
    x[nx // 2 :] -= 1.0
    ref = float(np.sum(x.astype(np.float64)))
    got = float(obs_mod.hybrid_sum(jnp.asarray(x)))
    cond = float(np.sum(np.abs(x.astype(np.float64)))) / max(abs(ref), 1e-300)
    bound = np.log2(nz) * np.finfo(np.float32).eps * cond
    assert abs(got - ref) <= bound * max(abs(ref), 1e-300), (got, ref, bound)
    # and the hybrid total is far better than a plain f32 sum on this case
    f32_err = abs(float(np.sum(x)) - ref)
    assert abs(got - ref) <= max(f32_err, 1e-12)
