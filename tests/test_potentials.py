"""Potential builders vs reference formulas (src/potential.rs:188-398)."""

import math

import numpy as np
import pytest

from tests.conftest import base_config
from wavefarm import errors, geometry
from wavefarm.models import potentials as pmod


def test_alphas_golden():
    """(reference test: src/potential.rs:446-449)"""
    assert abs(pmod.alphas(3.2) - 6.189593433886306) < 1e-14


def test_mu_debye_golden():
    """(reference test: src/potential.rs:450-454)"""
    assert abs(pmod.mu_debye(5.2) - 2.604838027702063) < 1e-14


def test_no_potential():
    cfg = base_config(potential="NoPotential")
    v = np.asarray(pmod.generate(cfg))
    assert v.shape == cfg.padded_size()
    assert np.all(v == 0.0)


def test_harmonic_pointwise():
    """V = (dn·r)²/2 with the padded-index centre (N+1)/2."""
    cfg = base_config()
    v = np.asarray(pmod.generate(cfg))
    n = cfg.grid.size.as_tuple()
    dn = cfg.grid.dn
    for idx in [(0, 0, 0), (5, 7, 9), (17, 1, 3)]:
        r2 = geometry.calculate_r2(idx, n)
        expected = (dn * math.sqrt(r2)) ** 2 / 2.0
        assert abs(v[idx] - expected) < 1e-12


def test_coulomb_clamp():
    """V = −1/r clamped to −1/dn within one cell of the centre."""
    cfg = base_config(potential="Coulomb", grid={"size": {"x": 15, "y": 15, "z": 15}})
    v = np.asarray(pmod.generate(cfg))
    # centre of padded index space: (N+1)/2 = 8 → exact grid point
    assert v[8, 8, 8] == -1.0 / cfg.grid.dn
    r = cfg.grid.dn * math.sqrt(geometry.calculate_r2((2, 8, 8), (15, 15, 15)))
    assert abs(v[2, 8, 8] - (-1.0 / r)) < 1e-12


def test_cube_bounds_integer_division():
    """Box bounds use floor division of the grid size on padded indices
    (reference: src/potential.rs:192-201)."""
    cfg = base_config(potential="Cube", grid={"size": {"x": 10, "y": 10, "z": 10}})
    v = np.asarray(pmod.generate(cfg))
    nx = 10
    for i in range(v.shape[0]):
        inside = (i > nx // 4) and (i <= 3 * nx // 4)
        expected = -10.0 if inside else 0.0
        assert v[i, 5, 5] == expected, i


def test_quadwell_short_z():
    cfg = base_config(potential="QuadWell", grid={"size": {"x": 16, "y": 16, "z": 16}})
    v = np.asarray(pmod.generate(cfg))
    nz = 16
    for k in range(v.shape[2]):
        inside_z = (k > 3 * nz // 8) and (k <= 5 * nz // 8)
        expected = -10.0 if (5 > 16 // 4) and (5 <= 12) and inside_z else 0.0
        assert v[5, 5, k] == expected


def test_periodic_formula():
    cfg = base_config(potential="Periodic")
    v = np.asarray(pmod.generate(cfg))
    n = cfg.grid.size.as_tuple()
    idx = (3, 4, 5)
    t = 1.0
    for d, nn in zip(idx, n):
        t *= math.sin(2 * math.pi * (d - 1) / (nn - 1)) ** 2
    assert abs(v[idx] - (-t + 1.0)) < 1e-12


def test_simple_cornell():
    cfg = base_config(potential="SimpleCornell", mass=4.65, sig=0.223)
    v = np.asarray(pmod.generate(cfg))
    n = cfg.grid.size.as_tuple()
    dn = cfg.grid.dn
    idx = (2, 3, 4)
    r = dn * math.sqrt(geometry.calculate_r2(idx, n))
    expected = -0.5 * (4.0 / 3.0) / r + 0.223 * r + 4.0 * 4.65
    assert abs(v[idx] - expected) < 1e-12
    # clamp region → 4m
    centre = ((n[0] + 1) // 2,) * 3
    assert abs(v[8, 8, 8] - 4.0 * 4.65) < 1e-12


def test_full_cornell_default_params():
    """At default t=1, ξ=0: md = μ(1); check the far-field formula."""
    cfg = base_config(potential="FullCornell", mass=4.65, sig=0.223)
    v = np.asarray(pmod.generate(cfg))
    n = cfg.grid.size.as_tuple()
    dn = cfg.grid.dn
    idx = (1, 2, 3)
    r = dn * math.sqrt(geometry.calculate_r2(idx, n))
    md = pmod.mu_debye(1.0)
    expected = (
        -pmod.alphas(2 * math.pi) * (4.0 / 3.0) * math.exp(-md * r) / r
        + 0.223 * (1.0 - math.exp(-md * r)) / md
        - 0.8 * 0.223 / (4.0 * 4.65 ** 2 * r)
        + 4.0 * 4.65
    )
    assert abs(v[idx] - expected) < 1e-10


def test_eliptical_coulomb():
    cfg = base_config(potential="ElipticalCoulomb")
    v = np.asarray(pmod.generate(cfg))
    n = cfg.grid.size.as_tuple()
    dn = cfg.grid.dn
    idx = (2, 3, 4)
    dx = idx[0] - (n[0] + 1) / 2
    dy = idx[1] - (n[1] + 1) / 2
    dz = (idx[2] - (n[2] + 1) / 2) * 2
    r = dn * math.sqrt(dx * dx + dy * dy + dz * dz)
    assert abs(v[idx] - (-1.0 / r + 1.0 / dn)) < 1e-12


def test_dodecahedron_constants_and_shape():
    """Golden-ratio plane constants match the reference's hardcoded decimals
    (src/potential.rs:283-308)."""
    assert abs(pmod._C_3_2PS5 - 12.70820393249937) < 1e-12
    assert abs(pmod._C_4S3PHI - 11.210068307552588) < 1e-12
    assert abs(pmod._C_S3_4P2S5 - 14.674169922690343) < 1e-12
    assert abs(pmod._C_2S3PHI - 5.605034153776295) < 1e-12
    assert abs(pmod._C_4S3PHI2 - 18.1382715378281) < 1e-12
    assert abs(pmod._C_2S3PHI2 - 9.06913576891405) < 1e-12
    assert abs(pmod._C_9P3S5 - 15.708203932499366) < 1e-11
    assert abs(pmod._C_3P3S5 - 9.708203932499369) < 1e-12
    assert abs(pmod._C_6_2PS5 - 25.416407864998739) < 1e-12
    cfg = base_config(potential="Dodecahedron", grid={"size": {"x": 20, "y": 20, "z": 20}})
    v = np.asarray(pmod.generate(cfg))
    centre_val = v[10, 10, 10]
    assert centre_val == -100.0  # centre is inside
    assert v[0, 0, 0] == 0.0  # corner is outside
    assert np.sum(v == -100.0) > 0


def test_complex_potentials_default_match_real():
    """absorb=0 reproduces the reference's real-valued stubs."""
    cfg_r = base_config(potential="Harmonic")
    cfg_c = base_config(potential="ComplexHarmonic")
    vr = np.asarray(pmod.generate(cfg_r))
    vc = np.asarray(pmod.generate(cfg_c))
    assert np.iscomplexobj(vc)
    np.testing.assert_allclose(vc.real, vr)
    np.testing.assert_allclose(vc.imag, 0.0)


def test_complex_absorb():
    cfg = base_config(potential="ComplexCoulomb", absorb=0.5)
    v = np.asarray(pmod.generate(cfg))
    np.testing.assert_allclose(v.imag, 0.5 * v.real, rtol=1e-12)


def test_complex_full_cornell_scaled_array():
    """Extension: the absorptive finite-T quarkonium potential is
    (1 + i·absorb)·FullCornell — the complex in-medium potential the
    reference's finite-T Cornell physics calls for but stubs as real
    (src/potential.rs:222,250-271)."""
    kw = dict(mass=4.65, sig=0.223)
    cfg_r = base_config(potential="FullCornell", **kw)
    cfg_c = base_config(potential="ComplexFullCornell", absorb=0.3, **kw)
    vr = np.asarray(pmod.generate(cfg_r))
    vc = np.asarray(pmod.generate(cfg_c))
    assert np.iscomplexobj(vc)
    np.testing.assert_allclose(vc.real, vr, rtol=1e-12)
    np.testing.assert_allclose(vc.imag, 0.3 * vr, rtol=1e-12)
    # the split (re, im) pair mirrors the complex array
    pr, pi_ = pmod.generate_split(cfg_c)
    np.testing.assert_allclose(np.asarray(pr), vr, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(pi_), 0.3 * vr, rtol=1e-12)
    # the binding offset V(∞) rides the real part's pot_sub array
    np.testing.assert_allclose(
        np.asarray(pmod.potential_sub_array(cfg_c)),
        np.asarray(pmod.potential_sub_array(cfg_r)),
    )
    with pytest.raises(errors.PotentialNotAvailableError):
        pmod.potential_sub_scalar(cfg_c)


def test_potential_sub_scalars():
    """(reference: src/potential.rs:346-363)"""
    assert pmod.potential_sub_scalar(base_config()) == 0.0
    cfg_e = base_config(potential="ElipticalCoulomb")
    assert pmod.potential_sub_scalar(cfg_e) == 1.0 / cfg_e.grid.dn
    cfg_s = base_config(potential="SimpleCornell", mass=4.65)
    assert pmod.potential_sub_scalar(cfg_s) == 4.0 * 4.65
    with pytest.raises(errors.PotentialNotAvailableError):
        pmod.potential_sub_scalar(base_config(potential="FullCornell"))


def test_potential_sub_array_full_cornell():
    cfg = base_config(potential="FullCornell", mass=4.65, sig=0.223)
    sub = np.asarray(pmod.potential_sub_array(cfg))
    assert sub.shape == cfg.work_size()
    md = pmod.mu_debye(1.0)
    expected = 0.223 / md + 4.0 * 4.65
    np.testing.assert_allclose(sub, expected, rtol=1e-12)


def test_build_ab():
    """B = 1/(1+dt·V/2), A = (1−dt·V/2)·B (reference: src/potential.rs:101-110)."""
    import jax.numpy as jnp

    v = jnp.asarray(np.linspace(-5, 5, 27).reshape(3, 3, 3))
    a, b = pmod.build_ab(v, 0.01)
    np.testing.assert_allclose(np.asarray(b), 1.0 / (1.0 + 0.01 * np.asarray(v) / 2))
    np.testing.assert_allclose(
        np.asarray(a), (1.0 - 0.01 * np.asarray(v) / 2) / (1.0 + 0.01 * np.asarray(v) / 2)
    )


def test_generate_block_offset_matches_full():
    """Sharded block generation equals the matching slice of the full array."""
    cfg = base_config(potential="Coulomb")
    full = np.asarray(pmod.generate(cfg))
    block = np.asarray(pmod.generate(cfg, shape=(6, 18, 18), offset=(6, 0, 0)))
    np.testing.assert_allclose(block, full[6:12, :, :])


def test_generate_errors_for_file_types():
    with pytest.raises(errors.PotentialNotAvailableError):
        pmod.generate(base_config(potential="FromFile"))


def test_semi_implicit_pole_warning(caplog):
    """B = 1/(1+dt·V/2) diverges where V ≤ −2/dt: load_arrays must warn so
    the ensuing NonFinite abort is attributable (the reference computes the
    same inf silently, src/potential.rs:101-110)."""
    import logging

    from tests.conftest import base_config

    cfg = base_config(
        potential="Dodecahedron",  # V = −100 inside the solid
        grid={"size": {"x": 12, "y": 12, "z": 12}, "dn": 0.3, "dt": 0.025},
    )
    log = logging.getLogger("pole-test")
    with caplog.at_level(logging.WARNING, logger="pole-test"):
        pmod.load_arrays(cfg, log)
    assert any("semi-implicit pole" in r.message for r in caplog.records)

    # pole-free dt: no warning
    caplog.clear()
    cfg2 = base_config(
        potential="Dodecahedron",
        grid={"size": {"x": 12, "y": 12, "z": 12}, "dn": 0.3, "dt": 0.01},
    )
    with caplog.at_level(logging.WARNING, logger="pole-test"):
        pmod.load_arrays(cfg2, log)
    assert not any("semi-implicit pole" in r.message for r in caplog.records)
