"""Initial conditions and symmetrisation (src/config.rs:577-728)."""

import math

import jax.numpy as jnp
import numpy as np

from tests.conftest import base_config
from wavefarm.models import initial


def test_constant_ic():
    cfg = base_config(init_condition="Constant")
    w = np.asarray(initial.set_initial_conditions(cfg))
    assert w.shape == cfg.padded_size()
    assert w[5, 5, 5] == 0.1
    # Dirichlet shell
    assert np.all(w[0] == 0) and np.all(w[:, 0] == 0) and np.all(w[..., -1] == 0)


def test_boolean_ic():
    """1 exactly where all indices are odd (src/config.rs:676-683)."""
    cfg = base_config(init_condition="Boolean")
    w = np.asarray(initial.set_initial_conditions(cfg))
    assert w[3, 5, 7] == 1.0
    assert w[2, 5, 7] == 0.0
    assert w[3, 4, 7] == 0.0
    assert w[3, 5, 6] == 0.0


def test_gaussian_ic_statistics():
    cfg = base_config(
        init_condition="Gaussian", sig=2.0, grid={"size": {"x": 24, "y": 24, "z": 24}}
    )
    w = np.asarray(initial.set_initial_conditions(cfg, seed=42))
    interior = w[1:-1, 1:-1, 1:-1]
    assert abs(interior.std() - 2.0) < 0.1
    assert abs(interior.mean()) < 0.1


def test_coulomb_ic_formula():
    cfg = base_config(init_condition="Coulomb", mass=2.0)
    w = np.asarray(initial.set_initial_conditions(cfg))
    init_size = cfg.padded_size()
    dn, m = cfg.grid.dn, cfg.mass
    idx = (4, 7, 11)
    dx = idx[0] - init_size[0] / 2.0
    dy = idx[1] - init_size[1] / 2.0
    dz = idx[2] - init_size[2] / 2.0
    r = dn * math.sqrt(dx * dx + dy * dy + dz * dz)
    costheta = dn * dz / r
    cosphi = dn * dx / r
    mr2 = math.exp(-m * r / 2.0)
    expected = (
        math.exp(-m * r)
        + (2.0 - m * r) * mr2
        + m * r * mr2 * costheta
        + m * r * mr2 * math.sqrt(1.0 - costheta ** 2) * cosphi
    )
    assert abs(w[idx] - expected) < 1e-12


def test_coulomb_ic_centre_is_finite():
    """Reference divides 0/0 at the exact centre; we take the r→0 limit."""
    cfg = base_config(init_condition="Coulomb")
    w = np.asarray(initial.set_initial_conditions(cfg))
    assert np.all(np.isfinite(w))
    centre = tuple(s // 2 for s in cfg.padded_size())
    assert w[centre] == 3.0  # exp(0) + (2-0)·exp(0)


def _symmetrise_reference(cfg, arr):
    """Sequential port of the reference loop (src/config.rs:691-728),
    generalised to the configured ext with writes clamped to interior
    planes (the reference's hardcoded ranges include one halo plane per
    axis; at its only valid ext=3 those writes deposit zeros for solver
    arrays — see initial.symmetrise_wavefunction)."""
    out = np.array(arr, dtype=np.float64)
    sym = cfg.init_symmetry.value
    sign = -1.0 if sym.startswith("Antisym") else 1.0
    ext = cfg.central_difference.ext
    n = cfg.grid.size.as_tuple()
    for sx in range(out.shape[0]):
        for sy in range(ext, ext + n[1]):
            for sz in range(ext, ext + n[2]):
                if sym.endswith("Z"):
                    z = sz
                    if z > (ext + n[2]) // 2:
                        z = (ext + n[2]) + 1 - z
                    out[sx, sy, sz] = sign * out[sx, sy, z]
                else:
                    y = sy
                    if y > (ext + n[1]) // 2:
                        y = (ext + n[1]) + 1 - y
                    out[sx, sy, sz] = sign * out[sx, y, sz]
    return out


def _check_vs_sequential(sym, cd, size, seed):
    cfg = base_config(
        central_difference=cd,
        init_symmetry=sym,
        grid={"size": {"x": size, "y": size, "z": size}, "dn": 0.1, "dt": 3e-3},
    )
    rng = np.random.default_rng(seed)
    w = rng.normal(size=cfg.padded_size())
    out = np.asarray(initial.symmetrise_wavefunction(cfg, jnp.asarray(w)))
    expected = _symmetrise_reference(cfg, w)
    np.testing.assert_allclose(out, expected, atol=1e-12)


def test_symmetrise_matches_sequential_reference():
    """Vectorised symmetrisation == the reference's sequential loop, for all
    four constraints, both hardcoded-ext (SevenPoint) and generalised
    (ThreePoint), even and odd pair-sums (self-mapped central plane)."""
    for i, sym in enumerate(["AboutZ", "AntisymAboutZ", "AboutY", "AntisymAboutY"]):
        _check_vs_sequential(sym, "SevenPoint", 8, 10 + i)
        _check_vs_sequential(sym, "ThreePoint", 8, 20 + i)
        _check_vs_sequential(sym, "ThreePoint", 9, 30 + i)  # odd N
        _check_vs_sequential(sym, "FivePoint", 12, 40 + i)


def test_symmetrise_keeps_dirichlet_halo_zero():
    """Symmetrising a zero-halo array must not pollute the halo: the
    generalisation at ext<3 would otherwise write an interior plane's value
    into the z = ext+N halo plane, silently changing the operator's
    boundary condition (round-2 regression)."""
    for cd, ext in [("ThreePoint", 1), ("FivePoint", 2), ("SevenPoint", 3)]:
        cfg = base_config(
            central_difference=cd,
            init_symmetry="AntisymAboutZ",
            grid={"size": {"x": 8, "y": 8, "z": 8}, "dn": 0.1, "dt": 3e-3},
        )
        rng = np.random.default_rng(ext)
        w = rng.normal(size=cfg.padded_size())
        from wavefarm import geometry

        w = np.asarray(geometry.zero_boundary(jnp.asarray(w), ext))
        out = np.asarray(initial.symmetrise_wavefunction(cfg, jnp.asarray(w)))
        halo = np.ones_like(out, dtype=bool)
        halo[ext:-ext, ext:-ext, ext:-ext] = False
        assert np.all(out[halo] == 0.0), cd


def test_symmetrise_not_constrained_noop():
    cfg = base_config()
    w = jnp.asarray(np.random.default_rng(5).normal(size=cfg.padded_size()))
    out = initial.symmetrise_wavefunction(cfg, w)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(w))


def test_symmetrised_ic_is_symmetric():
    """End-to-end: a symmetrised IC obeys w(z) = w(mirror z) inside."""
    cfg = base_config(
        central_difference="SevenPoint",
        init_condition="Gaussian",
        init_symmetry="AboutZ",
        grid={"size": {"x": 8, "y": 8, "z": 8}, "dn": 0.1, "dt": 3e-3},
    )
    w = np.asarray(initial.set_initial_conditions(cfg, seed=1))
    ext, n = 3, 8
    for p in range(ext, ext + n + 1):
        src = ext + n + 1 - p
        if src < ext or src > ext + n:
            continue
        np.testing.assert_allclose(
            w[:, ext : ext + n + 1, p], w[:, ext : ext + n + 1, src], atol=1e-14
        )


def test_exact_clone_gram_schmidt_cancels_to_zero():
    """The hazard perturb_clone exists for: normalise-then-orthogonalise of
    an EXACT clone cancels bitwise to the zero array whenever the norm
    scale and the overlap round to the same f32 (here both are exactly 1),
    which zeroes the excited-state seed (observed on the 256³ north star)."""
    from wavefarm.ops import gram_schmidt

    cfg = base_config()
    w = jnp.zeros(cfg.padded_size(), jnp.float32).at[5, 5, 5].set(1.0)
    phi = gram_schmidt.normalise_wavefunction(w, jnp.float32(1.0))
    phi = gram_schmidt.orthogonalise_wavefunction(phi, jnp.stack([w]), 1)
    assert float(jnp.max(jnp.abs(phi))) == 0.0  # the degenerate collapse


def test_perturb_clone_survives_gram_schmidt():
    """perturb_clone's seed leaves a non-zero residual after the chunk
    head's normalise+orthogonalise — the regression for the 256³ S=2
    collapse (solver._select_initial_condition memory fallback)."""
    from wavefarm.ops import gram_schmidt

    cfg = base_config()
    w = jnp.zeros(cfg.padded_size(), jnp.float32).at[5, 5, 5].set(1.0)
    seeded = initial.perturb_clone(cfg, w, wnum=1, seed=7)
    phi = gram_schmidt.normalise_wavefunction(
        seeded, gram_schmidt.get_norm_squared(seeded)
    )
    phi = gram_schmidt.orthogonalise_wavefunction(phi, jnp.stack([w]), 1)
    res = float(jnp.sqrt(gram_schmidt.get_norm_squared(phi)))
    assert res > 1e-5
    # Dirichlet shell stays clean without an explicit zero_boundary
    s = np.asarray(seeded)
    assert np.all(s[0] == 0) and np.all(s[:, -1] == 0) and np.all(s[..., 0] == 0)


def test_perturb_clone_deterministic_and_driver_consistent():
    """Same (seed, wnum) → identical noise; the interior (sharded-driver)
    field is exactly the padded field's interior, so cross-driver
    equivalence runs see the same perturbation."""
    cfg = base_config()
    w = jnp.ones(cfg.padded_size(), jnp.float32)
    a = np.asarray(initial.perturb_clone(cfg, w, wnum=2, seed=3))
    b = np.asarray(initial.perturb_clone(cfg, w, wnum=2, seed=3))
    np.testing.assert_array_equal(a, b)
    c = np.asarray(initial.perturb_clone(cfg, w, wnum=2, seed=4))
    assert np.any(a != c)
    wi = jnp.ones(cfg.grid.size.as_tuple(), jnp.float32)
    d = np.asarray(
        initial.perturb_clone(cfg, wi, wnum=2, seed=3, padded=False)
    )
    # identical interior noise field: (a - w) interior == (d - wi)
    np.testing.assert_allclose(
        a[1:-1, 1:-1, 1:-1] - 1.0, d - 1.0, rtol=0, atol=0
    )


def test_perturb_clone_rms_from_reference():
    """A zero imaginary part still gets a usable perturbation when the
    amplitude reference is the real part (split-pair callers)."""
    cfg = base_config()
    pr = jnp.full(cfg.padded_size(), 2.0, jnp.float32)
    pi = jnp.zeros(cfg.padded_size(), jnp.float32)
    out = np.asarray(
        initial.perturb_clone(
            cfg, pi, wnum=1, seed=5, component=1, rms_from=pr
        )
    )
    assert np.abs(out[2:-2, 2:-2, 2:-2]).max() > 1e-4  # ~1e-3·rms(pr)
    zero_amp = np.asarray(
        initial.perturb_clone(cfg, pi, wnum=1, seed=5, component=1)
    )
    assert np.abs(zero_amp).max() == 0.0  # rms(pi)=0 → no perturbation
