"""Work-area slicing and coordinate fields (reference goldens)."""

import jax.numpy as jnp
import numpy as np

from wavefarm import geometry


def test_work_area_dims():
    """(reference test: src/grid.rs:749-756)"""
    arr = jnp.zeros((5, 8, 7))
    work = geometry.work_area(arr, 1)
    assert work.shape == (3, 6, 5)


def test_set_work_area_boundary_untouched():
    """(reference test: src/grid.rs:758-778)"""
    arr = jnp.zeros((5, 8, 7))
    filled = geometry.set_work_area(arr, 1, jnp.ones((3, 6, 5)))
    expected = np.zeros((5, 8, 7))
    expected[1:-1, 1:-1, 1:-1] = 1.0
    np.testing.assert_allclose(np.asarray(filled), expected)


def test_calculate_r2_golden():
    """(reference test: src/potential.rs:434-443)"""
    assert abs(geometry.calculate_r2((3, 3, 3), (5, 6, 3)) - 1.25) < 1e-6


def test_r2_index_grid_matches_scalar():
    grid_size = (5, 6, 3)
    r2 = np.asarray(geometry.r2_index_grid((5, 6, 3), grid_size))
    for idx in [(0, 0, 0), (3, 3, 2), (4, 5, 2)]:
        assert abs(r2[idx] - geometry.calculate_r2(idx, grid_size)) < 1e-12


def test_r2_index_grid_offset():
    grid_size = (8, 8, 8)
    full = np.asarray(geometry.r2_index_grid((8, 8, 8), grid_size))
    block = np.asarray(geometry.r2_index_grid((4, 8, 8), grid_size, offset=(4.0, 0.0, 0.0)))
    np.testing.assert_allclose(block, full[4:, :, :])


def test_zero_boundary():
    arr = jnp.ones((6, 6, 6))
    z = np.asarray(geometry.zero_boundary(arr, 2))
    assert z[0, 3, 3] == 0 and z[1, 3, 3] == 0 and z[2, 3, 3] == 1
    assert z[3, 3, 5] == 0 and z[3, 3, 3] == 1


def test_stencil_coefficients():
    offs, coeffs, center, k = geometry.stencil_coefficients("FivePoint")
    assert offs == (1, 2) and coeffs == (16.0, -1.0)
    assert center == 90.0 and k == 24.0
