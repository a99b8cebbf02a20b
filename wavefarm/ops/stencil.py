"""Central-difference stencil sweep — the hot loop.

The reference implements this as a rayon ``Zip::indexed().par_apply`` where
every cell slices a (2·ext+1)³ window (src/grid.rs:544-687). Here the same
sweep is expressed as a handful of statically-shifted array slices that XLA
fuses into a streaming loop over device memory.

Update rule (src/grid.rs:567-664):

    ψ' = A∘ψ + B·dt·(Σᵢ cᵢ·ψ(±i shifts over 3 axes) − c₀·ψ) / (k·dn²·mass)

with (taps, c₀, k) = ±1/6/2 (ThreePoint), ±1,±2/90/24 (FivePoint),
±1..±3/1470/360 (SevenPoint). The B·dt·(...)/(k·dn²·m) term is exactly
dt·∇²ψ/(2m) with the chosen finite-difference order.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from wavefarm import geometry
from wavefarm.ops.gram_schmidt import (
    get_norm_squared,
    orthogonalise_wavefunction,
)


def _shifted(phi: jnp.ndarray, ext: int, axis: int, off: int) -> jnp.ndarray:
    """Work-area-shaped view of the padded array shifted by ``off`` along
    ``axis`` (static slice — jit/XLA friendly)."""
    slices = []
    for a in range(3):
        lo = ext + (off if a == axis else 0)
        hi = phi.shape[a] - ext + (off if a == axis else 0)
        slices.append(slice(lo, hi))
    return phi[tuple(slices)]


def stencil_taps(phi: jnp.ndarray, order: str) -> jnp.ndarray:
    """Numerator of the finite-difference Laplacian on the work area:
    ``Σ cᵢ·ψ(neighbours) − c₀·ψ`` (denominator ``k·dn²·mass`` applied by the
    caller)."""
    offsets, coeffs, center, _k = geometry.stencil_coefficients(order)
    ext = {"ThreePoint": 1, "FivePoint": 2, "SevenPoint": 3}[order]
    w = _shifted(phi, ext, 0, 0)
    acc = -center * w
    for axis in range(3):
        for off, c in zip(offsets, coeffs):
            acc = acc + c * _shifted(phi, ext, axis, +off)
            acc = acc + c * _shifted(phi, ext, axis, -off)
    return acc


def evolve_step(
    phi: jnp.ndarray,
    a: jnp.ndarray,
    b: jnp.ndarray,
    order: str,
    dt: float,
    dn: float,
    mass: float,
) -> jnp.ndarray:
    """One explicit-Euler imaginary-time step (src/grid.rs:562-673)."""
    _offsets, _coeffs, _center, k = geometry.stencil_coefficients(order)
    ext = {"ThreePoint": 1, "FivePoint": 2, "SevenPoint": 3}[order]
    denominator = k * dn * dn * mass
    w = geometry.work_area(phi, ext)
    a_w = geometry.work_area(a, ext)
    b_w = geometry.work_area(b, ext)
    taps = stencil_taps(phi, order)
    new_work = w * a_w + b_w * (dt / denominator) * taps
    return geometry.set_work_area(phi, ext, new_work)


@partial(jax.jit, static_argnames=("order", "n_steps", "n_lower", "per_step_norm"))
def evolve_chunk(
    phi: jnp.ndarray,
    a: jnp.ndarray,
    b: jnp.ndarray,
    w_store: Optional[jnp.ndarray],
    order: str,
    dt: float,
    dn: float,
    mass: float,
    n_steps: int,
    n_lower: int,
    per_step_norm: bool = False,
) -> jnp.ndarray:
    """``n_steps`` inner steps between screen updates
    (reference ``evolve``, src/grid.rs:544-687).

    For excited states (``n_lower > 0``) every step renormalises and
    Gram-Schmidt-projects against the stored lower states
    (src/grid.rs:674-681). ``per_step_norm`` forces the per-step
    renormalisation for the ground state too: ψ's scale drifts by
    ``exp(−(E−v_shift)·dt)`` per step, and when the potential's offset makes
    that drift large a whole screen_update chunk under/overflows f32 (the
    f64-only reference never needs this, see models/potentials.build_ab).
    Renormalisation only rescales, so the trajectory is unchanged."""

    def body(_i, phi):
        phi = evolve_step(phi, a, b, order, dt, dn, mass)
        if n_lower > 0 or per_step_norm:
            norm2 = get_norm_squared(phi)
            phi = phi / jnp.sqrt(norm2).astype(phi.dtype)
        if n_lower > 0:
            phi = orthogonalise_wavefunction(phi, w_store, n_lower)
        return phi

    return jax.lax.fori_loop(0, n_steps, body, phi)
