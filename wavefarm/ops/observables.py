"""Fused observable reductions: energy, norm², V∞, ⟨r²⟩.

One jitted pass replaces the reference's four sequential rayon reductions
(src/grid.rs:303-445). XLA fuses the stencil re-use and the elementwise
products into a single HBM stream.

Definitions (work area only; halo excluded):

    energy = Σ ( V·|ψ|² − ψ*·(Σ cᵢψᵢ − c₀ψ)/(k·dn²·m) )
    norm²  = Σ |ψ|²
    V∞     = Σ |ψ|²·potsub      (array, scalar, or absent → 0)
    ⟨r²⟩   = Σ |ψ|²·r²(idx)     (index units, work-area indices)

Complex ψ: the reference omits conjugation (TODO at src/grid.rs:311); we
conjugate, so energy is the true ⟨ψ|H|ψ⟩ (complex when V is complex).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from wavefarm import geometry
from wavefarm.ops.gram_schmidt import hybrid_sum
from wavefarm.ops.stencil import stencil_taps


@dataclass
class Observables:
    """Raw (un-normalised) observables (reference: src/grid.rs:15-28)."""

    energy: complex
    norm2: float
    v_infinity: float
    r2: float

    @property
    def norm_energy(self):
        return self.energy / self.norm2

    @property
    def r_norm(self) -> float:
        """r_rms = √(⟨r²⟩/norm²) in index units (src/output.rs:540)."""
        return float(jnp.sqrt(self.r2 / self.norm2))


@partial(jax.jit, static_argnames=("order",))
def compute_observables_device(
    phi: jnp.ndarray,
    v: jnp.ndarray,
    r2_grid: jnp.ndarray,
    pot_sub_array: Optional[jnp.ndarray],
    pot_sub_scalar: Optional[float],
    order: str,
    dn: float,
    mass: float,
):
    """Device portion: returns (energy, norm2, v_infinity, r2) scalars."""
    ext = {"ThreePoint": 1, "FivePoint": 2, "SevenPoint": 3}[order]
    _offsets, _coeffs, _center, k = geometry.stencil_coefficients(order)
    # Energy denominators match the evolve sweep: 2, 24, 360 · dn²·m
    # (src/grid.rs:314,337,367), i.e. k·dn²·m.
    denominator = k * dn * dn * mass

    w = geometry.work_area(phi, ext)
    v_w = geometry.work_area(v, ext)

    _sum = hybrid_sum
    wc = jnp.conj(w) if jnp.iscomplexobj(w) else w
    abs2 = jnp.real(wc * w)

    taps = stencil_taps(phi, order)
    energy = _sum(v_w * wc * w - wc * taps / denominator)
    norm2 = _sum(abs2)
    if pot_sub_array is not None:
        v_inf = _sum(abs2 * pot_sub_array)
    elif pot_sub_scalar is not None:
        v_inf = norm2 * pot_sub_scalar
    else:
        v_inf = jnp.zeros((), dtype=norm2.dtype)
    r2 = _sum(abs2 * r2_grid)
    return energy, norm2, v_inf, r2


def compute_observables(config, potentials, phi: jnp.ndarray) -> Observables:
    """Host-friendly wrapper (reference ``compute_observables``,
    src/grid.rs:303-445)."""
    ext = config.central_difference.ext
    r2_grid = geometry.r2_index_grid(
        config.work_size(), config.grid.size.as_tuple(), dtype=config.real_dtype
    )
    e, n2, vinf, r2 = compute_observables_device(
        phi,
        potentials.v,
        r2_grid,
        potentials.pot_sub_array,
        potentials.pot_sub_scalar,
        config.central_difference.value,
        config.grid.dn,
        config.mass,
    )
    e = complex(e) if jnp.iscomplexobj(phi) else float(e)
    return Observables(energy=e, norm2=float(n2), v_infinity=float(vinf), r2=float(r2))
