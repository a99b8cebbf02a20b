"""Normalisation and Gram-Schmidt orthogonalisation.

The reference projects the active state against every converged lower state
sequentially, allocating a fresh overlap buffer per state
(src/grid.rs:454-492). Here overlaps are single fused reductions; the
sequential subtraction order is preserved (stored states need not be exactly
mutually orthogonal, so order matters).

Unlike the reference (its TODO at src/grid.rs:311,456), inner products use
complex conjugation, so the complex-ψ path is correct.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


def hybrid_sum(x):
    """Full-array sum with hybrid-precision accumulation for single-
    precision inputs under x64: the elementwise values and the innermost
    (lane-axis) partial sums stay f32 — ≤ nz summands, rounding
    ~log₂(nz)·ε ≈ 5e-7 relative *of a single row* — and the combine over
    the remaining nx·ny partials is exact f64, giving near-f64 totals at
    full f32 bandwidth. Error bound: each row's partial carries
    ≤ ~log₂(nz)·ε_f32·Σ|row| absolute error, so the total's relative error
    is bounded by ~log₂(nz)·ε_f32 · Σ_rows Σ|row| / |Σ| — when rows cancel
    across the sum (kinetic-vs-potential energies, gauge-shifted E near
    zero) the condition number Σ|x|/|Σx| amplifies the per-row bound
    (regression: tests/test_ops.py::test_hybrid_sum_cancellation_bound).
    Rationale: plain f32 sums over ≥16M cells lose
    the 1e-6 relative-energy signal the convergence test needs, while
    upcasting whole arrays to f64 would double the bytes the pass moves.
    f64 inputs (the reference's precision, src/config.rs:19-22) pass
    through unchanged. Shared by the single-device observables, the
    sharded measures and the Gram-Schmidt overlaps."""
    single = x.dtype in (jnp.dtype(jnp.float32), jnp.dtype(jnp.complex64))
    if jax.config.jax_enable_x64 and single:
        dt_ = jnp.complex128 if jnp.iscomplexobj(x) else jnp.float64
        return jnp.sum(jnp.sum(x, axis=-1).astype(dt_))
    return jnp.sum(x)


def get_norm_squared(w: jnp.ndarray) -> jnp.ndarray:
    """⟨ψ|ψ⟩ (reference: src/grid.rs:454-457). Real, even for complex ψ.

    Computed over the full padded array: the halo is identically zero, so
    this equals the reference's work-area reduction."""
    if jnp.iscomplexobj(w):
        return jnp.sum(jnp.real(w) ** 2 + jnp.imag(w) ** 2)
    return jnp.sum(w * w)


def normalise_wavefunction(w: jnp.ndarray, norm2) -> jnp.ndarray:
    """ψ / √norm2 (reference: src/grid.rs:459-468)."""
    return w / jnp.sqrt(norm2).astype(w.dtype)


def orthogonalise_wavefunction(
    w: jnp.ndarray, w_store: Optional[jnp.ndarray], n_lower: int
) -> jnp.ndarray:
    """Sequentially project out each stored lower state
    (reference: src/grid.rs:477-492):

        for each lower: ψ ← ψ − lower·⟨lower|ψ⟩

    ``w_store`` is a stacked ``(n_states, ...)`` array; ``n_lower`` is static
    so the (small) loop unrolls inside jit. The overlaps accumulate through
    :func:`hybrid_sum`: a plain f32 sum over a large grid carries ~√N·ε
    relative error, which would leave a ~1e-5 admixture of each lower state
    behind instead of a rounding-level one."""
    if n_lower == 0 or w_store is None:
        return w
    for s in range(n_lower):
        lower = w_store[s]
        overlap = hybrid_sum(jnp.conj(lower) * w).astype(w.dtype)
        w = w - lower * overlap
    return w
