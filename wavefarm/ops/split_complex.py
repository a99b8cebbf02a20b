"""Split-complex solver path: complex ψ as (re, im) real-array pairs.

For platforms without complex dtypes, this module re-expresses the
imaginary-time update, observables, normalisation and Gram-Schmidt with the
complex algebra written out over real arrays — bit-compatible with the
native-complex XLA path (ops/stencil.py, ops/observables.py), which is the
path every supported platform (CPU, GPU) takes.

Maths (V, A, B complex; the stencil ``taps`` operator is linear so it acts
componentwise):

    ψ' = A∘ψ + B·s·taps(ψ)
    re' = aᵣψᵣ − aᵢψᵢ + s(bᵣtᵣ − bᵢtᵢ)
    im' = aᵣψᵢ + aᵢψᵣ + s(bᵣtᵢ + bᵢtᵣ)

    norm² = Σ ψᵣ² + ψᵢ²
    ⟨l|ψ⟩ = Σ (lᵣψᵣ + lᵢψᵢ) + i·Σ (lᵣψᵢ − lᵢψᵣ)
    energy = Σ V|ψ|² − ψ*·taps(ψ)/denom   (complex)
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from wavefarm import geometry
from wavefarm.ops.gram_schmidt import hybrid_sum
from wavefarm.ops.stencil import stencil_taps


def split(arr) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Complex array → (re, im) f32/f64 pair (host-side helper)."""
    return jnp.real(arr), jnp.imag(arr)


def fuse(re, im):
    return re + 1j * im


def _norm2(pr, pi):
    return jnp.sum(pr * pr + pi * pi)


def _overlap(lr, li, pr, pi):
    """⟨l|ψ⟩ = Σ conj(l)·ψ, split into (re, im)."""
    return jnp.sum(lr * pr + li * pi), jnp.sum(lr * pi - li * pr)


def _project(pr, pi, lr, li, o_re, o_im):
    """ψ ← ψ − l·⟨l|ψ⟩."""
    return pr - (lr * o_re - li * o_im), pi - (lr * o_im + li * o_re)


def evolve_step_sc(pr, pi, ar, ai, br, bi, order, dt, dn, mass):
    """One split-complex sweep (update rule of src/grid.rs:544-687)."""
    _o, _c, _cc, k = geometry.stencil_coefficients(order)
    ext = {"ThreePoint": 1, "FivePoint": 2, "SevenPoint": 3}[order]
    s = dt / (k * dn * dn * mass)
    tr = stencil_taps(pr, order)
    ti = stencil_taps(pi, order)
    wr = geometry.work_area(pr, ext)
    wi = geometry.work_area(pi, ext)
    arw = geometry.work_area(ar, ext)
    aiw = geometry.work_area(ai, ext)
    brw = geometry.work_area(br, ext)
    biw = geometry.work_area(bi, ext)
    new_r = arw * wr - aiw * wi + s * (brw * tr - biw * ti)
    new_i = arw * wi + aiw * wr + s * (brw * ti + biw * tr)
    return (
        geometry.set_work_area(pr, ext, new_r),
        geometry.set_work_area(pi, ext, new_i),
    )


@partial(jax.jit, static_argnames=("order", "n_steps", "n_lower", "per_step_norm"))
def evolve_chunk_sc(
    pr, pi, ar, ai, br, bi, store_r, store_i,
    order: str, dt: float, dn: float, mass: float, n_steps: int, n_lower: int,
    per_step_norm: bool = False,
):
    """``n_steps`` split-complex sweeps with per-step normalise +
    Gram-Schmidt for excited states (src/grid.rs:674-681).
    ``per_step_norm`` extends the renormalisation to the ground state (f32
    scale-drift guard, see ops/stencil.evolve_chunk)."""

    def body(_i, carry):
        pr, pi = carry
        pr, pi = evolve_step_sc(pr, pi, ar, ai, br, bi, order, dt, dn, mass)
        if n_lower > 0 or per_step_norm:
            inv = (1.0 / jnp.sqrt(_norm2(pr, pi))).astype(pr.dtype)
            pr, pi = pr * inv, pi * inv
        if n_lower > 0:
            for s_idx in range(n_lower):
                o_re, o_im = _overlap(store_r[s_idx], store_i[s_idx], pr, pi)
                pr, pi = _project(pr, pi, store_r[s_idx], store_i[s_idx], o_re, o_im)
        return pr, pi

    return jax.lax.fori_loop(0, n_steps, body, (pr, pi))


@partial(jax.jit, static_argnames=("order", "n_lower"))
def measure_and_prepare_sc(
    pr, pi, vr, vi, r2_grid, pot_sub_array, pot_sub_scalar, store_r, store_i,
    order: str, dn: float, mass: float, n_lower: int,
):
    """Fused observables + normalise + orthogonalise, split-complex
    (counterparts: ops/observables.py and solver._measure_and_prepare)."""
    ext = {"ThreePoint": 1, "FivePoint": 2, "SevenPoint": 3}[order]
    _o, _c, _cc, k = geometry.stencil_coefficients(order)
    denom = k * dn * dn * mass

    wr = geometry.work_area(pr, ext)
    wi = geometry.work_area(pi, ext)
    vrw = geometry.work_area(vr, ext)
    viw = geometry.work_area(vi, ext)
    abs2 = wr * wr + wi * wi
    tr = stencil_taps(pr, order)
    ti = stencil_taps(pi, order)

    # energy = Σ V|ψ|² − ψ*·taps/denom; ψ*·taps = (wr−i·wi)(tr+i·ti).
    # The five convergence-critical sums accumulate via hybrid_sum (f32
    # rows, f64 combine under x64) like the native-complex path
    # (ops/observables.py) and the sharded split path
    # (parallel/sharded_split.py) — plain f32 sums over ≥16M cells drown
    # the 1e-6 ΔE/N signal whenever |E| ≳ 2 (BASELINE config 4, 256³).
    e_re = hybrid_sum(vrw * abs2 - (wr * tr + wi * ti) / denom)
    e_im = hybrid_sum(viw * abs2 - (wr * ti - wi * tr) / denom)
    norm2 = hybrid_sum(abs2)
    if pot_sub_array is not None:
        v_inf = hybrid_sum(abs2 * pot_sub_array)
    elif pot_sub_scalar is not None:
        v_inf = norm2 * pot_sub_scalar
    else:
        v_inf = jnp.zeros((), dtype=norm2.dtype)
    r2 = hybrid_sum(abs2 * r2_grid)

    inv = (1.0 / jnp.sqrt(norm2)).astype(pr.dtype)
    pr, pi = pr * inv, pi * inv
    for s_idx in range(n_lower):
        o_re, o_im = _overlap(store_r[s_idx], store_i[s_idx], pr, pi)
        pr, pi = _project(pr, pi, store_r[s_idx], store_i[s_idx], o_re, o_im)
    return (e_re, e_im, norm2, v_inf, r2), (pr, pi)


def backend_supports_complex() -> bool:
    """Whether the active platform executes complex dtypes natively.

    Answered from the platform name alone: probing by running a complex
    op would need a second process on the device. CPU and GPU both
    implement complex64/complex128, so on every supported platform the
    native complex XLA path runs and this module is reached only by its
    tests."""
    return jax.devices()[0].platform in ("cpu", "gpu")
