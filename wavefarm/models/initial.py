"""Initial conditions and symmetry constraints for the wavefunction.

Vectorised counterparts of the reference's generators
(src/config.rs:577-683) plus the mid-plane (anti)symmetrisation
(src/config.rs:691-728).
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from wavefarm import errors, geometry
from wavefarm.config import Config, InitialCondition


def generate_gaussian(config: Config, init_size, seed: Optional[int] = None) -> jnp.ndarray:
    """Mean-0 Gaussian noise with σ = ``config.sig``
    (reference: src/config.rs:636-642, which uses a non-deterministic
    thread rng; we use a jax PRNG key, optionally seeded for reproducible
    runs)."""
    if seed is None:
        seed = int.from_bytes(os.urandom(4), "little")
    key = jax.random.PRNGKey(seed)
    return config.sig * jax.random.normal(key, init_size, dtype=config.real_dtype)


def generate_coulomb(config: Config, init_size) -> jnp.ndarray:
    """Coulomb-like guess: hydrogenic n=1, 2s, 2p₀, 2p±₁ superposition
    (reference: src/config.rs:650-668).

    Quirks preserved: the centre is ``init_size/2`` in *padded* coordinates,
    and the "cosines" carry a stray ``dn`` factor exactly as the reference
    computes them. The reference divides by zero at the exact centre cell
    (r = 0, which would panic its noisy floats); we define that cell by the
    r → 0 limit with costheta = cosphi = 0."""
    rdt = config.real_dtype
    dn = config.grid.dn
    m = config.mass
    fi = jnp.arange(init_size[0], dtype=rdt)[:, None, None]
    fj = jnp.arange(init_size[1], dtype=rdt)[None, :, None]
    fk = jnp.arange(init_size[2], dtype=rdt)[None, None, :]
    dx = fi - init_size[0] / 2.0
    dy = fj - init_size[1] / 2.0
    dz = fk - init_size[2] / 2.0
    r = dn * jnp.sqrt(dx * dx + dy * dy + dz * dz)
    r_safe = jnp.where(r > 0.0, r, 1.0)
    costheta = jnp.where(r > 0.0, dn * dz / r_safe, 0.0)
    cosphi = jnp.where(r > 0.0, dn * dx / r_safe, 0.0)
    mr2 = jnp.exp(-m * r / 2.0)
    sin_term = jnp.sqrt(jnp.maximum(1.0 - costheta ** 2, 0.0))
    return (
        jnp.exp(-m * r)
        + (2.0 - m * r) * mr2
        + m * r * mr2 * costheta
        + m * r * mr2 * sin_term * cosphi
    ).astype(rdt)


def generate_boolean(init_size, dtype) -> jnp.ndarray:
    """Parity test grid: 1 where i, j, k are all odd
    (reference: src/config.rs:676-683 — ``i%2 * j%2 * k%2`` evaluated
    left-to-right over floats reduces to exactly this)."""
    i = jnp.arange(init_size[0], dtype=jnp.int32)[:, None, None]
    j = jnp.arange(init_size[1], dtype=jnp.int32)[None, :, None]
    k = jnp.arange(init_size[2], dtype=jnp.int32)[None, None, :]
    return ((i % 2) * (j % 2) * (k % 2)).astype(dtype)


def perturb_clone(
    config: Config,
    w: jnp.ndarray,
    wnum: int,
    seed: Optional[int] = None,
    scale: float = 1e-3,
    padded: bool = True,
    component: int = 0,
    rms_from: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Seed state ``wnum`` from a converged lower state plus deterministic
    relative noise.

    The reference re-uses the previous state verbatim when no file is on
    disk (src/grid.rs:60-100) and relies on the f64 rounding residual of
    the first normalise-then-orthogonalise to seed the new state. In f32
    that residual is an outright hazard: the chunk head computes
    ``ψ/s − c·ψ`` elementwise, and whenever the two scalars round to the
    same f32 the subtraction cancels BITWISE to the exact zero array —
    the evolution then collapses to zeros and the norm² guard fires
    (observed on the 256³ Coulomb north star, data-dependent: the same
    workload passed in round 3). An explicit, seeded perturbation makes
    the excited seed well-defined; imaginary time converges to the same
    eigenstate, so converged observables are unaffected (documented
    divergence: docs/PARITY.md).

    Driver consistency: the noise is drawn on the INTERIOR grid shape
    from ``fold_in(seed, wnum·k + component)`` so every driver (padded
    single-device, interior sharded, split pairs via ``component``)
    derives the identical perturbation field; padded callers receive it
    zero-padded, which keeps the Dirichlet shell clean by construction.
    """
    key = jax.random.fold_in(
        jax.random.PRNGKey(0 if seed is None else seed),
        7919 * wnum + component,
    )
    size = config.grid.size.as_tuple()
    rdt = config.real_dtype
    noise = jax.random.normal(key, size, dtype=rdt)
    if jnp.iscomplexobj(w):
        noise = (
            noise
            + 1j
            * jax.random.normal(jax.random.fold_in(key, 1), size, dtype=rdt)
        ).astype(w.dtype)
    ext = config.central_difference.ext
    if padded:
        noise = jnp.pad(noise, ext)
    # amplitude reference: ``rms_from`` lets a split-pair caller scale a
    # (possibly all-zero) imaginary part by the real part's magnitude
    ref = w if rms_from is None else rms_from
    wi = ref[ext:-ext, ext:-ext, ext:-ext] if padded else ref
    rms = jnp.sqrt(jnp.mean(jnp.abs(wi) ** 2)).astype(rdt)
    return w + (scale * rms) * noise


def set_initial_conditions(config: Config, log=None, seed: Optional[int] = None) -> jnp.ndarray:
    """Build the starting wavefunction: generator → Dirichlet shell →
    symmetrisation (reference: src/config.rs:577-627)."""
    import logging

    log = log or logging.getLogger("wafer")
    log.info("Setting initial conditions for wavefunction")
    init_size = config.padded_size()
    ic = config.init_condition
    if ic is InitialCondition.FROM_FILE:
        from wavefarm.io import readers

        try:
            w = readers.wavefunction(
                config.wavenum,
                init_size,
                config.central_difference.bb,
                config.output.file_type,
                log,
                input_dir=config.input_dir,
            )
        except errors.WaferError as exc:
            raise errors.LoadWavefunctionError(config.wavenum) from exc
        w = jnp.asarray(w, dtype=config.dtype)
    elif ic is InitialCondition.GAUSSIAN:
        w = generate_gaussian(config, init_size, seed=seed)
    elif ic is InitialCondition.COULOMB:
        w = generate_coulomb(config, init_size)
    elif ic is InitialCondition.CONSTANT:
        w = jnp.full(init_size, 0.1, dtype=config.real_dtype)
    elif ic is InitialCondition.BOOLEAN:
        w = generate_boolean(init_size, config.real_dtype)
    else:  # pragma: no cover
        raise errors.SetInitialConditionsError()

    w = w.astype(config.dtype)
    # Dirichlet zero shell of width ext on all six faces
    # (reference: src/config.rs:597-622)
    w = geometry.zero_boundary(w, config.central_difference.ext)
    return symmetrise_wavefunction(config, w)


def symmetrise_wavefunction(config: Config, w: jnp.ndarray) -> jnp.ndarray:
    """Force (anti)symmetry about the y or z mid-plane
    (reference: src/config.rs:691-728).

    The reference's sequential ascending in-place loop
    (``w[p] = sign·w[m(p)]`` with ``m(p) = p`` for ``p ≤ mid`` else
    ``ext+N+1−p``, ``mid = (ext+N)//2``) has the net effect:

    - ``p ≤ mid``: scaled by ``sign``;
    - self-mapped central plane (``m(p) == p > mid``, even ``ext+N+1``):
      scaled by ``sign`` (single in-place application);
    - ``p > mid`` with ``m(p) ≥ ext``: receives the mirror's *pre-scaled*
      value (the mirror was already overwritten → net ``sign² = 1``);
    - ``p > mid`` with ``m(p) < ext`` (mirror in the halo, never written):
      receives ``sign``·halo — zero for solver arrays.

    The reference hardcodes ``ext = 3`` (only functions for SevenPoint); we
    generalise to the configured halo width. Its loop range ``[ext, ext+N]``
    includes one halo plane per axis: at ``ext = 3`` those writes deposit
    zeros (the mirror source is another halo plane), but for ``ext < 3`` the
    mirror of plane ``ext+N`` is an *interior* plane — writing it would
    pollute the Dirichlet shell and change the operator's spectrum. The
    generalisation therefore clamps writes to interior planes
    ``[ext, ext+N−1]``; for solver arrays (zero halos) this is observationally
    identical to the reference at ``ext = 3``."""
    sym = config.init_symmetry
    axis = sym.axis
    if axis is None:
        return w
    ext = config.central_difference.ext
    size = config.grid.size.as_tuple()
    n = size[1] if axis == 1 else size[2]

    p = np.arange(w.shape[axis])
    mid = (ext + n) // 2
    src = p.copy()
    upper = p > mid
    src[upper] = ext + n + 1 - p[upper]
    np.clip(src, 0, w.shape[axis] - 1, out=src)  # guard halo-mirror reads
    scale = np.ones(w.shape[axis])
    scale[(p <= mid) | (src == p) | (src < ext)] = sym.sign

    mirrored = jnp.take(w, jnp.asarray(src), axis=axis)
    shape = [1, 1, 1]
    shape[axis] = w.shape[axis]
    mirrored = mirrored * jnp.asarray(scale, dtype=w.real.dtype).reshape(shape)

    # Write region: interior y and z planes; all x
    # (reference loops: src/config.rs:701-726, halo-clamped as above)
    yj = np.arange(w.shape[1])
    zk = np.arange(w.shape[2])
    mask_y = (yj >= ext) & (yj < ext + size[1])
    mask_z = (zk >= ext) & (zk < ext + size[2])
    write = jnp.asarray(mask_y[None, :, None] & mask_z[None, None, :])
    return jnp.where(write, mirrored, w)
