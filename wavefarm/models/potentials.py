"""Potential builders: the 14 built-in families, ancillary arrays, pot_sub.

The reference computes every potential point-by-point inside a rayon
``Zip::indexed`` loop (src/potential.rs:46-62,188-319). Here each family is a
vectorised, jit-compiled function over coordinate grids — one XLA fusion
instead of N³ scalar calls.

Geometry quirks preserved from the reference:

* Built-in potentials are evaluated on *padded* indices (0..N+bb), so the
  potential centre ``(N+1)/2`` sits ``ext`` cells off the work-area centre
  used by the ⟨r²⟩ observable (src/potential.rs:46-62 vs src/grid.rs:428-437).
* ``Cube``/``QuadWell`` bounds use integer (floor) division of the grid size
  (src/potential.rs:192-210).
* ``potential_sub`` arrays are built at the *unpadded* work size with work
  indices (src/potential.rs:134-144).

Complex capability (new — the reference stubs these as real,
src/potential.rs:222,271): ``ComplexCoulomb``/``ComplexHarmonic`` scale the
real form by ``(1 + i·absorb)``; ``absorb`` defaults to 0 which reproduces the
reference's real values exactly, while any non-zero value gives an absorptive
(imaginary-part) potential with analytically known spectra for validation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from wavefarm import errors, geometry
from wavefarm.config import Config, PotentialType


@dataclass
class Potentials:
    """Potential and ancillary arrays (reference: src/potential.rs:14-25)."""

    v: jnp.ndarray  # (N+bb)³, real or complex
    a: jnp.ndarray  # (1 − dt·V/2)·B
    b: jnp.ndarray  # 1/(1 + dt·V/2)
    pot_sub_array: Optional[jnp.ndarray] = None  # N³ (FullCornell)
    pot_sub_scalar: Optional[float] = None
    # Finite minimum of V — computed at load like the reference's serial
    # scan (src/potential.rs:156-161; unused downstream there, but here it
    # doubles as the energy-gauge shift baked into a/b — see build_ab).
    v_min: Optional[float] = None
    # The gauge shift actually applied to a/b (v_min when finite, else 0).
    v_shift: float = 0.0


# --------------------------------------------------------------------------- #
# Cornell physics helpers (reference: src/potential.rs:374-398)
# --------------------------------------------------------------------------- #


def alphas(mu: float, nf: float = 2.0) -> float:
    """Running coupling αₛ(μ), scale matched to lattice data from
    hep-lat/0503017v2 (reference: src/potential.rs:374-391)."""
    b0 = 11.0 - 2.0 * nf / 3.0
    b1 = 51.0 - 19.0 * nf / 3.0
    b2 = 2857.0 - 5033.0 * nf / 9.0 + 325.0 * nf * nf / 27.0
    scale = 2.3
    l = 2.0 * math.log(mu / scale)
    ll = math.log(l)
    return (
        4.0
        * math.pi
        * (
            1.0
            - 2.0 * b1 * ll / (b0 * b0 * l)
            + 4.0
            * b1
            * b1
            * ((ll - 0.5) ** 2 + b2 * b0 / (8.0 * b1 * b1) - 5.0 / 4.0)
            / (b0 ** 4 * l * l)
        )
        / (b0 * l)
    )


def mu_debye(t: float, nf: float = 2.0, tc: float = 0.2) -> float:
    """Debye screening mass μ(T) (reference: src/potential.rs:393-398)."""
    return 1.4 * math.sqrt((1.0 + nf / 6.0) * 4.0 * math.pi * alphas(2.0 * math.pi * t)) * t * tc


# --------------------------------------------------------------------------- #
# Dodecahedron plane constants, derived from the golden ratio rather than
# hardcoded decimals (reference hardcodes them: src/potential.rs:283-308).
# --------------------------------------------------------------------------- #

_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)
_PHI = (1.0 + _SQRT5) / 2.0

_C_3_2PS5 = 3.0 * (2.0 + _SQRT5)  # 12.708203932499369
_C_4S3PHI = 4.0 * _SQRT3 * _PHI  # 11.210068307552588
_C_S3_4P2S5 = _SQRT3 * (4.0 + 2.0 * _SQRT5)  # 14.674169922690343
_C_2S3PHI = 2.0 * _SQRT3 * _PHI  # 5.605034153776295
_C_2PHI = 2.0 * _PHI  # 3.2360679774997896
_C_2OPHI = 2.0 / _PHI  # 1.2360679774997896
_C_2PS5 = 2.0 + _SQRT5  # 4.23606797749979
_C_2PHI2 = 2.0 * _PHI * _PHI  # 5.23606797749979 (= 3+√5)
_C_4S3PHI2 = 4.0 * _SQRT3 * _PHI * _PHI  # 18.1382715378281
_C_2S3PHI2 = 2.0 * _SQRT3 * _PHI * _PHI  # 9.06913576891405
_C_9P3S5 = 9.0 + 3.0 * _SQRT5  # 15.708203932499366
_C_3P3S5 = 3.0 + 3.0 * _SQRT5  # 9.708203932499369
_C_2P2S5 = 2.0 + 2.0 * _SQRT5  # 6.47213595499958
_C_4P2S5 = 4.0 + 2.0 * _SQRT5  # 8.47213595499958
_C_6_2PS5 = 6.0 * (2.0 + _SQRT5)  # 25.41640786499874
_C_2S3 = 2.0 * _SQRT3  # 3.4641016151377544


def _dodecahedron_mask(x, y, z):
    """Inside test for a regular dodecahedron in normalised coordinates
    (reference: src/potential.rs:283-308). All twelve face-plane inequalities
    expressed through golden-ratio constants."""
    return (
        (_C_3_2PS5 + _C_4S3PHI * x >= _C_S3_4P2S5 * z)
        & (_C_4S3PHI * x <= _C_3_2PS5 + _C_S3_4P2S5 * z)
        & (_C_2S3PHI * (_C_2PHI * x - _C_2OPHI * z) <= 6.0 * (_C_2PS5 + _C_2PHI2 * y))
        & (_C_4S3PHI2 * x + _C_2S3 * z <= _C_3_2PS5)
        & (_C_2S3PHI2 * x + _C_9P3S5 * y <= _C_3_2PS5 + _C_2S3 * z)
        & (_C_3P3S5 * y <= _C_3_2PS5 + _C_2S3PHI * x + _C_S3_4P2S5 * z)
        & (_C_3_2PS5 + _C_2S3PHI * x + _C_3P3S5 * y + _C_S3_4P2S5 * z >= 0.0)
        & (_C_9P3S5 * y + _C_2S3 * z <= _C_3_2PS5 + _C_2S3PHI2 * x)
        & (_C_2S3PHI * (-_C_2P2S5 * x - _C_2OPHI * z) <= _C_6_2PS5)
        & (_C_2S3 * z <= _C_2S3PHI2 * x + 3.0 * (_C_2PS5 + _C_2PHI2 * y))
        & (_SQRT3 * (_C_2PHI * x + _C_4P2S5 * z) <= 3.0 * (_C_2PS5 + _C_2PHI * y))
        & (_C_2S3PHI * x + _C_3P3S5 * y + _C_S3_4P2S5 * z <= _C_3_2PS5)
    )


# --------------------------------------------------------------------------- #
# Vectorised potential generation
# --------------------------------------------------------------------------- #


def generate(
    config: Config,
    shape: Optional[Tuple[int, int, int]] = None,
    offset: Tuple[int, int, int] = (0, 0, 0),
) -> jnp.ndarray:
    """Build the full potential array on padded indices
    (reference: src/potential.rs:46-62).

    ``shape``/``offset`` allow a sharded solver to build only its local block
    of the global padded array; defaults build the whole thing.
    """
    if config.potential in (PotentialType.FROM_FILE, PotentialType.FROM_SCRIPT):
        raise errors.PotentialNotAvailableError()

    if shape is None:
        shape = config.padded_size()
    rdt = config.real_dtype
    nx, ny, nz = config.grid.size.as_tuple()
    dn = config.grid.dn
    mass = config.mass
    pot = config.potential

    # Float padded-index coordinates (plus integer ones for box potentials).
    fi = jnp.arange(shape[0], dtype=rdt)[:, None, None] + offset[0]
    fj = jnp.arange(shape[1], dtype=rdt)[None, :, None] + offset[1]
    fk = jnp.arange(shape[2], dtype=rdt)[None, None, :] + offset[2]

    if pot is PotentialType.NO_POTENTIAL:
        return jnp.zeros(shape, dtype=config.dtype)

    if pot in (PotentialType.CUBE, PotentialType.QUAD_WELL):
        ii = jnp.arange(shape[0], dtype=jnp.int32)[:, None, None] + offset[0]
        jj = jnp.arange(shape[1], dtype=jnp.int32)[None, :, None] + offset[1]
        kk = jnp.arange(shape[2], dtype=jnp.int32)[None, None, :] + offset[2]
        in_x = (ii > nx // 4) & (ii <= 3 * nx // 4)
        in_y = (jj > ny // 4) & (jj <= 3 * ny // 4)
        if pot is PotentialType.CUBE:
            in_z = (kk > nz // 4) & (kk <= 3 * nz // 4)
        else:  # QuadWell: short side along z (src/potential.rs:202-211)
            in_z = (kk > 3 * nz // 8) & (kk <= 5 * nz // 8)
        return jnp.where(in_x & in_y & in_z, rdt(-10.0), rdt(0.0))

    if pot is PotentialType.PERIODIC:
        # (idx−1)/(num−1) on padded indices (src/potential.rs:212-219)
        sx = jnp.sin(2.0 * jnp.pi * (fi - 1.0) / (nx - 1.0)) ** 2
        sy = jnp.sin(2.0 * jnp.pi * (fj - 1.0) / (ny - 1.0)) ** 2
        sz = jnp.sin(2.0 * jnp.pi * (fk - 1.0) / (nz - 1.0)) ** 2
        return (-(sx * sy * sz) + 1.0).astype(rdt)

    # Shared centred radius (src/potential.rs:366-371)
    dx = fi - (nx + 1.0) / 2.0
    dy = fj - (ny + 1.0) / 2.0
    dz = fk - (nz + 1.0) / 2.0
    r2 = dx * dx + dy * dy + dz * dz
    r = dn * jnp.sqrt(r2)

    if pot in (PotentialType.COULOMB, PotentialType.COMPLEX_COULOMB):
        r_safe = jnp.maximum(r, dn)
        v = jnp.where(r < dn, -1.0 / dn, -1.0 / r_safe).astype(rdt)
        if pot is PotentialType.COMPLEX_COULOMB:
            return v.astype(config.dtype) * (1.0 + 1j * config.absorb)
        return v

    if pot is PotentialType.ELIPTICAL_COULOMB:
        # z-axis squashed by 2, offset so V(∞) = 1/dn (src/potential.rs:230-240)
        re = dn * jnp.sqrt(dx * dx + dy * dy + (2.0 * dz) ** 2)
        re_safe = jnp.maximum(re, dn)
        return jnp.where(re < dn, 0.0, -1.0 / re_safe + 1.0 / dn).astype(rdt)

    if pot is PotentialType.SIMPLE_CORNELL:
        # GeV units; sig is the string tension (src/potential.rs:241-249)
        r_safe = jnp.maximum(r, dn)
        far = -0.5 * (4.0 / 3.0) / r_safe + config.sig * r_safe + 4.0 * mass
        return jnp.where(r < dn, 4.0 * mass, far).astype(rdt)

    if pot in (PotentialType.FULL_CORNELL, PotentialType.COMPLEX_FULL_CORNELL):
        # Debye-screened anisotropic Cornell + spin correction
        # (src/potential.rs:250-269). t/xi/nf/tc are config-extension
        # parameters the reference hardcodes (its TODOs).
        cp = config.cornell
        r2_safe = jnp.maximum(r2, 1e-300)
        aniso = 1.0 - dn * dn * dz * dz / (dn * dn * r2_safe)
        md = (
            mu_debye(cp.t, cp.nf, cp.tc)
            * (1.0 + 0.07 * (cp.xi ** 0.2) * aniso)
            * (1.0 + cp.xi) ** -0.29
        )
        r_safe = jnp.maximum(r, dn)
        screened = jnp.exp(-md * r_safe)
        far = (
            -alphas(2.0 * math.pi * cp.t, cp.nf) * (4.0 / 3.0) * screened / r_safe
            + config.sig * (1.0 - screened) / md
            - 0.8 * config.sig / (4.0 * mass * mass * r_safe)
            + 4.0 * mass
        )
        v = jnp.where(r < dn, 4.0 * mass, far).astype(rdt)
        if pot is PotentialType.COMPLEX_FULL_CORNELL:
            # absorptive finite-T variant (the imaginary part the thermal
            # width gives the in-medium potential), with the same
            # (1 + i·absorb)·V convention as the other Complex* types
            return v.astype(config.dtype) * (1.0 + 1j * config.absorb)
        return v

    if pot in (PotentialType.HARMONIC, PotentialType.COMPLEX_HARMONIC):
        v = (r * r / 2.0).astype(rdt)
        if pot is PotentialType.COMPLEX_HARMONIC:
            return v.astype(config.dtype) * (1.0 + 1j * config.absorb)
        return v

    if pot is PotentialType.DODECAHEDRON:
        # normalised coordinates over the box (src/potential.rs:275-313)
        x = (fi - (nx + 1.0) / 2.0) / ((nx - 1.0) / 2.0)
        y = (fj - (ny + 1.0) / 2.0) / ((ny - 1.0) / 2.0)
        z = (fk - (nz + 1.0) / 2.0) / ((nz - 1.0) / 2.0)
        return jnp.where(_dodecahedron_mask(x, y, z), rdt(-100.0), rdt(0.0))

    raise errors.PotentialNotAvailableError()


def potential_scalar(config: Config, idx: Tuple[int, int, int]) -> complex:
    """Single-point evaluation for golden tests: V at one padded index."""
    block = generate(config, shape=(1, 1, 1), offset=idx)
    return complex(np.asarray(block).reshape(()))


# --------------------------------------------------------------------------- #
# potential_sub: the binding-energy offset V(∞)
# --------------------------------------------------------------------------- #


def potential_sub_scalar(config: Config) -> float:
    """Constant V(∞) per potential type (reference: src/potential.rs:346-363)."""
    pot = config.potential
    if pot is PotentialType.ELIPTICAL_COULOMB:
        return 1.0 / config.grid.dn
    if pot is PotentialType.SIMPLE_CORNELL:
        return 4.0 * config.mass
    if pot.variable_pot_sub:
        raise errors.PotentialNotAvailableError()
    return 0.0


def potential_sub_array(
    config: Config,
    shape: Optional[Tuple[int, int, int]] = None,
    offset: Tuple[int, int, int] = (0, 0, 0),
) -> jnp.ndarray:
    """FullCornell's indexed V(∞) array at the *work* size with work indices
    (reference: src/potential.rs:326-341,134-144).

    Mirrors the reference's exact parenthesisation of ``md`` here, which
    differs from the one inside ``potential()`` (both reduce to μ(T) at the
    default ξ=0)."""
    if not config.potential.variable_pot_sub:
        raise errors.PotentialNotAvailableError()
    if shape is None:
        shape = config.work_size()
    rdt = config.real_dtype
    nx, ny, nz = config.grid.size.as_tuple()
    dn = config.grid.dn
    cp = config.cornell

    fi = jnp.arange(shape[0], dtype=rdt)[:, None, None] + offset[0]
    fj = jnp.arange(shape[1], dtype=rdt)[None, :, None] + offset[1]
    fk = jnp.arange(shape[2], dtype=rdt)[None, None, :] + offset[2]
    dx = fi - (nx + 1.0) / 2.0
    dy = fj - (ny + 1.0) / 2.0
    dz = fk - (nz + 1.0) / 2.0
    r2 = dx * dx + dy * dy + dz * dz
    r2_safe = jnp.maximum(r2, 1e-300)
    aniso = 1.0 - dn * dn * dz * dz / (dn * dn * r2_safe)
    md = mu_debye(cp.t, cp.nf, cp.tc) * 1.0 + (
        0.07 * (cp.xi ** 0.2) * aniso * (1.0 + cp.xi) ** -0.29
    )
    return (config.sig / md + 4.0 * config.mass).astype(rdt)


# --------------------------------------------------------------------------- #
# Ancillary arrays and orchestration
# --------------------------------------------------------------------------- #


def generate_split(
    config: Config,
    shape: Optional[Tuple[int, int, int]] = None,
    offset: Tuple[int, int, int] = (0, 0, 0),
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Complex potential as a (re, im) pair of real arrays, for backends
    without complex support. Complex* types are (1 + i·absorb)·V_real.
    ``shape``/``offset`` build a per-shard block, as :func:`generate`."""
    if not config.potential.is_complex:
        raise errors.PotentialNotAvailableError()
    import dataclasses

    real_cfg = dataclasses.replace(
        config, potential=config.potential.real_counterpart
    )
    vr = generate(real_cfg, shape, offset)
    return vr, config.absorb * vr


def build_ab_split(vr, vi, dt: float, v_shift: float = 0.0):
    """Split-complex A/B factors: B = 1/(1 + dt·V/2), A = (1 − dt·V/2)·B
    with V = vr + i·vi, written over real arrays. ``v_shift`` as in
    :func:`build_ab` (applied to the real part)."""
    vr = vr - v_shift
    dr = 1.0 + dt * vr / 2.0
    di = dt * vi / 2.0
    mag = dr * dr + di * di
    br = dr / mag
    bi = -di / mag
    nr = 1.0 - dt * vr / 2.0
    ni = -dt * vi / 2.0
    ar = nr * br - ni * bi
    ai = nr * bi + ni * br
    return ar, ai, br, bi


def build_ab(
    v: jnp.ndarray, dt: float, v_shift: float = 0.0
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Semi-implicit split-operator factors
    (reference: src/potential.rs:101-110):

    ``B = 1/(1 + dt·V/2)``, ``A = (1 − dt·V/2)·B``.

    ``v_shift`` applies a constant energy gauge ``V → V − v_shift`` to the
    *evolution* factors only. A constant shift rescales ψ by the global
    factor ``exp(v_shift·τ)`` — removed by normalisation — so eigenstates
    and measured energies (which use the unshifted V) are unchanged, but the
    per-chunk decay rate drops from ``E`` to ``E − v_shift``. Without it,
    potentials with a large uniform offset (SimpleCornell's +4m ≈ 18.6 GeV,
    src/potential.rs:241-249) underflow f32 within one screen_update chunk.
    The reference never needs this because it is f64-only; its kept-but-
    unused v-minimum scan (src/potential.rs:156-161) is the shift source."""
    vs = v - v_shift
    b = 1.0 / (1.0 + dt * vs / 2.0)
    a = (1.0 - dt * vs / 2.0) * b
    return a, b


def load_pot_sub(
    config: Config, log=None, build_array: bool = True
) -> Tuple[Optional[jnp.ndarray], Optional[float]]:
    """potential_sub with the reference's file-preference and
    type-consistency checks (src/potential.rs:112-153): a work-size array
    for the FullCornell family, a positive scalar otherwise, (None, None)
    when V(∞) = 0. Shared by load_arrays and the sharded split driver
    (which builds (re, im) pairs instead of a Potentials bundle).

    ``build_array=False`` (sharded blocked-generation callers) skips
    materialising the global analytic FullCornell array — the caller
    builds per-shard blocks via :func:`potential_sub_array`'s
    shape/offset form instead; file-loaded arrays are still returned
    whole (file data is inherently global)."""
    import logging

    log = log or logging.getLogger("wafer")
    from wavefarm.io import readers

    pot_sub_array = None
    pot_sub_scalar_val: Optional[float] = None
    sub_from_file = None
    try:
        sub_from_file = readers.potential_sub(
            config.work_size(), config.output.file_type, log, input_dir=config.input_dir
        )
    except errors.FileNotFoundWaferError:
        sub_from_file = None

    if sub_from_file is not None:
        arr, scalar = sub_from_file
        if arr is None and scalar is not None and config.potential.variable_pot_sub:
            log.error(
                "Potential_sub input file contains a singular value, but potential "
                "type is FullCornell. Update or remove the potential file in the "
                "input directory before continuing."
            )
            raise errors.WrongPotentialSubDimsError()
        if arr is not None and scalar is None and not config.potential.variable_pot_sub:
            log.error(
                "Potential_sub input file contains an array, but potential type is "
                "not FullCornell. Update or remove the potential file in the input "
                "directory before continuing."
            )
            raise errors.WrongPotentialSubDimsError()
        log.info("Potential_sub loaded from disk")
        pot_sub_array = jnp.asarray(arr, dtype=config.real_dtype) if arr is not None else None
        pot_sub_scalar_val = float(scalar) if scalar is not None else None
    elif config.potential.variable_pot_sub:
        if build_array:
            pot_sub_array = potential_sub_array(config)
            log.info("Variable potential_sub calculated directly")
        else:
            log.info(
                "Variable potential_sub deferred to per-shard generation"
            )
    else:
        single = potential_sub_scalar(config)
        log.info("Constant potential_sub calculated directly")
        # only a positive offset is kept (src/potential.rs:146-153)
        pot_sub_scalar_val = single if single > 0.0 else None
    return pot_sub_array, pot_sub_scalar_val


def scan_v_min(config: Config, slabs: int = 8) -> float:
    """Finite minimum of the analytic V by x-slab scan, O(slab) host
    memory — the blocked counterpart of load_arrays' fused global
    reduction (reference scan: src/potential.rs:156-161). Slab mins
    compose exactly: min over the union == min of slab mins."""
    px, py, pz = config.padded_size()
    step = max(1, -(-px // slabs))
    v_min = float("inf")
    for x0 in range(0, px, step):
        blk = jnp.real(generate(config, (min(step, px - x0), py, pz), (x0, 0, 0)))
        m = float(jnp.min(jnp.where(jnp.isfinite(blk), blk, jnp.inf)))
        v_min = min(v_min, m)
    return v_min


def v_shift_and_pole_warn(config: Config, v_min: float, log) -> float:
    """Shared scalar side-channel: the energy-gauge shift from a finite
    positive V minimum, plus the semi-implicit pole warning (all three
    drivers — load_arrays, load_arrays_meta, and the sharded split path —
    apply the identical rule; reference computes the inf silently,
    src/potential.rs:101-110, 156-161).

    Only a positive offset is removed: for such potentials E₀ ≥ v_min > 0
    so the shift lands near the eigenvalue, while for deep wells
    (Coulomb's clamped −1/dn) E₀ sits near 0 and shifting to v_min would
    *inflate* the per-chunk scale drift instead of reducing it."""
    v_shift = max(v_min, 0.0) if math.isfinite(v_min) else 0.0
    if math.isfinite(v_min) and 1.0 + config.grid.dt * (v_min - v_shift) / 2.0 <= 0.0:
        log.warning(
            "Potential minimum %.6g reaches the semi-implicit pole for "
            "dt = %g (B = 1/(1+dt·V/2) diverges where V ≤ −2/dt = %.6g); "
            "reduce dt below %.6g or the run will abort non-finite.",
            v_min,
            config.grid.dt,
            -2.0 / config.grid.dt,
            2.0 / abs(v_min - v_shift) if v_min != v_shift else float("inf"),
        )
    return v_shift


def load_arrays_meta(config: Config, log=None) -> Potentials:
    """load_arrays' scalar side-channel WITHOUT materialising the global
    V/A/B arrays — for sharded drivers that build only their addressable
    shards via ``generate(shape, offset)`` (the reference's indexed
    generation is embarrassingly local, src/potential.rs:46-62).

    Returns a :class:`Potentials` whose ``v``/``a``/``b`` are ``None``;
    ``v_min``/``v_shift`` (slab-scanned, exactly load_arrays' values), the
    semi-implicit pole warning, and the pot_sub file arbitration follow
    load_arrays verbatim. The analytic FullCornell pot_sub array is
    deferred to per-shard generation (``pot_sub_array is None`` while
    ``config.potential.variable_pot_sub`` — callers build blocks with
    :func:`potential_sub_array`'s shape/offset form)."""
    import logging

    log = log or logging.getLogger("wafer")
    if config.potential in (PotentialType.FROM_FILE, PotentialType.FROM_SCRIPT):
        raise errors.PotentialNotAvailableError()

    log.info("Calculating potential per shard (blocked generation)")
    v_min = scan_v_min(config)
    v_shift = v_shift_and_pole_warn(config, v_min, log)
    pot_sub_array, pot_sub_scalar_val = load_pot_sub(
        config, log, build_array=False
    )
    return Potentials(
        v=None,
        a=None,
        b=None,
        pot_sub_array=pot_sub_array,
        pot_sub_scalar=pot_sub_scalar_val,
        v_min=v_min,
        v_shift=v_shift,
    )


def load_arrays(config: Config, log=None) -> Potentials:
    """Load or generate V, build A/B and pot_sub
    (reference: src/potential.rs:75-175)."""
    import logging

    log = log or logging.getLogger("wafer")
    from wavefarm.io import readers, script as script_io

    if config.potential is PotentialType.FROM_FILE:
        log.info("Loading potential from file")
        try:
            v = readers.potential(
                config.padded_size(),
                config.central_difference.bb,
                config.output.file_type,
                log,
                input_dir=config.input_dir,
            )
        except errors.WaferError as exc:
            raise errors.LoadPotentialError() from exc
        v = jnp.asarray(v, dtype=config.dtype)
    elif config.potential is PotentialType.FROM_SCRIPT:
        if config.script_location is None:
            raise errors.ScriptNotFoundError()
        v = script_io.script_potential(
            config.script_location, config.grid, config.central_difference.bb, log
        )
        v = jnp.asarray(v, dtype=config.dtype)
    else:
        log.info("Calculating potential array")
        v = generate(config)

    # finite minimum of V (one fused on-device reduction instead of the
    # reference's serial scan, src/potential.rs:156-161); its positive part
    # is the energy-gauge shift for the evolution factors (see build_ab).
    # Only a positive offset is removed: for such potentials E₀ ≥ v_min > 0
    # so the shift lands near the eigenvalue, while for deep wells
    # (Coulomb's clamped −1/dn) E₀ sits near 0 and shifting to v_min would
    # *inflate* the per-chunk scale drift instead of reducing it.
    v_real = jnp.real(v)
    v_min = float(jnp.min(jnp.where(jnp.isfinite(v_real), v_real, jnp.inf)))
    v_shift = v_shift_and_pole_warn(config, v_min, log)

    a, b = build_ab(v, config.grid.dt, v_shift)

    # potential_sub: prefer a file, with type-consistency checks
    # (src/potential.rs:112-153)
    pot_sub_array, pot_sub_scalar_val = load_pot_sub(config, log)

    pots = Potentials(
        v=v,
        a=a,
        b=b,
        pot_sub_array=pot_sub_array,
        pot_sub_scalar=pot_sub_scalar_val,
        v_min=v_min,
        v_shift=v_shift,
    )

    if config.output.save_potential:
        log.info("Saving potential to disk")
        from wavefarm.io import writers

        work = geometry.work_area(v, config.central_difference.ext)
        try:
            writers.potential(
                np.asarray(work), config.project_name, config.output.file_type,
                output_root=config.output_root,
            )
        except errors.WaferError as exc:
            log.warning("Could not write potential to disk: %s", exc)
        try:
            writers.potential_sub(config)
        except errors.WaferError as exc:
            log.warning("Could not write potential_sub to disk: %s", exc)

    return pots
