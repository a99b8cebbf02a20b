"""Plain NumPy float64 reference for one solver step, written independently
of ``wavefarm.ops`` — the yardstick the device path is compared with, on
the CPU in the tests and at full width on the GPU in ``chip_smoke.py``.

It implements the reference's update rule (src/grid.rs:562-673): on the
work area of a padded ψ,

    ψ' = A·ψ + B·dt·(Σ_axes Σ_o c_o·(ψ(+o) + ψ(−o)) − c₀·ψ) / (k·dn²·m)

with ``B = 1/(1 + dt·(V − s)/2)`` and ``A = (1 − dt·(V − s)/2)·B``
(src/potential.rs:101-110; ``s`` is the solver's gauge shift), and the
observables of src/grid.rs:303-445 (with the complex conjugate the
reference's TODO at :311 leaves out), then normalisation and sequential
Gram-Schmidt projection (src/grid.rs:454-492). Every array is promoted to
float64 / complex128 first.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# (tap weights for offsets 1..ext, centre weight c₀, denominator k) —
# src/grid.rs:568-663
STENCILS = {
    "ThreePoint": ((1.0,), 6.0, 2.0),
    "FivePoint": ((16.0, -1.0), 90.0, 24.0),
    "SevenPoint": ((270.0, -27.0, 2.0), 1470.0, 360.0),
}


def _hi(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, np.complex128 if np.iscomplexobj(x) else np.float64)


def taps(psi: np.ndarray, order: str) -> np.ndarray:
    """Laplacian numerator on the work area of the padded ``psi``."""
    weights, centre, _k = STENCILS[order]
    e = len(weights)
    psi = _hi(psi)
    nx, ny, nz = (n - 2 * e for n in psi.shape)

    def window(dx, dy, dz):
        return psi[e + dx : e + dx + nx, e + dy : e + dy + ny, e + dz : e + dz + nz]

    acc = -centre * window(0, 0, 0)
    for o, c in enumerate(weights, start=1):
        for d in ((o, 0, 0), (0, o, 0), (0, 0, o)):
            acc = acc + c * window(*d) + c * window(*(-x for x in d))
    return acc


def evolve_step(psi, v, order: str, dt: float, dn: float, mass: float,
                v_shift: float = 0.0) -> np.ndarray:
    """One imaginary-time step; ``psi`` and ``v`` are padded arrays."""
    e = len(STENCILS[order][0])
    k = STENCILS[order][2]
    psi = _hi(psi)
    vs = _hi(v)[e:-e, e:-e, e:-e] - v_shift
    b = 1.0 / (1.0 + dt * vs / 2.0)
    a = (1.0 - dt * vs / 2.0) * b
    out = psi.copy()
    out[e:-e, e:-e, e:-e] = (
        a * psi[e:-e, e:-e, e:-e] + b * (dt / (k * dn * dn * mass)) * taps(psi, order)
    )
    return out


def r2_grid(shape: Sequence[int]) -> np.ndarray:
    """Squared index distance from the grid centre ((N+1)/2 per axis) on
    the work indices (src/potential.rs:366-371)."""
    i, j, k = (np.arange(n, dtype=np.float64) - (n + 1) / 2.0 for n in shape)
    return i[:, None, None] ** 2 + j[None, :, None] ** 2 + k[None, None, :] ** 2


def observables(psi, v, order: str, dn: float, mass: float,
                pot_sub=None):
    """(energy, norm², V∞, ⟨r²⟩) of a padded ``psi``; ``pot_sub`` is a
    work-area array, a scalar, or None."""
    e = len(STENCILS[order][0])
    k = STENCILS[order][2]
    psi = _hi(psi)
    w = psi[e:-e, e:-e, e:-e]
    abs2 = (np.conj(w) * w).real
    vw = _hi(v)[e:-e, e:-e, e:-e]
    energy = np.sum(vw * abs2 - np.conj(w) * taps(psi, order) / (k * dn * dn * mass))
    norm2 = np.sum(abs2)
    if pot_sub is None:
        v_inf = 0.0
    elif np.ndim(pot_sub) == 0:
        v_inf = norm2 * float(pot_sub)
    else:
        v_inf = np.sum(abs2 * np.asarray(pot_sub, np.float64))
    r2 = np.sum(abs2 * r2_grid(w.shape))
    return energy, norm2, v_inf, r2


def normalise_project(psi, norm2: float,
                      stored: Optional[Sequence[np.ndarray]] = None):
    """ψ/√norm², then ψ ← ψ − l·⟨l|ψ⟩ for each stored ``l`` in order."""
    out = _hi(psi) / np.sqrt(norm2)
    for lower in stored or ():
        lower = _hi(lower)
        out = out - lower * np.sum(np.conj(lower) * out)
    return out


def max_rel_overlap(psi, stored: Sequence[np.ndarray]) -> float:
    """max_l |⟨l|ψ⟩| / (‖l‖·‖ψ‖)."""
    psi = _hi(psi)
    pn = np.sqrt(np.sum(np.abs(psi) ** 2))
    return max(
        abs(np.sum(np.conj(_hi(l)) * psi)) / (np.sqrt(np.sum(np.abs(_hi(l)) ** 2)) * pn)
        for l in stored
    )
