"""Wavefarm: a 3D Schrödinger equation solver on JAX/XLA.

A ground-up re-design of the capabilities of Libbum/Wafer (reference:
/root/reference/src/main.rs:1-14) — a Wick-rotated (imaginary-time)
finite-difference solver for the 3D time-independent Schrödinger equation —
built for accelerators:

* the hot explicit-Euler stencil sweep (reference: src/grid.rs:544-687) is a
  jitted XLA loop instead of a rayon ``Zip::par_apply`` loop,
* observables (energy, norm², ⟨r²⟩, V∞ — reference: src/grid.rs:303-445) are
  fused on-device reductions,
* grids shard over a ``jax.sharding.Mesh`` with ``ppermute`` halo exchange
  (the device-mesh counterpart of the ancestral MPI decomposition of
  Strickland & Yager-Elorriaga, J. Comp. Phys. 229, 6015 (2010)),
* complex wavefunction propagation is supported from day one (the reference
  leaves this as TODOs: src/potential.rs:222,271, src/grid.rs:311,566).

The YAML configuration schema, the five output file formats, the
snapshot/restart lifecycle and the observable definitions are compatible with
the reference.
"""

__version__ = "0.1.0"

from wavefarm.config import (  # noqa: F401
    CentralDifference,
    Config,
    FileType,
    Grid,
    Index3,
    InitialCondition,
    OutputConfig,
    PotentialType,
    SymmetryConstraint,
)
