"""Device compute kernels: stencils, reductions, orthogonalisation."""

from wavefarm.ops.stencil import evolve_chunk, evolve_step, stencil_taps  # noqa: F401
from wavefarm.ops.observables import Observables, compute_observables  # noqa: F401
from wavefarm.ops.gram_schmidt import (  # noqa: F401
    get_norm_squared,
    normalise_wavefunction,
    orthogonalise_wavefunction,
)
