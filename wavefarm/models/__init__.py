"""Physics model layer: potential families and initial conditions."""

from wavefarm.models.potentials import (  # noqa: F401
    Potentials,
    alphas,
    build_ab,
    generate,
    load_arrays,
    mu_debye,
    potential_sub_array,
    potential_sub_scalar,
)
from wavefarm.models.initial import (  # noqa: F401
    set_initial_conditions,
    symmetrise_wavefunction,
)
