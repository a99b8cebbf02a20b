"""The device step, observables and Gram-Schmidt against the plain NumPy
float64 reference (wavefarm/reference.py) — the same comparison
chip_smoke.py's phase A makes on the GPU at 256³."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from wavefarm import reference, solver
from wavefarm.ops import gram_schmidt

POTENTIALS = ["NoPotential", "Harmonic", "Coulomb", "SimpleCornell",
              "Periodic", "FullCornell"]


@pytest.mark.parametrize("shape", [(16, 16, 16), (16, 12, 20)],
                         ids=["cubic", "anisotropic"])
@pytest.mark.parametrize("dtype", chip_smoke.DTYPES)
@pytest.mark.parametrize("potential", POTENTIALS)
@pytest.mark.parametrize("order", chip_smoke.ORDERS)
def test_step_matches_reference(tmp_run, order, potential, dtype, shape):
    """One evolve step, the fused observables and the projection against 2
    stored states agree with the float64 reference within chip_smoke's
    phase-A tolerances."""
    rec = chip_smoke.step_case(order, dtype, potential, shape=shape, dn=0.1)
    assert rec["ok"], rec


@pytest.mark.parametrize("n_lower", [1, 2, 3])
def test_gram_schmidt_matches_reference(n_lower):
    """Sequential projection against 1–3 stored (not exactly orthogonal)
    states matches the reference; with orthonormal f32 stores the
    residual admixture is rounding-level, not the ~√N·ε of an f32 sum."""
    rng = np.random.default_rng(n_lower)
    shape = (24, 20, 28)
    stored = [rng.normal(size=shape) for _ in range(n_lower)]
    stored = [s / np.sqrt(np.sum(s * s)) for s in stored]
    psi = rng.normal(size=shape) + 3.0 * stored[0]
    n2 = float(np.sum(psi * psi))
    got = gram_schmidt.orthogonalise_wavefunction(
        gram_schmidt.normalise_wavefunction(jnp.asarray(psi), n2),
        jnp.asarray(np.stack(stored)), n_lower,
    )
    want = reference.normalise_project(psi, n2, stored)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-13)

    ortho = []
    for s in stored:
        for l in ortho:
            s = s - l * np.sum(l * s)
        ortho.append(s / np.sqrt(np.sum(s * s)))
    store32 = jnp.asarray(np.stack(ortho), jnp.float32)
    got32 = gram_schmidt.orthogonalise_wavefunction(
        jnp.asarray(psi / np.sqrt(n2), jnp.float32), store32, n_lower
    )
    assert reference.max_rel_overlap(np.asarray(got32), list(np.asarray(store32))) < 1e-6


def _dot_precisions(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args)
    found = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jaxpr.jaxpr)
    return found


@pytest.mark.parametrize("fn,n_args", [
    (solver._max_rel_overlap, 2), (solver._max_rel_overlap_sc, 4),
], ids=["native", "split"])
def test_overlap_contractions_use_highest_precision(fn, n_args):
    """The delayed-GS gate's admixture measurement must not run in TF32 on
    a GPU: every dot_general in it asks for Precision.HIGHEST."""
    f = jnp.ones((4, 4, 4), jnp.float32)
    s = jnp.ones((2, 4, 4, 4), jnp.float32)
    args = (f, s) if n_args == 2 else (f, f, s, s)
    precisions = _dot_precisions(fn, *args)
    assert precisions, "no contraction found"
    for p in precisions:
        assert p is not None and all(
            q == jax.lax.Precision.HIGHEST for q in p
        ), p
