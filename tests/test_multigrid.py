"""Multigrid (coarse→fine) schedule: the in-memory automation of the
reference's documented manual coarse→fine restart workflow
(src/config.rs:156-160 — "loading a wavefunction of lower resolution ...
can reduce simulation time"; resampler parity: src/input.rs:667-716).
"""

import cmath

import numpy as np
import pytest

from tests.conftest import base_config
from wavefarm import errors, solver
from wavefarm.io import run_dir


def _mg_cfg(**over):
    base = dict(
        grid={"size": {"x": 32, "y": 32, "z": 32}, "dn": 0.2, "dt": 0.012},
        tolerance=1e-7,
        potential="Harmonic",
        init_condition="Gaussian",
        output={"screen_update": 100, "file_type": "Json"},
        max_steps=200000,
        seed=7,
    )
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            base[k].update(v)
        else:
            base[k] = v
    return base_config(**base)


def test_multigrid_config_validation():
    with pytest.raises(errors.ConfigParseError):  # non-divisor
        _mg_cfg(multigrid=[3])
    with pytest.raises(errors.ConfigParseError):  # not strictly decreasing
        _mg_cfg(multigrid=[2, 2])
    with pytest.raises(errors.ConfigParseError):  # coarse grid too small
        _mg_cfg(multigrid=[8])
    with pytest.raises(errors.ConfigParseError):  # divisor < 2
        _mg_cfg(multigrid=[1])
    with pytest.raises(errors.ConfigParseError):  # restart unsupported
        _mg_cfg(multigrid=[2], wavenum=1, wavemax=1)
    with pytest.raises(errors.ConfigParseError):  # looser than final tol
        _mg_cfg(multigrid=[2], multigrid_tolerance=1e-9)
    cfg = _mg_cfg(multigrid=[4, 2], multigrid_tolerance=1e-6)
    assert cfg.multigrid == [4, 2]


def test_multigrid_matches_direct_harmonic(tmp_run):
    """A [2]-schedule must converge to the same fine-grid eigenvalues as a
    direct run (the discretised operator is identical at the final level)
    while spending fewer fine-level steps — the upsampled coarse state is
    already converged up to the inter-level discretisation error."""
    run_dir.check_output_dir("test")
    direct = solver.run(_mg_cfg(wavemax=1))
    mg = solver.run(_mg_cfg(wavemax=1, multigrid=[2]))
    for rd, rm in zip(direct, mg):
        ed = rd.observables.energy / rd.observables.norm2
        em = rm.observables.energy / rm.observables.norm2
        # same fixed point of the same discretised operator
        assert abs(ed - em) < 5e-6, (rd.wnum, ed, em)
        # and reached in fewer fine-level steps
        assert rm.steps < rd.steps, (rd.wnum, rd.steps, rm.steps)


def test_multigrid_intermediate_levels_write_no_wavefunctions(tmp_run):
    """Intermediate levels must not leave coarse-size wavefunction or
    snapshot files; the final level honours the configured output."""
    import glob
    import json

    run_dir.check_output_dir("test")
    cfg = _mg_cfg(
        multigrid=[2],
        output={"save_wavefns": True, "snap_update": 200},
    )
    solver.run(cfg)
    d = run_dir.get_project_dir(cfg.project_name)
    wfs = glob.glob(d + "/wavefunction_0.*")
    assert len(wfs) == 1
    data = json.load(open(wfs[0]))
    assert data["dim"] == [32, 32, 32]  # final work size, not coarse
    assert not glob.glob(d + "/wavefunction_0_partial.*")


def test_multigrid_split_complex(tmp_run, monkeypatch):
    """Multigrid on the split-complex path: the (re, im) pair upsamples
    componentwise and converges to the complex-harmonic oracle."""
    from wavefarm.ops import split_complex as sc

    monkeypatch.setattr(sc, "backend_supports_complex", lambda: False)
    run_dir.check_output_dir("test")
    cfg = _mg_cfg(
        potential="ComplexHarmonic",
        absorb=0.2,
        grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.02},
        tolerance=1e-6,
        init_condition="Constant",
        multigrid=[2],
    )
    res = solver.run(cfg)[0]
    assert isinstance(res.phi, tuple)  # split pair all the way through
    e = res.observables.energy / res.observables.norm2
    assert abs(e - 1.5 * cmath.sqrt(1 + 0.2j)) < 0.05, e


def test_multigrid_sharded_final_level(tmp_run):
    """Multigrid + multi-device mesh: coarse levels solve single-device,
    the final level runs the sharded driver seeded with the upsampled
    state — same fine-grid fixed point as the unsharded multigrid run,
    reached in fewer fine-level steps than a direct sharded run.

    Regression note: this test originally flaked in full-suite runs —
    the sharded drivers ignored ``config.seed`` (the Gaussian IC fell
    back to os.urandom), so the direct sharded run's step count was
    random. run_sharded/run_sharded_split now default seed to
    config.seed like solver.solve; everything here is deterministic."""
    run_dir.check_output_dir("test")
    common = dict(
        grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.02},
        tolerance=1e-5,
        wavemax=1,
    )
    plain_mg = solver.run(_mg_cfg(multigrid=[2], **common))
    direct_sh = solver.run(_mg_cfg(mesh={"x": 2, "y": 1, "z": 1}, **common))
    sharded_mg = solver.run(
        _mg_cfg(multigrid=[2], mesh={"x": 2, "y": 1, "z": 1}, **common)
    )
    for r_p, r_d, r_s in zip(plain_mg, direct_sh, sharded_mg):
        e_p = r_p.observables.energy / r_p.observables.norm2
        e_s = r_s.observables.energy / r_s.observables.norm2
        assert abs(e_p - e_s) < 5e-5, (r_p.wnum, e_p, e_s)
        # the coarse seed must save fine-level (= sharded) steps
        assert r_s.steps < r_d.steps, (r_p.wnum, r_s.steps, r_d.steps)


def test_multigrid_sharded_split_complex(tmp_run, monkeypatch):
    """Multigrid hand-over into the sharded split-complex driver: the
    upsampled (re, im) pair seeds the final sharded level."""
    from wavefarm.ops import split_complex as sc

    monkeypatch.setattr(sc, "backend_supports_complex", lambda: False)
    run_dir.check_output_dir("test")
    cfg = _mg_cfg(
        potential="ComplexHarmonic",
        absorb=0.2,
        grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.02},
        tolerance=1e-6,
        init_condition="Constant",
        multigrid=[2],
        mesh={"x": 2, "y": 1, "z": 1},
    )
    res = solver.run(cfg)[0]
    e = res.observables.energy / res.observables.norm2
    assert abs(e - 1.5 * cmath.sqrt(1 + 0.2j)) < 0.05, e


def test_multigrid_from_file_potential(tmp_run):
    """Multigrid with a FromFile potential: coarse levels load the same
    file and trilerp-resample it to the level grid (readers._fill_data,
    reference resampler src/input.rs:149-176), so the ladder composes
    with every potential source."""
    import jax.numpy as jnp

    from wavefarm.io import formats
    from wavefarm.models import potentials as pmod

    run_dir.check_output_dir("test")
    cfg = _mg_cfg(
        grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.02},
        tolerance=1e-6,
    )
    # write the full-resolution harmonic V as the input file
    v = np.asarray(pmod.generate(cfg))
    ext = cfg.central_difference.ext
    with open("input/potential.json", "w") as fh:
        fh.write(formats.array_to_json(v[ext:-ext, ext:-ext, ext:-ext]))
    cfg_ff = _mg_cfg(
        grid={"size": {"x": 16, "y": 16, "z": 16}, "dn": 0.3, "dt": 0.02},
        tolerance=1e-6,
        potential="FromFile",
        multigrid=[2],
    )
    res = solver.run(cfg_ff)[0]
    e = res.observables.energy / res.observables.norm2
    # same fixed point as the analytic harmonic run at this resolution
    direct = solver.run(cfg)[0]
    e_ref = direct.observables.energy / direct.observables.norm2
    assert abs(e - e_ref) < 5e-5, (e, e_ref)


def test_upsample_state_shape_and_boundary():
    """_upsample_state re-frames with the zero Dirichlet shell and applies
    the target config's symmetry constraint on the fine grid."""
    import jax.numpy as jnp

    from wavefarm.models import initial

    cfg_plain = _mg_cfg()
    ext = cfg_plain.central_difference.ext
    n_c = 16 + 2 * ext
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.standard_normal((n_c, n_c, n_c)))
    out = solver._upsample_state(w, cfg_plain)
    n_f = 32 + 2 * ext
    assert out.shape == (n_f, n_f, n_f)
    # Dirichlet shell zeroed on all six faces
    assert float(jnp.abs(out[:ext]).max()) == 0.0
    assert float(jnp.abs(out[:, :, -ext:]).max()) == 0.0
    # a constant interior stays constant under the resampler
    wc = jnp.zeros((n_c, n_c, n_c)).at[ext:-ext, ext:-ext, ext:-ext].set(0.5)
    oc = solver._upsample_state(wc, cfg_plain)
    assert np.allclose(np.asarray(oc)[ext:-ext, ext:-ext, ext:-ext], 0.5)
    # the symmetry constraint is applied on the fine grid (exact parity
    # with models/initial.symmetrise_wavefunction)
    cfg_sym = _mg_cfg(init_symmetry="AntisymAboutZ")
    out_sym = solver._upsample_state(w, cfg_sym)
    expect = initial.symmetrise_wavefunction(cfg_sym, out)
    assert np.array_equal(np.asarray(out_sym), np.asarray(expect))
