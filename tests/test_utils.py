"""Host utilities: logging drains, terminal UX, ordinals."""

import logging
import os

from wavefarm.ops.observables import Observables
from wavefarm.utils import logging as wlog
from wavefarm.utils import terminal


def test_dual_drain_logging(tmp_path):
    """File drain gets everything; screen drain is level-filtered
    (reference: src/main.rs:135-179)."""
    log_path = str(tmp_path / "simulation.log")
    log = wlog.setup_logging(log_path, debug_count=0)
    log.debug("debug-msg")
    log.info("info-msg")
    log.warning("warn-msg")
    for h in log.handlers:
        h.flush()
    content = open(log_path).read()
    assert "debug-msg" in content and "info-msg" in content and "warn-msg" in content
    # screen handler at WARNING for -d count 0
    stream_handlers = [
        h for h in log.handlers if isinstance(h, logging.StreamHandler)
        and not isinstance(h, logging.FileHandler)
    ]
    assert stream_handlers[0].level == logging.WARNING
    log.handlers.clear()


def test_screen_level_mapping():
    """slog level numbering: Warning=3, Info=4, Debug=5 (src/main.rs:160-164)."""
    assert wlog.screen_level_as_usize(0) == 3
    assert wlog.screen_level_as_usize(1) == 4
    assert wlog.screen_level_as_usize(2) == 5
    assert wlog.screen_level_as_usize(7) == 5


def test_ordinals():
    assert terminal.ordinal(1) == "1st"
    assert terminal.ordinal(2) == "2nd"
    assert terminal.ordinal(3) == "3rd"
    assert terminal.ordinal(4) == "4th"
    assert terminal.ordinal(11) == "11th"
    assert terminal.ordinal(12) == "12th"
    assert terminal.ordinal(21) == "21st"
    assert terminal.ordinal(103) == "103rd"


def test_term_size_bounds():
    """(reference test: src/output.rs:752-756)"""
    w = terminal.get_term_size()
    assert 70 <= w <= 100


def test_measurement_row_formats():
    obs = Observables(energy=1.5, norm2=1.0, v_infinity=0.0, r2=4.0)
    row0 = terminal.print_measurements(0.0, 1e-3, obs)
    assert "--" in row0  # first row prints no difference (src/output.rs:511-520)
    row = terminal.print_measurements(0.5, 1e-3, obs)
    assert "1.0000000000e+00" in row or "1.5" in row
    assert "1.00000e-03" in row


def test_complex_energy_row():
    obs = Observables(energy=1.5 + 0.2j, norm2=1.0, v_infinity=0.0, r2=4.0)
    row = terminal.print_measurements(0.5, 1e-3, obs)
    assert "1.5" in row  # real part displayed


def test_banner_smoke(capsys):
    terminal.print_banner("abc1234", 8, "gpu")
    out = capsys.readouterr().out
    assert "abc1234" in out
    assert "8 gpus" in out


def test_git_sha_runs():
    sha = terminal.git_sha()
    assert isinstance(sha, str) and len(sha) >= 4


