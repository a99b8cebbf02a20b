"""Dual-drain structured logging.

The reference duplicates an always-full async file log
(``<run_dir>/simulation.log``) with a level-filtered terminal drain selected
by the ``-d`` flag count (src/main.rs:135-179). Python's logging handlers map
onto this directly.
"""

from __future__ import annotations

import logging
import sys

from wavefarm import errors

_FORMAT = "%(asctime)s %(levelname)s [%(name)s] %(message)s"


def setup_logging(log_location: str, debug_count: int = 0) -> logging.Logger:
    """File handler at DEBUG (full), stream handler filtered by ``-d`` count:
    0 → WARNING, 1 → INFO, ≥2 → DEBUG (reference: src/main.rs:160-171)."""
    log = logging.getLogger("wafer")
    log.setLevel(logging.DEBUG)
    log.handlers.clear()

    try:
        fh = logging.FileHandler(log_location, mode="w")
    except OSError as exc:
        raise errors.CreateLogError(log_location) from exc
    fh.setLevel(logging.DEBUG)
    fh.setFormatter(logging.Formatter(_FORMAT))
    log.addHandler(fh)

    sh = logging.StreamHandler(sys.stderr)
    sh.setLevel(
        logging.WARNING if debug_count == 0 else logging.INFO if debug_count == 1 else logging.DEBUG
    )
    sh.setFormatter(logging.Formatter(_FORMAT))
    log.addHandler(sh)
    return log


def screen_level_as_usize(debug_count: int) -> int:
    """slog level numbering the reference threads through ``solve`` to decide
    progress-bar display: Warning=3, Info=4, Debug=5
    (src/main.rs:160-164, src/grid.rs:105)."""
    return {0: 3, 1: 4}.get(debug_count, 5)
