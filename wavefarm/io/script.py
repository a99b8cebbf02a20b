"""Script-generated potentials: the one cross-process boundary.

Contract identical to the reference (src/input.rs:186-248, example
gen_potential.py:1-67): spawn the user executable, write
``{"grid": {"x", "y", "z", "dn"}}`` as JSON to its stdin, read one float per
line from stdout in x-major (i, j, k) order, reshape to the work size, and
frame with a zero halo.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np

from wavefarm import errors
from wavefarm.config import Grid


def script_potential(file: str, grid: Grid, bb: int, log) -> np.ndarray:
    target_size = (grid.size.x + bb, grid.size.y + bb, grid.size.z + bb)
    log.info("Generating potential from script file: %s", file)

    payload = json.dumps(
        {"grid": {"x": grid.size.x, "y": grid.size.y, "z": grid.size.z, "dn": grid.dn}}
    )
    try:
        proc = subprocess.Popen(
            [file], stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True
        )
    except OSError as exc:
        raise errors.SpawnScriptError() from exc
    try:
        stdout, _ = proc.communicate(payload)
    except BrokenPipeError as exc:
        raise errors.StdInError() from exc
    except OSError as exc:
        raise errors.StdOutError() from exc

    values = []
    for line in stdout.splitlines():
        if not line.strip():
            continue
        try:
            values.append(float(line))
        except ValueError as exc:
            raise errors.ParseFloatError() from exc

    shape = (grid.size.x, grid.size.y, grid.size.z)
    if len(values) != shape[0] * shape[1] * shape[2]:
        raise errors.ArrayShapeError(len(values), shape)
    generated = np.array(values, dtype=np.float64).reshape(shape)

    ext = bb // 2
    complete = np.zeros(target_size, dtype=np.float64)
    if ext:
        complete[ext:-ext, ext:-ext, ext:-ext] = generated
    else:
        complete = generated
    return complete
