"""Multi-host entry: ``jax.distributed`` initialization.

The reference's ancestry is MPI Cartesian decomposition across nodes
(src/main.rs:10-14); its shipped code is single-process
(src/grid.rs:551). The multi-host counterpart here is
``jax.distributed.initialize`` — one process per host, all
devices visible as one ``jax.devices()`` list that the hierarchical
multi-slice mesh factorises process-major (parallel/multislice.py).

Driven by environment (so the CLI stays single-binary-style):

- ``WAFER_COORDINATOR``      host:port of process 0 (presence enables)
- ``WAFER_NUM_PROCESSES``    total process count
- ``WAFER_PROCESS_ID``       this process's rank

JAX's own autodetection (cluster metadata, ``JAX_COORDINATOR_ADDRESS``…)
still applies when these are unset and the user calls
``jax.distributed.initialize()`` themselves. Single-process runs (and the
virtual-CPU test mesh) never set the variables, so this is a no-op there.
"""

from __future__ import annotations

import os
from typing import Optional


def maybe_initialize_distributed(log=None) -> bool:
    """Initialize ``jax.distributed`` from ``WAFER_COORDINATOR`` /
    ``WAFER_NUM_PROCESSES`` / ``WAFER_PROCESS_ID``. Returns True when a
    multi-process runtime was started, False when the env is unset
    (single-process no-op). Must run before any JAX backend initialises."""
    coord = os.environ.get("WAFER_COORDINATOR")
    if not coord:
        return False
    import logging

    log = log or logging.getLogger("wafer")
    num = os.environ.get("WAFER_NUM_PROCESSES")
    pid = os.environ.get("WAFER_PROCESS_ID")
    kwargs = {"coordinator_address": coord}
    if num is not None:
        kwargs["num_processes"] = int(num)
    if pid is not None:
        kwargs["process_id"] = int(pid)
    import jax

    jax.distributed.initialize(**kwargs)
    log.info(
        "jax.distributed initialized: process %d/%d, coordinator %s",
        jax.process_index(), jax.process_count(), coord,
    )
    return True
