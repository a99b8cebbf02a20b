"""Process set-up shared by the launch scripts: the persistent compile
cache and the identity of the device a run measures on."""

from __future__ import annotations

import os
import subprocess

# The checkout root: the directory holding the ``wavefarm`` package.
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at one fixed directory and
    return it; call before the first compile.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
    no other directory is set here. Otherwise the cache lives at
    ``<checkout>/.jax_cache``. The path is part of the cache's key, so it is
    never derived from a temporary name, a pid or the time."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_identity() -> str:
    """``name, power.limit`` of each NVIDIA card as ``nvidia-smi`` reports
    them (a card set below its maximum power runs slower under load, so
    every measurement names both). Raises when nvidia-smi is missing or
    fails: a measurement must not go unlabelled."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return out.stdout.strip()


def require_gpu():
    """The first JAX device, which must be a GPU; raises ``SystemExit``
    with a non-zero code otherwise (measurement paths never fall back to
    the CPU)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU found: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind}); this script measures the GPU only"
        )
    return dev
