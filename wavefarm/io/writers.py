"""Output-side file handling: arrays, pot_sub, observables, snapshots.

Mirrors src/output.rs:85-419,533-677: every quantity writes in the configured
format into the per-run project directory; unconverged wavefunctions get a
``_partial`` suffix which is removed once the state converges.
"""

from __future__ import annotations

import os
import numpy as np

from wavefarm import errors
from wavefarm.config import Config, FileType
from wavefarm.io import formats
from wavefarm.io.run_dir import get_project_dir


def _write(path: str, payload) -> None:
    mode = "wb" if isinstance(payload, (bytes, bytearray)) else "w"
    try:
        with open(path, mode) as fh:
            fh.write(payload)
    except OSError as exc:
        raise errors.CreateFileError(path) from exc


def _encode_array(arr: np.ndarray, file_type: FileType):
    if file_type is FileType.MESSAGEPACK:
        return formats.array_to_mpk(arr)
    if file_type is FileType.CSV:
        return formats.array_to_csv(arr)
    if file_type is FileType.JSON:
        return formats.array_to_json(arr)
    if file_type is FileType.YAML:
        return formats.array_to_yaml(arr)
    return formats.array_to_ron(arr)


def potential(v: np.ndarray, project: str, file_type: FileType, output_root="./output") -> None:
    """Save the potential work area (reference: src/output.rs:85-98)."""
    path = f"{get_project_dir(project, output_root)}/potential{file_type.extension}"
    _write(path, _encode_array(np.asarray(v), file_type))


def potential_sub(config: Config) -> None:
    """Save pot_sub — array for FullCornell, scalar when positive, nothing
    otherwise (reference: src/output.rs:100-141)."""
    from wavefarm.models import potentials as pmod

    file_type = config.output.file_type
    path = (
        f"{get_project_dir(config.project_name, config.output_root)}/"
        f"potential_sub{file_type.extension}"
    )
    if config.potential.variable_pot_sub:
        arr = np.asarray(pmod.potential_sub_array(config))
        _write(path, _encode_array(arr, file_type))
    else:
        val = pmod.potential_sub_scalar(config)
        if val > 0.0:
            _write(path, formats.sub_single_to(file_type.value, val))


def wavefunction(
    phi: np.ndarray,
    num: int,
    converged: bool,
    project: str,
    file_type: FileType,
    output_root="./output",
) -> None:
    """Save a wavefunction work area; ``_partial`` marks unconverged
    snapshots (reference: src/output.rs:379-400)."""
    suffix = "" if converged else "_partial"
    path = (
        f"{get_project_dir(project, output_root)}/"
        f"wavefunction_{num}{suffix}{file_type.extension}"
    )
    _write(path, _encode_array(np.asarray(phi), file_type))


def remove_partial(wnum: int, project: str, file_type: FileType, output_root="./output") -> None:
    """Delete the ``_partial`` snapshot after convergence
    (reference: src/output.rs:402-419)."""
    path = (
        f"{get_project_dir(project, output_root)}/"
        f"wavefunction_{wnum}_partial{file_type.extension}"
    )
    try:
        os.remove(path)
    except OSError as exc:
        raise errors.DeletePartialError(wnum) from exc


def finalise_measurement(
    observables,
    wnum: int,
    numx: float,
    project: str,
    file_type: FileType,
    output_root="./output",
) -> dict:
    """Final per-state summary: normalised energy, binding energy, r_rms and
    L/r_rms, printed and saved (reference: src/output.rs:533-558)."""
    from wavefarm.utils import terminal

    r_norm = float(np.sqrt(observables.r2 / observables.norm2))
    energy = observables.energy / observables.norm2
    binding = (observables.energy - observables.v_infinity) / observables.norm2
    out = {
        "state": wnum,
        "energy": energy.real if isinstance(energy, complex) else energy,
        "binding_energy": binding.real if isinstance(binding, complex) else binding,
        "r": r_norm,
        "l_r": numx / r_norm,
    }
    if isinstance(energy, complex) and energy.imag != 0.0:
        out["energy_im"] = energy.imag

    terminal.print_summary(out)

    path = (
        f"{get_project_dir(project, output_root)}/observables_{wnum}{file_type.extension}"
    )
    try:
        _write(path, formats.observables_to(file_type.value, out))
    except errors.WaferError as exc:
        raise errors.SaveObservablesError() from exc
    return out
