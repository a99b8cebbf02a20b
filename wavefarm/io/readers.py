"""Input-side file handling: wavefunctions, potentials, pot_sub.

Mirrors src/input.rs: five formats per quantity, multi-file arbitration by
the configured ``file_type`` (with a warning), ``_partial`` fallback for
wavefunctions, and trilinear resampling when on-disk dims differ from the
requested grid.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from wavefarm import errors
from wavefarm.config import Config, FileType
from wavefarm.io import formats
from wavefarm.io.trilerp import trilerp_resize

_EXTENSIONS = ("mpk", "csv", "json", "yaml", "ron")
_EXT_TO_TYPE = {
    "mpk": FileType.MESSAGEPACK,
    "csv": FileType.CSV,
    "json": FileType.JSON,
    "yaml": FileType.YAML,
    "ron": FileType.RON,
}


def _read_payload(path: str):
    mode = "rb" if path.endswith(".mpk") else "r"
    try:
        with open(path, mode) as fh:
            return fh.read()
    except OSError as exc:
        raise errors.FileNotFoundWaferError(path) from exc


def _decode_array(path: str) -> np.ndarray:
    payload = _read_payload(path)
    ext = path.rsplit(".", 1)[-1]
    ft = _EXT_TO_TYPE[ext]
    if ft is FileType.MESSAGEPACK:
        return formats.array_from_mpk(payload)
    if ft is FileType.CSV:
        return formats.array_from_csv(payload, path)
    if ft is FileType.JSON:
        return formats.array_from_json(payload)
    if ft is FileType.YAML:
        return formats.array_from_yaml(payload)
    return formats.array_from_ron(payload)


def _fill_data(path: str, data: np.ndarray, target_size, bb: int, log) -> np.ndarray:
    """Frame file data into a zero-halo padded array, resampling when the
    sizes differ (reference ``fill_data``, src/input.rs:149-176).

    Divergence from the reference, documented: for non-CSV formats the
    reference compares the file dims against the *padded* size and therefore
    always routes work-size files through ``trilerp_resize`` with a
    padded-size basis — a lossy resample even on exact-size restarts
    (src/input.rs:162-173 with the basis built at src/input.rs:673-675).
    CSV files take an exact-copy path (src/input.rs:640-656). We use the
    CSV semantics for every format: exact copy when the file matches the
    work size (or padded size), correct-basis trilinear resample otherwise.
    """
    ext = bb // 2
    work_size = tuple(t - bb for t in target_size)
    complete = np.zeros(target_size, dtype=data.dtype)
    if tuple(data.shape) == tuple(target_size):
        return data.copy()
    if tuple(data.shape) == work_size:
        if ext:
            complete[ext:-ext, ext:-ext, ext:-ext] = data
            return complete
        return data.copy()
    log.info(
        "Interpolating %s from %s to requested size of %s "
        "(size includes central difference padding).",
        path,
        tuple(data.shape),
        tuple(target_size),
    )
    resized = trilerp_resize(data, work_size)
    if ext:
        complete = np.zeros(target_size, dtype=resized.dtype)
        complete[ext:-ext, ext:-ext, ext:-ext] = resized
        return complete
    return resized


def _arbitrate(paths: dict, file_type: FileType, what: str, log) -> Optional[str]:
    """Pick a file when several formats exist (src/input.rs:81-110)."""
    present = [p for p in paths.values() if p is not None]
    if not present:
        return None
    if len(present) > 1:
        log.warning(
            "Multiple %s files found in input directory. Chosing '%s' based on "
            "configuration settings.",
            what,
            file_type.display(),
        )
        if paths[file_type] is not None:
            return paths[file_type]
    # single file, or configured format absent: priority order mpk, csv,
    # json, yaml, ron (reference: src/input.rs:98-108)
    for ft in (FileType.MESSAGEPACK, FileType.CSV, FileType.JSON, FileType.YAML, FileType.RON):
        if paths[ft] is not None:
            return paths[ft]
    return None


def _candidates(basenames: List[str], input_dir: str) -> dict:
    out = {}
    for ft in FileType:
        ext = ft.extension.lstrip(".")
        found = None
        for base in basenames:
            path = os.path.join(input_dir, f"{base}.{ext}")
            if os.path.exists(path):
                found = path
                break
        out[ft] = found
    return out


def potential(target_size, bb: int, file_type: FileType, log, input_dir="./input") -> np.ndarray:
    """Load ``input/potential.*`` (reference: src/input.rs:69-111)."""
    paths = _candidates(["potential"], input_dir)
    chosen = _arbitrate(paths, file_type, "potential", log)
    if chosen is None:
        raise errors.FileNotFoundWaferError(f"{input_dir}/potential.*")
    data = _decode_array(chosen)
    return _fill_data(chosen, data, tuple(target_size), bb, log)


def wavefunction(
    wnum: int, target_size, bb: int, file_type: FileType, log, input_dir="./input"
) -> np.ndarray:
    """Load ``input/wavefunction_{n}[_partial].*``
    (reference: src/input.rs:513-578). The converged file wins over the
    partial snapshot."""
    paths = _candidates(
        [f"wavefunction_{wnum}", f"wavefunction_{wnum}_partial"], input_dir
    )
    chosen = _arbitrate(paths, file_type, f"wavefunction_{wnum}", log)
    if chosen is None:
        raise errors.FileNotFoundWaferError(f"input/wavefunction_{wnum}*.*")
    data = _decode_array(chosen)
    return _fill_data(chosen, data, tuple(target_size), bb, log)


def load_wavefunctions(config: Config, log) -> List[np.ndarray]:
    """Load all converged states below ``wavenum``
    (reference: src/input.rs:487-505)."""
    out = []
    for wnum in range(config.wavenum):
        try:
            w = wavefunction(
                wnum,
                config.padded_size(),
                config.central_difference.bb,
                config.output.file_type,
                log,
                input_dir=config.input_dir,
            )
        except errors.WaferError as exc:
            raise errors.LoadWavefunctionError(wnum) from exc
        out.append(w)
        log.info("Loaded (previous) wavefunction %d from disk", wnum)
    return out


def potential_sub(
    target_size, file_type: FileType, log, input_dir="./input"
) -> Tuple[Optional[np.ndarray], Optional[float]]:
    """Load ``input/potential_sub.*`` as array or scalar
    (reference: src/input.rs:259-301,454-478). Arrays are resampled to the
    work size when dims mismatch."""
    paths = _candidates(["potential_sub"], input_dir)
    chosen = _arbitrate(paths, file_type, "potential_sub", log)
    if chosen is None:
        raise errors.FileNotFoundWaferError(f"{input_dir}/potential_sub.*")
    payload = _read_payload(chosen)
    ext = chosen.rsplit(".", 1)[-1]
    ft = _EXT_TO_TYPE[ext]
    arr, scalar = formats.sub_from_text(ft.value, payload)
    if arr is not None and tuple(arr.shape) != tuple(target_size):
        log.info(
            "Interpolating potential_sub from %s to requested size of %s.",
            tuple(arr.shape),
            tuple(target_size),
        )
        arr = trilerp_resize(arr, tuple(target_size))
    return arr, scalar
