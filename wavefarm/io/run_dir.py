"""Run directory management and provenance.

Every run gets ``./output/{sanitized_project}_{YYYY-MM-DD_HH:MM:SS}`` with the
config file copied in (reference: src/output.rs:24-30,679-706,722-745). The
timestamp is fixed at first use per process, like the reference's
``lazy_static PROJDATE``.
"""

from __future__ import annotations

import os
import shutil
from datetime import datetime

from wavefarm import errors

_PROJDATE: str | None = None


def proj_date() -> str:
    global _PROJDATE
    if _PROJDATE is None:
        _PROJDATE = datetime.now().strftime("%Y-%m-%d_%H:%M:%S")
    return _PROJDATE


def reset_proj_date() -> None:
    """Testing hook: forget the cached timestamp."""
    global _PROJDATE
    _PROJDATE = None


def sanitize_string(component: str) -> str:
    """Filename-safe project names (reference: src/output.rs:722-745):
    letters/digits/-/_/. pass through (no leading '.'), spaces become '_',
    anything else becomes ``,{codepoint},``."""
    out = []
    for i, c in enumerate(component):
        is_letter = ("a" <= c <= "z") or ("A" <= c <= "Z")
        is_number = "0" <= c <= "9"
        is_valid = is_letter or is_number or c in "-_" or (c == "." and i != 0)
        if is_valid:
            out.append(c)
        elif c == " ":
            out.append("_")
        else:
            out.append(f",{ord(c)},")
    return "".join(out)


def get_project_dir(project: str, output_root: str = "./output") -> str:
    return f"{output_root}/{sanitize_string(project)}_{proj_date()}"


def check_output_dir(project: str, output_root: str = "./output") -> None:
    proj_dir = get_project_dir(project, output_root)
    try:
        os.makedirs(proj_dir, exist_ok=True)
    except OSError as exc:
        raise errors.CreateOutputDirError(proj_dir) from exc


def copy_config(project: str, file: str, output_root: str = "./output") -> None:
    dest = get_project_dir(project, output_root) + "/" + os.path.basename(file)
    try:
        shutil.copy(file, dest)
    except OSError as exc:
        raise errors.CopyConfigError(file) from exc


def check_input_dir(input_dir: str = "./input") -> None:
    """Create ``./input`` if missing (reference: src/input.rs:583-588)."""
    if not os.path.exists(input_dir):
        try:
            os.makedirs(input_dir)
        except OSError as exc:
            raise errors.CreateInputDirError() from exc
