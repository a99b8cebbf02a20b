"""ctypes bindings for the native I/O codec engine (wafer_native.cpp).

The shared library is built from ``src/wafer_native.cpp`` with g++ at first
use (or by ``make native``) into ``build/`` next to this file, which is not
under version control. Every entry point degrades to the pure-Python codecs
in io/formats.py when the toolchain or library is unavailable, logging that
once, so the framework never hard-depends on a compiled artefact.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "wafer_native.cpp")
_LIB_PATH = os.path.join(_DIR, "build", "libwafer_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    """Compile the library; concurrent builders each write their own
    temporary file and rename it into place atomically."""
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
        res = subprocess.run(
            [
                "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
                _SRC, "-o", tmp,
            ],
            capture_output=True,
            timeout=120,
        )
        if res.returncode != 0:
            return False
        os.replace(tmp, _LIB_PATH)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _fallback(reason: str) -> None:
    logging.getLogger("wafer").info(
        "native codec library unavailable (%s); using the pure-Python "
        "codecs", reason,
    )


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_LIB_PATH)
        ):
            if not _build():
                _fallback(f"g++ could not build {_LIB_PATH}")
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as exc:
            _fallback(str(exc))
            return None

        lib.wafer_free.argtypes = [ctypes.c_void_p]
        lib.wafer_csv_encode.restype = ctypes.c_void_p
        lib.wafer_csv_encode.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.wafer_csv_decode.restype = ctypes.c_int
        lib.wafer_csv_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.wafer_mpk_encode.restype = ctypes.c_void_p
        lib.wafer_mpk_encode.argtypes = lib.wafer_csv_encode.argtypes
        lib.wafer_mpk_decode.restype = ctypes.c_int
        lib.wafer_mpk_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def csv_encode(arr: np.ndarray) -> Optional[str]:
    """PlainRecord CSV text for a real 3D array, or None if unavailable."""
    lib = _load()
    if lib is None or np.iscomplexobj(arr) or arr.ndim != 3:
        return None
    data = np.ascontiguousarray(arr, dtype=np.float64)
    out_len = ctypes.c_int64()
    ptr = lib.wafer_csv_encode(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        *data.shape,
        ctypes.byref(out_len),
    )
    if not ptr:
        return None
    try:
        return ctypes.string_at(ptr, out_len.value).decode("ascii")
    finally:
        lib.wafer_free(ptr)


def csv_decode(text: str) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    raw = text.encode("ascii", errors="ignore")
    ijk = ctypes.POINTER(ctypes.c_int64)()
    vals = ctypes.POINTER(ctypes.c_double)()
    n = ctypes.c_int64()
    rc = lib.wafer_csv_decode(raw, len(raw), ctypes.byref(ijk), ctypes.byref(vals), ctypes.byref(n))
    if rc != 0:
        return None
    try:
        count = n.value
        if count == 0:
            return None
        idx = np.ctypeslib.as_array(ijk, shape=(count, 3)).copy()
        vv = np.ctypeslib.as_array(vals, shape=(count,)).copy()
    finally:
        lib.wafer_free(ctypes.cast(ijk, ctypes.c_void_p))
        lib.wafer_free(ctypes.cast(vals, ctypes.c_void_p))
    dims = idx.max(axis=0) + 1
    if count != int(np.prod(dims)):
        return None
    # Fill in FILE order, like the reference (src/input.rs:617-635 pushes
    # values and reshapes) and the Python fallback (formats.array_from_csv):
    # indices only infer the dims. Scattering by (i,j,k) would disagree for
    # rows not in row-major order.
    return vv.reshape(tuple(dims))


def mpk_encode(arr: np.ndarray) -> Optional[bytes]:
    lib = _load()
    if lib is None or np.iscomplexobj(arr) or arr.ndim != 3:
        return None
    data = np.ascontiguousarray(arr, dtype=np.float64)
    out_len = ctypes.c_int64()
    ptr = lib.wafer_mpk_encode(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        *data.shape,
        ctypes.byref(out_len),
    )
    if not ptr:
        return None
    try:
        return ctypes.string_at(ptr, out_len.value)
    finally:
        lib.wafer_free(ptr)


def mpk_decode(blob: bytes) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    dims = (ctypes.c_int64 * 3)()
    vals = ctypes.POINTER(ctypes.c_double)()
    n = ctypes.c_int64()
    rc = lib.wafer_mpk_decode(blob, len(blob), dims, ctypes.byref(vals), ctypes.byref(n))
    if rc != 0:
        return None
    try:
        vv = np.ctypeslib.as_array(vals, shape=(n.value,)).copy()
    finally:
        lib.wafer_free(ctypes.cast(vals, ctypes.c_void_p))
    return vv.reshape(tuple(dims))
