"""Native C++ codec engine vs the pure-Python codecs."""

import time

import numpy as np
import pytest

from wavefarm import native
from wavefarm.io import formats


@pytest.fixture(scope="module")
def lib_ok():
    if not native.available():
        pytest.skip("native codec library unavailable (no g++?)")


def test_csv_roundtrip_native(lib_ok):
    rng = np.random.default_rng(0)
    arr = rng.normal(size=(7, 5, 9))
    text = native.csv_encode(arr)
    assert text is not None
    out = native.csv_decode(text)
    np.testing.assert_array_equal(out, arr)  # shortest round-trip is exact


def test_csv_native_matches_python_layout(lib_ok):
    arr = np.array([[[1.5, -2.0]], [[0.25, 1e-5]]])
    text_native = native.csv_encode(arr)
    # python fallback (bypass the fast path by using complex then realifying
    # is awkward — call the slow writer directly)
    import csv as _csv
    import io as _io

    buf = _io.StringIO()
    w = _csv.writer(buf, lineterminator="\n")
    for (i, j, k), v in np.ndenumerate(arr):
        w.writerow([i, j, k, repr(float(v))])
    assert text_native == buf.getvalue()


def test_csv_decode_cross(lib_ok):
    """Native decoder reads python-written text and vice versa."""
    rng = np.random.default_rng(1)
    arr = rng.normal(size=(4, 4, 4))
    out = formats.array_from_csv(formats.array_to_csv(arr))
    np.testing.assert_array_equal(out, arr)


def test_mpk_roundtrip_native(lib_ok):
    rng = np.random.default_rng(2)
    arr = rng.normal(size=(6, 3, 5))
    blob = native.mpk_encode(arr)
    assert blob is not None
    out = native.mpk_decode(blob)
    np.testing.assert_array_equal(out, arr)


def test_mpk_native_matches_msgpack_layout(lib_ok):
    import msgpack

    arr = np.arange(8.0).reshape(2, 2, 2)
    blob = native.mpk_encode(arr)
    obj = msgpack.unpackb(blob)
    assert obj == [1, [2, 2, 2], list(np.arange(8.0))]


def test_mpk_decode_python_written(lib_ok):
    import msgpack

    arr = np.linspace(-1, 1, 12).reshape(3, 2, 2)
    blob = msgpack.packb([1, [3, 2, 2], [float(v) for v in arr.reshape(-1)]])
    out = native.mpk_decode(blob)
    np.testing.assert_array_equal(out, arr)


def test_complex_still_works_via_python_path():
    arr = np.array([1 + 2j, -3 + 0.5j]).reshape(1, 1, 2)
    out = formats.array_from_csv(formats.array_to_csv(arr))
    np.testing.assert_array_equal(out, arr)
    out2 = formats.array_from_mpk(formats.array_to_mpk(arr))
    np.testing.assert_array_equal(out2, arr)


def test_native_throughput(lib_ok):
    """The native path must beat pure Python by a wide margin on big grids.

    Best-of-3 on both sides: single-shot wall times are load-dependent
    (the first native call also pays the ctypes symbol bind), and a loaded
    CI box once read native 0.28 s vs python 0.47 s on single shots.
    """
    rng = np.random.default_rng(3)
    arr = rng.normal(size=(64, 64, 64))

    t_native = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        text = native.csv_encode(arr)
        t_native = min(t_native, time.perf_counter() - t0)

    import csv as _csv
    import io as _io

    t_py = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        buf = _io.StringIO()
        w = _csv.writer(buf, lineterminator="\n")
        for (i, j, k), v in np.ndenumerate(arr):
            w.writerow([i, j, k, repr(float(v))])
        t_py = min(t_py, time.perf_counter() - t0)

    assert text == buf.getvalue()
    assert t_native < t_py / 2, (t_native, t_py)


def test_csv_decode_fills_in_file_order():
    """The reference fills CSV values in FILE order and reshapes
    (src/input.rs:617-635); indices only infer dims. The native fast path
    must agree with that and with the Python fallback for shuffled rows."""
    import numpy as np

    from wavefarm import native
    from wavefarm.io import formats

    rows = [
        (0, 0, 1, 2.0), (0, 0, 0, 1.0), (0, 1, 0, 3.0), (0, 1, 1, 4.0),
        (1, 0, 0, 5.0), (1, 0, 1, 6.0), (1, 1, 0, 7.0), (1, 1, 1, 8.0),
    ]
    text = "".join(f"{i},{j},{k},{v}\n" for i, j, k, v in rows)
    expected = np.array([r[3] for r in rows]).reshape(2, 2, 2)
    via_formats = formats.array_from_csv(text)
    assert np.array_equal(via_formats, expected)
    fast = native.csv_decode(text)
    if fast is not None:  # toolchain present
        assert np.array_equal(fast, expected)
