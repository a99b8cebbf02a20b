"""MessagePack codec for the types the solver's files use.

Encodes and decodes nil, bool, int, float64, str, array and map, byte for
byte as ``msgpack.packb(obj)`` does with its defaults (smallest integer
form, float64 floats, str8 for 32–255-byte strings), which is also what the
reference's rmp-serde writer emits for these types (src/output.rs). The
decoder also reads float32 and maps with any scalar keys. A homogeneous
float64 array — the ``data`` field of an Array3 — is encoded and decoded in
bulk through NumPy.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np


class MsgpackError(ValueError):
    """Malformed or unsupported MessagePack input."""


_F64_ITEM = np.dtype([("tag", "u1"), ("v", ">f8")])


def _len_header(n: int, fix_base: int, fix_max: int, c16: int, c32: int) -> bytes:
    if n < fix_max:
        return bytes([fix_base | n])
    if n < 1 << 16:
        return struct.pack(">BH", c16, n)
    return struct.pack(">BI", c32, n)


def _pack_int(n: int) -> bytes:
    if 0 <= n < 128:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, fmt, bits in ((0xCC, "B", 8), (0xCD, "H", 16),
                                (0xCE, "I", 32), (0xCF, "Q", 64)):
            if n < 1 << bits:
                return struct.pack(">B" + fmt, code, n)
    else:
        for code, fmt, bits in ((0xD0, "b", 8), (0xD1, "h", 16),
                                (0xD2, "i", 32), (0xD3, "q", 64)):
            if n >= -(1 << (bits - 1)):
                return struct.pack(">B" + fmt, code, n)
    raise MsgpackError(f"integer {n} does not fit in 64 bits")


def _pack_f64_array(values: np.ndarray) -> bytes:
    items = np.empty(values.size, _F64_ITEM)
    items["tag"] = 0xCB
    items["v"] = values
    return _len_header(values.size, 0x90, 16, 0xDC, 0xDD) + items.tobytes()


def _pack(obj: Any, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, (int, np.integer)):
        out.append(_pack_int(int(obj)))
    elif isinstance(obj, (float, np.floating)):
        out.append(struct.pack(">Bd", 0xCB, float(obj)))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        if n < 32:
            out.append(bytes([0xA0 | n]))
        elif n < 1 << 8:
            out.append(struct.pack(">BB", 0xD9, n))
        elif n < 1 << 16:
            out.append(struct.pack(">BH", 0xDA, n))
        else:
            out.append(struct.pack(">BI", 0xDB, n))
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        if len(obj) > 16 and all(type(x) is float for x in obj):
            out.append(_pack_f64_array(np.asarray(obj, np.float64)))
            return
        out.append(_len_header(len(obj), 0x90, 16, 0xDC, 0xDD))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        out.append(_len_header(len(obj), 0x80, 16, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """Serialise ``obj``."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, blob: bytes):
        self.b = memoryview(blob)
        self.i = 0

    def take(self, n: int) -> memoryview:
        if self.i + n > len(self.b):
            raise MsgpackError("truncated MessagePack input")
        v = self.b[self.i : self.i + n]
        self.i += n
        return v

    def unpack(self, fmt: str) -> Tuple:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))

    def array(self, n: int) -> list:
        # bulk path: n float64 items, each 0xcb + 8 bytes big-endian
        end = self.i + 9 * n
        if n > 16 and end <= len(self.b):
            items = np.frombuffer(self.b[self.i : end], _F64_ITEM)
            if np.all(items["tag"] == 0xCB):
                self.i = end
                return items["v"].astype(np.float64).tolist()
        return [self.obj() for _ in range(n)]

    def mapping(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def obj(self) -> Any:
        (c,) = self.unpack(">B")
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.mapping(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return self.array(c & 0x0F)
        if 0xA0 <= c <= 0xBF:
            return bytes(self.take(c & 0x1F)).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        fixed = {
            0xCA: ">f", 0xCB: ">d",
            0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if c in fixed:
            return self.unpack(fixed[c])[0]
        sized = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if c in sized:
            (n,) = self.unpack(sized[c])
            return bytes(self.take(n)).decode("utf-8")
        if c in (0xDC, 0xDD):
            (n,) = self.unpack(">H" if c == 0xDC else ">I")
            return self.array(n)
        if c in (0xDE, 0xDF):
            (n,) = self.unpack(">H" if c == 0xDE else ">I")
            return self.mapping(n)
        raise MsgpackError(f"unsupported MessagePack type byte 0x{c:02x}")


def unpackb(blob: bytes) -> Any:
    """Deserialise one MessagePack object occupying all of ``blob``."""
    r = _Reader(bytes(blob))
    obj = r.obj()
    if r.i != len(r.b):
        raise MsgpackError("trailing bytes after MessagePack object")
    return obj
