"""Serialisation codecs for the five file formats.

The on-disk layouts are serde-compatible with the reference:

* **Array3** (ndarray + serde, used for ψ, V, array pot_sub):
  - JSON/YAML: mapping ``{"v": 1, "dim": [x, y, z], "data": [flat...]}``
  - MessagePack (rmp-serde compact): array ``[1, [x, y, z], [flat...]]``
  - RON: ``(v: 1, dim: (x, y, z), data: [flat...])``
  - CSV: headerless ``i,j,k,data`` rows in row-major order
    (reference PlainRecord: src/output.rs:47-58, src/input.rs:19-30)
* **PotentialSubSingle**: struct with one ``pot_sub`` field
  (src/potential.rs:27-33); CSV is the bare number.
* **ObservablesOutput**: struct ``{state, energy, binding_energy, r, l_r}``
  (src/output.rs:32-45); CSV carries a header row (csv::Writer default).

Complex arrays (a capability the reference lacks) are stored with ``data``
entries as ``[re, im]`` pairs; readers accept both forms.
"""

from __future__ import annotations

import csv as _csv
import io as _io
import json as _json
import re as _re
from typing import Optional, Tuple

import numpy as np

from wavefarm import errors
from wavefarm.io import msgpack_codec as msgpack
from wavefarm.io import yaml_subset as _yaml

# --------------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------------- #


def _num(x):
    """Compact, round-trippable scalar for text formats."""
    if isinstance(x, (np.floating, float)):
        return float(x)
    if isinstance(x, (np.integer, int)):
        return int(x)
    return x


def _flat_data(arr: np.ndarray):
    flat = np.asarray(arr).reshape(-1)
    if np.iscomplexobj(flat):
        return [[float(v.real), float(v.imag)] for v in flat]
    return [float(v) for v in flat]


def _parse_data(data, dim) -> np.ndarray:
    n = int(np.prod(dim))
    if len(data) != n:
        raise errors.ArrayShapeError(len(data), dim)
    if data and isinstance(data[0], (list, tuple)):
        vals = np.array([complex(d[0], d[1]) for d in data], dtype=np.complex128)
    else:
        vals = np.array([float(d) for d in data], dtype=np.float64)
    return vals.reshape(dim)


# --------------------------------------------------------------------------- #
# Array3
# --------------------------------------------------------------------------- #


def array_to_json(arr: np.ndarray) -> str:
    obj = {"v": 1, "dim": list(arr.shape), "data": _flat_data(arr)}
    return _json.dumps(obj, indent=2)


def array_from_json(text: str) -> np.ndarray:
    try:
        obj = _json.loads(text)
        return _parse_data(obj["data"], obj["dim"])
    except errors.WaferError:
        raise
    except Exception as exc:
        raise errors.DeserializeError() from exc


def array_to_yaml(arr: np.ndarray) -> str:
    obj = {"v": 1, "dim": list(arr.shape), "data": _flat_data(arr)}
    return _yaml.dumps(obj)


def array_from_yaml(text: str) -> np.ndarray:
    try:
        obj = _yaml.loads(text)
        return _parse_data(obj["data"], obj["dim"])
    except errors.WaferError:
        raise
    except Exception as exc:
        raise errors.DeserializeError() from exc


def array_to_mpk(arr: np.ndarray) -> bytes:
    from wavefarm import native

    fast = native.mpk_encode(np.asarray(arr))
    if fast is not None:
        return fast
    return msgpack.packb([1, list(arr.shape), _flat_data(arr)])


def array_from_mpk(blob: bytes) -> np.ndarray:
    from wavefarm import native

    fast = native.mpk_decode(blob)
    if fast is not None:
        return fast
    try:
        obj = msgpack.unpackb(blob)
        if isinstance(obj, dict):  # tolerate named-field packing
            return _parse_data(obj["data"], obj["dim"])
        v, dim, data = obj
        return _parse_data(data, dim)
    except errors.WaferError:
        raise
    except Exception as exc:
        raise errors.DeserializeError() from exc


def array_to_ron(arr: np.ndarray) -> str:
    dim = ", ".join(str(d) for d in arr.shape)
    parts = []
    for v in np.asarray(arr).reshape(-1):
        if np.iscomplexobj(arr):
            parts.append(f"({_ron_num(v.real)}, {_ron_num(v.imag)})")
        else:
            parts.append(_ron_num(v))
    data = ",\n        ".join(parts)
    return (
        "(\n    v: 1,\n    dim: ({dim},),\n    data: [\n        {data},\n    ],\n)".format(
            dim=dim, data=data
        )
    )


def _ron_num(v) -> str:
    s = repr(float(v))
    return s


_RON_TOKEN = _re.compile(
    r"""
    (?P<ident>[A-Za-z_][A-Za-z0-9_]*) |
    (?P<num>[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?) |
    (?P<punct>[()\[\]:,{}])
    """,
    _re.VERBOSE,
)


def _ron_tokens(text: str):
    pos = 0
    # strip comments
    text = _re.sub(r"//[^\n]*", "", text)
    for m in _RON_TOKEN.finditer(text):
        yield m.lastgroup, m.group(0)


class _RonParser:
    """Minimal RON reader covering the subset the reference emits: structs
    ``(field: value, ...)``, tuples/seqs ``(...)``/``[...]``, numbers,
    identifiers (bools / unit variants)."""

    def __init__(self, text: str):
        self.toks = list(_ron_tokens(text))
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def parse(self):
        kind, val = self.peek()
        if kind == "punct" and val == "(":
            return self._paren()
        if kind == "punct" and val == "[":
            return self._seq("]")
        if kind == "num":
            self.next()
            return float(val) if _re.search(r"[.eE]", val) else int(val)
        if kind == "ident":
            self.next()
            if val == "true":
                return True
            if val == "false":
                return False
            # struct name prefix: Name( ... )
            k2, v2 = self.peek()
            if k2 == "punct" and v2 == "(":
                return self._paren()
            return val
        raise errors.DeserializeError()

    def _paren(self):
        self.next()  # consume '('
        # struct (field: value, ...) or tuple (a, b, ...)
        items = []
        fields = {}
        is_struct = False
        while True:
            kind, val = self.peek()
            if kind is None:
                raise errors.DeserializeError()
            if kind == "punct" and val == ")":
                self.next()
                break
            if kind == "ident":
                # lookahead for ':'
                save = self.i
                self.next()
                k2, v2 = self.peek()
                if k2 == "punct" and v2 == ":":
                    self.next()
                    fields[val] = self.parse()
                    is_struct = True
                else:
                    self.i = save
                    items.append(self.parse())
            else:
                items.append(self.parse())
            k3, v3 = self.peek()
            if k3 == "punct" and v3 == ",":
                self.next()
        return fields if is_struct else items

    def _seq(self, closer):
        self.next()  # consume '['
        items = []
        while True:
            kind, val = self.peek()
            if kind is None:
                raise errors.DeserializeError()
            if kind == "punct" and val == closer:
                self.next()
                break
            items.append(self.parse())
            k2, v2 = self.peek()
            if k2 == "punct" and v2 == ",":
                self.next()
        return items


def ron_loads(text: str):
    return _RonParser(text).parse()


def array_from_ron(text: str) -> np.ndarray:
    obj = ron_loads(text)
    if not isinstance(obj, dict) or "data" not in obj or "dim" not in obj:
        raise errors.DeserializeError()
    return _parse_data(obj["data"], obj["dim"])


def array_to_csv(arr: np.ndarray) -> str:
    """Headerless ``i,j,k,data`` rows (complex: ``i,j,k,re,im``)."""
    from wavefarm import native

    fast = native.csv_encode(np.asarray(arr))
    if fast is not None:
        return fast
    buf = _io.StringIO()
    w = _csv.writer(buf, lineterminator="\n")
    a = np.asarray(arr)
    cplx = np.iscomplexobj(a)
    for (i, j, k), v in np.ndenumerate(a):
        if cplx:
            w.writerow([i, j, k, _fmt_float(v.real), _fmt_float(v.imag)])
        else:
            w.writerow([i, j, k, _fmt_float(v)])
    return buf.getvalue()


def _fmt_float(v: float) -> str:
    return repr(float(v))


def array_from_csv(text: str, path: str = "<csv>") -> np.ndarray:
    """Sparse PlainRecord parse with inferred dims
    (reference: src/input.rs:607-662)."""
    from wavefarm import native

    first = text.partition("\n")[0]
    # native path: real-valued 4-field records only (complex rows have 5
    # fields whose imaginary part the fast scanner would drop)
    if first.count(",") == 3 and ",nan" not in text:
        fast = native.csv_decode(text)
        if fast is not None:
            return fast
    max_i = max_j = max_k = 0
    data = []
    cplx = False
    reader = _csv.reader(_io.StringIO(text))
    for row in reader:
        if not row:
            continue
        try:
            i, j, k = int(row[0]), int(row[1]), int(row[2])
            if len(row) >= 5:
                val = complex(float(row[3]), float(row[4]))
                cplx = True
            else:
                val = float(row[3])
        except (ValueError, IndexError) as exc:
            raise errors.ParsePlainRecordError(path) from exc
        max_i, max_j, max_k = max(max_i, i), max(max_j, j), max(max_k, k)
        data.append(val)
    dims = (max_i + 1, max_j + 1, max_k + 1)
    if len(data) != dims[0] * dims[1] * dims[2]:
        raise errors.ArrayShapeError(len(data), dims)
    dtype = np.complex128 if cplx else np.float64
    return np.array(data, dtype=dtype).reshape(dims)


# --------------------------------------------------------------------------- #
# PotentialSubSingle (scalar pot_sub)
# --------------------------------------------------------------------------- #


def sub_single_to(file_type: str, value: float):
    if file_type == "Json":
        return _json.dumps({"pot_sub": _num(value)}, indent=2)
    if file_type == "Yaml":
        return _yaml.dumps({"pot_sub": _num(value)})
    if file_type == "Ron":
        return f"(\n    pot_sub: {_ron_num(value)},\n)"
    if file_type == "Csv":
        return f"{_fmt_float(value)}\n"
    if file_type == "Messagepack":
        return msgpack.packb([float(value)])
    raise ValueError(file_type)


def sub_from_text(file_type: str, payload) -> Tuple[Optional[np.ndarray], Optional[float]]:
    """Array-or-scalar pot_sub load (reference read_sub_*:
    src/input.rs:303-451): try the full array first, fall back to a single
    value."""
    try:
        if file_type == "Json":
            return array_from_json(payload), None
        if file_type == "Yaml":
            return array_from_yaml(payload), None
        if file_type == "Ron":
            return array_from_ron(payload), None
        if file_type == "Csv":
            return array_from_csv(payload), None
        if file_type == "Messagepack":
            return array_from_mpk(payload), None
    except errors.WaferError:
        pass
    # scalar fallback
    try:
        if file_type == "Json":
            return None, float(_json.loads(payload)["pot_sub"])
        if file_type == "Yaml":
            return None, float(_yaml.loads(payload)["pot_sub"])
        if file_type == "Ron":
            obj = ron_loads(payload)
            return None, float(obj["pot_sub"])
        if file_type == "Csv":
            return None, float(str(payload).strip())
        if file_type == "Messagepack":
            obj = msgpack.unpackb(payload)
            if isinstance(obj, dict):
                return None, float(obj["pot_sub"])
            return None, float(obj[0])
    except Exception as exc:
        raise errors.DeserializeError() from exc
    raise ValueError(file_type)


# --------------------------------------------------------------------------- #
# ObservablesOutput
# --------------------------------------------------------------------------- #

_OBS_FIELDS = ("state", "energy", "binding_energy", "r", "l_r")
# complex runs append Im(E) (a capability the reference lacks)
_OBS_COMPLEX = _OBS_FIELDS + ("energy_im",)


def observables_to(file_type: str, obs: dict):
    fields = _OBS_COMPLEX if "energy_im" in obs else _OBS_FIELDS
    vals = {k: _num(obs[k]) for k in fields}
    if file_type == "Json":
        return _json.dumps(vals, indent=2)
    if file_type == "Yaml":
        return _yaml.dumps(vals)
    if file_type == "Ron":
        body = ",\n".join(f"    {k}: {_ron_num(v) if isinstance(v, float) else v}" for k, v in vals.items())
        return "(\n" + body + ",\n)"
    if file_type == "Csv":
        # csv::Writer::from_path defaults to headers for serialize
        # (src/output.rs:624-637)
        buf = _io.StringIO()
        w = _csv.writer(buf, lineterminator="\n")
        w.writerow(fields)
        w.writerow(
            [vals["state"]] + [_fmt_float(vals[k]) for k in fields[1:]]
        )
        return buf.getvalue()
    if file_type == "Messagepack":
        return msgpack.packb([vals[k] for k in fields])
    raise ValueError(file_type)


def observables_from(file_type: str, payload) -> dict:
    if file_type == "Json":
        return dict(_json.loads(payload))
    if file_type == "Yaml":
        return dict(_yaml.loads(payload))
    if file_type == "Ron":
        return dict(ron_loads(payload))
    if file_type == "Csv":
        rows = list(_csv.reader(_io.StringIO(payload)))
        header, vals = rows[0], rows[1]
        out = {}
        for k, v in zip(header, vals):
            out[k] = int(v) if k == "state" else float(v)
        return out
    if file_type == "Messagepack":
        obj = msgpack.unpackb(payload)
        if isinstance(obj, dict):
            return obj
        return dict(zip(_OBS_COMPLEX, obj))
    raise ValueError(file_type)
