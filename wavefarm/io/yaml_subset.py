"""Reader and writer for the YAML subset the solver's files use.

Covers what the configuration schema (``wafer.yaml``, ``examples/*.yaml``)
and the reference's serde_yaml output need: block and flow mappings and
sequences, plain, single- and double-quoted scalars, ``#`` comments and the
``---``/``...`` document markers. Plain scalars resolve by the YAML 1.1 core
rules that ``yaml.safe_load`` applies (so ``1.0e-06`` is a float while
``1e-4`` stays a string, which the config schema converts with ``float``).
Anchors, tags, multi-document streams and block scalars (``|``, ``>``) are
outside the subset and raise :class:`YamlError`.

:func:`dumps` writes one flow-style document (``{key: value, ...}``) that
this reader, PyYAML and serde_yaml all read back.
"""

from __future__ import annotations

import json
import math
import re
from typing import Any, List, Tuple


class YamlError(ValueError):
    """Input outside the supported subset, or malformed."""


_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_HEX = re.compile(r"[-+]?0x[0-9a-fA-F_]+$")
_FLOAT = re.compile(
    r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
    r"|[-+]?\.[0-9_]+(?:[eE][-+][0-9]+)?$"
)
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")


def resolve_plain(text: str) -> Any:
    """Type of an unquoted scalar, by the YAML 1.1 resolver rules."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _HEX.match(text):
        return int(text.replace("_", ""), 16)
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return -math.inf if text.startswith("-") else math.inf
    if _NAN.match(text):
        return math.nan
    return text


# --------------------------------------------------------------------------- #
# scalars and flow collections
# --------------------------------------------------------------------------- #

_ESCAPES = {
    "0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
    "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
    "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0",
}


def _double_quoted(s: str, i: int) -> Tuple[str, int]:
    """Parse a double-quoted scalar starting at ``s[i] == '"'``."""
    out: List[str] = []
    i += 1
    while i < len(s):
        c = s[i]
        if c == '"':
            return "".join(out), i + 1
        if c == "\\":
            e = s[i + 1 : i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
                continue
            width = {"x": 2, "u": 4, "U": 8}.get(e)
            if width is None:
                raise YamlError(f"unknown escape \\{e}")
            out.append(chr(int(s[i + 2 : i + 2 + width], 16)))
            i += 2 + width
            continue
        out.append(c)
        i += 1
    raise YamlError("unterminated double-quoted scalar")


def _single_quoted(s: str, i: int) -> Tuple[str, int]:
    """Parse a single-quoted scalar starting at ``s[i] == "'"``."""
    out: List[str] = []
    i += 1
    while i < len(s):
        c = s[i]
        if c == "'":
            if s[i + 1 : i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        out.append(c)
        i += 1
    raise YamlError("unterminated single-quoted scalar")


def _skip_ws(s: str, i: int) -> int:
    while i < len(s) and s[i] in " \t\r\n":
        i += 1
    return i


class _Flow:
    """Recursive-descent parser for one flow node (``{...}``, ``[...]`` or
    a scalar) inside a string."""

    def __init__(self, s: str):
        self.s = s

    def node(self, i: int, in_flow: bool) -> Tuple[Any, int]:
        s = self.s
        i = _skip_ws(s, i)
        if i >= len(s):
            return None, i
        c = s[i]
        if c == "{":
            return self._mapping(i + 1)
        if c == "[":
            return self._sequence(i + 1)
        if c == '"':
            return _double_quoted(s, i)
        if c == "'":
            return _single_quoted(s, i)
        if c in "&*!|>%@`":
            raise YamlError(f"unsupported YAML syntax {c!r}")
        j = i
        while j < len(s):
            ch = s[j]
            if in_flow and ch in ",]}":
                break
            if ch == ":" and (j + 1 == len(s) or s[j + 1] in " \t\r\n,]}"):
                break
            j += 1
        return resolve_plain(s[i:j].strip()), j

    def _sequence(self, i: int) -> Tuple[list, int]:
        s = self.s
        out = []
        while True:
            i = _skip_ws(s, i)
            if i >= len(s):
                raise YamlError("unterminated flow sequence")
            if s[i] == "]":
                return out, i + 1
            item, i = self.node(i, True)
            i = _skip_ws(s, i)
            if i < len(s) and s[i] == ":":
                # single-pair mapping inside a sequence: [a: b]
                value, i = self.node(i + 1, True)
                item = {item: value}
                i = _skip_ws(s, i)
            out.append(item)
            if i < len(s) and s[i] == ",":
                i += 1
            elif i < len(s) and s[i] != "]":
                raise YamlError(f"expected ',' or ']' at offset {i}")

    def _mapping(self, i: int) -> Tuple[dict, int]:
        s = self.s
        out = {}
        while True:
            i = _skip_ws(s, i)
            if i >= len(s):
                raise YamlError("unterminated flow mapping")
            if s[i] == "}":
                return out, i + 1
            key, i = self.node(i, True)
            i = _skip_ws(s, i)
            value = None
            if i < len(s) and s[i] == ":":
                value, i = self.node(i + 1, True)
                i = _skip_ws(s, i)
            out[key] = value
            if i < len(s) and s[i] == ",":
                i += 1
            elif i < len(s) and s[i] != "}":
                raise YamlError(f"expected ',' or '}}' at offset {i}")


def _inline(text: str) -> Any:
    """A complete value written on (joined) lines: flow node or scalar."""
    value, end = _Flow(text).node(0, False)
    if _skip_ws(text, end) != len(text):
        raise YamlError(f"trailing content in {text!r}")
    return value


# --------------------------------------------------------------------------- #
# block structure
# --------------------------------------------------------------------------- #


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that is not inside a quoted scalar."""
    quote = None
    escaped = False
    for i, c in enumerate(line):
        if quote:
            if escaped:
                escaped = False
            elif c == "\\" and quote == '"':
                escaped = True
            elif c == quote:
                quote = None
        elif c in "\"'":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _split_key(content: str):
    """``(key, rest)`` when ``content`` is a ``key: value`` entry, else None."""
    if content[:1] in "\"'":
        key, end = (
            _double_quoted(content, 0) if content[0] == '"'
            else _single_quoted(content, 0)
        )
        rest = content[end:].lstrip()
        if rest.startswith(":") and (len(rest) == 1 or rest[1] in " \t"):
            return key, rest[1:].strip()
        return None
    if content[:1] in "[{":
        return None
    m = re.match(r"([^#]*?):(?:[ \t]+|$)", content)
    if m is None:
        return None
    return resolve_plain(m.group(1).strip()), content[m.end():].strip()


class _Block:
    def __init__(self, lines: List[Tuple[int, str]]):
        self.lines = lines
        self.i = 0

    def _flow_text(self, first: str) -> str:
        """Join continuation lines until the flow collection's brackets
        balance (wrapped flow output, e.g. PyYAML's 80-column dumps)."""
        text = first
        while _unbalanced(text):
            if self.i >= len(self.lines):
                raise YamlError("unterminated flow collection")
            text += " " + self.lines[self.i][1]
            self.i += 1
        return text

    def value(self, parent_indent: int, rest: str, seq_ok: bool) -> Any:
        """The value of a ``key:`` or ``-`` entry whose inline part is
        ``rest``: inline, or a nested block on the following lines."""
        if rest:
            return _inline(self._flow_text(rest))
        if self.i < len(self.lines):
            ind, content = self.lines[self.i]
            if ind > parent_indent or (
                seq_ok and ind == parent_indent and _is_item(content)
            ):
                return self.node(ind)
        return None

    def node(self, indent: int) -> Any:
        content = self.lines[self.i][1]
        if _is_item(content):
            return self.sequence(indent)
        if _split_key(content) is not None:
            return self.mapping(indent)
        self.i += 1
        return _inline(self._flow_text(content))

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.i < len(self.lines):
            ind, content = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                raise YamlError(f"bad indentation: {content!r}")
            kv = _split_key(content)
            if kv is None:
                raise YamlError(f"expected 'key: value', got {content!r}")
            self.i += 1
            key, rest = kv
            out[key] = self.value(indent, rest, seq_ok=True)
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            ind, content = self.lines[self.i]
            if ind != indent or not _is_item(content):
                if ind > indent:
                    raise YamlError(f"bad indentation: {content!r}")
                break
            rest = content[1:].lstrip()
            if rest and _split_key(rest) is not None and rest[:1] not in "[{":
                # "- key: value" opens a mapping indented past the dash
                self.lines[self.i] = (ind + len(content) - len(rest), rest)
                out.append(self.mapping(ind + len(content) - len(rest)))
                continue
            self.i += 1
            out.append(self.value(indent, rest, seq_ok=False))
        return out


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ") or content.startswith("-\t")


def _unbalanced(text: str) -> bool:
    depth = 0
    quote = None
    for c in text:
        if quote:
            if c == quote:
                quote = None
        elif c in "\"'":
            quote = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
    return depth > 0


def loads(text: str) -> Any:
    """Parse one YAML document of the supported subset."""
    lines: List[Tuple[int, str]] = []
    for raw in text.splitlines():
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise YamlError("tab indentation")
        line = _strip_comment(raw).rstrip()
        content = line.lstrip(" ")
        if not content:
            continue
        if content in ("---", "...") or content.startswith("--- "):
            if lines and content != "...":
                raise YamlError("multi-document streams are not supported")
            content = content[4:].strip() if content.startswith("--- ") else ""
            if not content:
                continue
        if content.startswith("%"):
            raise YamlError("YAML directives are not supported")
        lines.append((len(line) - len(content), content))
    if not lines:
        return None
    block = _Block(lines)
    value = block.node(lines[0][0])
    if block.i != len(lines):
        raise YamlError(f"unexpected content: {lines[block.i][1]!r}")
    return value


# --------------------------------------------------------------------------- #
# writer
# --------------------------------------------------------------------------- #

_PLAIN_SAFE = re.compile(r"[A-Za-z_][A-Za-z0-9_ .\-/]*$")


def _scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "e" in r and "." not in r.split("e")[0]:
            # YAML 1.1 floats need a dot in the mantissa: 1e-06 → 1.0e-06
            m, e = r.split("e")
            r = f"{m}.0e{e}"
        return r
    if isinstance(v, str):
        if (
            _PLAIN_SAFE.match(v)
            and v == v.strip()
            and resolve_plain(v) == v
        ):
            return v
        return json.dumps(v)
    raise TypeError(f"cannot write {type(v).__name__} as YAML")


def _flow(v: Any) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(
            f"{_scalar(k)}: {_flow(x)}" for k, x in v.items()
        ) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_flow(x) for x in v) + "]"
    return _scalar(v)


def dumps(value: Any) -> str:
    """One flow-style YAML document, newline-terminated."""
    return _flow(value) + "\n"
