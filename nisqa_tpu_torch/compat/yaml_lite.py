"""Flat YAML configs without PyYAML: the reader and writer the train CLI uses.

The reader takes what the shipped training configs (``nisqa_tpu/config/
*.yaml``) and ``yaml.dump`` of a config dict use: a top-level mapping of
scalars and lists of scalars; comments, trailing ones included; block lists
indented under their key or at its indent; flow lists ``[3, 3]``. Plain
scalars are typed as PyYAML's YAML 1.1 resolver types them: ``null`` /
``~`` / empty is None, ``true`` / ``yes`` / ``on`` (any of their three
casings) and their opposites are bools, ``0x``/``0b``/``0``-octal and
``:``-sexagesimal integers count, and a float needs a dot (``1e-3`` is a
string there, ``1.0e-3`` and ``0.001`` are floats). Quoted scalars are
strings. Timestamps, anchors, tags and nested mappings are not read.

The writer serves the per-run YAML, which the JAX package writes with
``yaml.dump(default_flow_style=None, sort_keys=False)``: one ``key: value``
line per key in order, lists of scalars in flow style, nested mappings in
block style, and every scalar written so that ``yaml.safe_load`` reads back
the same value (a tuple as a list).
"""

from __future__ import annotations

import datetime
import json
import math
import re

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0b[0-1_]+|0[0-7_]+|(?:0|[1-9][0-9_]*)|0x[0-9a-fA-F_]+"
                  r"|[1-9][0-9_]*(?::[0-5]?[0-9])+)")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*|[-+]?\.(?:inf|Inf|INF)"
                    r"|\.(?:nan|NaN|NAN)")
_KEY = re.compile(r"([^\s#'\"][^:#]*?|'[^']*'|\"[^\"]*\")\s*:(?:\s+|$)(.*)")


def _sexagesimal(s: str, cast):
    sign = -1 if s[0] == "-" else 1
    value = 0
    for part in s.lstrip("+-").split(":"):
        value = value * 60 + cast(part)
    return sign * value


def _plain(s: str):
    """A plain (unquoted) scalar, typed as PyYAML's resolver types it."""
    if s in _NULL:
        return None
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    if _INT.fullmatch(s):
        t = s.replace("_", "")
        sign = -1 if t[0] == "-" else 1
        body = t.lstrip("+-")
        if ":" in body:
            return _sexagesimal(t, int)
        if body.startswith("0b"):
            return sign * int(body[2:], 2)
        if body.startswith("0x"):
            return sign * int(body[2:], 16)
        if len(body) > 1 and body[0] == "0":
            return sign * int(body, 8)
        return sign * int(body)
    if _FLOAT.fullmatch(s):
        t = s.replace("_", "").lower()
        if t.endswith("nan"):
            return math.nan
        if t.endswith("inf"):
            return -math.inf if t[0] == "-" else math.inf
        if ":" in t:
            return _sexagesimal(t, float)
        return float(t)
    return s


def _quoted(s: str, pos: int):
    """(string, index after the closing quote) of the quoted scalar at ``pos``."""
    q = s[pos]
    i, out = pos + 1, []
    while i < len(s):
        c = s[i]
        if q == "'" and c == "'":
            if s[i + 1 : i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            esc = s[i + 1]
            if esc == "u":
                out.append(chr(int(s[i + 2 : i + 6], 16)))
                i += 6
                continue
            out.append({"n": "\n", "t": "\t", "r": "\r", "0": "\0", "\\": "\\", '"': '"',
                        "/": "/", " ": " "}[esc])
            i += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), i + 1
        out.append(c)
        i += 1
    raise ValueError(f"unterminated quoted scalar: {s[pos:]!r}")


def _strip_comment(s: str) -> str:
    """``s`` without a trailing comment: a ``#`` at the start or after
    whitespace, outside quotes."""
    i = 0
    while i < len(s):
        c = s[i]
        if c in "'\"" and (i == 0 or s[i - 1] in " \t[,:"):
            i = _quoted(s, i)[1]
            continue
        if c == "#" and (i == 0 or s[i - 1] in " \t"):
            return s[:i].rstrip()
        i += 1
    return s.rstrip()


def _scalar(s: str):
    s = s.strip()
    if s[:1] in ("'", '"'):
        value, end = _quoted(s, 0)
        if s[end:].strip():
            raise ValueError(f"text after a quoted scalar: {s!r}")
        return value
    return _plain(s)


def _flow_list(s: str) -> list:
    body = s.strip()[1:-1]
    items, i, start = [], 0, 0
    while i < len(body):
        c = body[i]
        if c in "'\"":
            i = _quoted(body, i)[1]
            continue
        if c in "[{":
            raise ValueError(f"nested flow collections are not read: {s!r}")
        if c == ",":
            items.append(body[start:i])
            start = i + 1
        i += 1
    items.append(body[start:])
    if items[-1].strip() == "":  # "[]" or a trailing comma
        items.pop()
    return [_scalar(x) for x in items]


def _value(s: str):
    s = s.strip()
    if s.startswith("["):
        if not s.endswith("]"):
            raise ValueError(f"flow list across lines is not read: {s!r}")
        return _flow_list(s)
    if s.startswith("{") or s[:1] in ("&", "*", "!", "|", ">"):
        raise ValueError(f"unsupported YAML value: {s!r}")
    return _scalar(s)


def loads(text: str) -> dict:
    """A flat YAML mapping (see the module docstring) -> dict."""
    out = {}
    key = None  # the key whose block list the following lines may hold
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = _strip_comment(raw.replace("\t", " "))
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        indent = len(line) - len(line.lstrip())
        body = line.strip()
        if body == "-" or body.startswith("- "):
            if key is None or (out[key] is not None and not isinstance(out[key], list)):
                raise ValueError(f"line {lineno}: list item outside a key's block list: {raw!r}")
            if out[key] is None:
                out[key] = []
            out[key].append(_value(body[1:]))
            continue
        if indent:
            raise ValueError(f"line {lineno}: nested mappings are not read: {raw!r}")
        m = _KEY.fullmatch(body)
        if not m:
            raise ValueError(f"line {lineno}: not a 'key: value' line: {raw!r}")
        name = _scalar(m.group(1))
        out[name] = _value(m.group(2)) if m.group(2) else None
        key = name if not m.group(2) else None
    return out


def load(path: str) -> dict:
    with open(path) as f:
        return loads(f.read())


_SAFE_PLAIN = re.compile(r"[A-Za-z0-9_./][A-Za-z0-9_./+@()=-]*(?: [A-Za-z0-9_./+@()=-]+)*")


def _scalar_text(v) -> str:
    if hasattr(v, "item") and not isinstance(v, (str, bytes)):  # numpy scalars
        v = v.item()
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
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, (datetime.date, datetime.datetime)):
        return str(v)
    s = str(v)
    if _SAFE_PLAIN.fullmatch(s) and isinstance(_plain(s), str):
        return s
    if s.isprintable() and "\n" not in s:
        return "'" + s.replace("'", "''") + "'"
    return json.dumps(s)


def _is_scalar(v) -> bool:
    return not isinstance(v, (list, tuple, dict))


def _lines(d: dict, indent: str) -> list:
    out = []
    for k, v in d.items():
        key = _scalar_text(k)
        if isinstance(v, dict):
            out += [f"{indent}{key}:"] + _lines(v, indent + "  ") if v else [f"{indent}{key}: {{}}"]
        elif isinstance(v, (list, tuple)):
            if all(_is_scalar(x) for x in v):
                out.append(f"{indent}{key}: [" + ", ".join(_scalar_text(x) for x in v) + "]")
            else:
                raise ValueError(f"{key}: lists of collections are not written")
        else:
            out.append(f"{indent}{key}: {_scalar_text(v)}")
    return out


def dumps(d: dict) -> str:
    """``d`` as YAML text (see the module docstring)."""
    return "\n".join(_lines(d, "")) + "\n"


def dump(d: dict, path: str):
    with open(path, "w") as f:
        f.write(dumps(d))
