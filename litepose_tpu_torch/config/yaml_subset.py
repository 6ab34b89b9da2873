"""A YAML reader and writer for the subset the experiment configs use (the
port's stand-in for ``yaml.safe_load`` / ``yaml.safe_dump``, which
``litepose_tpu/config/node.py`` imports and the card's host lacks).

The subset, read as PyYAML reads it (YAML 1.1):

* block mappings nested by indentation (spaces only), ``key: value`` and
  ``key:`` followed by a more indented block, or by nothing (null);
* flow sequences on one line, ``[a, 'b', [c]]``;
* plain scalars resolved as PyYAML's implicit resolvers do: booleans
  (``true``, ``yes``, ``on`` ... in their three spellings), null (``~``,
  ``null``, empty), ints (decimal, ``0b``, ``0x``, leading-zero octal,
  ``_`` separators, base 60) and floats (which need a dot: ``4e-3`` stays a
  string, as ``ConfigNode._coerce`` expects), else strings;
* single- and double-quoted scalars (``''`` and backslash escapes);
* ``#`` comments, whole-line or after whitespace.

Anything else (block sequences, flow mappings, anchors, aliases, tags,
block scalars, multi-line flow collections, documents, timestamps, merge
keys) raises ``ValueError`` with the line number.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)"
                    r"|\.(?:nan|NaN|NAN))$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
                        r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
                        r"(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
                        r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0"}


class _Error(ValueError):
    pass


def _fail(name: str, line: int, msg: str):
    raise _Error(f"{name}:{line}: {msg} (outside the YAML subset this reader takes)")


def _base60(value: str, cast):
    total = cast(0)
    for part in value.split(":"):
        total = total * 60 + cast(part)
    return total


def resolve_plain(s: str, name: str = "<string>", line: int = 0) -> Any:
    """A plain scalar as PyYAML's SafeLoader constructs it."""
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s in _TRUE
    if _INT.match(s):
        v = s.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return sign * _base60(v, int)
        return sign * int(v)
    if _FLOAT.match(s):
        v = s.replace("_", "").lower()
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return sign * _base60(v, float)
        return sign * float(v)
    if _TIMESTAMP.match(s):
        _fail(name, line, f"timestamp {s!r}")
    if s in ("<<", "="):
        _fail(name, line, f"merge or value key {s!r}")
    return s


def _quoted(text: str, i: int, name: str, line: int) -> Tuple[str, int]:
    """The quoted scalar starting at text[i]; returns (value, index past it)."""
    q = text[i]
    out: List[str] = []
    j = i + 1
    while j < len(text):
        c = text[j]
        if q == "'" and c == "'":
            if text[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == '"':
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            e = text[j + 1:j + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                j += 2
                continue
            width = {"x": 2, "u": 4, "U": 8}.get(e)
            if width is None or not re.fullmatch(r"[0-9a-fA-F]+", text[j + 2:j + 2 + width]):
                _fail(name, line, f"escape \\{e}")
            out.append(chr(int(text[j + 2:j + 2 + width], 16)))
            j += 2 + width
            continue
        out.append(c)
        j += 1
    _fail(name, line, "quoted scalar not closed on its line")


def _strip_comment(text: str, name: str, line: int) -> str:
    """The line without a trailing ``#`` comment (outside quotes)."""
    i = 0
    while i < len(text):
        c = text[i]
        if c in "'\"" and (i == 0 or text[i - 1] in " \t[,:"):
            _, i = _quoted(text, i, name, line)
            continue
        if c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def _flow_seq(text: str, i: int, name: str, line: int) -> Tuple[list, int]:
    """The flow sequence starting at text[i] == '['; (list, index past ']')."""
    out: list = []
    j = i + 1
    while True:
        while j < len(text) and text[j] in " \t":
            j += 1
        if j >= len(text):
            _fail(name, line, "flow sequence not closed on its line")
        c = text[j]
        if c == "]":
            return out, j + 1
        if c == "[":
            item, j = _flow_seq(text, j, name, line)
        elif c in "'\"":
            item, j = _quoted(text, j, name, line)
        elif c in "{&*!|>%@`":
            _fail(name, line, f"{c!r} in a flow sequence")
        else:
            k = j
            while k < len(text) and text[k] not in ",[]{}":
                k += 1
            plain = text[j:k].strip()
            if ": " in plain or plain.endswith(":"):
                _fail(name, line, "a mapping inside a flow sequence")
            item, j = resolve_plain(plain, name, line), k
        out.append(item)
        while j < len(text) and text[j] in " \t":
            j += 1
        if j < len(text) and text[j] == ",":
            j += 1
        elif j >= len(text) or text[j] != "]":
            _fail(name, line, "expected ',' or ']' in a flow sequence")


def _value(text: str, name: str, line: int) -> Any:
    """A scalar or flow sequence that fills the rest of a line."""
    c = text[0]
    if c == "[":
        v, j = _flow_seq(text, 0, name, line)
    elif c in "'\"":
        v, j = _quoted(text, 0, name, line)
    elif c in "{&*!|>%@`" or (c == "-" and text[1:2] in ("", " ")) or text.startswith("? "):
        _fail(name, line, f"value starting with {c!r}")
    else:
        if ": " in text or text.endswith(":"):
            _fail(name, line, "a mapping on one line")
        return resolve_plain(text, name, line)
    if text[j:].strip():
        _fail(name, line, f"text after a {'flow sequence' if c == '[' else 'quoted scalar'}")
    return v


def _split_key(text: str, name: str, line: int) -> Tuple[Any, str]:
    """``key: rest`` -> (key, rest)."""
    if text[0] in "'\"":
        key, j = _quoted(text, 0, name, line)
        if text[j:j + 1] != ":" or (text[j + 1:j + 2] not in ("", " ")):
            _fail(name, line, "expected ':' after a quoted key")
        return key, text[j + 1:].strip()
    if text[0] in "[{&*!|>%@`?-":
        _fail(name, line, f"line starting with {text[0]!r}")
    m = re.search(r":(?: |$)", text)
    if m is None:
        _fail(name, line, "expected 'key: value'")
    return resolve_plain(text[:m.start()].rstrip(), name, line), text[m.end():].strip()


def loads(text: str, name: str = "<string>") -> Any:
    """Parse ``text``; an empty document gives None, as ``yaml.safe_load``."""
    rows: List[Tuple[int, int, str]] = []  # (line number, indent, content)
    for n, raw in enumerate(text.splitlines(), 1):
        body = raw.lstrip(" ")
        if body.startswith("\t"):
            _fail(name, n, "tab indentation")
        content = _strip_comment(body, name, n)
        if not content:
            continue
        if content in ("---", "...") or content.startswith(("--- ", "%")):
            _fail(name, n, "document marker or directive")
        rows.append((n, len(raw) - len(body), content))
    if not rows:
        return None

    def block(i: int, indent: int) -> Tuple[dict, int]:
        out: dict = {}
        while i < len(rows):
            n, ind, content = rows[i]
            if ind < indent:
                break
            if ind > indent:
                _fail(name, n, "unexpected indentation")
            key, rest = _split_key(content, name, n)
            i += 1
            if rest:
                out[key] = _value(rest, name, n)
            elif i < len(rows) and rows[i][1] > indent:
                out[key], i = block(i, rows[i][1])
            else:
                out[key] = None
        return out, i

    tree, i = block(0, rows[0][1])
    if i < len(rows):
        _fail(name, rows[i][0], "indentation below the first line's")
    return tree


def load_file(path: str) -> Any:
    with open(path) as f:
        return loads(f.read(), path)


# -- writing ----------------------------------------------------------------


def _plain_ok(s: str) -> bool:
    """Whether PyYAML's emitter writes ``s`` as a plain scalar in block
    context (emitter.analyze_scalar, for one-line printable text)."""
    if not s or s != s.strip() or s.startswith(("---", "...")):
        return False
    if any(not c.isprintable() for c in s):
        return False
    if s[0] in "#,[]{}&*!|>'\"%@`":
        return False
    if s[0] in "?:-" and (len(s) == 1 or s[1] == " "):
        return False
    if ": " in s or " #" in s or s.endswith(":"):
        return False
    try:  # text that reads back as another type (or a timestamp) is quoted
        return isinstance(resolve_plain(s), str)
    except _Error:
        return False


def scalar_text(v: Any) -> str:
    """One scalar as ``yaml.safe_dump`` writes it."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        if _plain_ok(v):
            return v
        if all(c.isprintable() for c in v):
            return "'" + v.replace("'", "''") + "'"
        raise ValueError(f"string {v!r} needs a double-quoted YAML scalar")
    raise TypeError(f"cannot write {type(v).__name__} as YAML")


def _emit(obj: Any, indent: int, out: List[str]) -> None:
    pad = " " * indent
    for key in sorted(obj):
        v = obj[key]
        k = scalar_text(key)
        if isinstance(v, dict) and v:
            out.append(f"{pad}{k}:")
            _emit(v, indent + 2, out)
        elif isinstance(v, (list, tuple)) and v:
            out.append(f"{pad}{k}:")
            for item in v:
                if isinstance(item, (list, tuple, dict)):
                    raise ValueError(f"nested collection under {key!r}: outside the subset")
                out.append(f"{pad}- {scalar_text(item)}")
        elif isinstance(v, dict):
            out.append(f"{pad}{k}: {{}}")
        elif isinstance(v, (list, tuple)):
            out.append(f"{pad}{k}: []")
        else:
            out.append(f"{pad}{k}: {scalar_text(v)}")


def dumps(tree: dict) -> str:
    """``yaml.safe_dump(tree, sort_keys=True)`` for a mapping of scalars,
    flat lists of scalars and nested such mappings."""
    out: List[str] = []
    _emit(tree, 0, out)
    return "\n".join(out) + "\n" if out else "{}\n"
