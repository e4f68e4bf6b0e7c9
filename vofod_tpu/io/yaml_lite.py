"""Reader for the YAML subset of the reference's config files.

The detector's config path needs no third-party YAML package.  Supported:
block mappings (indentation-nested), flow mappings ``{k: v, ...}`` (nested),
plain and quoted scalars resolved like YAML 1.1 (ints, floats, bools,
nulls, strings), ``#`` comments and the ``!degrees`` tag of
config/sensors/*.yaml (a float).  Anything else — sequences, anchors,
aliases, block scalars, other tags, documents markers, tab indentation —
raises :class:`YamlSubsetError`, so an unsupported file fails loudly
instead of loading differently.
"""

from __future__ import annotations

import re
from typing import Any

__all__ = ["YamlSubsetError", "loads", "load_file"]


class YamlSubsetError(ValueError):
    """The text uses YAML outside the supported subset, or is malformed."""


_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(
    r"[-+]?(?:[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?"
)
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)")
# YAML 1.1 numeric forms this reader does not implement (octal, hex,
# binary, sexagesimal, digit separators): refused, not read as strings
_OTHER_NUMERIC = re.compile(
    r"[-+]?(?:0[0-7_]+|0x[0-9a-fA-F_]+|0b[01_]+|[0-9][0-9_]*(?::[0-5]?[0-9])+"
    r"(?:\.[0-9_]*)?|[0-9][0-9_]*_[0-9_]*(?:\.[0-9_]*)?)"
)
_BOOL = {
    **{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE",
                         "on", "On", "ON")},
    **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE",
                          "off", "Off", "OFF")},
}
_NULL = {"", "~", "null", "Null", "NULL"}
_INDICATORS = set("[]{},#&*!|>'\"%@`-?:")


def _scalar(text: str, where: str) -> Any:
    s = text.strip()
    if s.startswith("!degrees"):
        rest = s[len("!degrees"):]
        if rest and not rest[0].isspace():
            raise YamlSubsetError(f"{where}: unsupported tag {s.split()[0]!r}")
        try:
            return float(_scalar(rest, where))
        except (TypeError, ValueError) as e:
            raise YamlSubsetError(f"{where}: !degrees needs a number") from e
    if s[:1] in ("'", '"'):
        q = s[0]
        if len(s) < 2 or s[-1] != q or q in s[1:-1].replace(q * 2, ""):
            raise YamlSubsetError(f"{where}: unsupported quoted scalar {s!r}")
        if q == '"' and "\\" in s:
            raise YamlSubsetError(f"{where}: escapes are not supported")
        return s[1:-1].replace("''", "'") if q == "'" else s[1:-1]
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.fullmatch(s):
        return int(s)
    if _FLOAT.fullmatch(s):
        return float(s)
    if _INF.fullmatch(s):
        return float("-inf") if s[0] == "-" else float("inf")
    if _NAN.fullmatch(s):
        return float("nan")
    if _OTHER_NUMERIC.fullmatch(s):
        raise YamlSubsetError(f"{where}: unsupported numeric form {s!r}")
    if s[0] in _INDICATORS or ": " in s or s.endswith(":"):
        raise YamlSubsetError(f"{where}: unsupported syntax {s!r}")
    return s


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in ("'", '"') and (i == 0 or line[i - 1] in " {,:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1].isspace()):
            return line[:i]
    return line


def _split_key(text: str, where: str) -> tuple[Any, str]:
    """``key: rest`` -> (resolved key, rest); the colon must end the text
    or be followed by a space."""
    m = re.match(r"([^:]+?)\s*:(?:\s+|$)", text)
    if m is None:
        raise YamlSubsetError(f"{where}: expected 'key: value', got {text!r}")
    key = _scalar(m.group(1), where)
    if isinstance(key, dict):
        raise YamlSubsetError(f"{where}: mapping keys are not supported")
    return key, text[m.end():]


def _flow_map(text: str, pos: int, where: str) -> tuple[dict, int]:
    """Parse ``{k: v, ...}`` starting at text[pos] == '{'."""
    out: dict = {}
    pos += 1
    while True:
        while pos < len(text) and text[pos].isspace():
            pos += 1
        if pos >= len(text):
            raise YamlSubsetError(f"{where}: unclosed flow mapping")
        if text[pos] == "}":
            return out, pos + 1
        m = re.compile(r"([^:,{}\[\]]+?)\s*:\s+").match(text, pos)
        if m is None:
            raise YamlSubsetError(f"{where}: bad flow mapping entry")
        key = _scalar(m.group(1), where)
        pos = m.end()
        if pos < len(text) and text[pos] == "{":
            val, pos = _flow_map(text, pos, where)
        else:
            end = pos
            while end < len(text) and text[end] not in ",}":
                end += 1
            if end >= len(text):
                raise YamlSubsetError(f"{where}: unclosed flow mapping")
            val = _scalar(text[pos:end], where)
            pos = end
        out[key] = val
        while pos < len(text) and text[pos].isspace():
            pos += 1
        if pos < len(text) and text[pos] == ",":
            pos += 1
        elif pos >= len(text) or text[pos] != "}":
            raise YamlSubsetError(f"{where}: bad flow mapping separator")


def _value(text: str, where: str) -> Any:
    s = text.strip()
    if s.startswith("{"):
        val, end = _flow_map(s, 0, where)
        if s[end:].strip():
            raise YamlSubsetError(f"{where}: trailing text after mapping")
        return val
    return _scalar(s, where)


def loads(text: str) -> Any:
    """Parse YAML text in the supported subset (see module docstring).

    Returns None for an empty document, like ``yaml.safe_load``."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"line {n}"
        body = _strip_comment(raw).rstrip()
        if not body.strip():
            continue
        indent = len(body) - len(body.lstrip(" "))
        if body[indent:indent + 1] == "\t" or "\t" in body[:indent]:
            raise YamlSubsetError(f"{where}: tab indentation")
        if body.strip() in ("---", "..."):
            raise YamlSubsetError(f"{where}: document markers are not supported")
        lines.append((indent, body.strip(), where))
    if not lines:
        return None
    if len(lines) == 1 and not re.match(r"[^{\s][^:]*:(\s|$)", lines[0][1]):
        return _value(lines[0][1], lines[0][2])

    root: dict = {}
    # stack of (indent of this mapping's keys, mapping)
    stack: list[tuple[int, dict]] = [(lines[0][0], root)]
    pending: tuple[dict, Any, int] | None = None  # (parent, key, key indent)
    for indent, body, where in lines:
        if pending is not None:
            parent, key, kind = pending
            pending = None
            if indent > kind:
                child: dict = {}
                parent[key] = child
                stack.append((indent, child))
            else:
                parent[key] = None
        while stack and indent < stack[-1][0]:
            stack.pop()
        if not stack or indent != stack[-1][0]:
            raise YamlSubsetError(f"{where}: inconsistent indentation")
        mapping = stack[-1][1]
        key, rest = _split_key(body, where)
        if rest.strip():
            mapping[key] = _value(rest, where)
        else:
            pending = (mapping, key, indent)
    if pending is not None:
        pending[0][pending[1]] = None
    return root


def load_file(path: str) -> Any:
    with open(path) as f:
        return loads(f.read())
