"""A reader of the YAML that the port's configs use, so no pyyaml is needed
(the card machine does not promise it).

It reads block mappings and sequences nested by indentation (as
``yaml.safe_dump`` writes them, a sequence under a key at the key's own
indent included), whose leaves are plain or quoted scalars or flow
sequences and mappings (over several lines too, as the Ultralytics data
files write ``names``). Scalars are typed as pyyaml's safe loader types
them: null, bool, decimal int, float, else str (so a model YAML's unquoted
``None`` is the string "None", as with pyyaml). Not read, and raised on
where met: anchors, aliases, tags, several documents, plain scalars over
several lines, and block scalars (``key: |``) except under a top-level key
that the caller skips.
"""

from __future__ import annotations

import re
from typing import NamedTuple

__all__ = ["read_yaml"]

_KEY = re.compile(r"([^\s#'\"\-\[\]{},:?][^:#]*?):(?:[ \t]+(.*))?")  # a block mapping's "key: value"
_BLOCK_SCALAR = re.compile(r"(?:.*:[ \t]+|-[ \t]+)?[|>][-+0-9]*")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"(?:[-+]?[0-9][0-9_]*\.[0-9_]*|\.[0-9][0-9_]*)(?:[eE][-+][0-9]+)?")
_INF_NAN = re.compile(r"[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)")
_NULL = {"", "~", "null", "Null", "NULL"}
_BOOL = {v: True for v in ("true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON")}
_BOOL.update({v: False for v in ("false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF")})
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v", "f": "\f", "r": "\r",
            "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0"}


def _plain(text: str):
    """A plain scalar as pyyaml's safe loader types it: null, bool, int, float, else str."""
    text = text.strip()
    if text[:1] in ("&", "*", "!", "%", "@", "`"):
        raise ValueError(f"YAML: {text[:20]!r}: anchors, aliases, tags and directives are not read")
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        return int(text.replace("_", ""))
    if _FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    if _INF_NAN.fullmatch(text):
        return float(text.replace(".", ""))
    return text


def _scan(text: str):
    """Yield (char, inside_quotes) of ``text``, skipping ``#`` comments
    (at the start or after a blank) outside quotes and a double-quoted
    scalar's escaped line breaks. A quote opens a scalar
    only where one can start: first, or after a blank or ``[{,``."""
    quote, i = None, 0
    while i < len(text):
        ch = text[i]
        if quote:
            if quote == '"' and ch == "\\" and text[i + 1: i + 2] == "\n":
                i += 2  # an escaped line break: it and the next line's indent vanish
                while i < len(text) and text[i] in " \t":
                    i += 1
                continue
            if quote == '"' and ch == "\\":  # an escape: keep both characters
                yield ch, True
                yield text[i + 1: i + 2], True
                i += 2
                continue
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " \t\n[{,"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t\n"):
            while i < len(text) and text[i] != "\n":
                i += 1
            continue
        yield ch, quote is not None
        i += 1


def _is_open(text: str) -> bool:
    """True while ``text`` has an unclosed quote or flow bracket."""
    depth, inside = 0, False
    for ch, inside in _scan(text):
        if not inside:
            depth += (ch in "[{") - (ch in "]}")
    return inside or depth > 0


class _Flow:
    """Recursive-descent reader of one flow node: ``[...]``, ``{...}``,
    a quoted or a plain scalar (line breaks already folded to spaces)."""

    def __init__(self, text: str):
        self.s, self.i = text, 0

    def _ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def node(self, in_flow: bool = False, is_key: bool = False):
        self._ws()
        ch = self.s[self.i: self.i + 1]
        if ch == "[":
            return self._seq()
        if ch == "{":
            return self._map()
        if ch in ("'", '"'):
            return self._quoted(ch)
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            nxt = self.s[self.i + 1: self.i + 2]
            if in_flow and c in ",[]{}":
                break
            if is_key and c == ":" and (nxt in ("", " ", "\t") or (in_flow and nxt in ",[]{}")):
                break
            self.i += 1
        return _plain(self.s[start: self.i])

    def _expect(self, ch: str) -> None:
        self._ws()
        if self.s[self.i: self.i + 1] != ch:
            raise ValueError(f"YAML: expected {ch!r} at {self.s[self.i: self.i + 20]!r}")
        self.i += 1

    def _seq(self) -> list:
        self._expect("[")
        out = []
        while True:
            self._ws()
            if self.s[self.i: self.i + 1] == "]":
                self.i += 1
                return out
            out.append(self.node(in_flow=True))
            self._ws()
            if self.s[self.i: self.i + 1] == ",":
                self.i += 1

    def _map(self) -> dict:
        self._expect("{")
        out = {}
        while True:
            self._ws()
            if self.s[self.i: self.i + 1] == "}":
                self.i += 1
                return out
            key = self.node(in_flow=True, is_key=True)
            self._expect(":")
            self._ws()
            out[key] = None if self.s[self.i: self.i + 1] in (",", "}") else self.node(in_flow=True)
            self._ws()
            if self.s[self.i: self.i + 1] == ",":
                self.i += 1

    def _quoted(self, q: str) -> str:
        self.i += 1
        out = []
        while self.i < len(self.s):
            ch = self.s[self.i]
            if q == "'" and ch == "'":
                if self.s[self.i + 1: self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if q == '"' and ch == '"':
                self.i += 1
                return "".join(out)
            if q == '"' and ch == "\\":
                esc = self.s[self.i + 1: self.i + 2]
                width = {"x": 2, "u": 4, "U": 8}.get(esc)
                if width:
                    out.append(chr(int(self.s[self.i + 2: self.i + 2 + width], 16)))
                    self.i += 2 + width
                    continue
                if esc not in _ESCAPES:
                    raise ValueError(f"YAML: unknown escape \\{esc}")
                out.append(_ESCAPES[esc])
                self.i += 2
                continue
            out.append(ch)
            self.i += 1
        raise ValueError("YAML: unterminated quoted scalar")


def _flow_value(text: str):
    """One flow node, comments stripped and line breaks folded."""
    reader = _Flow(text)
    value = reader.node()
    if text[reader.i:].strip():
        raise ValueError(f"YAML: unexpected text after a value: {text[reader.i:][:40]!r}")
    return value


class _Line(NamedTuple):
    indent: int
    text: str  # comments stripped; the line breaks of a flow node over several lines folded to spaces
    scalar: bool  # a block scalar's header; its body lines were consumed with it


def _logical_lines(text: str) -> list[_Line]:
    """Non-blank lines with the continuation lines of an open flow node or
    quote joined to the line they continue, and block scalar bodies dropped."""
    raw, out, i = text.splitlines(), [], 0
    while i < len(raw):
        chunk, i = raw[i], i + 1
        while _is_open(chunk) and i < len(raw):
            chunk, i = chunk + "\n" + raw[i], i + 1
        body = re.sub(r"[ \t]*\n[ \t]*", " ", "".join(ch for ch, _ in _scan(chunk))).strip()
        if not body:
            continue
        indent = len(chunk) - len(chunk.lstrip(" "))
        scalar = bool(_BLOCK_SCALAR.fullmatch(body))
        while scalar and i < len(raw) and (not raw[i].strip() or len(raw[i]) - len(raw[i].lstrip(" ")) > indent):
            i += 1
        out.append(_Line(indent, body, scalar))
    return out


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith(("- ", "-\t"))


def _below(lines: list[_Line], i: int, indent: int) -> bool:
    """Whether lines[i] belongs to the value of a key at ``indent``: deeper,
    or a sequence item at the key's own indent."""
    return i < len(lines) and (lines[i].indent > indent or (lines[i].indent == indent and _is_item(lines[i].text)))


def _node(lines: list[_Line], i: int):
    """The block node starting at lines[i] -> (value, index after it)."""
    line = lines[i]
    if _is_item(line.text):
        return _sequence(lines, i, line.indent)
    if _KEY.fullmatch(line.text):
        return _mapping(lines, i, line.indent)
    if line.scalar:
        raise ValueError("YAML: block scalars (| or >) are not read")
    return _flow_value(line.text), i + 1


def _sequence(lines: list[_Line], i: int, indent: int):
    out = []
    while i < len(lines) and lines[i].indent == indent and _is_item(lines[i].text):
        text = lines[i].text[1:]
        rest = text.lstrip(" \t")
        if rest:  # the item starts on the dash's line: read it as a line of its own at its column
            lines[i] = _Line(indent + 1 + len(text) - len(rest), rest, lines[i].scalar)
            value, i = _node(lines, i)
        elif i + 1 < len(lines) and lines[i + 1].indent > indent:
            value, i = _node(lines, i + 1)
        else:
            value, i = None, i + 1
        out.append(value)
    return out, i


def _mapping(lines: list[_Line], i: int, indent: int, keys: tuple[str, ...] | None = None):
    out = {}
    while i < len(lines) and lines[i].indent == indent and not _is_item(lines[i].text):
        line = lines[i]
        m = _KEY.fullmatch(line.text)
        if not m:
            raise ValueError(f"YAML: cannot read the line {line.text!r}")
        key, value_text, i = _Flow(m.group(1)).node(is_key=True), m.group(2), i + 1
        if keys is not None and key not in keys:  # skipped unread, with all that lies below it
            while _below(lines, i, indent):
                i += 1
            continue
        if line.scalar:
            raise ValueError(f"YAML: {key!r} holds a block scalar (| or >), which is not read")
        if value_text:
            out[key] = _flow_value(value_text)
        elif _below(lines, i, indent):
            out[key], i = _node(lines, i)
        else:
            out[key] = None
    return out, i


def read_yaml(text: str, keys: tuple[str, ...] | None = None) -> dict:
    """The top-level mapping of ``text``; with ``keys``, only those keys
    (the others are skipped unread)."""
    lines = _logical_lines(text)
    if not lines:
        return {}
    out, i = _mapping(lines, 0, lines[0].indent, keys) if _KEY.fullmatch(lines[0].text) else _node(lines, 0)
    if i < len(lines):
        raise ValueError(f"YAML: cannot read the line {lines[i].text[:60]!r}")
    if not isinstance(out, dict):
        raise ValueError("YAML: the top level is not a mapping")
    return out if keys is None else {k: v for k, v in out.items() if k in keys}
