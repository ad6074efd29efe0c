"""A reader of the YAML subset the repository's configs use, without PyYAML.

The port does not depend on PyYAML (the packages of the card's machine
are fixed), so it reads ``configs/*.yaml`` and the CLI's override values
itself. ``load(text)`` gives what
``yaml.safe_load(text)`` gives for:

- block mappings, and block sequences (``- item``, as ``yaml.dump`` writes
  lists), nested by indentation;
- flow mappings (``{lr: 0.0001, momentum: 0.9}``) and flow sequences
  (``[2, 3, 4, 5]``), nested, each on one line;
- plain, single-quoted and double-quoted scalars, comments, one optional
  ``---`` document start.

Plain scalars resolve as PyYAML's YAML 1.1 resolver resolves them: ``~``,
``null`` and the empty value are None; ``yes``/``no``/``on``/``off``/
``true``/``false`` in three casings are booleans; ints in decimal, octal
(leading 0), ``0x``, ``0b`` and base 60, with ``_`` ignored; floats need a
dot, and an exponent needs a sign, so ``1e-4`` stays the string "1e-4"
while ``1.0e-4`` is a float; every other plain scalar is a string.
Anything else (anchors and aliases, tags, block scalars, complex keys,
timestamps, merge keys, directives, several documents, tabs in the
indentation, a flow collection or a quoted scalar across lines) raises
``YAMLSubsetError`` naming the construct.
"""

import math
import re
from typing import Any, List, Tuple

__all__ = ["YAMLSubsetError", "load", "resolve_scalar"]


class YAMLSubsetError(ValueError):
    pass


# PyYAML's implicit resolvers (yaml/resolver.py), anchored, in its order
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                  |[-+]?0[0-7_]+
                  |[-+]?(?:0|[1-9][0-9_]*)
                  |[-+]?0x[0-9a-fA-F_]+
                  |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                        |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                        (?:[Tt]|[ \t]+)[0-9][0-9]?
                        :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                        (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)

_FLOW_END = ",[]{}"
# what a plain scalar may not start with, and the construct each names
_INDICATORS = {"&": "anchor", "*": "alias", "!": "tag", "|": "block scalar",
               ">": "block scalar", "%": "directive", "@": "reserved indicator '@'",
               "`": "reserved indicator '`'", "?": "complex mapping key"}


def _sexagesimal(parts: List[float]) -> float:
    value, base = 0, 1
    for d in reversed(parts):
        value += d * base
        base *= 60
    return value


def resolve_scalar(text: str) -> Any:
    """A plain scalar's value by PyYAML's YAML 1.1 rules (SafeConstructor)."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v[1:] if v[0] in "+-" else v
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if ":" in v:
            return sign * _sexagesimal([int(p) for p in v.split(":")])
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1 if v[0] == "-" else 1
        v = v[1:] if v[0] in "+-" else v
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return sign * _sexagesimal([float(p) for p in v.split(":")])
        return sign * float(v)
    if _TIMESTAMP.match(text):
        raise YAMLSubsetError(f"timestamp scalar {text!r} is outside the supported subset")
    if text in ("<<", "="):
        raise YAMLSubsetError(f"{'merge key' if text == '<<' else 'value key'} {text!r} is "
                              f"outside the supported subset")
    return text


def _strip_comment(line: str, lineno: int) -> str:
    """The line without its comment: a '#' at the start or after a blank,
    outside quotes."""
    quote = None
    i = 0
    while i < len(line):
        c = line[i]
        if quote == "'":
            if c == "'":
                if line[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    if quote is not None:
        raise YAMLSubsetError(f"line {lineno}: multi-line quoted scalar is outside the "
                              f"supported subset")
    return line.rstrip()


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}


class _Flow:
    """Recursive descent over one (joined) line of flow content."""

    def __init__(self, text: str, lineno: int):
        self.s, self.i, self.lineno = text, 0, lineno

    def error(self, what: str) -> YAMLSubsetError:
        return YAMLSubsetError(f"line {self.lineno}: {what} in {self.s!r}")

    def skip(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def node(self, flow: bool) -> Any:
        self.skip()
        c = self.peek()
        if c == "[":
            return self.sequence()
        if c == "{":
            return self.mapping()
        if c and c in "'\"":
            return self.quoted()
        if flow and not c:
            raise self.error("unclosed flow collection (one line each)")
        return self.plain(flow)

    def quoted(self) -> str:
        q = self.s[self.i]
        self.i += 1
        out = []
        while True:
            if self.i >= len(self.s):
                raise self.error("unterminated quoted scalar")
            c = self.s[self.i]
            if q == "'" and c == "'":
                if self.s[self.i + 1:self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if q == '"' and c == '"':
                self.i += 1
                return "".join(out)
            if q == '"' and c == "\\":
                e = self.s[self.i + 1:self.i + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    self.i += 2
                    continue
                width = {"x": 2, "u": 4, "U": 8}.get(e)
                if width is None:
                    raise self.error(f"unknown escape \\{e}")
                out.append(chr(int(self.s[self.i + 2:self.i + 2 + width], 16)))
                self.i += 2 + width
                continue
            out.append(c)
            self.i += 1

    def plain(self, flow: bool) -> Any:
        c = self.peek()
        if c in _INDICATORS:
            raise self.error(f"{_INDICATORS[c]} is outside the supported subset")
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            nxt = self.s[self.i + 1:self.i + 2]
            if flow and c in _FLOW_END:
                break
            if c == ":" and (nxt == "" or nxt in " \t" or (flow and nxt in _FLOW_END)):
                break
            self.i += 1
        text = self.s[start:self.i].strip()
        if flow and not text:
            raise self.error("empty flow entry")
        return resolve_scalar(text)

    def key_value(self) -> Tuple[Any, Any, bool]:
        """An entry: (key, value, whether it had a ':')."""
        key = self.node(flow=True)
        self.skip()
        if self.peek() != ":":
            return key, None, False
        self.i += 1
        self.skip()
        if self.peek() in (",", "}", "]"):
            return key, None, True
        return key, self.node(flow=True), True

    def sequence(self) -> list:
        self.i += 1
        out = []
        while True:
            self.skip()
            if self.peek() == "]":
                self.i += 1
                return out
            key, value, pair = self.key_value()
            out.append({key: value} if pair else key)
            self.skip()
            c = self.peek()
            if c == ",":
                self.i += 1
            elif c != "]":
                raise self.error("expected ',' or ']'")

    def mapping(self) -> dict:
        self.i += 1
        out = {}
        while True:
            self.skip()
            if self.peek() == "}":
                self.i += 1
                return out
            key, value, _ = self.key_value()
            out[key] = value
            self.skip()
            c = self.peek()
            if c == ",":
                self.i += 1
            elif c != "}":
                raise self.error("expected ',' or '}'")

    def end(self) -> None:
        self.skip()
        if self.i != len(self.s):
            raise self.error("unexpected content after the value")


class _Block:
    """The block structure over (indent, text, lineno) lines."""

    def __init__(self, lines: List[Tuple[int, str, int]]):
        self.lines = lines
        self.k = 0

    def inline(self, text: str, lineno: int) -> Any:
        """A value on one line: a flow collection, a quoted or a plain
        scalar."""
        if text == "-" or text.startswith("- "):
            raise YAMLSubsetError(f"line {lineno}: a sequence entry is not allowed here: "
                                  f"{text!r}")
        f = _Flow(text, lineno)
        value = f.node(flow=False)
        f.end()
        return value

    def node(self, indent: int) -> Any:
        ind, text, lineno = self.lines[self.k]
        if text == "-" or text.startswith("- "):
            return self.sequence(ind)
        if _mapping_key(text) is not None:
            return self.mapping(ind)
        self.k += 1
        return self.inline(text, lineno)

    def nested(self, parent: int, allow_seq_at_parent: bool) -> Any:
        """The value after a ``key:`` or ``-`` with nothing on its line: a
        deeper block, a sequence at the key's own indent, or None."""
        if self.k < len(self.lines):
            ind, text, _ = self.lines[self.k]
            if ind > parent or (allow_seq_at_parent and ind == parent
                                and (text == "-" or text.startswith("- "))):
                return self.node(ind)
        return None

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.k < len(self.lines):
            ind, text, lineno = self.lines[self.k]
            if ind < indent:
                break
            if ind > indent:
                raise YAMLSubsetError(f"line {lineno}: unexpected indentation")
            split = _mapping_key(text)
            if split is None:
                raise YAMLSubsetError(f"line {lineno}: expected 'key: value', got {text!r}")
            key_text, rest = split
            f = _Flow(key_text, lineno)
            key = f.node(flow=False)
            f.end()
            self.k += 1
            out[key] = (self.inline(rest, lineno) if rest
                        else self.nested(indent, allow_seq_at_parent=True))
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while self.k < len(self.lines):
            ind, text, lineno = self.lines[self.k]
            if ind < indent or not (text == "-" or text.startswith("- ")):
                if ind > indent:
                    raise YAMLSubsetError(f"line {lineno}: unexpected indentation")
                break
            if ind > indent:
                raise YAMLSubsetError(f"line {lineno}: unexpected indentation")
            rest = text[1:].lstrip()
            if not rest:
                self.k += 1
                out.append(self.nested(indent, allow_seq_at_parent=False))
                continue
            # a compact nested node: re-read the item's text as a line of
            # its own at the column it starts in
            self.lines[self.k] = (ind + len(text) - len(rest), rest, lineno)
            out.append(self.node(self.lines[self.k][0]))
        return out


def _mapping_key(text: str):
    """(key text, value text) when ``text`` is a block mapping entry, else
    None. The key is a quoted scalar or a plain one up to ': ' (or a ':'
    ending the line)."""
    if text[:1] in "[{":
        return None
    if text[:1] in "'\"":
        f = _Flow(text, 0)
        try:
            f.quoted()
        except YAMLSubsetError:
            return None
        rest = text[f.i:]
        if rest.startswith(":") and (len(rest) == 1 or rest[1] in " \t"):
            return text[:f.i], rest[1:].strip()
        return None
    m = re.search(r":(?:[ \t]|$)", text)
    if m is None:
        return None
    return text[:m.start()].rstrip(), text[m.end():].strip()


def load(text: str) -> Any:
    """Parse one YAML document of the subset; the value ``yaml.safe_load``
    gives (None for an empty document)."""
    lines: List[Tuple[int, str, int]] = []
    started = False
    for lineno, raw in enumerate(text.splitlines(), start=1):
        body = raw.lstrip(" ")
        if body.startswith("\t") or ("\t" in raw[:len(raw) - len(body)]):
            raise YAMLSubsetError(f"line {lineno}: a tab in the indentation is outside the "
                                  f"supported subset")
        stripped = _strip_comment(body, lineno)
        if not stripped:
            continue
        indent = len(raw) - len(body)
        if indent == 0 and stripped.startswith("%"):
            raise YAMLSubsetError(f"line {lineno}: directive is outside the supported subset")
        if indent == 0 and (stripped == "---" or stripped.startswith("--- ")):
            if started or lines:
                raise YAMLSubsetError(f"line {lineno}: several documents are outside the "
                                      f"supported subset")
            started = True
            stripped = stripped[3:].strip()
            if not stripped:
                continue
        if indent == 0 and stripped == "...":
            raise YAMLSubsetError(f"line {lineno}: document end marker is outside the "
                                  f"supported subset")
        lines.append((indent, stripped, lineno))
    if not lines:
        return None
    block = _Block(lines)
    value = block.node(lines[0][0])
    if block.k != len(lines):
        raise YAMLSubsetError(f"line {lines[block.k][2]}: unexpected content "
                              f"{lines[block.k][1]!r}")
    return value
