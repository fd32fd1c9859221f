"""A YAML reader for the subset that settings files use.

The card's machine has no pyyaml. This reads what ``settings/*.yml``
holds, with ``yaml.safe_load``'s results: block mappings and sequences
(a sequence may sit at its key's indent), flow sequences and mappings (over
several lines too), comments, plain, single- and double-quoted scalars,
and YAML 1.1's implicit types as PyYAML resolves them (``null``/``~``,
``true``/``yes``/``on`` and their opposites, ints in decimal, octal, hex
and binary, floats that have a dot, ``.inf``, ``.nan``). Anything else
raises :class:`YamlError` with its line number: anchors, aliases, tags,
block and multi-line scalars, document markers, merge keys, sexagesimal
numbers and timestamps.
"""

from __future__ import annotations

import re
from pathlib import Path

__all__ = ["YamlError", "load", "load_file"]


class YamlError(ValueError):
    """A document outside the supported subset, or malformed."""

    def __init__(self, line: int, message: str):
        super().__init__(f"line {line}: {message}")
        self.line = line


_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True, "True": True, "TRUE": True,
         "on": True, "On": True, "ON": True, "no": False, "No": False, "NO": False,
         "false": False, "False": False, "FALSE": False, "off": False, "Off": False,
         "OFF": False}
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+)$""", re.X)
_UNSUPPORTED = re.compile(r"""^(?:[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?
                    |[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:(?:[Tt]|[ \t]+).*)?
                    |<<|=)$""", re.X)


def _plain(text: str, line: int):
    """A plain scalar's value as PyYAML's safe loader resolves it."""
    if _NULL.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        sign = -1 if text[0] == "-" else 1
        body = text.lstrip("+-").replace("_", "")
        if body.startswith("0b"):
            return sign * int(body[2:], 2)
        if body.startswith("0x"):
            return sign * int(body[2:], 16)
        if len(body) > 1 and body[0] == "0":
            return sign * int(body, 8)
        return sign * int(body)
    if _FLOAT.match(text):
        body = text.replace("_", "").lower()
        if body.endswith(".inf"):
            return float("-inf") if body[0] == "-" else float("inf")
        if body.endswith(".nan"):
            return float("nan")
        return float(body)
    if _UNSUPPORTED.match(text):
        raise YamlError(line, f"unsupported scalar {text!r} (sexagesimal, timestamp or merge)")
    if text[0] in "&*!|>%@`":
        raise YamlError(line, f"unsupported YAML construct {text[0]!r} in {text!r}")
    return text


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}


class _Scanner:
    """Reads quoted scalars and flow collections from one logical text."""

    def __init__(self, text: str, line: int):
        self.text, self.pos, self.line = text, 0, line

    def error(self, message: str):
        return YamlError(self.line, message)

    def skip_spaces(self) -> None:
        while self.pos < len(self.text) and self.text[self.pos] in " \t\n":
            self.pos += 1

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def quoted(self) -> str:
        quote = self.text[self.pos]
        self.pos += 1
        out = []
        while True:
            if self.pos >= len(self.text):
                raise self.error("unterminated quoted scalar")
            ch = self.text[self.pos]
            if ch == "\n":
                raise self.error("multi-line quoted scalars are not supported")
            if quote == "'" and ch == "'":
                if self.text[self.pos + 1:self.pos + 2] == "'":
                    out.append("'")
                    self.pos += 2
                    continue
                self.pos += 1
                return "".join(out)
            if quote == '"' and ch == '"':
                self.pos += 1
                return "".join(out)
            if quote == '"' and ch == "\\":
                esc = self.text[self.pos + 1:self.pos + 2]
                if esc in _ESCAPES:
                    out.append(_ESCAPES[esc])
                    self.pos += 2
                    continue
                width = {"x": 2, "u": 4, "U": 8}.get(esc)
                if width is None:
                    raise self.error(f"unknown escape \\{esc}")
                code = self.text[self.pos + 2:self.pos + 2 + width]
                out.append(chr(int(code, 16)))
                self.pos += 2 + width
                continue
            out.append(ch)
            self.pos += 1

    def node(self):
        """A flow node: a collection, a quoted or a plain scalar."""
        self.skip_spaces()
        ch = self.peek()
        if ch == "[":
            return self.sequence()
        if ch == "{":
            return self.mapping()
        if ch in "'\"":
            return self.quoted()
        start = self.pos
        while self.pos < len(self.text) and self.text[self.pos] not in ",[]{}\n":
            if self.text[self.pos] == ":" and self.text[self.pos + 1:self.pos + 2] in (" ", ","):
                break
            self.pos += 1
        return _plain(self.text[start:self.pos].strip(), self.line)

    def sequence(self) -> list:
        self.pos += 1
        out = []
        while True:
            self.skip_spaces()
            if self.peek() == "]":
                self.pos += 1
                return out
            out.append(self.node())
            self.skip_spaces()
            ch = self.peek()
            if ch == ",":
                self.pos += 1
            elif ch != "]":
                raise self.error(f"expected ',' or ']' in a flow sequence, got {ch!r}")

    def mapping(self) -> dict:
        self.pos += 1
        out = {}
        while True:
            self.skip_spaces()
            if self.peek() == "}":
                self.pos += 1
                return out
            key = self.node()
            self.skip_spaces()
            if self.peek() != ":":
                raise self.error("expected ':' in a flow mapping")
            self.pos += 1
            self.skip_spaces()
            out[key] = None if self.peek() in (",", "}") else self.node()
            self.skip_spaces()
            ch = self.peek()
            if ch == ",":
                self.pos += 1
            elif ch != "}":
                raise self.error(f"expected ',' or '}}' in a flow mapping, got {ch!r}")


def _strip_comment(text: str) -> str:
    """``text`` without a ``#`` comment (one at the start or after a
    space, outside quotes)."""
    quote, i = None, 0
    while i < len(text):
        ch = text[i]
        if quote:
            if quote == "'" and text[i:i + 2] == "''":
                i += 1
            elif quote == '"' and ch == "\\":
                i += 1
            elif ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " \t[{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def _depth(text: str) -> int:
    """Open brackets minus closed ones outside quotes."""
    depth, quote = 0, None
    for ch in text:
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    return depth


def _key_split(text: str):
    """(key text, rest) when ``text`` is ``key: rest`` outside quotes and
    brackets, else None."""
    quote, depth = None, 0
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
            continue
        if ch in "'\"" and i == 0:
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == ":" and depth == 0 and (i + 1 == len(text) or text[i + 1] in " \t"):
            return text[:i].rstrip(), text[i + 1:].strip()
    return None


class _Parser:
    def __init__(self, source: str):
        self.lines: list[tuple[int, int, str]] = []  # (line number, indent, text)
        raw = source.splitlines()
        i = 0
        while i < len(raw):
            number, line = i + 1, raw[i]
            i += 1
            text = _strip_comment(line)
            if not text.strip():
                continue
            body = text.lstrip(" ")
            if body.startswith("\t") or "\t" in text[:len(text) - len(body)]:
                raise YamlError(number, "tabs in indentation")
            if body.startswith(("---", "...", "%")):
                raise YamlError(number, f"document markers and directives are not supported: "
                                        f"{body!r}")
            # A flow collection that spans lines is one logical line.
            while _depth(body) > 0:
                if i >= len(raw):
                    raise YamlError(number, "unterminated flow collection")
                body += "\n" + _strip_comment(raw[i]).strip()
                i += 1
            self.lines.append((number, len(text) - len(text.lstrip(" ")), body))
        self.i = 0

    def value(self, text: str, number: int):
        """An inline value: a flow collection or a scalar."""
        if text[0] in "|>":
            raise YamlError(number, "block scalars are not supported")
        if text[0] in "&*!":
            raise YamlError(number, f"unsupported YAML construct {text[0]!r} (anchors, aliases "
                                    "and tags are not supported)")
        if text[0] not in "[{'\"":
            return _plain(text, number)  # block context: commas and brackets are text
        scanner = _Scanner(text, number)
        out = scanner.node()
        scanner.skip_spaces()
        if scanner.pos != len(text):
            raise YamlError(number, f"unexpected text after a value: {text[scanner.pos:]!r}")
        return out

    def block(self, indent: int):
        number, ind, text = self.lines[self.i]
        if text == "-" or text.startswith("- "):
            return self.sequence(ind)
        if _key_split(text) is not None:
            return self.mapping(ind)
        self.i += 1
        if self.i < len(self.lines) and self.lines[self.i][1] > ind:
            raise YamlError(self.lines[self.i][0], "multi-line plain scalars are not supported")
        return self.value(text, number)

    def after_key(self, indent: int, number: int, rest: str, seq_at_indent: bool):
        """The value of ``key:`` whose inline ``rest`` may be empty."""
        if rest:
            return self.value(rest, number)
        if self.i < len(self.lines):
            nxt_number, nxt_ind, nxt_text = self.lines[self.i]
            if nxt_ind > indent or (seq_at_indent and nxt_ind == indent and
                                    (nxt_text == "-" or nxt_text.startswith("- "))):
                return self.block(nxt_ind)
        return None

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.i < len(self.lines):
            number, ind, text = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                raise YamlError(number, "bad indentation of a mapping entry")
            if text == "-" or text.startswith("- "):
                break
            split = _key_split(text)
            if split is None:
                raise YamlError(number, f"expected 'key: value', got {text!r}")
            key_text, rest = split
            if key_text.startswith("? "):
                raise YamlError(number, "complex mapping keys are not supported")
            key = self.value(key_text, number)
            self.i += 1
            out[key] = self.after_key(indent, number, rest, seq_at_indent=True)
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            number, ind, text = self.lines[self.i]
            if ind != indent or not (text == "-" or text.startswith("- ")):
                if ind > indent:
                    raise YamlError(number, "bad indentation of a sequence entry")
                break
            rest = text[1:].lstrip(" ")
            if not rest:
                self.i += 1
                out.append(self.after_key(indent, number, "", seq_at_indent=False))
            elif rest.startswith("- ") or rest == "-" or _key_split(rest) is not None:
                # An entry that opens a nested block on its own line: read it
                # as the block at the entry's column.
                col = ind + len(text) - len(rest)
                self.lines[self.i] = (number, col, rest)
                out.append(self.block(col))
            else:
                self.i += 1
                out.append(self.value(rest, number))
        return out

    def document(self):
        if not self.lines:
            return None
        out = self.block(self.lines[0][1])
        if self.i < len(self.lines):
            raise YamlError(self.lines[self.i][0], "unexpected content after the document")
        return out


def load(source: str):
    """The document in ``source`` as Python data, as ``yaml.safe_load``
    reads it (within the subset above)."""
    return _Parser(source).document()


def load_file(path: str | Path):
    with open(path) as f:
        return load(f.read())
